"""The benchmark of islam_tpu_torch (``python3 portbench/run.py``)."""
