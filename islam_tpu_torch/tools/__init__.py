"""Measurement tools of the port: the counterparts of ``tools/*.py``.

- ``h100``: the card's peak rates, the ``nvidia-smi`` line, the TF32 flags;
- ``flops``: the model FLOPs of one ``train_step`` by part
  (``tools/flops_analysis.py``);
- ``conv_roofline``: every convolution family of a profiled window against
  the card's roofline, and the window's MFU (``tools/conv_roofline.py``);
- ``copies``: the copy-like ops of a profiled window by bytes
  (``tools/dump_copies.py``).

``profile_window`` (the package's root) is the counterpart of
``tools/profile_step.py`` and ``tools/analyze_xplane.py``.  Each tool runs
as ``python -m islam_tpu_torch.tools.<name>`` and prints one JSON object.
"""
