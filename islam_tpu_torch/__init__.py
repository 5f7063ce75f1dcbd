"""islam_tpu_torch: the PyTorch and CUDA port of islam_tpu for NVIDIA Hopper.

Mirrors the module tree of ``islam_tpu`` (the JAX reference it is held
against), in PyTorch idiom: networks are ``nn.Module``s in NCHW, everything
else is plain functions on tensors, the device is always explicit, and the
one TPU kernel on the path (the PWC-Net correlation) is a hand-written CUDA
kernel (``csrc/correlation_sm90.cu``).  Public functions keep the JAX package's
layouts: images NHWC, correlation (B, C, H, W), SE3 rows [t, q] with
quaternions (x, y, z, w).

This package imports neither JAX nor ``islam_tpu``.
"""

__version__ = "0.1.0"
