"""Tensor ops: correlation (CUDA kernel + plain version), warp, geometry."""
