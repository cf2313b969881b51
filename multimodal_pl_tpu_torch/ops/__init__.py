"""Tensor ops: conv, norm, resize and the fused conv3x3 kernel wrapper."""
