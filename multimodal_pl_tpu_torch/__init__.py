"""multimodal_pl_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
multimodal_pl_tpu.

The JAX package stays the reference; every module here sits at the path of
its JAX counterpart and is tested against it (tests/test_torch_port_*.py).
This package imports torch and never JAX; from the JAX package it imports
only the JAX-free data pipeline (``multimodal_pl_tpu.data``).

Activations are channels-last (B, D, H, W, C) at every public function, as in
the JAX package. Parameters use the reference torch ``state_dict`` names, so
a reference ``.pth`` loads with ``load_state_dict(strict=True)``
(:mod:`multimodal_pl_tpu_torch.convert`).

The ported slice is the FEAM sliding-window inference path: ops, the
UNet3DFEAM segmenter, the predictor, the metrics and ``mpl-evaluate-torch``.
Its stride-1 3x3x3 convs run a hand-written CUDA kernel for sm_90a
(``csrc/conv3x3_gn.cu``), built with nvcc on first use
(:mod:`multimodal_pl_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"
