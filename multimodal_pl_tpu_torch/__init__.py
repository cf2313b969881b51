"""multimodal_pl_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
multimodal_pl_tpu.

The JAX package stays the reference; every module here sits at the path of
its JAX counterpart and is tested against it (tests/test_torch_port_*.py).
This package imports torch and never JAX, and nothing of the JAX package:
where it needs a JAX-free module of it (the data pipeline, small helpers),
it keeps its own copy, pinned to the original by a test.

Activations are channels-last (B, D, H, W, C) at every public function, as in
the JAX package. Parameters use the reference torch ``state_dict`` names, so
a reference ``.pth`` loads with ``load_state_dict(strict=True)``
(:mod:`multimodal_pl_tpu_torch.convert`).

Ported: the FEAM sliding-window inference path (ops, the UNet3DFEAM
segmenter, the predictor, the metrics, ``mpl-evaluate-torch``) and training
(the refiner, the discriminators, the losses, the train step, loop and
checkpoints, ``mpl-train-torch``). Every stride-1 3x3x3 conv of the U-Nets
past their stems runs a hand-written CUDA kernel for sm_90a (``csrc/conv3x3_gn.cu``), forward and
dx under autograd; every GroupNorm -> ReLU under autograd runs
``csrc/gn_relu.cu``. Both are built with nvcc on first use
(:mod:`multimodal_pl_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"
