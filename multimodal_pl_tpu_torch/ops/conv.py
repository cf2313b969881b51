"""3D convolution primitives (channels-last activations, torch-layout weights).

Port of ``multimodal_pl_tpu/ops/conv.py``. Activations are (B, D, H, W, C);
kernels keep the torch layout (Cout, Cin, kd, kh, kw) of the reference
``state_dict``. ``conv3d`` is the library conv, used only where the JAX
package leaves the conv to XLA: the Cin=1 stem, the stride-2 3x3x3 convs and
the 1x1 heads. Stride-1 3x3x3 convs go through
:func:`multimodal_pl_tpu_torch.ops.conv3x3.conv3x3_gn`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def standardize_kernel(w: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Weight-standardize a (Cout, Cin, kd, kh, kw) kernel: per output channel,
    subtract the mean and divide by sqrt(unbiased variance + eps). Statistics
    are f32 whatever the dtype of ``w``; the result has the dtype of ``w``."""
    dtype = w.dtype
    wf = w.float()
    wf = wf - wf.mean(dim=(1, 2, 3, 4), keepdim=True)
    var = wf.reshape(wf.shape[0], -1).var(dim=1, unbiased=True)
    return (wf / torch.sqrt(var + eps).view(-1, 1, 1, 1, 1)).to(dtype)


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, D, H, W, Cin) x (Cout, Cin, kd, kh, kw) -> (B, D', H', W', Cout),
    torch-convention symmetric ``padding``. A 1x1x1 kernel is a matmul over
    the channel axis (after striding); any other goes to ``F.conv3d`` on the
    channels-first view, which is already ``channels_last_3d`` (no copy)."""
    if w.shape[2:] == (1, 1, 1) and padding == 0:
        if stride != 1:
            x = x[:, ::stride, ::stride, ::stride, :]
        return F.linear(x, w.reshape(w.shape[0], w.shape[1]), bias)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1)
