"""Logical FLOP accounting for the flagship model (MFU reporting), a copy
of ``multimodal_pl_tpu/utils/flops.py`` (importing it would run the JAX
package's ``__init__``), pinned to it by ``tests/test_torch_port_remat.py``.

All counts are LOGICAL voxel FLOPs of the reference model's math
(reference unet3D.py:938-1190): 2 * k^3 * Ci * Co MACs-as-FLOPs per
output voxel for convs, 2*M*K*N for matmuls — independent of how a backend
lowers them (MFU is always judged against the logical count).

Elementwise work (GN, ReLU, residuals, upsample blends, softmax) is omitted:
it is < 1% of the conv FLOPs and bandwidth-bound besides.
"""

from __future__ import annotations


def _conv(ci: int, co: int, voxels: float, k: int = 27) -> float:
    return 2.0 * k * ci * co * voxels


def flagship_forward_flops(shape=(64, 192, 192), batch: int = 1,
                           base: int = 32, num_classes: int = 14,
                           layers=(1, 2, 2, 2, 2), eam: bool = True) -> float:
    """Logical FLOPs of one UNet3DFEAM forward (train-mode graph; the eval
    graph is identical minus the deep_up resizes, which carry no matmul
    FLOPs). Mirrors models/unet3d.py stage by stage."""
    d, h, w = shape
    b, nc = base, num_classes

    def vox(s):
        return float(batch) * (d // s) * (h // s) * (w // s)

    f = _conv(1, b, vox(1))                                  # stem conv1
    for _ in range(layers[0]):                               # layer0
        f += 2 * _conv(b, b, vox(1))
    chans = [b, 2 * b, 4 * b, 8 * b, 8 * b]
    for li in range(1, 5):                                   # enc stages 1-4
        ci, co, s = chans[li - 1], chans[li], 2 ** li
        f += _conv(ci, co, vox(s)) + _conv(co, co, vox(s))   # block0
        f += _conv(ci, co, vox(s), k=1)                      # projection
        for _ in range(layers[li] - 1):
            f += 2 * _conv(co, co, vox(s))
    f += _conv(8 * b, 8 * b, vox(16), k=1)                   # fusion head

    # decoder resb stages (1 block each; projection when channels change)
    for ci, co, s in ((8 * b, 4 * b, 8), (4 * b, 2 * b, 4),
                      (2 * b, b, 2), (b, b, 1)):
        f += _conv(ci, co, vox(s)) + _conv(co, co, vox(s))
        if ci != co:
            f += _conv(ci, co, vox(s), k=1)

    # deep-sup heads + classifier
    for co, s in ((4 * b, 8), (2 * b, 4), (b, 2)):
        f += _conv(co, nc, vox(s), k=1)
    f += _conv(b, nc, vox(1), k=1)

    if eam:
        # EAM cross-attention at the three decoder scales (models/eam.py):
        # kv projection (N, C)@(C, 2C), q ((nc-1), C)@(C, C), scores
        # (nt, C)@(C, N), attn@v, out proj (nt, C)@(C, C)
        nt = nc - 1
        for dim, s in ((4 * b, 8), (2 * b, 4), (b, 2)):
            n = vox(s)
            f += 2 * n * dim * (2 * dim)            # kv
            f += 2 * batch * nt * dim * dim         # q
            f += 2 * 2 * nt * n * dim               # scores + attn@v
            f += 2 * batch * nt * dim * dim         # out proj
    return f


def refiner_forward_flops(shape=(64, 192, 192), batch: int = 1,
                          init_filter: int = 24) -> float:
    """unet3D_g refiner (models/refiner.py; reference unet3D.py:1507-1623):
    stride-2 stem conv0, enc stages f..8f at /2../16, decoder back to /2,
    final 1x1 + x2 upsample."""
    d, h, w = shape
    f0 = init_filter

    def vox(s):
        return float(batch) * (d // s) * (h // s) * (w // s)

    f = _conv(2, f0, vox(2))                                 # conv0 stride-2 stem
    chans = [f0, f0, 2 * f0, 4 * f0, 8 * f0]
    scales = [2, 2, 4, 8, 16]
    f += 2 * _conv(f0, f0, vox(2)) * 1                       # layer0 (1 block)
    for li in range(1, 5):
        ci, co, s = chans[li - 1], chans[li], scales[li]
        f += _conv(ci, co, vox(s)) + _conv(co, co, vox(s))
        f += _conv(ci, co, vox(s), k=1)
    f += _conv(8 * f0, 8 * f0, vox(16), k=1)                 # fusion
    for ci, co, s in ((8 * f0, 4 * f0, 8), (4 * f0, 2 * f0, 4),
                      (2 * f0, f0, 2)):
        f += _conv(ci, co, vox(s)) + _conv(co, co, vox(s))
        f += _conv(ci, co, vox(s), k=1)
    f += _conv(f0, 2, vox(2), k=1)                           # precls (2-way)
    return f


def train_step_flops(shape=(64, 192, 192), batch: int = 1, base: int = 32,
                     num_classes: int = 14, refine_k: int = 2,
                     aug_mask: int = 2) -> dict:
    """Logical FLOPs of the full fused train step (train/step.py), by
    component. Backward passes are counted as 2x the forward (dgrad + wgrad,
    the standard conv accounting).

    refine_k: static organ count of the refiner GRAD pass (tlist gather);
    the no-grad complement pass runs all (num_classes-1) organs."""
    seg = flagship_forward_flops(shape, batch, base, num_classes)
    ref1 = refiner_forward_flops(shape, batch * refine_k * aug_mask)
    refc = refiner_forward_flops(shape, batch * (num_classes - 1))
    # discriminator: k4-s2 pyramid 2->64->128->256->512->1024->2 at /2../64
    d, h, w = shape
    disc = 0.0
    ci = num_classes + 13  # preds (nc) + atlas (13) input planes
    co = 64
    for s in (2, 4, 8, 16, 32, 64):
        vv = float(batch) * max(d // s, 1) * max(h // s, 1) * max(w // s, 1)
        disc += _conv(ci, co, vv, k=64)
        ci, co = co, min(co * 2, 1024)
    return {
        "seg_fwd": seg,
        "seg_bwd": 2 * seg,
        "refiner_grad": 3 * ref1,
        "refiner_nograd": refc,
        "disc": 3 * disc * 2,        # D pass + G pass, fwd+bwd each
        "total": seg * 3 + 3 * ref1 + refc + disc * 6,
    }


# H100 SXM dense bf16 peak: 989 TFLOP/s (NVIDIA data sheet, at the 700 W limit)
H100_BF16_PEAK = 989e12
