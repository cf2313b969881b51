"""Device-resident training batches, port of
``multimodal_pl_tpu/data/device_cache.py``.

The host path (``AMOSDataset.batches``) crops and augments every batch in a
background thread with numpy and scipy, then copies about 20 MB per sample
(image and atlas channels) to the card. Here the crop-invariant prepared
volumes (``AMOSDataset._prepared``: read, atlas resize, trim, pad, intensity
truncate) go to the card once, and each batch is assembled there: slices at
crop corners drawn on the host, optional mirror flips, and the
batchgenerators intensity recipe as batched tensor ops. The host draws only
indices, corners, flips and augmentation parameters.

Faithfulness (as in the JAX package):
- crop corners, flips, the augmentation parameters and their order
  (noise -> blur -> brightness x -> brightness + -> contrast,
  MOTSDataset.py:36-42) follow the host path's numpy control flow, and the
  batch takes sample 0's catlas, sup_mask and label_t (train:246-248);
- the noise comes from a ``torch.Generator`` on the pipeline's device,
  seeded per batch number (same distribution as the host's, another
  stream), and the blur has a fixed radius of 4 voxels against scipy's
  int(4 * sigma + 0.5) (for sigma in [0.5, 1.0] the extra taps carry at
  most 3e-5 of the kernel's weight); both pad as scipy's ``'reflect'``
  (numpy's ``'symmetric'``), which repeats the edge sample;
- volumes are stored in the compute dtype (the step casts them anyway);
  the recipe runs in f32 like the host path's.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from multimodal_pl_tpu_torch.data.supervision import label_t_of

_AUG_KEYS = ("noise_on", "noise_std", "blur_on", "blur_sig",
             "bm_on", "bm_f", "ba_on", "ba_sh", "ct_on", "ct_f")
_BLUR_R = 4  # kernel radius; scipy's truncate=4.0 at sigma<=1.0 rounds to <=4


def draw_aug_params(rng: np.random.Generator, batch: int) -> Dict[str, np.ndarray]:
    """Per-sample aug parameters with the exact control flow (probabilities,
    draw order, single-channel inner loops) of data/augment.draw_intensity."""
    p = {k: np.zeros(batch, np.float32) for k in _AUG_KEYS}
    p["blur_sig"][:] = 0.75  # placeholder sigma for disabled rows (selected away)
    p["bm_f"][:] = 1.0
    p["ct_f"][:] = 1.0
    for i in range(batch):
        if rng.random() < 0.1:  # GaussianNoiseTransform(p_per_sample=0.1)
            p["noise_on"][i] = 1.0
            p["noise_std"][i] = np.sqrt(rng.uniform(0, 0.1))
        if rng.random() < 0.2:  # GaussianBlurTransform, per-channel p=0.5, C=1
            if rng.random() < 0.5:
                p["blur_on"][i] = 1.0
                p["blur_sig"][i] = rng.uniform(0.5, 1.0)
        if rng.random() < 0.15:  # BrightnessMultiplicativeTransform
            p["bm_on"][i] = 1.0
            p["bm_f"][i] = rng.uniform(0.75, 1.25)
        if rng.random() < 0.15:  # BrightnessTransform, per-channel p=0.5, C=1
            if rng.random() < 0.5:
                p["ba_on"][i] = 1.0
                p["ba_sh"][i] = rng.normal(0.0, 0.1)
        if rng.random() < 0.15:  # ContrastAugmentationTransform(preserve_range)
            p["ct_on"][i] = 1.0
            p["ct_f"][i] = rng.uniform(0.75, 1.25)
    return p


def symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of numpy's ``'symmetric'`` padding of a length-n axis by r on
    each side: the edge sample repeats (..., x1, x0 | x0, x1, ...), which is
    scipy's ``'reflect'``. Torch's ``'reflect'`` mode skips the edge sample
    and ``'replicate'`` repeats only it."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def gauss_kernels(sigma: torch.Tensor, radius: int = _BLUR_R) -> torch.Tensor:
    """(B,) sigmas -> (B, 2 * radius + 1) normalized f32 Gaussian taps."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x / sigma.float()[:, None]) ** 2)
    return k / k.sum(-1, keepdim=True)


def _blur_axis(x: torch.Tensor, kern: torch.Tensor, ax: int) -> torch.Tensor:
    """Separable 1-D Gaussian along axis ``ax`` (1, 2 or 3) of (B, D, H, W),
    sample b with the taps kern[b]."""
    n = x.shape[ax]
    xp = x.index_select(ax, symmetric_index(n, _BLUR_R, x.device))
    view = (x.shape[0], 1, 1, 1)
    out = kern[:, 0].view(view) * xp.narrow(ax, 0, n)
    for t in range(1, 2 * _BLUR_R + 1):
        out = out + kern[:, t].view(view) * xp.narrow(ax, t, n)
    return out


def intensity_augment_device(x: torch.Tensor, p: Dict[str, torch.Tensor],
                             generator: torch.Generator) -> torch.Tensor:
    """The intensity recipe of data/augment.apply_intensity over a batch,
    each sample with its own parameters (the JAX package's vmap).
    x: (B, D, H, W) f32; p: {key of _AUG_KEYS: (B,) f32 tensor on x's
    device}; generator: a torch.Generator on x's device (the noise)."""
    b = x.shape[0]

    def col(v):
        return v.view(b, 1, 1, 1)

    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    x = x + col(p["noise_on"]) * (noise * col(p["noise_std"]))
    kern = gauss_kernels(torch.clamp(p["blur_sig"], min=0.5))
    xb = x
    for ax in (1, 2, 3):
        xb = _blur_axis(xb, kern, ax)
    x = torch.where(col(p["blur_on"]) > 0, xb, x)
    x = x * col(torch.where(p["bm_on"] > 0, p["bm_f"], 1.0))
    x = x + col(torch.where(p["ba_on"] > 0, p["ba_sh"], 0.0))
    dims = (1, 2, 3)
    mn, mx = col(x.amin(dims)), col(x.amax(dims))
    mean = col(x.mean(dims))
    xc = torch.minimum(torch.maximum((x - mean) * col(p["ct_f"]) + mean, mn), mx)
    return torch.where(col(p["ct_on"]) > 0, xc, x)


class DeviceDataPipeline:
    """Batches of ``AMOSDataset.batches``' semantics, assembled on ``device``
    from the whole prepared training set held there.

    Every case must have the same original volume shape (so one resized
    atlas serves all and every crop corner range is the same); otherwise, or
    with random-scale zoom (``ds.scale``), the constructor raises ValueError
    and callers take the host path. ``device`` defaults to the GPU and a
    CUDA device raises where there is none.

    Data parallelism (``rank`` of ``world`` ranks, the JAX pipeline's
    ``mesh``): every rank holds the whole prepared set on its own card and
    draws the same host stream (same seed) for ``batch_size * world``
    samples a step; rank r assembles row block r of each draw, and its
    noise seed folds in r as JAX folds in ``axis_index`` (rank 0's is the
    one-device seed). At ``world == 1`` the pipeline is the single-device
    one, bit for bit.
    """

    def __init__(self, ds, compute_dtype: torch.dtype = torch.bfloat16, augment: bool = True,
                 mirror: bool = False, seed: int = 0, device="cuda", rank: int = 0,
                 world: int = 1):
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.rank, self.world = rank, world
        if getattr(ds, "scale", False):
            raise ValueError("random-scale zoom is host-path only")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DeviceDataPipeline(device={device!r}): no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        self.augment, self.mirror, self.compute_dtype = augment, mirror, compute_dtype
        self.crop = (ds.crop_d, ds.crop_h, ds.crop_w)  # in the (D, H, W) layout
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self._nbatch = 0
        self._gen = torch.Generator(device=self.device)

        imgs, labs, sups, lts = [], [], [], []
        shape = catlas0 = None
        for i in range(len(ds)):
            cid, image, label, catlas = ds._prepared(i)  # (H, W, D) volumes
            if shape is None:
                shape, catlas0 = image.shape, catlas
            elif image.shape != shape:
                raise ValueError(f"device data pipeline needs uniform case shapes: "
                                 f"{image.shape} != {shape}")
            imgs.append(image.transpose(2, 0, 1))  # -> (D, H, W)
            labs.append(label.transpose(2, 0, 1).astype(np.uint8))
            sups.append(ds._sup_mask(cid))
            lts.append(label_t_of(cid))
        self.n = len(imgs)
        if self.n == 0:
            raise ValueError("empty dataset")

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

        self.images = put(np.stack(imgs), compute_dtype)  # (N, D, H, W)
        self.labels = put(np.stack(labs), torch.uint8)
        # uniform shapes => every case's resized atlas is the same: one copy
        self.catlas = put(catlas0.transpose(0, 3, 1, 2), compute_dtype)  # (nfg, D, H, W)
        self.sup = put(np.stack(sups), torch.float32)
        self.lt = put(np.stack(lts), torch.float32)
        self.vol_shape = tuple(self.images.shape[1:])

    def draw_starts(self, batch: int) -> np.ndarray:
        """Per-sample crop corners, the host path's ranges (dataset.py:264-266)
        mapped to the (D, H, W) layout."""
        d, h, w = self.vol_shape
        cd, ch, cw = self.crop
        out = np.zeros((batch, 3), np.int64)
        for i in range(batch):
            b = self.rng.integers(0, h - ch)  # axis H (host axis 0)
            c = self.rng.integers(0, w - cw)  # axis W (host axis 1)
            a = self.rng.integers(0, d - cd)  # axis D (host axis 2)
            out[i] = (a, b, c)
        return out

    def draws(self, batch_size: int, shuffle: bool = True, epochs: int = 1):
        """The host's part of each batch, in the JAX pipeline's numpy draw
        order: (case indices (B,), corners (B, 3), flips (B, 3) 0/1, aug
        parameters {key: (B,) f32}, batch number)."""
        for _ in range(epochs):
            order = np.arange(self.n)
            if shuffle:
                self.rng.shuffle(order)
            for i in range(0, self.n - batch_size + 1, batch_size):
                idxs = order[i: i + batch_size]
                starts = self.draw_starts(batch_size)
                flips = ((self.rng.random((batch_size, 3)) < 0.5).astype(np.float32)
                         if self.mirror else np.zeros((batch_size, 3), np.float32))
                p = (draw_aug_params(self.rng, batch_size) if self.augment
                     else {k: np.zeros(batch_size, np.float32) for k in _AUG_KEYS})
                self._nbatch += 1
                yield idxs, starts, flips, p, self._nbatch

    def _crop(self, vol: torch.Tensor, start, flips) -> torch.Tensor:
        """vol (..., D, H, W) cropped at ``start``, flipped on the set axes."""
        (a, b, c), (cd, ch, cw) = start, self.crop
        out = vol[..., a:a + cd, b:b + ch, c:c + cw]
        dims = [ax - 3 for ax in range(3) if flips[ax] > 0]
        return out.flip(dims) if dims else out

    def assemble(self, idxs, starts, flips, p, nbatch: int) -> Dict[str, torch.Tensor]:
        """One batch on the device from its host draws: the dict that
        ``train.loop.to_device`` makes of a host batch (image (B, D, H, W, 1)
        and catlas (nfg, D, H, W) in the compute dtype, label (B, D, H, W)
        uint8, sup_mask and label_t f32 of sample 0)."""
        img = torch.stack([self._crop(self.images[int(i)], s, f)
                           for i, s, f in zip(idxs, starts, flips)])
        lab = torch.stack([self._crop(self.labels[int(i)], s, f)
                           for i, s, f in zip(idxs, starts, flips)])
        if self.augment:
            # the noise stream is keyed per batch number, as the JAX
            # pipeline's fold_in(key, batch number), and per rank r > 0, as
            # its fold_in(key, axis_index) (rank 0 keeps the one-device stream)
            entropy = [self.seed, nbatch] + ([self.rank] if self.rank else [])
            key = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
            self._gen.manual_seed(int(key))
            pt = {k: torch.from_numpy(v).to(self.device) for k, v in p.items()}
            img = intensity_augment_device(img.float(), pt, self._gen)
        i0 = int(idxs[0])
        return {"image": img.to(self.compute_dtype)[..., None].contiguous(),
                "label": lab.contiguous(),
                "catlas": self._crop(self.catlas, starts[0], flips[0]).contiguous(),
                "sup_mask": self.sup[i0], "label_t": self.lt[i0]}

    def batches(self, batch_size: int, shuffle: bool = True,
                epochs: int = 1) -> Iterator[Dict[str, torch.Tensor]]:
        """Device batches of ``batch_size`` samples, ``len // (batch_size *
        world)`` per epoch, as ``AMOSDataset.batches`` yields them on the host
        (grouped over the ranks, as the data-parallel loop groups them)."""
        b, r = batch_size, self.rank
        for idxs, starts, flips, p, nbatch in self.draws(b * self.world, shuffle, epochs):
            rows = slice(r * b, (r + 1) * b)
            yield self.assemble(idxs[rows], starts[rows], flips[rows],
                                {k: v[rows] for k, v in p.items()}, nbatch)
