"""Batched sliding-window full-volume inference with Gaussian blending, port
of ``multimodal_pl_tpu/infer/sliding.py``.

Window geometry is the reference's: stride = ceil(tile * 3/4), edge windows
clamped back inside the volume (evaluate_amos.py:215-239). Flip TTA folds the
8 flip variants into the tile batch (:247-255). Volumes are zero-padded on
the device to a bucket shape; count normalization makes the padded margins
exact no-ops, so bucketing never changes the result. Copies of the last
window fill the last batch and are added like any window, as the JAX
predictor adds them: where the last window overlaps another, each copy
weighs it once more.

The window-batch loop is a Python loop: tiles are sliced out of the device
volume, run through the network as one batch, weighted by the Gaussian and
added in place into an f32 accumulator on the device (in-place slice-adds,
where the JAX package's functional updates copy). :meth:`predict_iter` copies
the next volume host -> device from pinned memory on a side CUDA stream while
the current volume computes; compute waits on an event for its own copy.

``make_window_grid`` and ``pad_to_bucket`` are copies of the JAX package's
pure functions (its module imports JAX); the tests pin them equal.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_pl_tpu_torch.infer.gaussian import gaussian_importance_map


def make_window_grid(image_size: Sequence[int], tile: Sequence[int],
                     overlap: float = 0.25) -> np.ndarray:
    """Edge-clamped window starts (N, 3) int32 of (d, h, w)."""
    D, H, W = image_size
    td, th, tw = tile
    stride_hw = math.ceil(th * (1 - overlap))
    stride_d = math.ceil(td * (1 - overlap))
    tiles_d = int(math.ceil((D - td) / stride_d) + 1) if D > td else 1
    tiles_h = int(math.ceil((H - th) / stride_hw) + 1) if H > th else 1
    tiles_w = int(math.ceil((W - tw) / stride_hw) + 1) if W > tw else 1
    starts = []
    for dep in range(tiles_d):
        for row in range(tiles_h):
            for col in range(tiles_w):
                d2 = min(dep * stride_d + td, D)
                h2 = min(row * stride_hw + th, H)
                w2 = min(col * stride_hw + tw, W)
                starts.append((max(d2 - td, 0), max(h2 - th, 0), max(w2 - tw, 0)))
    return np.asarray(starts, np.int32)


def pad_to_bucket(shape: Sequence[int], bucket: Sequence[int] = (32, 64, 64),
                  tile: Sequence[int] = (64, 192, 192)) -> Tuple[int, int, int]:
    """Round a volume shape up to bucket multiples (and at least the tile)."""
    return tuple(
        max(int(np.ceil(s / b)) * b, t) for s, b, t in zip(shape, bucket, tile)
    )


_FLIPS = [(), (1,), (2,), (3,), (1, 2), (1, 3), (2, 3), (1, 2, 3)]  # spatial axes of NDHWC


def _tta_forward(apply_fn, tiles: torch.Tensor) -> torch.Tensor:
    """8-way flip TTA folded into the batch axis (evaluate_amos.py:247-255)."""
    variants = torch.cat([tiles.flip(ax) if ax else tiles for ax in _FLIPS])
    parts = apply_fn(variants).chunk(len(_FLIPS))
    out = parts[0]
    for p, ax in zip(parts[1:], _FLIPS[1:]):
        out = out + p.flip(ax)
    return out / len(_FLIPS)


class SlidingWindowPredictor:
    """apply_fn: tile batch (B, td, th, tw, 1) -> logits (B, td, th, tw, C),
    called on ``device`` in ``compute_dtype``.

    output='logits' returns count-normalized blended logits (D, H, W, C) f32
    (evaluate_amos.py:261-279); 'argmax' returns the uint8 label map (D, H, W)
    and needs no count accumulator (argmax is invariant to the per-voxel
    count, which all channels share).

    ``device`` defaults to the GPU; without one the constructor raises.
    Pass ``device="cpu"`` to run on the CPU."""

    def __init__(self, apply_fn: Callable, tile: Sequence[int], num_classes: int,
                 window_batch: int = 2, tta: bool = False,
                 bucket: Sequence[int] = (32, 64, 64), overlap: float = 0.25,
                 compute_dtype: torch.dtype = torch.float32, device="cuda",
                 output: str = "logits"):
        if output not in ("logits", "argmax"):
            raise ValueError(f"output must be 'logits' or 'argmax', got {output!r}")
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SlidingWindowPredictor(device={device!r}): no CUDA device is "
                               "available; pass device='cpu' to run on the CPU")
        self.apply_fn = apply_fn
        self.tile = tuple(tile)
        self.num_classes = num_classes
        self.window_batch = window_batch
        self.tta = tta
        self.bucket = tuple(bucket)
        self.overlap = overlap
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.output = output
        self.gaussian = torch.from_numpy(gaussian_importance_map(self.tile))[..., None].to(
            self.device)

    def _plan(self, shape):
        """-> (padded shape, window starts (n_batches, window_batch, 3))."""
        padded = pad_to_bucket(shape, self.bucket, self.tile)
        starts = make_window_grid(padded, self.tile, self.overlap)
        wb = self.window_batch
        n_batches = -(-len(starts) // wb)
        if n_batches * wb > len(starts):
            starts = np.concatenate(
                [starts, np.repeat(starts[-1:], n_batches * wb - len(starts), 0)])
        return padded, starts.reshape(n_batches, wb, 3)

    def _host_volume(self, image) -> torch.Tensor:
        """(D, H, W[, 1]) host volume -> (D, H, W, 1) tensor in compute_dtype,
        pinned when the device is a GPU."""
        img = np.asarray(image, dtype=np.float32)
        if img.ndim == 3:
            img = img[..., None]
        host = torch.from_numpy(np.ascontiguousarray(img)).to(self.compute_dtype)
        return host.pin_memory() if self.device.type == "cuda" else host

    def _device_volume(self, host: torch.Tensor, padded) -> torch.Tensor:
        vol = host.to(self.device, non_blocking=True)
        pads = []
        for s, p in zip(reversed(host.shape[:3]), reversed(padded)):
            pads += [0, p - s]
        return F.pad(vol, [0, 0] + pads)

    def _accumulate(self, vol: torch.Tensor, starts: np.ndarray, full: torch.Tensor,
                    count) -> None:
        """Adds the Gaussian-weighted logits of the windows at ``starts``
        (batches of window_batch) into ``full`` and their weights into
        ``count`` (None: not kept), in place."""
        td, th, tw = self.tile
        for batch in starts.tolist():
            tiles = torch.stack([vol[d:d + td, h:h + th, w:w + tw] for d, h, w in batch])
            logits = _tta_forward(self.apply_fn, tiles) if self.tta else self.apply_fn(tiles)
            logits = logits.float() * self.gaussian
            for i, (d, h, w) in enumerate(batch):
                full[d:d + td, h:h + th, w:w + tw] += logits[i]
                if count is not None:
                    count[d:d + td, h:h + th, w:w + tw] += self.gaussian

    def _normalize(self, full: torch.Tensor, count) -> torch.Tensor:
        if self.output == "argmax":
            return full.argmax(dim=-1).to(torch.uint8)
        return full / count

    def _merge(self, acc: torch.Tensor) -> None:
        """Merges the accumulators of the ranks that share the volume's
        windows, in place (a predictor over one process has none)."""

    @torch.inference_mode()
    def _run(self, vol: torch.Tensor, starts: np.ndarray) -> torch.Tensor:
        nc = self.num_classes
        logits = self.output == "logits"
        # full and (for 'logits') count in one tensor: one collective merges both
        acc = torch.zeros((*vol.shape[:3], nc + logits), dtype=torch.float32,
                          device=vol.device)
        full, count = acc[..., :nc], (acc[..., nc:] if logits else None)
        self._accumulate(vol, starts, full, count)
        self._merge(acc)
        return self._normalize(full, count)

    def __call__(self, image) -> torch.Tensor:
        """image: (D, H, W) or (D, H, W, 1) host volume. Returns the blended
        logits (D, H, W, C) f32 or the label map (D, H, W) uint8, on the
        device, for the original shape."""
        host = self._host_volume(image)
        orig = tuple(host.shape[:3])
        padded, starts = self._plan(orig)
        out = self._run(self._device_volume(host, padded), starts)
        return out[: orig[0], : orig[1], : orig[2]]

    def predict_iter(self, images: Iterable) -> Iterator[torch.Tensor]:
        """Streaming inference over host volumes, in order. On a GPU the next
        volume's host -> device copy runs on a side stream while the current
        volume computes."""
        images = iter(images)
        side = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        main = torch.cuda.current_stream(self.device) if side is not None else None

        def stage():
            image = next(images, None)
            if image is None:
                return None
            host = self._host_volume(image)
            orig = tuple(host.shape[:3])
            padded, starts = self._plan(orig)
            if side is None:
                return self._device_volume(host, padded), None, orig, starts
            with torch.cuda.stream(side):
                vol = self._device_volume(host, padded)
                ready = torch.cuda.Event()
                ready.record(side)
            vol.record_stream(main)  # freed only after main's work on it
            return vol, ready, orig, starts

        nxt = stage()
        while nxt is not None:
            vol, ready, orig, starts = nxt
            if ready is not None:
                main.wait_event(ready)
            out = self._run(vol, starts)  # enqueued; runs while the next copy stages
            nxt = stage()
            yield out[: orig[0], : orig[1], : orig[2]]


def predict_sliding_naive(apply_fn, image, tile, num_classes: int,
                          overlap: float = 0.25) -> np.ndarray:
    """Reference-shaped per-tile Python loop (evaluate_amos.py:211-279) on
    host arrays, f64 accumulation: the golden baseline in tests. apply_fn
    takes a (1, *tile, 1) f32 CPU tensor."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3:
        img = img[..., None]
    D, H, W, _ = img.shape
    gauss = gaussian_importance_map(tile)[..., None].astype(np.float64)
    full = np.zeros((D, H, W, num_classes), np.float64)
    count = np.zeros((D, H, W, 1), np.float64)
    for d, h, w in make_window_grid((D, H, W), tile, overlap):
        tile_img = np.ascontiguousarray(img[d: d + tile[0], h: h + tile[1], w: w + tile[2]])
        with torch.inference_mode():
            logits = apply_fn(torch.from_numpy(tile_img[None]))[0].float().cpu().numpy()
        full[d: d + tile[0], h: h + tile[1], w: w + tile[2]] += logits * gauss
        count[d: d + tile[0], h: h + tile[1], w: w + tile[2]] += gauss
    return full / count
