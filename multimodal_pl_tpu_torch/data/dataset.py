"""AMOS dataset: discovery, seeded split, truncation, crop, atlas channel.

A copy of ``multimodal_pl_tpu/data/dataset.py``, so that the port's CLIs read
data without importing the JAX package; tests pin its samples to the
original's.

Reference: MOTSDataset.py:70-397 (AMOSDataSet_newatlas). Axis conventions are
preserved exactly: stored volumes are (A0, A1, A2) arrays cropped with sizes
(crop_h, crop_w, crop_d) along (0, 1, 2); the model consumes channels-last
(D, H, W, 1) where D == A2 (the reference's transpose at :390-392 mapped to
channels-last).

Pipeline per sample (order matters and matches :299-397):
  read -> atlas nearest-resize to volume shape -> shape-mismatch trim ->
  pad to crop+5 -> truncate (CT window / MRI z-score by case id) ->
  random crop (train) -> layout to (D, H, W).
"""

from __future__ import annotations

import glob
import os
import random
import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from multimodal_pl_tpu_torch.data.atlas import resize_atlas_nearest
from multimodal_pl_tpu_torch.data.augment import intensity_augment
from multimodal_pl_tpu_torch.data.nifti import read_nifti
from multimodal_pl_tpu_torch.data.supervision import (
    label_t_of,
    load_supervision_csv,
    supervision_mask_for_case,
)


def split_files(files: Sequence[str], usage: str, seed: int = 1):
    """Seeded 70/10/20 split (MOTSDataset.py:95-104)."""
    files = list(files)
    rng = random.Random(seed)
    rng.shuffle(files)
    n = len(files)
    if usage == "train":
        return files[: int(0.7 * n)]
    if usage == "valid":
        return files[int(0.7 * n) : int(0.8 * n)]
    return files[int(0.8 * n) :]


def case_id_of(path: str) -> int:
    """amos_0007_0000.nii.gz / amos_0007.nii.gz -> 7."""
    name = os.path.basename(path)
    digits = "".join(c for c in name.split("amos")[-1] if c.isdigit() or c == "_")
    first = [p for p in digits.split("_") if p]
    return int(first[0])


def truncate_intensity(vol: np.ndarray, case_id: int) -> np.ndarray:
    """CT: clip to ±325 HU and divide by 325; MRI: z-score (MOTSDataset.py:171-186)."""
    vol = vol.astype(np.float32)
    if int(case_id) < 500:
        vol = np.clip(vol, -325.0, 325.0) / 325.0
    else:
        # The reference divides by an unguarded std (MOTSDataset.py:171-186);
        # a constant-intensity volume (possible after an aggressive body crop
        # on a corrupt case) would yield NaNs that poison the step. Guard it.
        vol = (vol - vol.mean()) / max(float(vol.std()), 1e-6)
    return vol


def pad_to(vol: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Zero-pad trailing edges up to target (MOTSDataset.py:269-297)."""
    pads = [(0, max(0, int(np.ceil(t - s)))) for s, t in zip(vol.shape[-3:], target)]
    if vol.ndim == 4:
        pads = [(0, 0)] + pads
    return np.pad(vol, pads, "constant")


def id2trainId(label: np.ndarray, task_id: int) -> Optional[np.ndarray]:
    """MOTS 2-channel (organ, tumor) target map (MOTSDataset.py:188-217);
    channels are -1 where the task has no such structure."""
    if task_id in (0, 1, 3):
        organ, tumor = label >= 1, label == 2
    elif task_id == 2:
        organ, tumor = label == 1, label == 2
    elif task_id in (4, 5):
        organ, tumor = None, label == 1
    elif task_id == 6:
        organ, tumor = label == 1, None
    else:
        print("Error, No such task!")
        return None
    out = np.zeros((2, *label.shape), np.float32)
    out[0] = -1 if organ is None else np.where(organ, 1, 0)
    out[1] = -1 if tumor is None else np.where(tumor, 1, 0)
    return out


def locate_bbx(label: np.ndarray, crop_size, scaler: float, rng: np.random.Generator,
               margin: int = 32, p_fg: float = 0.8):
    """Foreground-biased crop box (MOTSDataset.py:219-267): with prob p_fg the
    crop is drawn around the label bounding box (expanded to at least the
    scaled crop size + margin), otherwise uniformly."""
    scale = [int(c * scaler) for c in crop_size]
    shape = label.shape
    idx = np.nonzero(label >= 1)
    lo = [int(a.min()) for a in idx] if idx[0].size else [0, 0, 0]
    hi = [int(a.max()) for a in idx] if idx[0].size else list(shape)
    for d in range(3):
        if hi[d] - lo[d] <= scale[d]:
            half = (scale[d] - (hi[d] - lo[d])) // 2
            lo[d] -= half
            hi[d] += half
        lo[d] = max(lo[d] - margin, 0)
        hi[d] = min(hi[d] + margin, shape[d])
    starts = []
    for d in range(3):
        if rng.random() < p_fg:
            a, b = lo[d], max(hi[d] - scale[d], lo[d] + 1)
        else:
            a, b = 0, max(shape[d] - scale[d], 1)
        starts.append(int(rng.integers(a, b)))
    return [(s, s + sc) for s, sc in zip(starts, scale)]


@dataclass
class Sample:
    image: np.ndarray       # (D, H, W, 1) float32
    label: np.ndarray       # (D, H, W) int32
    catlas: np.ndarray      # (num_fg, D, H, W) float32
    name: str
    case_id: int
    sup_mask: np.ndarray    # (num_classes,)
    label_t: np.ndarray     # (num_fg,)


class AMOSDataset:
    """File-list dataset over preprocessed AMOS NIfTI volumes.

    root contains image volumes (``amos_XXXX_0000.nii.gz``); labels are found
    by the images->labels / _0000 substitution of the reference
    (MOTSDataset.py:304).
    """

    def __init__(
        self,
        root: str,
        crop_size=(64, 192, 192),          # (crop_d, crop_h, crop_w), reference order
        usage: str = "train",
        atlas: Optional[np.ndarray] = None,
        atlas_path: Optional[str] = None,
        supervision: Optional[Dict[str, np.ndarray]] = None,
        supervision_csv: Optional[str] = None,
        use_ct_mri=(True, True),
        split_seed: int = 1,
        seed: int = 0,
        mirror: bool = False,
        scale: bool = False,
        cache: bool = False,
    ):
        # Note: the reference dataset accepts scale/mirror flags but its final
        # __getitem__ never applies them (MOTSDataset.py:299-397) — the run
        # that produced the baseline log used intensity augs only. Enabling
        # them here adds random axis flips / 0.9-1.1 zoom to training crops.
        self.root = root
        self.crop_d, self.crop_h, self.crop_w = crop_size
        self.usage = usage
        self.mirror = mirror
        self.scale = scale
        self.rng = np.random.default_rng(seed)

        allfiles = sorted(glob.glob(os.path.join(root, "*.nii.gz"))) + sorted(
            glob.glob(os.path.join(root, "*.nii"))
        )
        allfiles = [f for f in allfiles if "amos" in os.path.basename(f)]
        files = split_files(allfiles, usage, split_seed)
        # CT/MRI filter by id threshold 410 (MOTSDataset.py:107-118)
        if not use_ct_mri[0]:
            files = [f for f in files if case_id_of(f) >= 410]
        if not use_ct_mri[1]:
            files = [f for f in files if case_id_of(f) < 410]
        self.files = files

        if atlas is None and atlas_path:
            atlas = np.load(atlas_path)
        self.atlas = atlas

        if supervision is None and supervision_csv:
            supervision = load_supervision_csv(supervision_csv)
        self.supervision = supervision
        # cache=True memoizes the crop-invariant prepared volumes (NIfTI read,
        # atlas resize, trim/pad, intensity truncate) — the reference re-reads
        # and re-resizes every sample (MOTSDataset.py:303-372, an I/O hot spot
        # per SURVEY §3.3); random crops/augs still re-sample per access
        self.cache = cache
        self._cache: Dict[int, tuple] = {}

    def __len__(self):
        return len(self.files)

    def _label_path(self, image_path: str) -> str:
        return image_path.replace("images", "labels").replace("_0000", "")

    def _sup_mask(self, case_id: int) -> np.ndarray:
        if self.supervision is not None:
            key = f"amos_{case_id:04d}"
            if key in self.supervision:
                return self.supervision[key]
        return supervision_mask_for_case(case_id)

    def supervision_rows(self):
        """Yield (sup_mask, label_t) for every case — the supervision
        metadata interface REQUIRED of every train dataset: train_loop's
        refine-capacity guard (train/loop.py) validates the static
        refine_grad_organs gather size against it, and refuses datasets
        that don't expose it (a wrapped source silently skipping the guard
        is exactly the failure the guard exists to prevent)."""
        for f in self.files:
            cid = case_id_of(f)
            yield self._sup_mask(cid), label_t_of(cid)

    def _prepared(self, index: int):
        """Crop-invariant per-case volumes: read, atlas-resize, trim, pad,
        truncate (memoized when cache=True)."""
        if self.cache and index in self._cache:
            return self._cache[index]
        path = self.files[index]
        cid = case_id_of(path)
        image = read_nifti(path).data.astype(np.float32)
        label = read_nifti(self._label_path(path)).data.astype(np.int32)

        num_fg = self.atlas.shape[0] if self.atlas is not None else 13
        catlas = (
            resize_atlas_nearest(self.atlas, image.shape)
            if self.atlas is not None
            else np.zeros((num_fg, *image.shape), np.float32)
        )

        if image.shape != label.shape:  # shape-mismatch trim (:359-367)
            fs = [min(a, b) for a, b in zip(image.shape, label.shape)]
            image = image[: fs[0], : fs[1], : fs[2]]
            label = label[: fs[0], : fs[1], : fs[2]]
            catlas = catlas[:, : fs[0], : fs[1], : fs[2]]

        target = [self.crop_h + 5, self.crop_w + 5, self.crop_d + 5]
        image = pad_to(image, target)
        label = pad_to(label, target)
        catlas = pad_to(catlas, target)

        image = truncate_intensity(image, cid)
        out = (cid, image, label, catlas)
        if self.cache:
            self._cache[index] = out
        return out

    def __getitem__(self, index: int) -> Sample:
        cid, image, label, catlas = self._prepared(index)

        if self.usage == "train":
            b = int(self.rng.integers(0, label.shape[0] - self.crop_h))
            c = int(self.rng.integers(0, label.shape[1] - self.crop_w))
            a = int(self.rng.integers(0, label.shape[2] - self.crop_d))
            image = image[b : b + self.crop_h, c : c + self.crop_w, a : a + self.crop_d]
            label = label[b : b + self.crop_h, c : c + self.crop_w, a : a + self.crop_d]
            catlas = catlas[:, b : b + self.crop_h, c : c + self.crop_w, a : a + self.crop_d]
            if self.mirror:
                for ax in range(3):
                    if self.rng.random() < 0.5:
                        image = np.flip(image, ax)
                        label = np.flip(label, ax)
                        catlas = np.flip(catlas, ax + 1)
            if self.scale and self.rng.random() < 0.3:
                from scipy.ndimage import zoom as nd_zoom

                z = float(self.rng.uniform(0.9, 1.1))
                shp = image.shape
                image = nd_zoom(image, z, order=1)
                label = nd_zoom(label, z, order=0)
                catlas = nd_zoom(catlas, (1, z, z, z), order=0)
                image = pad_to(image, shp)[: shp[0], : shp[1], : shp[2]]
                label = pad_to(label, shp)[: shp[0], : shp[1], : shp[2]]
                catlas = pad_to(catlas, shp)[:, : shp[0], : shp[1], : shp[2]]

        # (H, W, D) -> channels-last (D, H, W)
        image = np.ascontiguousarray(image.transpose(2, 0, 1))[..., None]
        label = np.ascontiguousarray(label.transpose(2, 0, 1))
        catlas = np.ascontiguousarray(catlas.transpose(0, 3, 1, 2))

        return Sample(
            image=image.astype(np.float32),
            label=label.astype(np.int32),
            catlas=catlas.astype(np.float32),
            name=f"{cid:04d}",
            case_id=cid,
            sup_mask=self._sup_mask(cid),
            label_t=label_t_of(cid),
        )

    # ------------------------------------------------------------------ #

    def batches(self, batch_size: int, shuffle: bool = True, augment: bool = True,
                epochs: int = 1, prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Background-thread prefetching batch iterator (the Engine's
        DataLoader role, engine.py:34-55, collate my_collate MOTSDataset.py:54-67).

        Batches are dicts of stacked arrays; an un-augmented copy is kept as
        ``image_r`` like the reference collate.
        """
        q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        stop = object()

        def worker():
            for _ in range(epochs):
                order = np.arange(len(self))
                if shuffle:
                    self.rng.shuffle(order)
                for i in range(0, len(order) - batch_size + 1, batch_size):
                    idxs = order[i : i + batch_size]
                    samples = [self[int(j)] for j in idxs]
                    image = np.stack([s.image for s in samples])
                    batch = {
                        "image": image,
                        "image_r": image.copy(),
                        "label": np.stack([s.label for s in samples]),
                        "catlas": samples[0].catlas,           # sample-0 semantics (train:246-248)
                        "sup_mask": samples[0].sup_mask,
                        "label_t": samples[0].label_t,
                        "name": [s.name for s in samples],
                        "case_id": np.array([s.case_id for s in samples]),
                    }
                    if augment:
                        batch["image"] = intensity_augment(batch["image"], self.rng)
                    q.put(batch)
            q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                return
            yield item
