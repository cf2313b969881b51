"""Multi-source CT dataset variant, a copy of
``multimodal_pl_tpu/data/multisource.py`` on the port's ``AMOSDataset``
(reference AMOSDataSet_newatlas_onlyct, MOTSDataset.py:399-815).

Extends the AMOS pipeline with per-source file filters — ``amos_ct`` /
``amos_mri`` (case-id threshold 410), ``chaos`` ("CHAOS" in name), ``msd``
("img" in name) — and an ``only_data`` organ filter that keeps only cases
whose supervision mask includes the requested organ. Per-source label
remapping hooks stand in for the reference's missing convert_seg_chao /
convert_seg_msd helpers (referenced but undefined there — a latent
NameError; SURVEY.md §2 #13): CHAOS liver label (1) -> AMOS liver (5 in our
label space), MSD identity by default.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from multimodal_pl_tpu_torch.data.atlas import atlas_cores_weighted
from multimodal_pl_tpu_torch.data.dataset import AMOSDataset, case_id_of
from multimodal_pl_tpu_torch.data.supervision import supervision_mask_for_case


def source_of(path: str) -> str:
    name = os.path.basename(path)
    if "amos" in name:
        return "amos_mri" if case_id_of(path) >= 410 else "amos_ct"
    if "CHAOS" in name:
        return "chaos"
    if "img" in name:
        return "msd"
    return "unknown"


def convert_seg_chaos(label: np.ndarray) -> np.ndarray:
    """CHAOS CT labels: 1=liver -> our label 5."""
    out = np.zeros_like(label)
    out[label == 1] = 5
    return out


def convert_seg_msd(label: np.ndarray) -> np.ndarray:
    """MSD task labels pass through (organ+tumor collapsed to organ)."""
    return np.where(label > 0, label, 0)


DEFAULT_CONVERTERS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "chaos": convert_seg_chaos,
    "msd": convert_seg_msd,
}


class MultiSourceDataset(AMOSDataset):
    def __init__(self, root: str, usedataset: Sequence[str] = ("amos_ct",),
                 only_data: int = -1,
                 converters: Optional[Dict[str, Callable]] = None, **kwargs):
        super().__init__(root, **kwargs)
        # probability-weighted per-organ atlas cores (MOTSDataset.py:504-519)
        # — the multi-source variant's core definition (vs the unweighted
        # support mean of the base dataset, :126-141)
        self.cores = (atlas_cores_weighted(self.atlas)
                      if self.atlas is not None else None)
        self.converters = dict(DEFAULT_CONVERTERS)
        if converters:
            self.converters.update(converters)
        # per-source filters (MOTSDataset.py:447-488)
        self.files = [f for f in self.files if source_of(f) in usedataset]
        # only_data organ filter (:533-539): keep cases supervising that organ
        if only_data != -1:
            self.files = [
                f for f in self.files
                if source_of(f).startswith("amos")
                and supervision_mask_for_case(case_id_of(f))[only_data] == 1
            ]

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        src = source_of(self.files[index])
        conv = self.converters.get(src)
        if conv is not None:
            sample.label[...] = conv(sample.label)
        return sample
