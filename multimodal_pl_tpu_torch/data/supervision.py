"""Supervision-mask semantics for partial labeling: the part of
``multimodal_pl_tpu/data/supervision.py`` that the dataset and the fixture
generators use (the masks, the csv reader and writer), copied.

The reference's mask plumbing is internally inconsistent (generator emits a
15-slot organ-only row, the trainer indexes it as label-indexed with
[0]=background, csv keys/headers don't match the lookups — SURVEY.md §2.2).
This module fixes the convention by spec:

  * A supervision mask is a ``num_classes``(=14)-vector indexed by LABEL,
    mask[0] == 0 (background NEVER directly supervised), mask[l] == 1 iff
    organ label l is annotated for that case.

    mask[0] == 0 is load-bearing, verified against the reference driver:
    train:312 passes the raw csv row (whose slot 0 is 0 in every row of the
    snapshot's supervise_mask.csv) into get_loss as the per-class weight
    vector, so the background channel gets NO dice and NO BCE term
    (loss_partial.py:52, :90-92). Each organ channel is therefore trained
    only in cases where that organ is annotated (to 1 inside / 0 outside)
    and background emerges purely as the softmax residual — there is no
    contradictory "be background" pressure on unsupervised organs. Weighting
    the background channel instead (an earlier build convention) creates an
    all-background equilibrium that partial-label training cannot escape.
  * CSV rows are ``case_id,bitstring`` keyed by the bare case id
    (e.g. ``amos_0001``), no header ambiguity: a header row is written and
    skipped on read.

Case-id semantics follow the reference throughout: id < 500 ⇒ CT,
id >= 500 ⇒ MRI (MOTSDataset.py:171-186, train:223-226); the per-case
single supervised organ for CT follows the id-range table of
preprocess/atlas_gen_mm.py:33-54 mapped into label space.
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np

NUM_CLASSES = 14

# modality-style flags per organ index 0..12 (labels 1..13), train:223-226
LABEL_T_MRI = np.array([1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0], np.float32)
LABEL_T_CT = np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)

# CT case-id upper bound -> supervised organ label (atlas_gen_mm.py:33-54,
# re-based into 1..13 label space: the generator's slots 4..14 minus the
# off-by-one means labels 3..13; clamp to the 13 AMOS organs)
_CT_RANGES = [
    (45, 3), (85, 4), (135, 5), (180, 6), (242, 7), (300, 8),
    (370, 9), (440, 10), (460, 11), (480, 12), (500, 13),
]


def label_t_of(case_id: int) -> np.ndarray:
    return LABEL_T_MRI.copy() if int(case_id) >= 500 else LABEL_T_CT.copy()


def supervision_mask_for_case(case_id: int) -> np.ndarray:
    """(14,) 0/1 mask; CT cases get exactly one supervised organ by id range,
    MRI cases get none (all-zero row, like the reference csv's MRI rows)."""
    mask = np.zeros(NUM_CLASSES, np.float32)
    cid = int(case_id)
    if cid >= 500:
        return mask
    for hi, label in _CT_RANGES:
        if cid <= hi:
            mask[label] = 1.0
            break
    return mask


def generate_supervision_csv(case_ids, out_path: str,
                             organ_overrides: Dict[int, int] | None = None) -> None:
    """supervise_mask.csv writer (atlas_gen_mm.py:59-71, fixed key format):
    a header, then ``amos_XXXX,bitstring`` rows.

    organ_overrides: optional {case_id: organ_label} replacing the id-range
    assignment for those CT cases, so that a fixture can supervise every
    organ in >= 1 train case (the id-range table never supervises labels
    1-2). MRI cases (id >= 500) stay all-zero regardless."""
    overrides = organ_overrides or {}
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "mask"])
        for cid in case_ids:
            cid = int(cid)
            if cid in overrides and cid < 500:
                mask = np.zeros(NUM_CLASSES, np.float32)
                mask[int(overrides[cid])] = 1.0
            else:
                mask = supervision_mask_for_case(cid)
            w.writerow([f"amos_{cid:04d}", "".join(str(int(b)) for b in mask)])


def load_supervision_csv(path: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with open(path, newline="") as f:
        for i, row in enumerate(csv.reader(f)):
            if i == 0 and row and row[0] == "name":
                continue
            name, bits = row[0], row[1]
            out[name] = np.array([float(b) for b in bits], np.float32)
    return out
