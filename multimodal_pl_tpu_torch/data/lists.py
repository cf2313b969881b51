"""Data-list bootstrap, a copy of ``multimodal_pl_tpu/data/lists.py``
(reference setup.py create_data_lists, recovered from bytecode — SURVEY.md
§2 #29): writes list/MOTS/{MOTS_train,MOTS_test}.txt from imagesTr/imagesTs
globs; ``setup_project`` adds the directories, the supervision csv and the
atlas through the port's own copies. Host work only: no device is used."""

from __future__ import annotations

import glob
import os


def create_data_lists(data_root: str, out_dir: str = "list/MOTS") -> tuple[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    train_files = sorted(glob.glob(os.path.join(data_root, "imagesTr", "*.nii.gz")))
    test_files = sorted(glob.glob(os.path.join(data_root, "imagesTs", "*.nii.gz")))
    train_txt = os.path.join(out_dir, "MOTS_train.txt")
    test_txt = os.path.join(out_dir, "MOTS_test.txt")
    with open(train_txt, "w") as f:
        f.writelines(p + "\n" for p in train_files)
    with open(test_txt, "w") as f:
        f.writelines(p + "\n" for p in test_files)
    return train_txt, test_txt


def setup_project(data_root: str, out_root: str = ".") -> None:
    """Reference setup.py:setup_project equivalent: directories + lists +
    supervision csv + atlas."""
    os.makedirs(os.path.join(out_root, "list", "MOTS"), exist_ok=True)
    os.makedirs(os.path.join(out_root, "snapshots", "amos_ours_tpu"), exist_ok=True)
    create_data_lists(data_root, os.path.join(out_root, "list", "MOTS"))

    from multimodal_pl_tpu_torch.data.atlas import generate_atlas
    from multimodal_pl_tpu_torch.data.dataset import case_id_of
    from multimodal_pl_tpu_torch.data.supervision import generate_supervision_csv

    labels_dir = os.path.join(data_root, "labelsTr")
    files = sorted(glob.glob(os.path.join(labels_dir, "*.nii.gz")))
    generate_supervision_csv([case_id_of(f) for f in files],
                             os.path.join(out_root, "supervise_mask.csv"))
    generate_atlas(labels_dir, os.path.join(out_root, "atlas_mm.npy"))
