"""YAML config loading for the offline preprocessing stage, a copy of
``multimodal_pl_tpu/data/config.py``.

Reference: preprocess/forward_crop.py:17-35 get_config + the
preprocess/config/*.yaml schema (preprocessing_amos.yaml: margin, key,
orientation, resize_shape; amos.yaml: label map + small/mid/large organ
grouping). The augmentation block maps onto data.transforms.AugmentConfig.

PyYAML is imported by :func:`get_config` alone, when it reads a file:
importing this module needs no ``yaml``.
"""

from __future__ import annotations

import os
from dataclasses import fields
from typing import Any, Dict

from multimodal_pl_tpu_torch.data.transforms import AugmentConfig

# AMOS label map (reference preprocess/config/amos.yaml:5-19)
AMOS_LABELS: Dict[int, str] = {
    0: "background", 1: "spleen", 2: "right kidney", 3: "left kidney",
    4: "gall bladder", 5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta",
    9: "postcava", 10: "pancreas", 11: "right adrenal gland",
    12: "left adrenal gland", 13: "duodenum",
}

DEFAULT_PREPROCESSING: Dict[str, Any] = {
    "dataset": "amos",
    "margin": [5, 5, 5],
    "key": "label",
    "orientation": "RAS",
    "resize_shape": [256, 256, 128],
    "target_spacing": [1, 1, 2],
}


def get_config(name_or_path: str, config_dir: str = "config") -> Dict[str, Any]:
    """Load ``<config_dir>/<name>.yaml`` (or a direct path); falls back to the
    built-in AMOS preprocessing defaults when the file doesn't exist.
    Reading a file needs PyYAML."""
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(config_dir, f"{name_or_path}.yaml")
    if not os.path.exists(path):
        if "preprocessing" in name_or_path or name_or_path == "amos":
            return dict(DEFAULT_PREPROCESSING)
        raise FileNotFoundError(f"no config '{name_or_path}' (looked at {path})")
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the config {path} needs the 'yaml' package (PyYAML), "
                          "which is not installed") from e
    with open(path) as f:
        return yaml.safe_load(f)


def augment_config_from_yaml(cfg: Dict[str, Any]) -> AugmentConfig:
    """Build an AugmentConfig from a reference-style ``augmentation:`` block."""
    aug = cfg.get("augmentation", cfg)
    kwargs = {}
    names = {f.name for f in fields(AugmentConfig)}
    rename = {
        "translate_precentage": "translate_percentage",  # reference yaml typo
        "flip_axis": "flip_axes",
    }
    for k, v in aug.items():
        k = rename.get(k, k)
        if k in names:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return AugmentConfig(**kwargs)
