"""The port's boundary and entry point: importing every port module, and
parsing both CLIs' arguments, loads no JAX and no module of the JAX package,
and mpl-evaluate-torch runs end to end on a synthetic AMOS-layout set on the
CPU.
"""

import csv
import json
import os
import subprocess
import sys

import pytest
import torch

from multimodal_pl_tpu.data.synthetic import make_synthetic_amos
from multimodal_pl_tpu_torch.cli import evaluate
from multimodal_pl_tpu_torch.convert import save_npz
from multimodal_pl_tpu_torch.models import UNet3DFEAM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import multimodal_pl_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from multimodal_pl_tpu_torch.cli import evaluate, train
evaluate.get_arguments().parse_args([])
train.get_arguments().parse_args([])
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
ref = sorted(m for m in sys.modules if m.split(".")[0] == "multimodal_pl_tpu")
print(json.dumps({"n": len(names), "bad": bad, "ref": ref}))
""" % (FORBIDDEN,)


def _python(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)


def test_port_imports_no_jax():
    bare = _python("import sys; print(sorted(m for m in sys.modules if m.split('.')[0] in %r))"
                   % (FORBIDDEN,))
    assert bare.returncode == 0, bare.stderr
    if bare.stdout.strip() != "[]":
        pytest.skip(f"this interpreter preloads JAX: {bare.stdout.strip()}")
    proc = _python(_IMPORT_ALL)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    assert got["n"] >= 15, got  # every module of the package was imported
    assert got["bad"] == [], f"JAX modules loaded: {got['bad']}"
    assert got["ref"] == [], f"JAX-package modules loaded: {got['ref']}"


def test_str2bool():
    assert evaluate.str2bool("True") and evaluate.str2bool("1")
    assert not evaluate.str2bool("false") and not evaluate.str2bool("n")


@pytest.mark.parametrize("atlas_rule", [False, True])
def test_evaluate_cli_on_synthetic_cases(tmp_path, atlas_rule):
    root = str(tmp_path / "data")
    img_dir, atlas_path, _ = make_synthetic_amos(root, n_ct=8, n_mri=2, shape=(40, 40, 24),
                                                 seed=3, spread_ids=False)
    ckpt = str(tmp_path / "weights.npz")
    save_npz(ckpt, UNet3DFEAM(generator=torch.Generator().manual_seed(5)).state_dict())
    out_dir = str(tmp_path / "out")
    csv_path = evaluate.main([
        "--data_dir", img_dir, "--reload_path", ckpt, "--save_path", out_dir,
        "--input_size", "16,32,32", "--atlas_path", atlas_path, "--window_batch", "4",
        "--bf16", "false", "--use_atlas_threshold", str(atlas_rule), "--device", "cpu"])
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["case"] + [f"organ{i}" for i in range(13)]
    assert len(rows) == 3  # the 2 cases of the test split
    for row in rows[1:]:
        assert all(0.0 <= float(v) <= 1.0 for v in row[1:])
