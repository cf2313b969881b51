"""The port's boundary and entry point: importing every port module (the
data-parallel and the asset ones among them), and parsing the CLIs'
arguments (mpl-evaluate's --pallas_k2, --fused_gn, --bd and --mesh among
them; mpl-preprocess-torch's and mpl-atlas-torch's; the step ladder's,
``tools/step_ablate.py``), loads
no JAX and no module of the JAX package;
mpl-evaluate-torch accepts every flag of mpl-evaluate with mpl-train-torch's
semantics, and runs end to end on a synthetic AMOS-layout set on the CPU.
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
evaluate.get_arguments().parse_args(["--pallas_k2", "false", "--fused_gn", "false", "--bd",
                                     "true", "--mesh", "data:2"])
train.get_arguments().parse_args([])
from multimodal_pl_tpu_torch.cli import atlas, preprocess
preprocess.get_arguments().parse_args(["--images_dir", "raw/imagesTr", "--out_images", "i",
                                       "--out_labels", "l"])
atlas.get_arguments().parse_args(["--labels_dir", "l"])
from multimodal_pl_tpu_torch.tools import step_ablate
step_ablate.get_arguments().parse_args(["--steps", "3", "--patch", "64,96,96", "--batch", "3",
                                        "--route", "plain", "--rungs", "full,segonly"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
ref = sorted(m for m in sys.modules if m.split(".")[0] == "multimodal_pl_tpu")
print(json.dumps({"names": names, "bad": bad, "ref": ref}))
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
    assert len(got["names"]) >= 15, got  # every module of the package was imported
    assert {"multimodal_pl_tpu_torch.data.device_cache",
            "multimodal_pl_tpu_torch.utils.flops", "multimodal_pl_tpu_torch.engine",
            "multimodal_pl_tpu_torch.parallel.mesh",
            "multimodal_pl_tpu_torch.parallel.sharded_step",
            "multimodal_pl_tpu_torch.parallel.sharded_infer",
            "multimodal_pl_tpu_torch.parallel.spatial",
            "multimodal_pl_tpu_torch.tools.spatial_fault",
            "multimodal_pl_tpu_torch.tools.halo_p2p",
            "multimodal_pl_tpu_torch.tools.spawn",
            "multimodal_pl_tpu_torch.tools.campaign",
            "multimodal_pl_tpu_torch.tools.campaign_eval",
            "multimodal_pl_tpu_torch.tools.route_probe",
            "multimodal_pl_tpu_torch.tools.step_ablate",
            "multimodal_pl_tpu_torch.data.preprocess", "multimodal_pl_tpu_torch.data.lists",
            "multimodal_pl_tpu_torch.data.atlas", "multimodal_pl_tpu_torch.cli.preprocess",
            "multimodal_pl_tpu_torch.cli.atlas"} <= set(got["names"]), got
    assert got["bad"] == [], f"JAX modules loaded: {got['bad']}"
    assert got["ref"] == [], f"JAX-package modules loaded: {got['ref']}"


def test_evaluate_cli_accepts_every_jax_flag():
    from multimodal_pl_tpu.cli.evaluate import get_arguments as jax_arguments

    def opts(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert opts(jax_arguments()) <= opts(evaluate.get_arguments())
    args = evaluate.get_arguments().parse_args([])
    assert args.pallas_k2 and args.fused_gn and args.bd and args.mesh == ""


@pytest.mark.parametrize("flags,conv_impl,gn_impl", [
    ([], "kernel", "kernel"),
    (["--pallas_k2", "false"], "plain", "kernel"),
    (["--fused_gn", "false"], "kernel", "plain"),
    (["--pallas_k2", "false", "--fused_gn", "false", "--bd", "false"], "plain", "plain"),
    (["--bd", "true"], "kernel", "kernel"),
])
def test_evaluate_kernel_flags_choose_the_route(flags, conv_impl, gn_impl):
    """--pallas_k2 false builds the members with conv_impl='plain' (convs and
    upsamples), --fused_gn false with gn_impl='plain'; --bd changes nothing."""
    args = evaluate.get_arguments().parse_args(
        flags + ["--reload_from_checkpoint", "false", "--device", "cpu"])
    (member,) = evaluate._load_members(args, torch.device("cpu"))
    block = member.layer1[0]
    assert (member.conv_impl, block.conv_impl, block.gn_impl) == (conv_impl, conv_impl, gn_impl)


def test_evaluate_mesh_raises():
    """--mesh data:2 without a group of 2 ranks raises naming the world size,
    and so does data:2,space:2 (4 ranks); --mesh data:N with --tta raises
    (the JAX CLI drops --tta under a data mesh)."""
    with pytest.raises(ValueError, match="world size is 1"):
        evaluate.main(["--mesh", "data:2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 4 devices, have 1: the world size is 1"):
        evaluate.main(["--mesh", "data:2,space:2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--tta"):
        evaluate.main(["--mesh", "data:1", "--tta", "true", "--device", "cpu"])


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
