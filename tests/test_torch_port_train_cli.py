"""mpl-train-torch end to end on the CPU: two short epochs at the tiny
geometry on synthetic AMOS-layout cases write the JSONL log and a
checkpoint, and a second run resumes from it, on the host batch path and on
the device batch path (``--device_data``) with ``--remat``; mpl-evaluate-torch
loads the checkpoint a full-width run writes, named or as the latest. The
device flags of both CLIs raise where CUDA is missing, and ``--mesh`` raises
where the world does not match it or names the unported space axis."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from multimodal_pl_tpu.data.synthetic import make_synthetic_amos
from multimodal_pl_tpu_torch.cli import evaluate, train
from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint

torch.set_num_threads(2)

TINY = ["--input_size", "32,32,32", "--model_base", "16", "--model_layers", "1,1,1,1,1",
        "--refiner_filter", "8", "--disc_ndf", "16", "--disc_depth", "5", "--bf16", "false",
        "--log_every", "1", "--random_scale", "false"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("amos"))
    img_dir, atlas_path, csv_path = make_synthetic_amos(root, n_ct=3, n_mri=1, shape=(40, 40, 36),
                                                        seed=2, spread_ids=False)
    return ["--data_dir", img_dir, "--atlas_path", atlas_path, "--supervision_csv", csv_path]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Cases of two shapes: ids 1-3 and 500 at 40 x 40 x 36, ids 4-6 at
    44 x 40 x 36 (the seeded split puts both shapes in the train split)."""
    root = str(tmp_path_factory.mktemp("amos_mixed"))
    img_dir, atlas_path, csv_path = make_synthetic_amos(root, n_ct=3, n_mri=1, shape=(40, 40, 36),
                                                        seed=2, spread_ids=False)
    other = str(tmp_path_factory.mktemp("amos_other"))
    make_synthetic_amos(other, n_ct=6, n_mri=0, shape=(44, 40, 36), seed=3, spread_ids=False)
    for sub, name in (("imagesTr", "amos_{:04d}_0000.nii.gz"), ("labelsTr", "amos_{:04d}.nii.gz")):
        for cid in (4, 5, 6):
            shutil.copy(os.path.join(other, sub, name.format(cid)), os.path.join(root, sub))
    return ["--data_dir", img_dir, "--atlas_path", atlas_path, "--supervision_csv", csv_path]


def _records(snap):
    with open(os.path.join(snap, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_two_epochs_and_resumes(data, tmp_path):
    snap = str(tmp_path / "snap")
    args = data + TINY + ["--snapshot_dir", snap, "--device", "cpu", "--device_data", "false"]
    state = train.main(args + ["--num_epochs", "2"])
    path = latest_checkpoint(snap)
    assert path is not None and int(state.step) >= 2
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "epoch/epoch_loss" in r] == [0, 1]
    assert all(r["loss"] > 0 and r["grads_finite"] == 1.0 for r in recs if "loss" in r)
    saved = restore_checkpoint(path)
    assert int(saved.step) == int(state.step)
    assert all(torch.equal(saved.tokens[k], state.tokens[k]) for k in state.tokens)

    resumed = train.main(args + ["--num_epochs", "3", "--start_epoch", "2",
                                 "--reload_from_checkpoint", "true"])
    assert int(resumed.step) == int(state.step) * 3 // 2  # one more epoch from the checkpoint
    assert latest_checkpoint(snap) != path


def test_train_cli_device_data_and_remat_run_and_resume(data, tmp_path, capsys):
    """--device_data true --remat true: two epochs on device batches, a
    checkpoint, one resumed epoch; as many steps as the host path, patches/s
    in each epoch record."""
    snap = str(tmp_path / "snap")
    args = data + TINY + ["--snapshot_dir", snap, "--device", "cpu", "--device_data", "true",
                          "--remat", "true"]
    state = train.main(args + ["--num_epochs", "2"])
    assert "device data pipeline: 2 cases resident on cpu" in capsys.readouterr().out
    assert int(state.step) == 4  # 2 train cases, batch 1
    recs = _records(snap)
    assert all(r["loss"] > 0 and r["grads_finite"] == 1.0 for r in recs if "loss" in r)
    assert [r["epoch/patches_per_sec"] > 0 for r in recs if "epoch/epoch_loss" in r] == [True] * 2
    path = latest_checkpoint(snap)
    resumed = train.main(args + ["--num_epochs", "3", "--start_epoch", "2",
                                 "--reload_from_checkpoint", "true"])
    assert int(resumed.step) == 6 and latest_checkpoint(snap) != path


def test_train_cli_remat_trains_as_without(data, tmp_path, monkeypatch):
    """--remat true reaches the segmenter (its stages run checkpointed) and
    one epoch ends in the same state, bit for bit, as without it."""
    from multimodal_pl_tpu_torch.models import unet3d

    calls = []
    real = unet3d.checkpoint
    monkeypatch.setattr(unet3d, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    states = {}
    for remat in ("false", "true"):
        calls.clear()
        states[remat] = train.main(data + TINY + [
            "--snapshot_dir", str(tmp_path / remat), "--device", "cpu", "--num_epochs", "1",
            "--remat", remat])
        assert len(calls) == (18 if remat == "true" else 0)  # 9 stages x 2 steps
    for group in ("params", "rparams", "dparams", "tokens"):
        a, b = getattr(states["true"], group), getattr(states["false"], group)
        assert all(torch.equal(a[k], b[k]) for k in a), group


def test_train_cli_device_data_true_raises_on_mixed_shapes(mixed, tmp_path):
    with pytest.raises(ValueError, match="uniform case shapes"):
        train.main(mixed + TINY + ["--snapshot_dir", str(tmp_path), "--device", "cpu",
                                   "--device_data", "true"])


def test_train_cli_device_data_auto_falls_back_on_mixed_shapes(mixed, tmp_path, capsys):
    """auto on cases of two shapes: says why and trains on host batches."""
    state = train.main(mixed + TINY + ["--snapshot_dir", str(tmp_path), "--device", "cpu",
                                       "--num_epochs", "1"])
    out = capsys.readouterr().out
    assert "device data pipeline unavailable (device data pipeline needs uniform case shapes" in out
    assert "using host path" in out and int(state.step) == 4  # 4 train cases


def test_train_cli_device_data_auto_takes_the_pipeline(data, tmp_path, capsys, monkeypatch):
    """auto on cases of one shape: the batches come from the pipeline (the
    host iterator is never asked for one)."""
    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset

    def no_host_batches(*a, **k):
        raise AssertionError("host batches requested")

    monkeypatch.setattr(AMOSDataset, "batches", no_host_batches)
    state = train.main(data + TINY + ["--snapshot_dir", str(tmp_path), "--device", "cpu",
                                      "--num_epochs", "1"])
    assert "device data pipeline: 2 cases resident on cpu" in capsys.readouterr().out
    assert int(state.step) == 2


@pytest.mark.parametrize("flag", [["--mesh", "data:2"], ["--mesh", "data:2,space:2"]])
def test_train_cli_unported_options_raise(flag):
    """--mesh data:2 without a group of 2 ranks raises naming the world size
    (data parallelism runs under torchrun); the space axis is not ported."""
    if "space" in flag[1]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train.main(flag + ["--device", "cpu"])
    else:
        with pytest.raises(ValueError, match="world size is 1"):
            train.main(flag + ["--device", "cpu"])


def test_evaluate_cli_loads_what_train_cli_writes(data, tmp_path, monkeypatch, capsys):
    """One epoch of mpl-train-torch at the evaluator's model (the flagship's
    widths; a 32^3 patch, so a 5-conv discriminator) writes ckpt_<step>.pt; mpl-evaluate-torch loads its
    segmenter parameters exactly, by --reload_path and, with an empty
    --reload_path, as the latest checkpoint in the working directory, and
    runs end to end on it."""
    snap = str(tmp_path / "snap")
    state = train.main(data + ["--input_size", "32,32,32", "--bf16", "false", "--num_epochs",
                               "1", "--random_scale", "false", "--device_data", "false",
                               "--disc_depth", "5",
                               "--snapshot_dir", snap, "--device", "cpu"])
    path = latest_checkpoint(snap)
    assert path is not None and path.endswith(".pt")
    eval_args = data[:4] + ["--input_size", "32,32,32", "--bf16", "false", "--device", "cpu",
                            "--save_path", str(tmp_path / "out")]
    monkeypatch.chdir(snap)
    for reload_path in (path, ""):
        args = evaluate.get_arguments().parse_args(eval_args + ["--reload_path", reload_path])
        (member,) = evaluate._load_members(args, torch.device("cpu"))
        assert f"loading from checkpoint: {path if reload_path else './' + os.path.basename(path)}" \
            in capsys.readouterr().out
        got = member.state_dict()
        assert sorted(got) == sorted(state.params)
        assert all(torch.equal(got[k], state.params[k]) for k in got)
    csv_path = evaluate.main(eval_args + ["--reload_path", path])
    with open(csv_path) as f:
        assert len(f.read().strip().splitlines()) >= 2  # the header and the test cases


def test_train_cli_accepts_every_jax_flag():
    from multimodal_pl_tpu.cli.train import get_arguments as jax_arguments

    def opts(parser):
        return {o for a in parser._actions for o in a.option_strings}

    assert opts(jax_arguments()) <= opts(train.get_arguments())
    args = train.get_arguments().parse_args([])
    assert args.device == "cuda" and args.pallas_gn and args.pallas_k2


@pytest.mark.parametrize("cli", [train, evaluate])
def test_default_device_raises_without_cuda(cli, monkeypatch):
    """No quiet fallback to the CPU: the default --device cuda raises where
    no GPU is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data_dir", "/nonexistent"])


def test_validate_scores_the_valid_split(data):
    """train.loop.validate: the port's predictor over the valid split with
    the state's parameters, in the step's compute dtype; its dice sum and
    per-organ CT and MRI tables equal the JAX loop's validate from one state,
    at atol 1e-5: the tables are dice scores of argmax label maps, and the
    argmax of a random init's near-tied logits can differ between two f32
    forwards (measured 1.5e-6 on one organ, 0 on the others)."""
    import jax

    from multimodal_pl_tpu.data.dataset import AMOSDataset
    from multimodal_pl_tpu.train import loop as jloop
    from multimodal_pl_tpu.train import state as jstate
    from multimodal_pl_tpu_torch.convert import train_state_from_jax
    from multimodal_pl_tpu_torch.train.loop import LoopConfig, validate
    from multimodal_pl_tpu_torch.train.state import build_models, tiny_step_config

    jcfg = jstate.tiny_step_config()
    js = jstate.create_train_state(jax.random.PRNGKey(0), jcfg)
    ds = AMOSDataset(data[1], crop_size=(32, 32, 32), usage="valid")
    want = jloop.validate(js, jstate.build_models(jcfg)[0], ds,
                          jloop.LoopConfig(tile=(32, 32, 32)))
    cfg = tiny_step_config()
    got = validate(train_state_from_jax(js), build_models(cfg)[0], ds,
                   LoopConfig(tile=(32, 32, 32)), cfg, "cpu")
    sup_sum, ct, mri, n_ct, n_mri = got
    assert n_ct + n_mri == len(ds) == 1 and (n_ct, n_mri) == want[3:]
    assert ct.shape == mri.shape == (13,) and 0.0 <= sup_sum <= 13.0
    np.testing.assert_allclose(sup_sum, want[0], rtol=0, atol=1e-5)
    for g, w in zip((ct, mri), want[1:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
