"""``tools/route_probe.py``'s arithmetic on the CPU, at tiny widths
(``tiny_step_config``, 32^3 patches, B = 1).

On the CPU the kernel route runs the plain versions, so the probes are
checked against planted routes: a copy of the plain bf16 route whose
refiner adds +0.5% of its rms to the GroupNorm -> ReLU output that feeds
``precls_conv``'s 1x1 conv (a bias), and one that adds zero-mean noise of
the same rms there (no bias). The rest-pass probe must flag the first
(|z| > 3) and not the second; the per-leaf projection must flag the conv
downstream of the plant and no leaf of the noisy route.
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from multimodal_pl_tpu_torch.tools import campaign
from multimodal_pl_tpu_torch.tools import route_probe as R
from multimodal_pl_tpu_torch.train.loop import to_device
from multimodal_pl_tpu_torch.train.state import create_train_state, tiny_step_config

PLANT = 0.005  # of the rms of the planted tensor


def _batch(seed, cfg):
    rng = np.random.default_rng(seed)
    nc, patch = cfg.num_classes, (32, 32, 32)
    sup = np.zeros(nc, np.float32)
    sup[5] = 1
    host = {"image": rng.standard_normal((1, *patch, 1)).astype(np.float32),
            "label": rng.integers(0, nc, (1, *patch)).astype(np.uint8),
            "catlas": rng.random((nc - 1, *patch)).astype(np.float32), "sup_mask": sup,
            "label_t": np.array([0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 1, 1, 1], np.float32)}
    return to_device(host, cfg, "cpu")


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    cfgs = R.route_configs(tiny_step_config(num_epochs=100))
    state = create_train_state(torch.Generator().manual_seed(0), cfgs["f32"])
    state = state.replace(epoch=torch.tensor(60))
    steps = R.make_steps(cfgs, "cpu")
    steps["planted"] = R.make_steps({"p": cfgs["plain"]}, "cpu")["p"]
    steps["noisy"] = R.make_steps({"n": cfgs["plain"]}, "cpu")["n"]
    noise = torch.Generator().manual_seed(3)

    def rms(x):
        return x.float().square().mean().sqrt()

    steps["planted"].refiner.precls_conv[2].register_forward_pre_hook(
        lambda m, a: (a[0] + (PLANT * rms(a[0])).to(a[0].dtype),))
    steps["noisy"].refiner.precls_conv[2].register_forward_pre_hook(
        lambda m, a: (a[0] + (PLANT * rms(a[0]) * torch.randn(
            a[0].shape, generator=noise)).to(a[0].dtype),))
    del steps["kernel"]
    batches = [_batch(i, cfgs["plain"]) for i in range(4)]
    _, wf = R.schedule(state, cfgs["plain"])
    return steps, state, batches, wf


def test_shift_and_bias_arithmetic():
    s = R.shift([1.0, 2.0, 3.0])
    assert s["mean"] == 2.0 and s["sd"] == 1.0 and s["n"] == 3
    assert s["z"] == pytest.approx(2.0 * np.sqrt(3))
    assert R.shift([0.0, 0.0])["z"] == 0.0 and R.shift([1.0, 1.0])["z"] == np.inf
    table = R.BiasTable()
    f32 = torch.tensor([1.0, -1.0, 2.0, -2.0])
    table.add(("k", (4,), "y"), f32 + 0.1, f32 + torch.tensor([0.1, -0.1, 0.1, -0.1]), f32)
    table.add(("k", (4,), "y"), f32 + 0.1, f32, f32)
    (row,) = table.rows()
    rms = np.sqrt(2.5)
    assert row["calls"] == 2 and row["n"] == 8
    assert row["bias_kernel"] == pytest.approx(0.1 / rms)
    assert row["bias_plain"] == pytest.approx(0.0, abs=1e-12)
    assert row["err_kernel"] == pytest.approx(0.1 / rms)
    assert row["err_plain"] == pytest.approx(np.sqrt(0.04 / 8) / rms)


def test_route_configs_and_campaign_config(tmp_path):
    cfg, seed = R.campaign_config(str(tmp_path), 2500, ["--seed", "1"])
    assert seed == 1 and cfg.num_epochs == 2500 and cfg.compute_dtype == torch.bfloat16
    assert (cfg.conv_impl, cfg.gn_impl, cfg.base, cfg.pretrain_epoch) == ("kernel", "kernel",
                                                                          32, 20)
    cfgs = R.route_configs(cfg)
    assert [(c.conv_impl, c.gn_impl, c.compute_dtype) for c in cfgs.values()] == [
        ("kernel", "kernel", torch.bfloat16), ("plain", "plain", torch.bfloat16),
        ("plain", "plain", torch.float32)]
    assert all(dataclasses.replace(c, conv_impl="kernel", gn_impl="kernel",
                                   compute_dtype=torch.bfloat16) == cfgs["kernel"]
               for c in cfgs.values())


def test_rest_probe_flags_a_planted_shift(setup):
    steps, state, batches, wf = setup
    inputs = [R.rest_inputs(steps["plain"], state, b, wf) for b in batches]
    assert all(len(rows) == 11 for _, _, rows in inputs)  # 13 organs, K = 2 gradient rows
    got = R.rest(steps, state, inputs)
    assert set(got) == {"plain-f32", "planted-f32", "noisy-f32", "planted-plain",
                        "noisy-plain"}
    planted, noisy = got["planted-plain"]["all"], got["noisy-plain"]["all"]
    assert abs(planted["prob"]["z"]) > R.Z_FLAG and planted["prob"]["n"] == 44
    assert abs(noisy["prob"]["z"]) < R.Z_FLAG
    assert len(R.biased_organs(got["planted-plain"])) >= 6
    assert noisy["dice"] > 0.99 and planted["dice"] > 0.99


def test_leaf_projection_flags_the_leaf_downstream_of_the_plant(setup):
    steps, state, batches, wf = setup
    got = R.leaves(steps, state, batches, wf)
    assert len(got["checks"]) == 4 * len(batches)  # planted and noisy, per batch, both ways
    flagged = R.flagged_leaves(got["excess"], "planted")
    assert "rparams.precls_conv.2.weight" in flagged
    assert all(k.startswith("rparams.precls_conv") for k in flagged), flagged
    assert R.flagged_leaves(got["excess"], "noisy") == []
    conv = got["excess"]["planted"]["rparams.precls_conv.2.weight"]
    assert conv["z"] > R.Z_FLAG and conv["proj"] > 0


def test_campaign_run_stops_at_until(tmp_path):
    """The probes' states come from ``tools/campaign.py run --until``: the
    chunks of the whole schedule, cut at that epoch."""
    img = tmp_path / "imagesTr"
    img.mkdir()
    for cid in campaign.CAMPAIGN_CT_IDS + list(range(500, 506)):
        (img / f"amos_{cid:04d}_0000.nii.gz").touch()
    argvs = []

    def train_main(argv):
        argvs.append(argv)
        stop = int(argv[argv.index("--stop_epoch") + 1])
        snap = argv[argv.index("--snapshot_dir") + 1]
        os.makedirs(snap, exist_ok=True)
        open(os.path.join(snap, f"ckpt_{stop * 6}.pt"), "w").close()
        return types.SimpleNamespace(step=stop * 6)

    records = campaign.run_chunks(str(tmp_path), 2500, 800, train_main=train_main, until=1200)
    assert [(r["start"], r["stop"]) for r in records] == [(0, 800), (800, 1200)]
    assert all(a[a.index("--num_epochs") + 1] == "2500" for a in argvs)
