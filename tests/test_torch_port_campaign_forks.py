"""Forks of one campaign state (``tools/campaign.py run --fork_from``) and
their paired test (``tools/campaign_seeds.py``): a tiny-width fork on the
CPU resumes from the copied checkpoint at its epoch and logs only its own
epochs; two forks at one seed draw the same batches on either route; the
Wilcoxon verdict at its boundaries; a fork's row read from its
``train.jsonl`` and ``campaign_eval best`` JSON, and the refusals."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch
from scipy.stats import rankdata, wilcoxon

from multimodal_pl_tpu_torch.tools import campaign
from multimodal_pl_tpu_torch.tools import campaign_seeds as S

TINY = ["--input_size", "32,32,32", "--bf16", "false", "--device", "cpu", "--model_base", "16",
        "--model_layers", "1,1,1,1,1", "--refiner_filter", "8", "--disc_ndf", "16",
        "--disc_depth", "5", "--log_every", "1"]
PLAIN = ["--pallas_k2", "false", "--pallas_gn", "false"]
BASE_EPOCH, BATCH = 3, 2


@pytest.fixture(scope="module")
def forks(tmp_path_factory):
    """A tiny fixture, a fresh tiny state saved as the epoch-3 checkpoint of
    a base run, and its forks on the kernel and the plain route at seed 5
    for one epoch, each step's batch digested."""
    from multimodal_pl_tpu_torch.cli.train import get_arguments, step_config
    from multimodal_pl_tpu_torch.train import loop
    from multimodal_pl_tpu_torch.train.checkpoint import save_checkpoint
    from multimodal_pl_tpu_torch.train.state import create_train_state
    from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

    root = str(tmp_path_factory.mktemp("campaign"))
    make_synthetic_amos(root, n_ct=6, n_mri=2, shape=(40, 40, 36))
    per_epoch = campaign.steps_per_epoch(root, BATCH)
    cfg = step_config(get_arguments().parse_args(TINY + ["--num_epochs", "20"]))
    state = create_train_state(torch.Generator().manual_seed(0), cfg)
    step = BASE_EPOCH * per_epoch
    state = state.replace(step=torch.tensor(step), epoch=torch.tensor(BASE_EPOCH - 1))
    base = save_checkpoint(os.path.join(root, "snapshots"), state, step)

    batches, real_loop = {}, loop.train_loop

    def recording_loop(state, step_fn, *args, **kw):
        seen = batches.setdefault(route, [])

        def step_and_digest(state, b, lr, wf):
            h = hashlib.sha256()
            for k in sorted(b):
                h.update(k.encode())
                h.update(b[k].contiguous().view(-1).view(torch.uint8).numpy())
            seen.append(h.hexdigest())
            return step_fn(state, b, lr, wf)

        return real_loop(state, step_and_digest, *args, **kw)

    out = {"root": root, "base": base, "per_epoch": per_epoch, "batches": batches}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "train_loop", recording_loop)
        for route, flags in (("kernel", []), ("plain", PLAIN)):
            snap = os.path.join(root, f"fork_{route}")
            out[route] = campaign.run_chunks(root, 20, 10, snap, BATCH, extra=TINY + flags + [
                "--seed", "5"], until=BASE_EPOCH + 1, fork_from=base)
    return out


def test_fork_resumes_from_the_copied_checkpoint(forks):
    """The fork copies the base checkpoint into its fresh snapshot
    directory, trains from that checkpoint's epoch, and its train.jsonl
    holds the fork's epochs only; the base directory is left as it was."""
    per_epoch, base = forks["per_epoch"], forks["base"]
    for route in ("kernel", "plain"):
        snap = os.path.join(forks["root"], f"fork_{route}")
        (chunk,) = forks[route]
        copied = os.path.join(snap, os.path.basename(base))
        assert (chunk["start"], chunk["stop"], chunk["resumed_from"]) == (
            BASE_EPOCH, BASE_EPOCH + 1, copied)
        assert chunk["step"] == (BASE_EPOCH + 1) * per_epoch
        assert campaign.checkpoint_digest(copied) == campaign.checkpoint_digest(base)
        with open(os.path.join(snap, "train.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        steps = [r["step"] for r in recs if "loss" in r]
        assert steps == list(range(BASE_EPOCH * per_epoch + 1, (BASE_EPOCH + 1) * per_epoch + 1))
        assert [r["step"] for r in recs if "epoch/epoch_loss" in r] == [BASE_EPOCH]
    assert sorted(os.listdir(os.path.dirname(base))) == [os.path.basename(base)]
    with pytest.raises(ValueError, match="not empty"):
        campaign.fork_checkpoint(base, os.path.join(forks["root"], "fork_kernel"))


def test_forks_at_one_seed_draw_equal_batches(forks):
    """The device pipeline draws from --seed alone: the kernel route's fork
    and the plain route's fork see bit-equal batches."""
    b = forks["batches"]
    assert len(b["kernel"]) == forks["per_epoch"] and b["kernel"] == b["plain"]
    assert len(set(b["kernel"])) == len(b["kernel"])


def _pvalue(d):
    return wilcoxon(d, alternative="greater", method="exact").pvalue


@pytest.mark.parametrize("d,w_minus,word", [
    ([0.02, -0.03, 0.035, 0.04, 0.05, 0.06], 2, "confirmed"),      # p = 3/64
    ([0.02, 0.03, -0.035, 0.04, 0.05, 0.06], 3, "inconclusive"),   # p = 5/64
    ([0.02, 0.03, 0.035, 0.04, -0.05, 0.06], 5, "inconclusive"),   # p = 10/64
    ([0.02, 0.03, 0.035, 0.04, 0.05, -0.06], 6, "spread"),         # p = 14/64
    ([0.02, 0.03, 0.035, -0.04, 0.05, -0.06], 10, "spread"),
    ([0.01, -0.015, 0.02, 0.04, 0.05, 0.06], 2, "confirmed"),      # median 0.03
    ([0.01, -0.015, 0.02, 0.0399, 0.05, 0.06], 2, "inconclusive"),  # median 0.02995
    ([0.005, 0.008, 0.01, 0.02, 0.05, 0.06], 0, "inconclusive"),   # median 0.015
    ([0.01, 0.012, 0.0148, 0.015, 0.05, 0.06], 0, "spread"),       # median 0.0149
    ([-0.01, -0.012, -0.0148, -0.015, -0.05, 0.06], 15, "spread"),
])
def test_fork_verdict_boundaries(d, w_minus, word):
    ranks = rankdata(np.abs(d))
    assert sum(r for r, x in zip(ranks, d) if x < 0) == w_minus
    out = S.fork_verdict(d)
    assert (out["n"], out["W_minus"], out["verdict"]) == (6, w_minus, word), out
    assert out["p"] == _pvalue(d)
    assert out["median_d"] == np.median(d)


def test_fork_verdict_exact_p_and_pending():
    """p = #{sign patterns with W- <= w} / 2^6 at n = 6; fewer pairs:
    pending, untested."""
    for w, count in ((0, 1), (1, 2), (2, 3), (3, 5), (6, 14)):
        d = [0.1 * (i + 1) * (-1 if i + 1 == w else 1) for i in range(6)]  # W- = w
        assert S.fork_verdict(d)["p"] == pytest.approx(count / 64)
    out = S.fork_verdict([0.1, 0.2, 0.3, 0.4, 0.5])
    assert (out["n"], out["W_minus"], out["p"], out["verdict"]) == (5, None, None, "pending")


def _write_fork(tmp_path, name, curve, evaluated, first=1001, last=1500, stat=0.7):
    """A fork's PREFIX.train.jsonl (epoch records first..last, validation
    every 100 epochs from ``curve``: epoch -> ct_mean) and PREFIX.best.json."""
    prefix = str(tmp_path / name)
    with open(prefix + ".train.jsonl", "w") as f:
        for e in range(first, last + 1):
            f.write(json.dumps({"step": e - 1, "epoch/patches_per_sec": 14.0 + e % 3}) + "\n")
            if e % 100 == 0:
                f.write(json.dumps({"step": e - 1, "val/val_dice_ct_mean": curve.get(e, 0.5),
                                    "val/val_dice_sup_sum": 0.5}) + "\n")
    peak = {"unsup_mean": stat, "unsup_organs_above": 11, "unsup_mean_atlas": 0.8,
            "unsup_organs_above_atlas": 13}
    with open(prefix + ".best.json", "w") as f:
        json.dump({"peak_epoch": evaluated - 1, "peak": peak, "final": peak}, f)
    return prefix


def test_read_fork_and_its_refusals(tmp_path):
    row = S.read_fork("kernel", 10, _write_fork(tmp_path, "k10", {1200: 0.62, 1500: 0.55}, 1200))
    assert (row["base"], row["window"], row["reached"], row["peak_epoch"]) == (
        1000, [1100, 1500], 1500, 1200)
    assert (row["stat"], row["peak_ct"], row["end_ct"], row["fell_back"]) == (
        0.7, 0.62, 0.55, True)
    assert row["curve"] == [0.5, 0.62, 0.5, 0.5, 0.55] and row["pps"] == 15.0
    held = S.read_fork("plain", 10, _write_fork(tmp_path, "p10", {1300: 0.6, 1500: 0.58}, 1300))
    assert (held["peak_epoch"], held["fell_back"]) == (1300, False)
    with pytest.raises(ValueError, match="evaluated epoch 1500"):
        S.read_fork("kernel", 10, _write_fork(tmp_path, "off", {1200: 0.62}, 1500))
    # the base's own records in the fork's train.jsonl: a window reaching back
    with pytest.raises(ValueError, match="at or before the base epoch"):
        S.read_fork("kernel", 10, _write_fork(tmp_path, "back", {900: 0.7, 1200: 0.6}, 1200,
                                              first=1))
    with pytest.raises(ValueError, match="at or before the base epoch"):
        S.read_fork("kernel", 10, _write_fork(tmp_path, "edge", {1200: 0.6}, 1200, first=1000))
    with pytest.raises(ValueError, match="reached epoch 1450"):
        S.read_fork("kernel", 10, _write_fork(tmp_path, "short", {1200: 0.6}, 1200, last=1450))


def test_main_pairs_the_forks(tmp_path, capsys):
    """--fork rows go to the forks file with --add; the table pairs them by
    seed, a counted fork is refused, and six pairs give the verdict."""
    runs = tmp_path / "runs.jsonl"
    runs.write_text(open(S.RUNS).read())
    forks = tmp_path / "forks.jsonl"
    d = [0.02, -0.03, 0.035, 0.04, 0.05, 0.06]
    specs = []
    for seed, di in zip(S.FORK_SEEDS, d):
        for route, stat in (("kernel", 0.6), ("plain", 0.6 + di)):
            prefix = _write_fork(tmp_path, f"{route}{seed}", {1400: 0.7}, 1400, stat=stat)
            specs += ["--fork", f"{route}:{seed}:{prefix}"]
    out = S.main(specs[:8] + ["--add"], str(runs), str(forks))  # seeds 10 and 11
    assert out["p"] == pytest.approx(4 / 21)
    assert (out["forks"]["n"], out["forks"]["verdict"]) == (2, "pending")
    assert out["forks"]["missing_seeds"] == list(S.FORK_SEEDS[2:])
    with pytest.raises(ValueError, match="counted already"):
        S.main(specs[:2], str(runs), str(forks))
    out = S.main(specs[8:] + ["--add"], str(runs), str(forks))["forks"]
    assert (out["n"], out["W_minus"], out["verdict"]) == (6, 2, "confirmed")
    assert out["p"] == _pvalue(np.array([0.6 + x for x in d]) - 0.6)
    assert len(forks.read_text().splitlines()) == 12
    text = capsys.readouterr().out
    assert "| 11 | 0.6000 (11/13) | 0.5700 (11/13) | -0.0300 | 1400 / 1400 |" in text


def test_counted_forks():
    """The counted forks' rows agree with their own curves: the peak is the
    first highest validation of epochs 1100-1500, the end ct_mean its last,
    and 'fell back' the rule's 0.05 below the peak."""
    rows = S.read_rows(S.FORKS)
    assert rows and all(r["route"] in ("kernel", "plain") and r["seed"] in S.FORK_SEEDS
                        for r in rows)
    for r in rows:
        assert (r["base"], r["window"], r["reached"]) == (1000, [1100, 1500], 1500)
        assert len(r["curve"]) == 5 and r["peak_epoch"] == 1100 + 100 * int(np.argmax(r["curve"]))
        assert (r["peak_ct"], r["end_ct"]) == (max(r["curve"]), r["curve"][-1])
        assert r["fell_back"] == (r["end_ct"] < r["peak_ct"] - S.FELL_BACK)
    assert len({(r["route"], r["seed"]) for r in rows}) == len(rows)
