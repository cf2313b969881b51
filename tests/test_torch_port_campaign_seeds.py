"""``tools/campaign_seeds.py``: the verdict rule on chosen samples, a
run's row read from its ``train.jsonl`` and ``campaign_eval best`` JSON
(the peak over epochs <= 1600, a run cut short refused), and the counted
runs' file."""

import json

import numpy as np
import pytest
from scipy.stats import mannwhitneyu

from multimodal_pl_tpu_torch.tools import campaign_seeds as S


@pytest.mark.parametrize("plain,kernel,word", [
    ([0.73, 0.70, 0.72, 0.71, 0.69], [0.61, 0.60, 0.54, 0.58, 0.62], "confirmed"),
    ([0.73, 0.60, 0.55, 0.71, 0.59], [0.61, 0.60, 0.54, 0.58, 0.62], "spread"),
    ([0.64, 0.63, 0.62], [0.61, 0.60, 0.54, 0.58, 0.62], "inconclusive"),
    ([0.61, 0.62, 0.60], [0.61, 0.60, 0.54, 0.58, 0.66], "spread"),  # median gap 0.01
    ([0.90, 0.91, 0.92], [0.50, 0.51, 0.52, 0.53, 0.95], "inconclusive"),  # p 0.071
])
def test_verdict_rule(plain, kernel, word):
    out = S.verdict(plain, kernel)
    assert out["verdict"] == word, out
    ref = mannwhitneyu(plain, kernel, alternative="greater", method="exact").pvalue
    assert out["p"] == ref
    assert out["median_gap"] == pytest.approx(np.median(plain) - np.median(kernel))


def test_exact_p_of_all_plain_above():
    """Every plain sample above every kernel sample: p = 1 / C(n_p + n_k, n_p)."""
    assert S.verdict([0.9] * 1 + [0.8, 0.85], [0.1, 0.2, 0.3, 0.4, 0.5])["p"] == pytest.approx(
        1 / 56)
    assert S.verdict([0.9, 0.8, 0.85, 0.7, 0.75], [0.1, 0.2, 0.3, 0.4, 0.5])["p"] == \
        pytest.approx(1 / 252)


def _write_run(tmp_path, until, peaks, evaluated):
    prefix = str(tmp_path / "plain1")
    with open(prefix + ".train.jsonl", "w") as f:
        for e in range(until):
            f.write(json.dumps({"step": e, "epoch/patches_per_sec": 10.0 + e % 3}) + "\n")
            if (e + 1) % 100 == 0:
                f.write(json.dumps({"step": e, "val/val_dice_ct_mean": peaks.get(e + 1, 0.1),
                                    "val/val_dice_sup_sum": 0.5}) + "\n")
    peak = {"unsup_mean": 0.7, "unsup_organs_above": 12, "unsup_mean_atlas": 0.8,
            "unsup_organs_above_atlas": 13}
    with open(prefix + ".best.json", "w") as f:
        json.dump({"peak_epoch": evaluated - 1, "peak": peak, "final": peak}, f)
    return prefix


def test_read_run(tmp_path):
    prefix = _write_run(tmp_path, 1600, {900: 0.6, 1300: 0.6}, 900)
    row = S.read_run("plain", 1, prefix)
    assert (row["reached"], row["peak_epoch"], row["stat"], row["above"]) == (1600, 900, 0.7, 12)
    assert len(row["curve"]) == 16 and row["curve"][8] == 0.6 and row["pps"] == 11.0
    with pytest.raises(ValueError, match="evaluated epoch 1300"):
        S.read_run("plain", 1, _write_run(tmp_path, 1600, {900: 0.6, 1300: 0.6}, 1300))
    with pytest.raises(ValueError, match="reached epoch 1175"):
        S.read_run("plain", 1, _write_run(tmp_path, 1175, {900: 0.6}, 900))


def test_counted_runs_and_add(tmp_path, capsys):
    """The counted runs' peaks sit on their curves; main tabulates them,
    appends a new run with --add and refuses a seed counted already."""
    with open(S.RUNS) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        assert len(r["curve"]) == 16
        assert r["peak_epoch"] == 100 * (int(np.argmax(r["curve"])) + 1)
    runs = tmp_path / "runs.jsonl"
    runs.write_text(open(S.RUNS).read())
    assert S.main([], str(runs))["p"] == pytest.approx(4 / 21)
    prefix = _write_run(tmp_path, 1600, {1200: 0.65}, 1200)
    out = S.main(["--run", f"plain:2:{prefix}", "--add"], str(runs))
    assert (out["n_plain"], out["n_kernel"]) == (3, 5)
    assert "| plain | 2 |" in capsys.readouterr().out
    assert len(runs.read_text().splitlines()) == len(rows) + 1
    with pytest.raises(ValueError, match="counted already"):
        S.main(["--run", f"plain:2:{prefix}"], str(runs))
