"""The partial-label campaign of the port (``tools/campaign.py``,
``tools/campaign_eval.py``, ``data/supervision.generate_supervision_csv``)
against the JAX package's scripts (``scripts/partial_label_campaign.py``,
``scripts/campaign_eval.py``, ``scripts/run_campaign_chunks.sh``):

- the fixture: every file the port's ``generate`` writes equals the JAX
  script's (the NIfTI volumes after gunzip, since gzip stamps the time; the
  atlas and the csv byte for byte), for the default fixture and with
  ``full_coverage``, at the campaign's own 96 x 96 x 80;
- the csv writer with and without organ overrides, byte for byte;
- the held-out evaluation (``--plain --device cpu``) of an orbax checkpoint
  that JAX's ``save_checkpoint`` wrote from ``create_train_state(
  PRNGKey(0), StepConfig(num_classes=14, deep_up=True))``: the table that
  JAX's script prints on the same root at a 16 x 32 x 32 tile;
- the chunk runner's trainer argv for 2500 epochs in chunks of 800, against
  the shell runner's with a stand-in ``python`` that records its argv and
  writes the checkpoint the chunk would; a two-chunk run on the CPU that
  resumes chunk 1's checkpoint.
"""

import filecmp
import gzip
import importlib.util
import json
import os
import re
import stat
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from multimodal_pl_tpu.data.supervision import generate_supervision_csv as jax_csv
from multimodal_pl_tpu_torch.data.supervision import generate_supervision_csv
from multimodal_pl_tpu_torch.tools import campaign, campaign_eval
from multimodal_pl_tpu_torch.utils.synthetic import make_synthetic_amos

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDS = sorted(campaign.CAMPAIGN_CT_IDS) + list(range(500, 506))
TILE = "16,32,32"
# JAX's script prints dice to 3 or 4 decimals: a port value may differ from
# the printed one by half a unit of the last digit, plus PRINT_SLACK for the
# f32 difference of two implementations' logits. That moves a dice by far
# less unless it flips a voxel whose top two logits (or whose probability
# and atlas threshold) tie within it; one flipped voxel of an organ of ~1000
# would move its dice by ~1e-3. Measured: every number within the rounding
# alone, so no voxel flips here.
PRINT_SLACK = 1e-5


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b):
    """Every file under a equals the one under b: .nii.gz after gunzip,
    everything else byte for byte."""
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".gz"):
            with gzip.open(pa) as fa, gzip.open(pb) as fb:
                assert fa.read() == fb.read(), name
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name
    return names


@pytest.mark.parametrize("full_coverage", [False, True], ids=["default", "full_coverage"])
def test_fixture_matches_jax(tmp_path, full_coverage):
    ref, port = str(tmp_path / "jax"), str(tmp_path / "port")
    # numpy, scipy and zlib release the GIL: the two generations overlap
    with ThreadPoolExecutor(2) as pool:
        for done in [pool.submit(_script("partial_label_campaign").generate, ref,
                                 full_coverage=full_coverage),
                     pool.submit(campaign.generate, port, full_coverage=full_coverage)]:
            done.result()
    names = _same_tree(ref, port)
    assert len(names) == 2 * len(IDS) + 2
    assert np.load(os.path.join(port, "atlas_mm.npy")).shape == (13, *campaign.SHAPE)
    with open(os.path.join(port, "supervise_mask.csv")) as f:
        rows = dict(line.strip().split(",") for line in f)
    supervised = {int(r[5:9]): m.index("1") for r, m in rows.items() if "1" in m}
    covered = {supervised[c] for c in campaign.train_ids(port) if c in supervised}
    # the default csv leaves organs 1, 2, 4 and 10 without a train case
    # (the JAX record's lockout); full coverage supervises all 13
    assert covered == (set(range(1, 14)) if full_coverage
                       else set(range(1, 14)) - {1, 2, 4, 10})


@pytest.mark.parametrize("overrides", [None, {40: 1, 80: 2, 130: 13, 501: 4}],
                         ids=["id_ranges", "overrides"])
def test_supervision_csv_matches_jax(tmp_path, overrides):
    jax_csv(IDS, str(tmp_path / "jax.csv"), organ_overrides=overrides)
    generate_supervision_csv(IDS, str(tmp_path / "port.csv"), organ_overrides=overrides)
    port = (tmp_path / "port.csv").read_bytes()
    assert port == (tmp_path / "jax.csv").read_bytes()
    if overrides:
        lines = port.decode().splitlines()
        assert "amos_0040,01000000000000" in lines and "amos_0501,00000000000000" in lines


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """7 CT and 2 MRI cases at 40 x 40 x 36: held out are 501 (MRI), 80 and
    130; 6 train cases."""
    root = str(tmp_path_factory.mktemp("small"))
    make_synthetic_amos(root, n_ct=7, n_mri=2, shape=(40, 40, 36), seed=5, organ_r_frac=0.2)
    return root


@pytest.fixture(scope="module")
def jax_ckpt(small, tmp_path_factory):
    from multimodal_pl_tpu.train.checkpoint import save_checkpoint
    from multimodal_pl_tpu.train.state import StepConfig, create_train_state

    state = create_train_state(jax.random.PRNGKey(0), StepConfig(num_classes=14, deep_up=True))
    snap = str(tmp_path_factory.mktemp("jax_snap"))
    save_checkpoint(snap, state, 7)
    return snap, state


NUMBER = r"-?\d+\.\d+|nan"


def _numbers(line):
    """[(value, decimal places)] of the numbers printed in ``line``."""
    return [(float(t), 0 if t == "nan" else len(t.split(".")[1]))
            for t in re.findall(NUMBER, line)]


def test_eval_matches_jax_script(small, jax_ckpt, monkeypatch, capsys):
    """The port's plain route on the CPU gives the table JAX's script prints
    (its f32 route) for the same orbax checkpoint, root and tile."""
    import multimodal_pl_tpu.train.state as jstate

    snap, state = jax_ckpt
    # the script builds its restore target with create_train_state; the
    # fixture's state is that target, made once
    monkeypatch.setattr(jstate, "create_train_state", lambda key, cfg: state)
    monkeypatch.setattr(sys, "argv", ["campaign_eval.py", "--root", small, "--snapshot_dir",
                                      snap, "--input_size", TILE])
    _script("campaign_eval").main()
    ref = capsys.readouterr().out.splitlines()
    lines = []
    out = campaign_eval.evaluate(small, snap, 0, tuple(map(int, TILE.split(","))), plain=True,
                                 device="cpu", say=lines.append)
    assert out["checkpoint"].endswith("ckpt_7") and ref[0].endswith("ckpt_7")
    assert [c["case_id"] for c in out["cases"]] == [501, 80, 130]  # valid, then test
    assert [c["modality"] for c in out["cases"]] == ["mri", "ct", "ct"]
    ref = ref[1:]
    assert len(ref) == len(lines) - 1
    worst = 0.0
    for want, got in zip(ref, lines[1:]):
        # the same line, up to its numbers
        assert re.sub(NUMBER, "#", want) == re.sub(NUMBER, "#", got), got
        for (a, p), (b, _) in zip(_numbers(want), _numbers(got)):
            if np.isnan(a):
                assert np.isnan(b)
                continue
            worst = max(worst, abs(a - b) - 0.5 * 10.0 ** -p)
        counts = re.findall(r"organs > 0.3: (\d+)", want)
        assert counts == re.findall(r"organs > 0.3: (\d+)", got)
    assert worst <= PRINT_SLACK, worst
    assert out["unsup_organs_above"] == int(ref[-4].split(":")[1].split("/")[0])


def _fake_python(bindir, log):
    """A ``python`` that appends its argv to ``log`` as JSON and makes the
    orbax directory of the chunk's last step (6 steps per epoch)."""
    path = os.path.join(bindir, "python")
    with open(path, "w") as f:
        f.write(f"""#!{sys.executable}
import json, os, sys
argv = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(json.dumps(argv) + "\\n")
snap = argv[argv.index("--snapshot_dir") + 1]
stop = int(argv[argv.index("--stop_epoch") + 1])
os.makedirs(os.path.join(snap, f"ckpt_{{stop * 6}}"), exist_ok=True)
""")
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)


def test_chunk_argv_matches_shell_runner(tmp_path):
    root = str(tmp_path / "root")
    os.makedirs(os.path.join(root, "imagesTr"))
    for cid in IDS:  # the split reads names only
        open(os.path.join(root, "imagesTr", f"amos_{cid:04d}_0000.nii.gz"), "w").close()
    assert campaign.steps_per_epoch(root) == 6
    bindir, log = str(tmp_path / "bin"), str(tmp_path / "argv.jsonl")
    os.makedirs(bindir)
    _fake_python(bindir, log)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"])
    proc = subprocess.run(["bash", os.path.join(REPO, "scripts", "run_campaign_chunks.sh"),
                           root, "2500", "800"], env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0 and "campaign complete at epoch 2500" in proc.stdout, proc
    with open(log) as f:
        shell = [json.loads(line) for line in f]
    assert all(a[:2] == ["-m", "multimodal_pl_tpu.cli.train"] for a in shell)

    argvs = []

    def train_main(argv):
        argvs.append(argv)
        stop = int(argv[argv.index("--stop_epoch") + 1])
        snap = argv[argv.index("--snapshot_dir") + 1]
        os.makedirs(snap, exist_ok=True)
        open(os.path.join(snap, f"ckpt_{stop * 6}.pt"), "w").close()
        return types.SimpleNamespace(step=stop * 6)

    # the shell runner left its checkpoints in ROOT/snapshots: start afresh
    for d in os.listdir(os.path.join(root, "snapshots")):
        os.rmdir(os.path.join(root, "snapshots", d))
    records = campaign.run_chunks(root, 2500, 800, train_main=train_main)
    assert argvs == [a[2:] for a in shell]
    # stop = start + chunk, cut at the horizon: a last chunk of 100 epochs
    assert [(r["start"], r["stop"]) for r in records] == [(0, 800), (800, 1600), (1600, 2400),
                                                          (2400, 2500)]
    assert [r["resumed_from"] for r in records] == [None] + [r["checkpoint"]
                                                             for r in records[:-1]]


TINY = ["--input_size", "32,32,32", "--model_base", "16", "--model_layers", "1,1,1,1,1",
        "--refiner_filter", "8", "--disc_ndf", "16", "--disc_depth", "5", "--bf16", "false",
        "--log_every", "1"]


def test_two_chunk_run_resumes_on_cpu(small, tmp_path, capsys):
    snap = str(tmp_path / "snap")
    records = campaign.main(["run", "--root", small, "--skip_gen", "--snapshot_dir", snap,
                             "--epochs", "2", "--chunk", "1", "--batch_size", "2",
                             "--device", "cpu"] + TINY)
    out = capsys.readouterr().out
    first = os.path.join(snap, "ckpt_3.pt")  # 6 train cases at B = 2: 3 steps an epoch
    assert [(r["start"], r["stop"], r["resumed_from"], r["step"]) for r in records] == [
        (0, 1, None, 3), (1, 2, first, 6)]
    assert records[0]["checkpoint"] == first and f"loading from checkpoint: {first}" in out
    with open(os.path.join(snap, "train.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "loss" in r] == list(range(1, 7))
    assert [r["step"] for r in recs if "epoch/epoch_loss" in r] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)


def test_entry_points_run_on_the_gpu_unless_asked(small, tmp_path):
    """Without --device cpu both entry points ask for the GPU, which raises
    where there is none (they never fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device would run")
    with pytest.raises(RuntimeError, match="--device cpu"):
        campaign.main(["run", "--root", small, "--skip_gen", "--snapshot_dir",
                       str(tmp_path / "snap"), "--epochs", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        campaign_eval.main(["--root", small, "--snapshot_dir", str(tmp_path / "snap")])
