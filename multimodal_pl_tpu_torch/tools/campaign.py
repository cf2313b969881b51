"""The partial-label campaign on the port: the counterpart of
``scripts/partial_label_campaign.py`` and ``scripts/run_campaign_chunks.sh``.

It shows the whole partial-label system (pretrain, then the consistency
ramp and the GAN terms) learning organs that a case never supervised. The
fixture is 28 synthetic cases at 96 x 96 x 80 (22 CT ids that cover every
CT-supervisable organ 3..13 twice, 6 MRI ids that supervise nothing) with
``organ_r_frac=0.2``, an atlas and a supervision csv, written by the port's
own copies (``utils/synthetic.make_case``, ``data/nifti.write_nifti``,
``data/supervision.generate_supervision_csv``); a test pins every file to
the JAX script's. Training is ``mpl-train-torch``'s own ``main`` at
64 x 96 x 96, B = 3.

    python -m multimodal_pl_tpu_torch.tools.campaign train --root ROOT [--epochs 800]
    python -m multimodal_pl_tpu_torch.tools.campaign run --root ROOT [--epochs 2500] [--chunk 800] \
        [--until EPOCH] [--snapshot_dir DIR --fork_from CKPT]

Both modes write the fixture first unless ``--skip_gen`` is given.
``train`` trains once with the JAX script's argv. ``run`` trains in chunks
of ``--chunk`` epochs with the chunk runner's argv (``--val_pred_every 100
--device_data true --cache_data true``): each chunk resumes from the latest
checkpoint in the snapshot directory (``--reload_from_checkpoint true
--start_epoch --stop_epoch``) and ``--num_epochs`` stays the whole horizon,
so the LR schedule is that of an unbroken run; a chunk stops at its start +
``--chunk`` or at the horizon (2500 / 800: 0-800, 800-1600, 1600-2400,
2400-2500); ``--until`` stops the run at an epoch, each chunk cut there
(``--until 1200``: 0-800, 800-1200). A chunk starts a new dataset stream
(the dataset's random generator is seeded per process), as a chunk of the
JAX runner does. The
epoch to resume is the latest checkpoint's step over the steps per epoch of
the training split (19 train cases at B = 3: 6). Arguments that neither
mode knows go to every ``mpl-train-torch`` call after its own, so they
override them (``--seed 1`` for a second seed, small model widths for a
rehearsal). Both modes train on the GPU unless ``--device cpu`` is given.

``run --fork_from CKPT`` forks a run: it copies the one checkpoint into the
snapshot directory, which must be empty or absent, and trains from that
checkpoint's epoch, so the new ``train.jsonl`` holds the fork's epochs only.
Forks of one checkpoint at one ``--seed`` draw the same batches whatever
the route, since the device pipeline draws from the seed alone. A fork of
the epoch-1000 state of a ``--chunk 1000 --until 1000`` run:

    python -m multimodal_pl_tpu_torch.tools.campaign run --root ROOT --skip_gen \
        --snapshot_dir ROOT/fork_plain10 --fork_from ROOT/snapshots/ckpt_6000.pt \
        --epochs 2500 --chunk 1000 --until 1500 --seed 10 --pallas_k2 false --pallas_gn false
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import os
import shutil
import time

# two full coverage passes of the CT supervision ranges (labels 3..13,
# data/supervision._CT_RANGES): id -> organ <=45:3, <=85:4, <=135:5,
# <=180:6, <=242:7, <=300:8, <=370:9, <=440:10, <=460:11, <=480:12, <=500:13
CAMPAIGN_CT_IDS = [
    40, 80, 130, 170, 240, 290, 360, 430, 455, 475, 490,
    35, 70, 120, 160, 230, 280, 340, 420, 458, 478, 495,
]
SHAPE = (96, 96, 80)   # (H, W, D) of a case
NUM_FG = 13
TILE = "64,96,96"      # the training patch and the evaluation tile, (D, H, W)
BATCH = 3


def generate(root: str, seed: int = 7, ct_only: bool = False,
             full_coverage: bool = False) -> None:
    """Write the fixture under ``root``: imagesTr/, labelsTr/, atlas_mm.npy
    and supervise_mask.csv. ``ct_only`` leaves out the MRI cases (the
    reference's CT-only regime); ``full_coverage`` writes a csv in which
    every organ 1..13 supervises >= 1 train case: the organs go round-robin
    over the train split's CT cases, then over the other CT cases."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from multimodal_pl_tpu_torch.data.nifti import write_nifti
    from multimodal_pl_tpu_torch.data.supervision import generate_supervision_csv
    from multimodal_pl_tpu_torch.utils.synthetic import make_case

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imagesTr")
    lab_dir = os.path.join(root, "labelsTr")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    ids = sorted(CAMPAIGN_CT_IDS) + ([] if ct_only else list(range(500, 506)))
    labels_sum = np.zeros((NUM_FG, *SHAPE), np.float32)
    for cid in ids:
        modality = "mri" if cid >= 500 else "ct"
        img, lab = make_case(rng, SHAPE, NUM_FG, modality, organ_r_frac=0.2)
        write_nifti(os.path.join(img_dir, f"amos_{cid:04d}_0000.nii.gz"), img, (1, 1, 2))
        write_nifti(os.path.join(lab_dir, f"amos_{cid:04d}.nii.gz"), lab, (1, 1, 2))
        for organ in range(1, NUM_FG + 1):
            labels_sum[organ - 1] += lab == organ
        print(f"wrote case {cid} ({modality}), fg {(lab > 0).mean() * 100:.1f}%")

    atlas = np.stack([gaussian_filter(labels_sum[i] / len(ids), 3) for i in range(NUM_FG)])
    np.save(os.path.join(root, "atlas_mm.npy"), atlas.astype(np.float32))
    overrides = None
    if full_coverage:
        train_ct = [cid for cid in train_ids(root) if cid < 500]
        rest_ct = [cid for cid in ids if cid < 500 and cid not in train_ct]
        overrides = {cid: i % NUM_FG + 1 for i, cid in enumerate(train_ct + rest_ct)}
        covered = sorted({overrides[c] for c in train_ct})
        print(f"full-coverage csv: train CT {len(train_ct)} cases, organs "
              f"covered in train: {covered}")
        if covered != list(range(1, NUM_FG + 1)):
            raise ValueError(f"need >= {NUM_FG} train CT cases, got {len(train_ct)}")
    generate_supervision_csv(ids, os.path.join(root, "supervise_mask.csv"),
                             organ_overrides=overrides)
    print(f"{len(ids)} cases -> {root}")


def train_ids(root: str) -> list:
    """Case ids of the training split of ``root``/imagesTr (the dataset's
    seeded 70/10/20 split), sorted."""
    from multimodal_pl_tpu_torch.data.dataset import case_id_of, split_files

    files = sorted(glob.glob(os.path.join(root, "imagesTr", "*.nii.gz")))
    return sorted(case_id_of(f) for f in split_files(files, "train", 1))


def steps_per_epoch(root: str, batch_size: int = BATCH) -> int:
    """Train steps per epoch: the training split's cases // the batch (the
    loop drops an incomplete last batch)."""
    return len(train_ids(root)) // batch_size


def data_argv(root: str, snapshot_dir: str) -> list:
    return ["--data_dir", os.path.join(root, "imagesTr"),
            "--atlas_path", os.path.join(root, "atlas_mm.npy"),
            "--supervision_csv", os.path.join(root, "supervise_mask.csv"),
            "--snapshot_dir", snapshot_dir]


def train_argv(root: str, snapshot_dir: str, epochs: int, batch_size: int = BATCH,
               val_every: int = 50) -> list:
    """One unbroken run (partial_label_campaign.py:122-135)."""
    return data_argv(root, snapshot_dir) + [
        "--input_size", TILE, "--batch_size", str(batch_size), "--num_epochs", str(epochs),
        "--val_pred_every", str(val_every), "--learning_rate", "5e-4",
        "--pretrain_epoch", "20", "--cache_data", "true"]


def chunk_argv(root: str, snapshot_dir: str, total: int, start: int, stop: int,
               batch_size: int = BATCH, val_every: int = 100) -> list:
    """One chunk of the chunked run (run_campaign_chunks.sh:30-40)."""
    return data_argv(root, snapshot_dir) + [
        "--input_size", TILE, "--batch_size", str(batch_size), "--num_epochs", str(total),
        "--val_pred_every", str(val_every), "--learning_rate", "5e-4",
        "--pretrain_epoch", "20", "--cache_data", "true", "--device_data", "true",
        "--reload_from_checkpoint", "true", "--start_epoch", str(start),
        "--stop_epoch", str(stop)]


def resume_epoch(snapshot_dir: str, per_epoch: int):
    """(epoch to start from, latest checkpoint or None): the latest
    checkpoint's step // the steps per epoch."""
    from multimodal_pl_tpu_torch.train.checkpoint import checkpoint_step, latest_checkpoint

    path = latest_checkpoint(snapshot_dir)
    if path is None:
        return 0, None
    return checkpoint_step(snapshot_dir, os.path.basename(path)) // per_epoch, path


def checkpoint_digest(path: str) -> str:
    """sha256 over a ``ckpt_<step>.pt``'s tensors in field and name order:
    equal for the same state whatever the file's bytes."""
    import torch

    from multimodal_pl_tpu_torch.train.checkpoint import restore_checkpoint

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                feed(x[k])
        elif isinstance(x, (tuple, list)):
            for v in x:
                feed(v)
        else:
            h.update(x.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())

    state = restore_checkpoint(path)
    for field in dataclasses.fields(state):
        h.update(field.name.encode())
        feed(getattr(state, field.name))
    return h.hexdigest()


def fork_checkpoint(ckpt: str, snapshot_dir: str) -> str:
    """Copy the checkpoint file ``ckpt`` into ``snapshot_dir``, which must be
    empty or absent; returns the copy's path."""
    if os.path.isdir(snapshot_dir) and os.listdir(snapshot_dir):
        raise ValueError(f"fork into {snapshot_dir}: the directory is not empty")
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"fork from {ckpt}: no such checkpoint file")
    os.makedirs(snapshot_dir, exist_ok=True)
    dst = os.path.join(snapshot_dir, os.path.basename(ckpt))
    shutil.copyfile(ckpt, dst)
    return dst


def run_chunks(root: str, total: int, chunk: int, snapshot_dir: str = "",
               batch_size: int = BATCH, val_every: int = 100, extra=(),
               train_main=None, until: int = 0, fork_from: str = "") -> list:
    """Train epochs 0 .. ``total`` in chunks of ``chunk`` epochs, each
    resumed from the latest checkpoint, through ``train_main`` (default:
    mpl-train-torch's ``main``) with ``chunk_argv`` + ``extra``; with
    ``until``, stop at that epoch (the LR horizon stays ``total``); with
    ``fork_from``, first copy that checkpoint into the empty snapshot
    directory (``fork_checkpoint``), so the run starts at its epoch. Returns
    one record per chunk run: start, stop, the checkpoint it resumed from,
    the latest checkpoint after it, the step it ended at and its seconds."""
    if train_main is None:
        from multimodal_pl_tpu_torch.cli.train import main as train_main
    snap = snapshot_dir or os.path.join(root, "snapshots")
    per_epoch = steps_per_epoch(root, batch_size)
    if fork_from:
        copied = fork_checkpoint(fork_from, snap)
        print(f"forked {fork_from} into {snap} at epoch {resume_epoch(snap, per_epoch)[0]} "
              f"(state sha256 {checkpoint_digest(copied)})", flush=True)
    end = min(until, total) if until else total
    records = []
    while True:
        start, resumed_from = resume_epoch(snap, per_epoch)
        if start >= end:
            print(f"campaign {'complete' if end == total else 'stopped'} at epoch {start}")
            return records
        stop = min(start + chunk, end)
        print(f"=== chunk: epochs {start} -> {stop} ===", flush=True)
        t0 = time.perf_counter()
        state = train_main(chunk_argv(root, snap, total, start, stop, batch_size, val_every)
                           + list(extra))
        _, latest = resume_epoch(snap, per_epoch)
        records.append({"start": start, "stop": stop, "resumed_from": resumed_from,
                        "checkpoint": latest, "step": int(state.step),
                        "seconds": time.perf_counter() - t0})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", choices=("train", "run"))
    p.add_argument("--root", default="campaign")
    p.add_argument("--snapshot_dir", default="", help="default: ROOT/snapshots")
    p.add_argument("--epochs", type=int, default=0,
                   help="the LR horizon (default: 800 for train, 2500 for run)")
    p.add_argument("--chunk", type=int, default=800, help="run: epochs per chunk")
    p.add_argument("--until", type=int, default=0,
                   help="run: stop at this epoch, the LR horizon staying --epochs (0: the end)")
    p.add_argument("--fork_from", default="",
                   help="run: copy this checkpoint into the empty --snapshot_dir and train on "
                        "from its epoch")
    p.add_argument("--val_every", type=int, default=0,
                   help="validation cadence in epochs (default: 50 for train, 100 for run)")
    p.add_argument("--batch_size", type=int, default=BATCH)
    p.add_argument("--skip_gen", action="store_true")
    p.add_argument("--ct_only", action="store_true", help="no MRI cases")
    p.add_argument("--full_coverage", action="store_true",
                   help="supervision csv in which every organ 1..13 supervises >= 1 train case")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    args, extra = p.parse_known_args(argv)
    if args.fork_from and args.mode != "run":
        p.error("--fork_from needs the run mode")
    if not args.skip_gen:
        generate(args.root, ct_only=args.ct_only, full_coverage=args.full_coverage)
    snap = args.snapshot_dir or os.path.join(args.root, "snapshots")
    extra = ["--device", args.device] + extra
    if args.mode == "train":
        from multimodal_pl_tpu_torch.cli.train import main as train_main

        return train_main(train_argv(args.root, snap, args.epochs or 800, args.batch_size,
                                     args.val_every or 50) + extra)
    records = run_chunks(args.root, args.epochs or 2500, args.chunk, snap, args.batch_size,
                         args.val_every or 100, extra, until=args.until,
                         fork_from=args.fork_from)
    for r in records:
        print(f"chunk {r['start']} -> {r['stop']}: resumed from {r['resumed_from']}, "
              f"ended at step {r['step']} ({r['checkpoint']}), {r['seconds']:.1f} s")
    return records


if __name__ == "__main__":
    main()
