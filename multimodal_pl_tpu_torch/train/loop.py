"""Epoch-level training, port of ``multimodal_pl_tpu/train/loop.py``
(reference train_amos_atlas_final.py:188-474).

Per epoch: poly LR, batches (host batches from ``AMOSDataset.batches``
copied to the device from pinned memory, or device batches from a
``data.device_cache.DeviceDataPipeline``), the train step, metric logs and
the epoch's patches/s; every ``val_every``
epochs (from epoch 5) a full-volume sliding-window validation on the valid
split and a checkpoint; a checkpoint at the end.

Metrics stay device scalars between logs: ``float(...)`` runs only at the
``log_every`` cadence and once for the epoch summary, so the host never waits
for the device inside a step.

Data parallelism (``rank`` of ``world``, the JAX loop's ``n_dev``): every rank
runs the loop with the same state and a data-parallel step
(:mod:`multimodal_pl_tpu_torch.parallel.sharded_step`). The host dataset
(``AMOSDataset.batches(rank=, world=)``) and the device pipeline (built with
the same rank and world) each yield the rank's batches: batch i of the
stream where ``i % world == r``, without an incomplete last group
(``loop.py:171-180``). An epoch has ``len // (batch_size * world)`` steps. Rank 0
alone validates, logs metrics and writes checkpoints; the ranks wait for it
at a barrier after each.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from multimodal_pl_tpu_torch.infer.metrics import organ_scores
from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
from multimodal_pl_tpu_torch.losses.compose import feature_ramp
from multimodal_pl_tpu_torch.parallel.mesh import barrier as wait_for_ranks
from multimodal_pl_tpu_torch.train.checkpoint import save_checkpoint
from multimodal_pl_tpu_torch.train.state import StepConfig, TrainState
from multimodal_pl_tpu_torch.train.step import poly_lr
from multimodal_pl_tpu_torch.utils.logging import MetricsLogger

DEVICE_KEYS = ("image", "label", "catlas", "sup_mask", "label_t")


@dataclass
class LoopConfig:
    num_epochs: int = 500
    batch_size: int = 1
    learning_rate: float = 5e-4
    power: float = 0.9
    val_every: int = 50
    snapshot_dir: str = "snapshots/fold1"
    start_epoch: int = 0
    # stop after this epoch without touching the LR horizon (num_epochs);
    # 0 = run to num_epochs
    stop_epoch: int = 0
    tile: tuple = (64, 192, 192)
    num_classes: int = 14


def validate(state: TrainState, model, dataset, cfg: LoopConfig, scfg: StepConfig,
             device, logger: Optional[MetricsLogger] = None, epoch: int = 0):
    """Sliding-window validation over the valid split (train:480-597) through
    the port's predictor, in the step's compute dtype (the serving kernels
    take bf16). Returns (sup_dice_sum, CT table, MRI table, n_ct, n_mri)."""
    def fwd(tiles):
        return functional_call(model, state.params, (tiles,), {"aux": False})

    predictor = SlidingWindowPredictor(fwd, cfg.tile, cfg.num_classes,
                                       compute_dtype=scfg.compute_dtype, device=device)
    nfg = cfg.num_classes - 1
    ct_dice, ct_count = np.zeros(nfg), np.zeros(nfg)
    mri_dice, mri_count = np.zeros(nfg), np.zeros(nfg)
    sup_dice_sum, sup_count = 0.0, 0
    for i in range(len(dataset)):
        s = dataset[i]
        logits = predictor(s.image[..., 0])
        label = torch.from_numpy(s.label).to(logits.device)
        dice = organ_scores(logits[None], label[None], nfg)[0].cpu().numpy()
        if s.case_id < 510:  # CT bucket threshold (train:532)
            ct_dice += dice
            ct_count += 1
        else:
            mri_dice += dice
            mri_count += 1
        sup = np.asarray(s.sup_mask[1:]) > 0
        sup_dice_sum += float(dice[sup].sum())
        sup_count += int(sup.sum())
    ct = ct_dice / np.maximum(ct_count, 1)
    mri = mri_dice / np.maximum(mri_count, 1)
    if logger:
        logger.log(epoch, {"val_dice_ct_mean": float(ct.mean()),
                           "val_dice_mri_mean": float(mri.mean()),
                           "val_dice_sup_sum": sup_dice_sum}, prefix="val/")
    return sup_dice_sum, ct, mri, int(ct_count[0]), int(mri_count[0])


def check_refine_grad_capacity(train_ds, scfg: StepConfig) -> int:
    """The refiner's gradient pass gathers a static ``refine_grad_organs``
    rows; a case with more supervised labeled-modality organs would silently
    drop rows from the refiner loss. Check the dataset's supervision rows (a
    required interface of every train dataset) up front."""
    rows = getattr(train_ds, "supervision_rows", None)
    if rows is None:
        raise TypeError(
            f"{type(train_ds).__name__} does not expose supervision_rows(); "
            "every train dataset must yield (sup_mask, label_t) per case so "
            "the refiner gradient capacity can be validated")
    max_tlist = 0
    for sup_mask, label_t in rows():
        max_tlist = max(max_tlist, int(np.sum(np.asarray(sup_mask)[1:] * np.asarray(label_t))))
    if max_tlist > scfg.refine_grad_organs:
        raise ValueError(
            f"refine_grad_organs={scfg.refine_grad_organs} < max per-case "
            f"supervised labeled-modality organs ({max_tlist}); raise "
            "--refine_grad_organs or refiner gradients silently drop organs")
    return max_tlist


def to_device(batch, scfg: StepConfig, device) -> dict:
    """A host batch -> device tensors: image and catlas in the compute dtype,
    labels as uint8 (values < num_classes), copied from pinned memory on a
    GPU."""
    dtypes = {"image": scfg.compute_dtype, "catlas": scfg.compute_dtype,
              "label": torch.uint8, "sup_mask": torch.float32, "label_t": torch.float32}
    device = torch.device(device)
    out = {}
    for k in DEVICE_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k])).to(dtypes[k])
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def train_loop(state: TrainState, step_fn, model, train_ds, valid_ds, scfg: StepConfig,
               cfg: LoopConfig, device, log_every: int = 10, device_pipe=None,
               rank: int = 0, world: int = 1) -> TrainState:
    """Runs epochs start_epoch .. stop (or num_epochs) - 1 on ``device``,
    where ``state`` must already be. device_pipe: a DeviceDataPipeline of
    train_ds on ``device``; its batches are assembled on the device and go
    to the step as they are, in place of train_ds's host batches. rank,
    world: this process's place in a data-parallel group (a default process
    group must then exist)."""
    lead = rank == 0
    if lead:
        os.makedirs(cfg.snapshot_dir, exist_ok=True)
    logger = MetricsLogger(cfg.snapshot_dir) if lead else None
    check_refine_grad_capacity(train_ds, scfg)
    device = torch.device(device)
    if device_pipe is not None and device_pipe.device != device:
        raise ValueError(f"device_pipe holds its batches on {device_pipe.device}, the step "
                         f"runs on {device}")
    if device_pipe is not None and (device_pipe.rank, device_pipe.world) != (rank, world):
        raise ValueError(f"device_pipe assembles rank {device_pipe.rank} of "
                         f"{device_pipe.world}, the loop runs rank {rank} of {world}")

    def barrier():
        if world > 1:
            wait_for_ranks(device)

    stop = min(cfg.stop_epoch, cfg.num_epochs) if cfg.stop_epoch else cfg.num_epochs
    for epoch in range(cfg.start_epoch, stop):
        state = state.replace(epoch=torch.tensor(epoch, dtype=torch.long, device=device))
        lr = poly_lr(cfg.learning_rate, epoch, cfg.num_epochs, cfg.power).to(device)
        wf = feature_ramp(epoch, scfg.pretrain_epoch, scfg.ramp_until,
                          scfg.weight_feature_max).to(device)
        loss_handles = []
        t0 = time.time()
        if device_pipe is not None:
            epoch_batches = device_pipe.batches(cfg.batch_size, epochs=1)
        else:
            epoch_batches = (to_device(b, scfg, device)
                             for b in train_ds.batches(cfg.batch_size, epochs=1, rank=rank,
                                                       world=world))
        for it, b in enumerate(epoch_batches):
            state, metrics = step_fn(state, b, lr, wf)
            loss_handles.append(metrics["loss"])
            if lead and log_every >= 1 and it % log_every == 0:  # <= 0: epoch summaries only
                logger.log(int(state.step), {k: float(v) for k, v in metrics.items()})
        epoch_losses = [float(h) for h in loss_handles]
        dt = time.time() - t0
        pps = max(len(epoch_losses), 1) * cfg.batch_size * world / dt
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        if lead:
            logger.log(epoch, {"epoch_loss": mean_loss, "lr": float(lr),
                               "patches_per_sec": pps}, prefix="epoch/")
            print(f"Epoch_sum {epoch}: lr = {float(lr):.4} loss = {mean_loss:.4} "
                  f"({pps:.2f} patches/s)")

        if valid_ds is not None and epoch >= 5 and (epoch + 1) % cfg.val_every == 0:
            if lead:
                r1, ct, mri, n_ct, n_mri = validate(state, model, valid_ds, cfg, scfg, device,
                                                    logger, epoch)
                print(f"validate: sup_dice_sum={r1:.4f} ct_mean={ct.mean():.4f} "
                      f"({n_ct} cases) mri_mean={mri.mean():.4f} ({n_mri} cases)")
                print("  CT  organ dice: " + " ".join(f"{v:.3f}" for v in ct))
                print("  MRI organ dice: " + " ".join(f"{v:.3f}" for v in mri))
                save_checkpoint(cfg.snapshot_dir, state, int(state.step))
            barrier()

    if lead:
        save_checkpoint(cfg.snapshot_dir, state, int(state.step))
        logger.close()
    barrier()
    return state
