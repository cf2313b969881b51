"""mpl-train-torch — the training CLI on PyTorch, port of
``multimodal_pl_tpu/cli/train.py`` (flag-compatible with the reference
train_amos_atlas_final.py).

It accepts every flag of the JAX CLI. Differences:

- ``--device`` (default ``cuda``) raises when there is no GPU; ``cpu`` runs
  only when asked for (the kernels' plain versions then run);
- ``--pallas_gn`` / ``--pallas_k2`` select the hand-written CUDA kernels
  (true, the default) or their plain PyTorch versions (false), which on the
  GPU serve tests only (``--pallas_k2`` covers the convs and the trilinear
  upsamples);
- ``--mesh data:N`` trains data-parallel over N processes, one per GPU,
  started by ``torchrun --standalone --nproc_per_node N -m
  multimodal_pl_tpu_torch.cli.train --mesh data:N ...`` (NCCL; gloo with
  ``--device cpu``). Each rank's device is ``cuda:LOCAL_RANK`` unless
  ``--device`` names an index. A mesh that is not the world size raises
  ValueError; a ``space`` axis raises NotImplementedError (JAX's trainer
  builds the data-parallel step for any mesh; the H-split step is
  ``parallel.spatial.make_spatial_train_step``). Every rank runs
  the step on its own batches (``--batch_size`` is per rank, as in the JAX
  CLI) and holds the same state; rank 0 alone validates, logs and writes
  checkpoints;
- ``--device_data`` (``data/device_cache.py``): ``auto`` (the default)
  holds the training set on ``--device`` and assembles batches there when
  every case has the same shape, else prints why and takes the host batch
  path; ``true`` raises that ValueError instead; ``false`` takes the host
  path;
- ``--remat true`` checkpoints the segmenter's encoder and decoder stages;
- ``--bd`` is accepted and changes nothing: the voxel path is the reference.

Checkpoints (``ckpt_<step>.pt`` in ``--snapshot_dir``) hold the whole train
state; ``--reload_from_checkpoint true`` resumes from ``--reload_path`` or
the latest one there, which may also be an orbax ``ckpt_<step>/`` of
``mpl-train``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from multimodal_pl_tpu_torch.cli.evaluate import resolve_device, str2bool


def get_arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="multimodal_pl_tpu_torch trainer (unet3D FEAM)")
    # reference-compatible flags (train_amos_atlas_final.py:51-90)
    p.add_argument("--data_dir", type=str, required=False, default="data/imagesTr")
    p.add_argument("--train_list", type=str, default="")  # accepted; the split is seeded
    p.add_argument("--val_list", type=str, default="")
    p.add_argument("--snapshot_dir", type=str, default="snapshots/fold1/")
    p.add_argument("--reload_path", type=str, default="")
    p.add_argument("--reload_from_checkpoint", type=str2bool, default=False)
    p.add_argument("--input_size", type=str, default="64,192,192")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_gpus", type=int, default=1)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--FP16", type=str2bool, default=False, help="accepted; use --bf16")
    p.add_argument("--num_epochs", type=int, default=500)
    p.add_argument("--itrs_each_epoch", type=int, default=250,
                   help="accepted, unused (dead flag in the reference too)")
    p.add_argument("--patience", type=int, default=3,
                   help="accepted, unused (dead flag in the reference too)")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--stop_epoch", type=int, default=0,
                   help="stop after this epoch (the LR horizon stays num_epochs)")
    p.add_argument("--val_pred_every", type=int, default=50)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--num_classes", type=int, default=14)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--weight_std", type=str2bool, default=True)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--power", type=float, default=0.9)
    p.add_argument("--weight_gan", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--ignore_label", type=int, default=255)
    p.add_argument("--is_training", action="store_true")
    p.add_argument("--random_mirror", type=str2bool, default=True)
    p.add_argument("--random_scale", type=str2bool, default=True)
    p.add_argument("--deep_up", type=str2bool, default=True)
    p.add_argument("--random_seed", type=int, default=1234)
    p.add_argument("--gpu", type=str, default="None")
    p.add_argument("--disweight", type=float, default=0)
    p.add_argument("--augmask", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrain_epoch", type=int, default=20)
    # additions shared with mpl-train
    p.add_argument("--atlas_path", type=str, default="atlas_mm.npy")
    p.add_argument("--supervision_csv", type=str, default="supervise_mask.csv")
    p.add_argument("--bf16", type=str2bool, default=True,
                   help="bfloat16 compute (f32 losses and optimizer); the CUDA kernels "
                        "take bf16")
    p.add_argument("--remat", type=str2bool, default=False,
                   help="recompute the segmenter's encoder and decoder stages in the "
                        "backward instead of keeping their activations")
    p.add_argument("--mesh", type=str, default="",
                   help="data-parallel mesh data:N: N ranks under torchrun, one per GPU "
                        "(NCCL; gloo on the CPU); --batch_size is per rank. A space axis "
                        "raises: the trainer builds the data-parallel step only")
    p.add_argument("--model_base", type=int, default=32,
                   help="U-Net stage-width base (reference: 32)")
    p.add_argument("--model_layers", type=str, default="1,2,2,2,2",
                   help="residual blocks per stage (reference: 1,2,2,2,2)")
    p.add_argument("--refiner_filter", type=int, default=24,
                   help="refiner init_filter (reference: 24)")
    p.add_argument("--disc_ndf", type=int, default=32,
                   help="discriminator base width (reference: 32)")
    p.add_argument("--disc_depth", type=int, default=6,
                   help="discriminator stride-2 conv count; the minimum patch edge is "
                        "2**(depth-1) (reference: 6 -> 64)")
    p.add_argument("--pallas_gn", type=str2bool, default=True,
                   help="GN -> ReLU through the hand-written CUDA kernel (csrc/gn_relu.cu); "
                        "false runs its plain PyTorch version, which on the GPU serves "
                        "tests only")
    p.add_argument("--bd", type=str2bool, default=False,
                   help="accepted, changes nothing: the voxel path is the reference")
    p.add_argument("--pallas_k2", type=str2bool, default=True,
                   help="stride-1 3x3x3 convs and trilinear upsamples through the "
                        "hand-written CUDA kernels (csrc/conv3x3_gn.cu, csrc/resize3d.cu); "
                        "false runs their plain PyTorch versions, which on the GPU serve "
                        "tests only")
    p.add_argument("--cache_data", type=str2bool, default=False,
                   help="memoize prepared volumes in host RAM")
    p.add_argument("--train_refiner", type=str2bool, default=True,
                   help="include the refiner in the SGD update (false reproduces the "
                        "reference snapshot's optimizer, train:132)")
    p.add_argument("--log_every", type=int, default=10,
                   help="per-step JSONL metric cadence (each log waits for the device; "
                        "<= 0 keeps epoch summaries only)")
    p.add_argument("--device_data", choices=("auto", "true", "false"), default="auto",
                   help="hold the prepared training set in device memory and assemble "
                        "batches (crop + intensity augs) there (data/device_cache.py). "
                        "auto: on when case shapes are uniform")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def main(argv=None):
    """Returns the final train state (on every rank under ``--mesh``)."""
    args = get_arguments().parse_args(argv)
    if not args.mesh:
        return _train(args, resolve_device(args.device), None)
    from multimodal_pl_tpu_torch.parallel.mesh import init_data_parallel

    with init_data_parallel(args.mesh, resolve_device(args.device)) as dp:
        return _train(args, dp.device, dp)


def _train(args, device, dp):
    """The run on ``device``; dp: this rank's DataParallel, or None."""
    import torch

    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.data.device_cache import DeviceDataPipeline
    from multimodal_pl_tpu_torch.train.checkpoint import latest_checkpoint, restore_checkpoint
    from multimodal_pl_tpu_torch.train.loop import LoopConfig, train_loop
    from multimodal_pl_tpu_torch.train.state import (
        StepConfig,
        build_models,
        create_train_state,
    )
    from multimodal_pl_tpu_torch.train.step import make_train_step
    from multimodal_pl_tpu_torch.utils.prng import seedfix

    rank, world = (dp.rank, dp.world) if dp else (0, 1)
    say = print if rank == 0 else (lambda *a, **k: None)

    d, h, w = map(int, args.input_size.split(","))
    generator = seedfix(args.seed)
    impl = {True: "kernel", False: "plain"}
    scfg = StepConfig(
        num_classes=args.num_classes, num_epochs=args.num_epochs, deep_up=args.deep_up,
        augmask=args.augmask, weight_gan=args.weight_gan, momentum=args.momentum,
        weight_decay=args.weight_decay, pretrain_epoch=args.pretrain_epoch,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        conv_impl=impl[args.pallas_k2], gn_impl=impl[args.pallas_gn],
        train_refiner=args.train_refiner, weight_std=args.weight_std, base=args.model_base,
        layers=tuple(int(x) for x in args.model_layers.split(",")),
        refiner_filter=args.refiner_filter, disc_ndf=args.disc_ndf,
        disc_depth=args.disc_depth, remat=args.remat)
    state = create_train_state(generator, scfg)
    if args.reload_from_checkpoint:
        path = args.reload_path or latest_checkpoint(args.snapshot_dir)
        if path and os.path.exists(path):
            say(f"loading from checkpoint: {path}")
            state = restore_checkpoint(path)
        else:
            say(f"File not exists in the reload path: {args.reload_path}")
    state = state.to(device)
    model, refiner, disc = (m.to(device) for m in build_models(scfg))

    atlas = np.load(args.atlas_path) if os.path.exists(args.atlas_path) else None
    sup_csv = args.supervision_csv if os.path.exists(args.supervision_csv) else None
    train_ds = AMOSDataset(args.data_dir, crop_size=(d, h, w), usage="train", atlas=atlas,
                           supervision_csv=sup_csv, seed=args.seed, cache=args.cache_data)
    valid_ds = AMOSDataset(args.data_dir, crop_size=(d, h, w), usage="valid", atlas=atlas,
                           supervision_csv=sup_csv)
    say(f"{len(train_ds)} train / {len(valid_ds)} valid cases on {device}"
        + (f", rank 0 of {world}" if dp else ""))

    lcfg = LoopConfig(num_epochs=args.num_epochs, batch_size=args.batch_size,
                      learning_rate=args.learning_rate, power=args.power,
                      val_every=args.val_pred_every, snapshot_dir=args.snapshot_dir,
                      start_epoch=args.start_epoch, stop_epoch=args.stop_epoch,
                      tile=(d, h, w), num_classes=args.num_classes)
    device_pipe = None
    if args.device_data != "false":
        try:
            device_pipe = DeviceDataPipeline(train_ds, compute_dtype=scfg.compute_dtype,
                                             seed=args.seed, device=device, rank=rank,
                                             world=world)
            say(f"device data pipeline: {len(train_ds)} cases resident on {device} "
                f"({device_pipe.images.nbytes / 1e6:.0f} MB images)")
        except ValueError as e:
            if args.device_data == "true":
                raise
            say(f"device data pipeline unavailable ({e}); using host path")
    if dp:
        from multimodal_pl_tpu_torch.parallel.sharded_step import make_sharded_train_step

        step_fn = make_sharded_train_step(model, refiner, disc, scfg, dp.group)
    else:
        step_fn = make_train_step(model, refiner, disc, scfg)
    return train_loop(state, step_fn, model, train_ds, valid_ds, scfg, lcfg, device,
                      log_every=args.log_every, device_pipe=device_pipe, rank=rank,
                      world=world)


if __name__ == "__main__":
    main()
