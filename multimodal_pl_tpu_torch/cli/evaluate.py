"""mpl-evaluate-torch — the evaluation CLI on PyTorch, port of
``multimodal_pl_tpu/cli/evaluate.py`` (flag-compatible with the reference
evaluate_amos.py).

Full-volume sliding-window prediction over a split of an AMOS-layout
dataset, a per-case dice CSV, per-organ CT/MRI tables, and optional NIfTI
prediction dumps. ``--reload_path`` takes a reference ``.pth`` or an
``.npz`` written by :func:`multimodal_pl_tpu_torch.convert.save_npz`;
comma-separated paths are an ensemble whose logits are averaged. A missing
checkpoint leaves the seeded random weights. ``--device`` (default
``cuda``) raises when there is no GPU; ``cpu`` runs only when asked for (the
conv kernel's plain version then runs).
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def resolve_device(name: str) -> torch.device:
    """The torch device for ``--device``: a CUDA device raises when no GPU is
    visible instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    return device


def get_arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="multimodal_pl_tpu_torch evaluator")
    # reference-compatible flags (evaluate_amos.py:54-88)
    p.add_argument("--data_dir", type=str, default="data/imagesTr")
    p.add_argument("--val_list", type=str, default="")
    p.add_argument("--reload_path", type=str, default="")
    p.add_argument("--reload_from_checkpoint", type=str2bool, default=True)
    p.add_argument("--save_path", type=str, default="outputs/")
    p.add_argument("--input_size", type=str, default="64,192,192")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_gpus", type=int, default=1)
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--FP16", type=str2bool, default=False)
    p.add_argument("--num_classes", type=int, default=14)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--weight_std", type=str2bool, default=True)
    p.add_argument("--print", dest="print_preds", type=str2bool, default=False)
    p.add_argument("--dataset_type", type=str, default="default")
    p.add_argument("--usage", type=str, default="test", choices=["test", "valid", "train"])
    # additions shared with mpl-evaluate
    p.add_argument("--atlas_path", type=str, default="atlas_mm.npy")
    p.add_argument("--tta", type=str2bool, default=False, help="8-way flip TTA")
    p.add_argument("--window_batch", type=int, default=4)
    p.add_argument("--use_atlas_threshold", type=str2bool, default=False,
                   help="atlas-blended decision rule (evaluate_amos.py:146)")
    p.add_argument("--deep_up", type=str2bool, default=True)
    p.add_argument("--bf16", type=str2bool, default=True,
                   help="bfloat16 tile compute (f32 Gaussian blend)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def _save_qualitative_png(save_path: str, sample, pred: np.ndarray) -> None:
    """Middle-slice image/label/prediction triptych (evaluate_amos.py:441-480)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    t = pred.shape[0] // 2
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    axes[0].imshow(sample.image[t, :, :, 0], cmap="gray")
    axes[1].imshow(sample.label[t], vmin=0, vmax=13, cmap="nipy_spectral")
    axes[2].imshow(pred[t], vmin=0, vmax=13, cmap="nipy_spectral")
    for ax in axes:
        ax.axis("off")
    fig.savefig(os.path.join(save_path, f"{sample.name}.png"), dpi=150, bbox_inches="tight")
    plt.close(fig)


def _load_members(args, device):
    """One model per comma-separated checkpoint path. Class tokens are not
    needed: with token_update='post' they feed only the attention maps."""
    from multimodal_pl_tpu_torch.convert import load_feam_state_dict, read_checkpoint
    from multimodal_pl_tpu_torch.models import UNet3DFEAM

    members = []
    for pth in [p for p in args.reload_path.split(",") if p] or [""]:
        model = UNet3DFEAM(num_classes=args.num_classes, weight_std=args.weight_std,
                           deep_up=args.deep_up,
                           generator=torch.Generator().manual_seed(1234))
        if args.reload_from_checkpoint and pth and os.path.exists(pth):
            print(f"loading from checkpoint: {pth}")
            load_feam_state_dict(model, read_checkpoint(pth))
        elif args.reload_from_checkpoint:
            print(f"File not exists in the reload path: {pth}")
        members.append(model.to(device).eval())
    return members


def main(argv=None):
    args = get_arguments().parse_args(argv)

    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.data.nifti import write_nifti
    from multimodal_pl_tpu_torch.infer.metrics import label_scores, organ_scores_atlas
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor

    device = resolve_device(args.device)
    d, h, w = map(int, args.input_size.split(","))
    nfg = args.num_classes - 1
    members = _load_members(args, device)

    def fwd(tiles):
        # logits only (aux=False): the EAMs and deep heads do not feed them
        out = sum(m(tiles, aux=False).float() for m in members)
        return out / len(members)

    atlas = np.load(args.atlas_path) if os.path.exists(args.atlas_path) else None
    use_atlas = args.use_atlas_threshold and atlas is not None
    predictor = SlidingWindowPredictor(
        fwd, (d, h, w), args.num_classes, window_batch=args.window_batch, tta=args.tta,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device,
        output="logits" if use_atlas else "argmax")

    ds = AMOSDataset(args.data_dir, crop_size=(d, h, w), usage=args.usage, atlas=atlas)
    print(f"{len(ds)} {args.usage} cases")

    os.makedirs(args.save_path, exist_ok=True)
    csv_path = os.path.join(args.save_path, "per_case_dice.csv")
    totals = {name: {"dice": np.zeros(nfg), "senc": np.zeros(nfg), "spec": np.zeros(nfg),
                     "cases": []} for name in ("CT", "MRI")}

    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["case"] + [f"organ{i}" for i in range(nfg)])
        pending: list = []

        def _volumes():
            for i in range(len(ds)):
                s = ds[i]
                pending.append(s)
                yield s.image[..., 0]

        for out in predictor.predict_iter(_volumes()):
            s = pending.pop(0)
            label = torch.from_numpy(s.label).to(device)[None]
            if use_atlas:
                catlas = torch.from_numpy(s.catlas).to(device).movedim(0, -1)[None]
                dice, senc, spec = organ_scores_atlas(out[None], label, catlas, nfg)
                pred = out.argmax(-1)
            else:
                pred = out
                dice, senc, spec = label_scores(pred[None], label, nfg)
            dice, senc, spec = (t.cpu().numpy() for t in (dice, senc, spec))
            writer.writerow([s.name] + [f"{x:.4f}" for x in dice])
            print(f"{s.name}: mean dice {dice.mean():.4f}")
            # CT/MRI bucket threshold (evaluate_amos.py:374)
            acc = totals["CT" if s.case_id < 507 else "MRI"]
            acc["dice"] += dice
            acc["senc"] += senc
            acc["spec"] += spec
            acc["cases"].append(dice)
            if args.print_preds:
                pred_np = pred.to(torch.uint8).cpu().numpy()
                write_nifti(os.path.join(args.save_path, f"{s.name}_pred.nii.gz"),
                            pred_np, (1, 1, 2))
                _save_qualitative_png(args.save_path, s, pred_np)

    for name, acc in totals.items():
        mean = acc["dice"] / max(len(acc["cases"]), 1)
        print(f"Sum results {name}")
        for t in range(nfg):
            print(f"Sum: Task{t}- Organ:{mean[t]:.4f}")
        print("mean_result", float(mean.mean()))
        if acc["cases"]:  # per-organ mean/std tables (evaluate_amos.py:507-508)
            arr = np.stack(acc["cases"])
            print(f"{name} per-organ mean: {np.round(arr.mean(0), 4).tolist()}")
            print(f"{name} per-organ std:  {np.round(arr.std(0), 4).tolist()}")
    print(f"per-case CSV: {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
