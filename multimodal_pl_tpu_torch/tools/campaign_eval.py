"""Held-out evaluation of a partial-label campaign checkpoint: the
counterpart of ``scripts/campaign_eval.py``.

Full-volume sliding-window inference over the ``valid`` and ``test`` splits
of a campaign root (``tools/campaign.py``), per-organ dice bucketed by
modality (case id < 500 is CT, >= 500 MRI: the dataset's rule), and the
per-case unsupervised-organ means: in training each CT case supervised one
organ and each MRI case none, so the other organs' dice measures what the
refiner, atlas consistency and GAN terms taught the model. Each table is
given under two decision rules: the argmax, and the reference's
atlas-blended threshold ``(p + 0.15) > (1 - atlas)`` (evaluate_amos.py:146).

    python -m multimodal_pl_tpu_torch.tools.campaign_eval [eval] --root ROOT [--ckpt STEP] [--plain]
    python -m multimodal_pl_tpu_torch.tools.campaign_eval best --root ROOT [--plain]

``eval`` reads ``ckpt_<STEP>`` (the latest without ``--ckpt``) of either
trainer: the port's ``ckpt_<step>.pt`` or a JAX orbax ``ckpt_<step>/``
(``convert.read_checkpoint``). ``best`` reads the loop's validation records
(``val/val_dice_ct_mean`` in the snapshot directory's ``train.jsonl``) and
evaluates the checkpoint at the ct_mean peak, the rule the JAX record
chose its checkpoint by, and the final one. The model runs the hand-written
kernels on bf16 tiles (the port's serving route); ``--plain`` runs the
plain PyTorch versions in f32, what the JAX script computes without
``--bd``. It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

NUM_FG = 13


def _checkpoint(snapshot_dir: str, step: int) -> str:
    from multimodal_pl_tpu_torch.train.checkpoint import checkpoint_step, latest_checkpoint

    if not step:
        path = latest_checkpoint(snapshot_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {snapshot_dir}")
        return path
    for name in (f"ckpt_{step}.pt", f"ckpt_{step}"):
        if checkpoint_step(snapshot_dir, name) == step and os.path.exists(
                os.path.join(snapshot_dir, name)):
            return os.path.join(snapshot_dir, name)
    raise FileNotFoundError(f"no checkpoint of step {step} in {snapshot_dir}")


def evaluate(root: str, snapshot_dir: str = "", ckpt: int = 0, tile=(64, 96, 96),
             plain: bool = False, device="cuda", keep_maps: bool = False,
             say=print, bf16=None) -> dict:
    """The held-out tables of one checkpoint (``ckpt``: its step; 0: the
    latest) by the kernels or the plain versions (``plain``), on bf16 tiles
    or f32 (``bf16``; default: bf16 for the kernels, f32 for the plain
    versions). Returns a dict: the checkpoint, the route, per case its id,
    split, modality, supervised organs and dice under both rules (with its
    argmax label map as uint8 numpy where ``keep_maps``), the CT and MRI
    per-organ means, the supervised mean, and under both rules the
    per-case unsupervised mean, the per-organ unsupervised dice and the
    number of organs above 0.3."""
    import torch

    from multimodal_pl_tpu_torch.cli.evaluate import resolve_device
    from multimodal_pl_tpu_torch.convert import load_feam_state_dict, read_checkpoint
    from multimodal_pl_tpu_torch.data.dataset import AMOSDataset
    from multimodal_pl_tpu_torch.infer.metrics import organ_scores, organ_scores_atlas
    from multimodal_pl_tpu_torch.infer.sliding import SlidingWindowPredictor
    from multimodal_pl_tpu_torch.models import UNet3DFEAM

    device = resolve_device(str(device))
    snap = snapshot_dir or os.path.join(root, "snapshots")
    path = _checkpoint(snap, ckpt)
    say(f"checkpoint: {path}")
    impl = "plain" if plain else "kernel"
    model = UNet3DFEAM(num_classes=NUM_FG + 1, weight_std=True, deep_up=True, conv_impl=impl,
                       gn_impl=impl)
    load_feam_state_dict(model, read_checkpoint(path))
    model = model.to(device).eval()
    bf16 = not plain if bf16 is None else bf16
    predictor = SlidingWindowPredictor(
        lambda tiles: model(tiles, aux=False), tuple(tile), NUM_FG + 1,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32, device=device)

    atlas = np.load(os.path.join(root, "atlas_mm.npy"))
    csvp = os.path.join(root, "supervise_mask.csv")
    cases = []
    for usage in ("valid", "test"):
        ds = AMOSDataset(os.path.join(root, "imagesTr"), crop_size=tuple(tile), usage=usage,
                         atlas=atlas, supervision_csv=csvp)
        for i in range(len(ds)):
            s = ds[i]
            with torch.inference_mode():
                logits = predictor(s.image[..., 0])
                label = torch.from_numpy(s.label)[None].to(logits.device)
                dice, _, _, pred = organ_scores(logits[None], label, NUM_FG)
                catlas = torch.from_numpy(s.catlas.transpose(1, 2, 3, 0))[None].to(
                    logits.device)
                dice_a = organ_scores_atlas(logits[None], label, catlas, NUM_FG)[0]
            dice, dice_a = dice.cpu().numpy(), dice_a.cpu().numpy()
            sup = np.asarray(s.sup_mask[1:]) > 0
            mod = "mri" if s.case_id >= 500 else "ct"
            case = {"case_id": int(s.case_id), "usage": usage, "modality": mod,
                    "supervised": sup.tolist(), "dice": dice.tolist(),
                    "dice_atlas": dice_a.tolist()}
            if keep_maps:
                case["label_map"] = pred[0].to(torch.uint8).cpu().numpy()
            cases.append(case)
            say(f"  case {s.case_id:04d} ({mod}, {usage}) mean {dice.mean():.3f} "
                f"sup {dice[sup].mean() if sup.any() else float('nan'):.3f} "
                f"unsup {dice[~sup].mean():.3f}")
    out = {"checkpoint": path, "route": f"{impl} {'bf16' if bf16 else 'f32'}",
           "cases": cases, **summarize(cases)}
    for mod in ("ct", "mri"):
        if out[f"{mod}_cases"]:
            say(f"{mod.upper()} ({out[f'{mod}_cases']} cases) mean dice "
                f"{np.mean(out[f'{mod}_per_organ']):.4f}")
            say("  per-organ: " + " ".join(f"{v:.3f}" for v in out[f"{mod}_per_organ"]))
    if out["sup_mean"] is not None:
        say(f"supervised-organ dice mean: {out['sup_mean']:.4f}")
    say(f"per-case-unsupervised organ dice mean: {out['unsup_mean']:.4f}")
    say("per-organ dice over cases where that organ was UNSUPERVISED:")
    say("  " + " ".join(f"{v:.3f}" for v in out["unsup_per_organ"]))
    say(f"  organs > 0.3: {out['unsup_organs_above']} / {NUM_FG}")
    say(f"[atlas-blended eval, (p+0.15)>(1-atlas), evaluate_amos.py:146] "
        f"unsupervised mean: {out['unsup_mean_atlas']:.4f}")
    say("  " + " ".join(f"{v:.3f}" for v in out["unsup_per_organ_atlas"]))
    say(f"  organs > 0.3: {out['unsup_organs_above_atlas']} / {NUM_FG}")
    return out


def summarize(cases) -> dict:
    """The tables of per-case records (``evaluate``'s ``cases``)."""
    out = {}
    for mod in ("ct", "mri"):
        rows = [c["dice"] for c in cases if c["modality"] == mod]
        out[f"{mod}_cases"] = len(rows)
        out[f"{mod}_per_organ"] = np.mean(rows, 0).tolist() if rows else None
    sup_vals = [d for c in cases for d, s in zip(c["dice"], c["supervised"]) if s]
    out["sup_mean"] = float(np.mean(sup_vals)) if sup_vals else None
    for key, suffix in (("dice", ""), ("dice_atlas", "_atlas")):
        vals, total, count = [], np.zeros(NUM_FG), np.zeros(NUM_FG)
        for c in cases:
            unsup = ~np.asarray(c["supervised"])
            d = np.asarray(c[key])
            vals.extend(d[unsup].tolist())
            total[unsup] += d[unsup]
            count[unsup] += 1
        per = total / np.maximum(count, 1)
        out[f"unsup_mean{suffix}"] = float(np.mean(vals))
        out[f"unsup_per_organ{suffix}"] = per.tolist()
        out[f"unsup_organs_above{suffix}"] = int((per > 0.3).sum())
    return out


def validation_curve(snapshot_dir: str) -> list:
    """The loop's validation records in ``snapshot_dir``/train.jsonl, one per
    epoch (the last where a resumed run repeated one): [(epoch, ct_mean,
    sup_dice_sum)] in epoch order."""
    curve = {}
    with open(os.path.join(snapshot_dir, "train.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if "val/val_dice_ct_mean" in r:
                curve[r["step"]] = (r["step"], r["val/val_dice_ct_mean"],
                                    r["val/val_dice_sup_sum"])
    return [curve[e] for e in sorted(curve)]


def best(root: str, snapshot_dir: str = "", batch_size: int = 3, **kw) -> dict:
    """``evaluate`` at the checkpoint of the validation ct_mean peak (the
    first epoch of the highest) and at the latest one. The peak epoch's
    checkpoint is step (epoch + 1) * steps per epoch (the loop writes one
    after each validation). Returns {"curve", "peak_epoch", "peak", "final"}."""
    from multimodal_pl_tpu_torch.tools.campaign import steps_per_epoch

    snap = snapshot_dir or os.path.join(root, "snapshots")
    say = kw.get("say", print)
    curve = validation_curve(snap)
    if not curve:
        raise ValueError(f"no validation record in {snap}/train.jsonl")
    epoch, ct_mean, sup_sum = max(curve, key=lambda r: (r[1], -r[0]))
    say(f"validation peak: epoch {epoch} ct_mean {ct_mean:.4f} sup_dice_sum {sup_sum:.4f}")
    step = (epoch + 1) * steps_per_epoch(root, batch_size)
    return {"curve": curve, "peak_epoch": epoch,
            "peak": evaluate(root, snap, step, **kw), "final": evaluate(root, snap, 0, **kw)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", choices=("eval", "best"), default="eval")
    p.add_argument("--root", default="campaign")
    p.add_argument("--snapshot_dir", default="", help="default: ROOT/snapshots")
    p.add_argument("--ckpt", type=int, default=0, help="eval: the step; 0 = latest")
    p.add_argument("--input_size", default="64,96,96", help="the tile, D,H,W")
    p.add_argument("--batch_size", type=int, default=3,
                   help="best: the training batch (steps per epoch)")
    p.add_argument("--plain", action="store_true",
                   help="the plain PyTorch versions in f32 instead of the kernels on bf16 tiles")
    p.add_argument("--device", default="cuda", help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--json", default="", help="also write the result (without label maps) here")
    args = p.parse_args(argv)
    kw = dict(tile=tuple(map(int, args.input_size.split(","))), plain=args.plain,
              device=args.device)
    if args.mode == "best":
        out = best(args.root, args.snapshot_dir, args.batch_size, **kw)
    else:
        out = evaluate(args.root, args.snapshot_dir, args.ckpt, **kw)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
