"""``mpl-preprocess-torch``: offline preprocessing (reference
preprocess/forward_crop.py as a script), the port's copy of ``mpl-preprocess``
with the same flags, defaults and printed lines.

Orientation -> spacing (1,1,2) -> label-extent crop -> body-mask crop ->
MRI hand-removal, writing preprocessed NIfTI pairs. Host work in numpy and
scipy (``data/preprocess.py``), as in the JAX package: it uses no GPU and
takes no ``--device``.

    mpl-preprocess-torch --images_dir RAW/imagesTr --labels_dir RAW/labelsTr \
        --out_images DATA/imagesTr --out_labels DATA/labelsTr [--only_case ID]
"""

from __future__ import annotations

import argparse
import glob
import os


def get_arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="offline AMOS preprocessing")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--labels_dir", default="", help="default: images_dir with images->labels")
    p.add_argument("--out_images", required=True)
    p.add_argument("--out_labels", required=True)
    p.add_argument("--only_case", type=int, default=-1)
    return p


def main(argv=None):
    args = get_arguments().parse_args(argv)

    from multimodal_pl_tpu_torch.data.dataset import case_id_of
    from multimodal_pl_tpu_torch.data.preprocess import preprocess_case

    labels_dir = args.labels_dir or args.images_dir.replace("images", "labels")
    files = sorted(glob.glob(os.path.join(args.images_dir, "*.nii.gz")))
    print(f"Totally {len(files)} files.")
    for idx, f in enumerate(files):
        cid = case_id_of(f)
        if args.only_case >= 0 and cid != args.only_case:
            continue
        label_path = os.path.join(labels_dir, os.path.basename(f).replace("_0000", ""))
        out_img = os.path.join(args.out_images, os.path.basename(f))
        out_lab = os.path.join(args.out_labels, os.path.basename(label_path))
        pre, post = preprocess_case(f, label_path, out_img, out_lab, cid)
        print(f"[{idx}] amos_{cid:04d}: {pre} -> {post}")


if __name__ == "__main__":
    main()
