"""``mpl-atlas-torch``: asset bootstrap (reference setup.py +
preprocess/atlas_gen_mm.py), the port's copy of ``mpl-atlas`` with the same
flags, defaults and printed lines: generates the organ-probability atlas and
the supervision-mask csv. Host work in numpy and scipy
(``data/atlas.generate_atlas``, ``data/supervision``), as in the JAX
package: it uses no GPU and takes no ``--device``.

    mpl-atlas-torch --labels_dir DATA/labelsTr [--out_atlas atlas_mm.npy] \
        [--out_csv supervise_mask.csv] [--num_fg 13] [--sigma 3.0]
"""

from __future__ import annotations

import argparse
import glob
import os


def get_arguments() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="generate atlas_mm.npy + supervise_mask.csv")
    p.add_argument("--labels_dir", required=True)
    p.add_argument("--out_atlas", default="atlas_mm.npy")
    p.add_argument("--out_csv", default="supervise_mask.csv")
    p.add_argument("--num_fg", type=int, default=13)
    p.add_argument("--sigma", type=float, default=3.0)
    return p


def main(argv=None):
    args = get_arguments().parse_args(argv)

    from multimodal_pl_tpu_torch.data.atlas import generate_atlas
    from multimodal_pl_tpu_torch.data.dataset import case_id_of
    from multimodal_pl_tpu_torch.data.supervision import generate_supervision_csv

    files = sorted(glob.glob(os.path.join(args.labels_dir, "*.nii.gz")))
    ids = [case_id_of(f) for f in files]
    generate_supervision_csv(ids, args.out_csv)
    print(f"wrote {args.out_csv} ({len(ids)} cases)")

    atlas = generate_atlas(args.labels_dir, args.out_atlas, num_fg=args.num_fg,
                           sigma=args.sigma)
    print(f"wrote {args.out_atlas} shape={atlas.shape}")


if __name__ == "__main__":
    main()
