"""Whether a backend takes point-to-point sends of CUDA tensors, for the
halo exchange of the H-split (``--mesh space:N``) forward.

``SpatialGroup.halo_rows`` gathers every rank's boundary rows with one
``all_gather``, a collective that NCCL and gloo both take on CUDA tensors;
each rank receives N pairs of rows where it needs its two neighbours', so
the traffic grows with N. A neighbour exchange by ``batch_isend_irecv``
would receive two at any N. This script spawns ranks that send one full-
resolution boundary row of a 4-tile batch (4 x 64 x 1 x 192 x 32 bf16, 1.6
MB) to each neighbour (``tools/spawn.py`` ``sp_sendrecv``), and reports
whether the rows arrived or what the backend raised, beside the time of the
``all_gather`` of the same rows. Run from the repository root:

    PYTHONPATH=. python3 multimodal_pl_tpu_torch/tools/halo_p2p.py [--device cpu] [--world N] [OUTDIR]

On the card, two gloo ranks share ``cuda:0`` (two NCCL ranks cannot share
one card). The result also goes to ``OUTDIR/halo_p2p.json`` (default
``chiprun_out``).
"""

from __future__ import annotations

import argparse
import json
import os

ROW = (4, 64, 1, 192, 32)


def main(argv=None) -> dict:
    from multimodal_pl_tpu_torch.tools import spawn

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("outdir", nargs="?", default="chiprun_out")
    args = p.parse_args(argv)
    try:
        ranks = spawn.run(spawn.sp_sendrecv, args.world, ROW, args.device, backend="gloo",
                          timeout=120)
        result = {"backend": "gloo", "device": args.device, "world": args.world,
                  "row_shape": list(ROW), "ranks": ranks}
    except Exception as e:  # noqa: BLE001 - a rank that died is the answer too
        result = {"backend": "gloo", "device": args.device, "world": args.world,
                  "row_shape": list(ROW), "error": f"{type(e).__name__}: {e}"}
    print(json.dumps(result), flush=True)
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "halo_p2p.json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
