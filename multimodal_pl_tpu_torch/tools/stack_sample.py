"""Where a script's wall time goes, line by line: run SCRIPT as ``__main__``
(as ``python3 SCRIPT`` does) while a thread samples the main thread's stack
every ``period`` seconds and charges the time since the last sample to the
innermost frames of SCRIPT (up to three, innermost first) and to the
innermost frame of any file under SCRIPT's directory. Processes the script
spawns are not sampled: their time is charged to the line that waits for
them. From the repository root, e.g. on the card:

    python3 -m multimodal_pl_tpu_torch.tools.stack_sample chiprun_out/stacks.json chip_smoke.py

Writes OUT as JSON: ``total_s``, ``script`` and ``inner`` (lists of [frames,
seconds], largest first); exits with the script's exit code.
"""

from __future__ import annotations

import collections
import json
import os
import runpy
import sys
import threading
import time


def sample(script: str, argv=(), period: float = 0.5) -> tuple[int, dict]:
    """Run ``script`` with ``argv`` as ``__main__`` under the sampler.
    Returns (its exit code, the record written by :func:`main`)."""
    script = os.path.abspath(script)
    tree = os.path.dirname(script)
    by_script, by_inner = collections.Counter(), collections.Counter()
    main_id = threading.get_ident()
    done = threading.Event()

    def tick():
        last = time.perf_counter()
        while not done.wait(period):
            now = time.perf_counter()
            dt, last = now - last, now
            f = sys._current_frames().get(main_id)
            own, inner = [], None
            while f is not None:
                path = f.f_code.co_filename
                if inner is None and path.startswith(tree + os.sep):
                    inner = f"{os.path.relpath(path, tree)}:{f.f_code.co_name}:{f.f_lineno}"
                if path == script and len(own) < 3:
                    own.append(f"{f.f_code.co_name}:{f.f_lineno}")
                f = f.f_back
            by_script[" < ".join(own)] += dt
            by_inner[inner or "outside"] += dt

    thread = threading.Thread(target=tick, daemon=True)
    saved_argv, saved_path = sys.argv, list(sys.path)
    sys.argv, sys.path[0] = [script, *argv], tree
    t0 = time.perf_counter()
    thread.start()
    code = 0
    try:
        runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        done.set()
        thread.join()
        sys.argv, sys.path[:] = saved_argv, saved_path
    return code, {"total_s": time.perf_counter() - t0, "script": by_script.most_common(),
                  "inner": by_inner.most_common()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise SystemExit("usage: python3 -m multimodal_pl_tpu_torch.tools.stack_sample "
                         "OUT.json SCRIPT [ARGS...]")
    out, script, *rest = argv
    code, record = sample(script, rest)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=0)
    return code


if __name__ == "__main__":
    sys.exit(main())
