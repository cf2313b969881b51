"""``tools/stack_sample.py``: a script run as ``__main__`` under the sampler
keeps its exit code, and its wall time is charged to the line it waits on."""

import json

from multimodal_pl_tpu_torch.tools import stack_sample

SCRIPT = """import sys, time


def slow():
    time.sleep(1.5)


def quick():
    time.sleep(0.05)


if __name__ == "__main__":
    quick()
    slow()
    sys.exit(int(sys.argv[1]))
"""


def test_sampler_charges_the_waiting_line(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(SCRIPT)
    out = tmp_path / "out" / "stacks.json"
    assert stack_sample.main([str(out), str(script), "3"]) == 3
    rec = json.loads(out.read_text())
    (top, seconds), *_ = rec["script"]
    assert top == "slow:5 < <module>:14"
    assert 0.9 <= seconds <= rec["total_s"] <= 10
    assert rec["inner"][0][0] == "job.py:slow:5"
