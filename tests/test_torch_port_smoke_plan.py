"""The plan of ``chip_smoke.py``, read from its source with ``ast`` (no GPU,
nothing imported): every ``phase_*`` function the script defines is reached
from ``run_phases``, directly or through the functions it calls or names,
and ``run_phases`` closes its stages with ``phase_done`` under these names,
in this order. A change that adds or renames a stage updates STAGES."""

import ast
import os

import pytest

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "chip_smoke.py")
STAGES = ["build", "serving kernels", "serving", "training kernels", "train step",
          "train entry point", "production step", "production entry point", "profile",
          "data parallel", "ablations", "spatial serving", "campaign", "spatial train step",
          "raw NIfTI to label maps", "step ladder", "flip TTA and ensembles"]


@pytest.fixture(scope="module")
def functions():
    with open(SCRIPT) as f:
        tree = ast.parse(f.read(), SCRIPT)
    return {node.name: node for node in tree.body if isinstance(node, ast.FunctionDef)}


def _names(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def test_every_phase_function_is_reached_from_run_phases(functions):
    seen, todo = set(), ["run_phases"]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        todo += [n for n in _names(functions[name]) if n in functions]
    phases = sorted(n for n in functions if n.startswith("phase_"))
    assert len(phases) >= 27
    assert [n for n in phases if n not in seen] == []


def test_run_phases_closes_the_stages_in_order(functions):
    done = [call for call in ast.walk(functions["run_phases"])
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
            and call.func.id == "phase_done"]
    assert all(len(c.args) == 1 and isinstance(c.args[0], ast.Constant) for c in done)
    assert [c.args[0].value for c in sorted(done, key=lambda c: c.lineno)] == STAGES
