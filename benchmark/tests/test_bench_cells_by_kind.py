"""``test_bench_cells.py``'s three cases for every cell, with the planted
faults found by the cell's kind, so that a cell of a kind that file does
not know (``sop_prep``) runs them too: there ``KIND_FAULTS[kind]`` is
looked up while the file is collected, and a new kind stops it collecting.
Every cell's run at a tiny size on the CPU, the program's kernels in their
plain versions: the port agrees with the plain reference by each number's
limit; the control (the reference in TF32 in the program's place) fails
one of them; and each fault that the cell can have, planted under the
timed path, turns ``correct`` false."""
import pytest

from benchmark import faults, faults_sop, spec
from benchmark.run import run_cell
from benchmark.tests.tiny import ROOT, cells
from benchmark.tests.tiny_sop import make_tiny_sop

SEED = 2**33 + 5

# kind -> (the module that plants its faults, their names)
FAULTS = {"prep": (faults, faults.PREP), "score": (faults, faults.PREP),
          "fit": (faults, faults.PREP + faults.FIT), "sop_prep": (faults_sop, faults_sop.SOP)}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_sop(str(tmp_path_factory.mktemp("tiny_by_kind")))


def run(tiny, cell, traced=False, control=False):
    root, bench = tiny
    return run_cell(cell, SEED, 0.5, traced, root=root, bench_dir=bench, device="cpu",
                    control=control)


def test_every_kind_has_its_faults():
    assert {spec.load_cell(c, ROOT).kind for c in cells()} <= set(FAULTS)


@pytest.mark.parametrize("cell", cells())
def test_the_port_agrees_and_the_control_does_not(tiny, cell):
    result, checks = run(tiny, cell, control=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    ctl = [c for c in checks if c.name.startswith("control_")]
    assert ctl and not all(c.ok for c in ctl), result["checks"]


@pytest.mark.parametrize("cell", cells())
def test_a_traced_run_checks_the_same(tiny, cell):
    result, _ = run(tiny, cell, traced=True)
    assert result["correct"], result["checks"]
    assert "breakdown" in result and "window_s" in result["device"]


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in cells()
    for fault in FAULTS.get(spec.load_cell(cell, ROOT).kind, (None, ()))[1]])
def test_a_planted_fault_is_caught(tiny, cell, fault, monkeypatch):
    module = FAULTS[spec.load_cell(cell, ROOT).kind][0]
    getattr(module, fault)(monkeypatch)
    result, _ = run(tiny, cell)
    assert not result["correct"], result["checks"]
    if fault == "state_unchanged":
        assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
