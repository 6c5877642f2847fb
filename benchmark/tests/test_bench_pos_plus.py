"""The PoS Plus cell ``cora_pos_plus.prep`` at a tiny size on the CPU, the
program's kernels in their plain versions: the port agrees with the plain
reference by each number's limit, the control (the reference in TF32 in the
program's place) fails it, a traced run checks the same and reads the CCN
counters, and each fault the cell can have, planted under the timed path,
stops the run at set-up or, planted after it, fails the comparison. Also the PoS Plus yardstick alone: the reference,
the work model and the generators load nothing of the program, the work
model's CCN counts on a hand-built graph, the generators' invariants and
the reader ``prep.ccn_row_fill``."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import faults, faults_pos_plus, graphs_planetoid, spec, workmodel_pos_plus
from benchmark.cellbase import TraceContext
from benchmark.reference import RefGraph
from benchmark.run import run_cell
from benchmark.tests.test_bench_imports import PROGRAM, _imports
from benchmark.tests.tiny import BENCH, make_tiny

CELL = "cora_pos_plus.prep"
SEED = 2**33 + 5
# A graph of 60 nodes whose train split's most common neighbours (5) lie
# above half its CCN width (8), so that halving the width drops rows.
SMALL = {"graph": {"n": 60, "n_undirected": 110, "alpha": 1.5, "p_triad": 0.5},
         "features": {"columns": 12, "mean_words": 4.0},
         "pos": {"buckets": [32, 64, 128], "max_subgraph_nodes": 128}}


def make_tiny_pos_plus(dest: str) -> tuple[str, str]:
    """``tiny.make_tiny(dest)``, then ``cora_pos_plus`` cut to :data:`SMALL`."""
    root, bench = make_tiny(dest)
    path = os.path.join(bench, "configs", "cora_pos_plus.json")
    with open(path) as f:
        config = json.load(f)
    for key, fields in SMALL.items():
        config[key].update(fields)
    with open(path, "w") as f:
        json.dump(config, f)
    return root, bench


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_pos_plus(str(tmp_path_factory.mktemp("tiny_pos_plus")))


def run(tiny, traced=False, control=False):
    root, bench = tiny
    return run_cell(CELL, SEED, 0.3, traced, root=root, bench_dir=bench, device="cpu",
                    control=control)


def test_the_port_agrees_and_the_control_does_not(tiny):
    result, checks = run(tiny, control=True)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"prep_links_per_s", "setup_s"}
    assert result["checks"]["row_mask_wrong"]["value"] == 0.0
    ctl = result["checks"]["control_ops_gap"]
    assert ctl["value"] > ctl["limit"]


def test_a_traced_run_checks_the_same_and_reads_the_ccn_counters(tiny):
    from s3grl_tpu_torch.profiling import counters

    result, _ = run(tiny, traced=True)
    assert result["correct"], result["checks"]
    assert "breakdown" in result and "window_s" in result["device"]
    # No card, no device trace and no peaks: the shares are left out; the
    # counters read.
    assert "pos_power_rows_roofline" not in result["metrics"]
    c = counters()
    fill = result["metrics"]["prep.ccn_row_fill"]["value"]
    assert fill == pytest.approx(100.0 * c["pos.ccn.rows"] / c["pos.ccn.slots"])
    assert 0 < fill < 100
    assert {"prep.slot_fill", "prep.input_bytes_per_link"} <= set(result["metrics"])


FAULTS = [(faults_pos_plus, f) for f in faults_pos_plus.POS_PLUS] + \
    [(faults, f) for f in faults.PREP]


@pytest.mark.parametrize("module,fault", FAULTS)
def test_a_fault_planted_before_set_up_stops_the_run(tiny, module, fault, monkeypatch):
    getattr(module, fault)(monkeypatch)
    with pytest.raises(SystemExit, match="warm pass's rows fail their checks: (ops_gap|row_mask)"):
        run(tiny)


@pytest.mark.parametrize("module,fault", FAULTS)
def test_a_fault_planted_in_the_window_is_caught(tiny, module, fault, monkeypatch):
    root, bench = tiny
    cell = spec.load_cell(CELL, root, bench_dir=bench)
    r = spec.kind_module(cell.kind).Run(cell.config, cell.traffic, cell.limits, SEED,
                                        torch.device("cpu"))
    r.setup()
    getattr(module, fault)(monkeypatch)
    r.window(0.3)
    r.release()
    assert not all(c.ok for c in r.check()) and r.failed > 0


def test_the_cell_is_found_by_name():
    from benchmark.tests.tiny import ROOT

    cell = spec.load_cell(CELL, ROOT)
    assert cell.kind == "pos_plus_prep" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"prep_links_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "prep.device_idle", "prep.mfu", "pos_power_rows_roofline", "prep.slot_fill",
        "prep.selector_sm_fill", "prep.input_bytes_per_link", "prep.ccn_row_fill"}


@pytest.mark.parametrize("name", ["reference_pos_plus.py", "workmodel_pos_plus.py",
                                  "graphs_planetoid.py"])
def test_the_pos_plus_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in set(_imports(os.path.join(BENCH, name)))


def test_ccn_sizes_count_the_kept_first_hop():
    # 0-1 linked; 2, 3 and 4 neighbours of both; 5 of 0 alone; 6 of 1 alone.
    und = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (0, 4), (1, 4), (0, 5), (1, 6)]
    src = [a for a, b in und] + [b for a, b in und]
    dst = [b for a, b in und] + [a for a, b in und]
    g = RefGraph(7, np.array([src, dst]), np.zeros((7, 1), np.float32), "cpu")
    links = np.array([[0, 1], [2, 3], [5, 6]])
    inter = workmodel_pos_plus.ccn_sizes(g, links, strategy="intersection", max_nodes=64)
    union = workmodel_pos_plus.ccn_sizes(g, links, strategy="union", max_nodes=64)
    assert inter.tolist() == [3, 2, 0] and union.tolist() == [5, 2, 2]
    # Kept: s, d and the first 2 of the first hop by id (2, 3).
    assert workmodel_pos_plus.ccn_sizes(g, links[:1], strategy="union", max_nodes=4).tolist() \
        == [2]
    w = {"members": np.array([7, 4]), "entries": np.array([16, 6])}
    n_bytes, flops = workmodel_pos_plus.pos_plus_work(w, inter[:2], features=3, sign_k=2)
    rows = np.array([5.0, 4.0])
    assert n_bytes == 4 * 22 + 4 * 3 * 11 + 4 * 3 * 4 * rows.sum()
    assert flops == 2 * (2 * (rows * [16, 6]).sum() + 2 * 4 * (rows * [7, 4]).sum())


def test_the_generators_keep_their_invariants():
    ei = graphs_planetoid.holme_kim_edges(3, 200, 380, 1.08, 0.3)
    assert ei.shape == (2, 760) and (ei[0] != ei[1]).all()
    keys = set(zip(ei[0].tolist(), ei[1].tolist()))
    assert len(keys) == 760 and all((b, a) in keys for a, b in keys)
    x = graphs_planetoid.bag_of_words(4, 300, 50, 6.0, 0.5)
    nnz = (x > 0).sum(axis=1)
    assert (nnz >= 1).all() and np.allclose(x.sum(axis=1), 1.0)
    assert np.allclose(x[x > 0], np.repeat(1.0 / nnz, nnz))
    with pytest.raises(ValueError):
        graphs_planetoid.holme_kim_edges(3, 200, 500, 1.08, 0.3)


@pytest.mark.parametrize("counts,want", [
    ({"pos.ccn.rows": 3, "pos.ccn.slots": 48}, 6.25), ({}, None), ({"pos.slots": 5}, None)])
def test_ccn_row_fill_reads_the_programs_counters(monkeypatch, counts, want):
    from s3grl_tpu_torch import profiling

    # The parent program keeps no pos.ccn.* counters: nothing to read, no raise.
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert spec.reader("prep.ccn_row_fill")(TraceContext()) == want
