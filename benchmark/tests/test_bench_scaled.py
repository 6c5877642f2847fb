"""The ScaLed PoS Plus cell ``cora_pos_plus_scaled.prep`` at a tiny size on
the CPU, the program's kernels in their plain versions: the cell is found
by name; the port agrees with the plain reference by each number's limit
and the control (the reference in TF32 in the program's place) fails it; a
traced run checks the same and reads the walk counters; and each fault the
cell can have, planted under the timed path, stops the run at set-up or,
planted after it, fails the comparison. Also the ScaLed yardstick alone:
the reference and the work model load nothing of the program, the work
model counts a hand-built walk subgraph, and the reader
``prep.walk_mask_per_member``."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import faults, faults_scaled, reference_scaled, spec, workmodel_scaled
from benchmark.cellbase import TraceContext
from benchmark.reference import RefGraph
from benchmark.run import run_cell
from benchmark.tests.test_bench_imports import PROGRAM, _imports
from benchmark.tests.tiny import BENCH, make_tiny

CELL = "cora_pos_plus_scaled.prep"
SEED = 2**33 + 5
# A graph of 60 nodes, walks that visit a good part of it, and CCN rows on
# most train links.
SMALL = {"graph": {"n": 60, "n_undirected": 110, "alpha": 1.5, "p_triad": 0.5},
         "features": {"columns": 12, "mean_words": 4.0},
         "pos": {"buckets": [32, 64, 128], "max_subgraph_nodes": 128}}


def make_tiny_scaled(dest: str) -> tuple[str, str]:
    """``tiny.make_tiny(dest)``, then ``cora_pos_plus_scaled`` cut to
    :data:`SMALL`."""
    root, bench = make_tiny(dest)
    path = os.path.join(bench, "configs", "cora_pos_plus_scaled.json")
    with open(path) as f:
        config = json.load(f)
    for key, fields in SMALL.items():
        config[key].update(fields)
    with open(path, "w") as f:
        json.dump(config, f)
    return root, bench


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_scaled(str(tmp_path_factory.mktemp("tiny_scaled")))


def run(tiny, traced=False, control=False, seed=SEED):
    root, bench = tiny
    return run_cell(CELL, seed, 0.3, traced, root=root, bench_dir=bench, device="cpu",
                    control=control)


def test_the_cell_is_found_by_name():
    from benchmark.tests.tiny import ROOT

    cell = spec.load_cell(CELL, ROOT)
    assert cell.kind == "scaled_prep" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"prep_links_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "prep.device_idle", "prep.mfu", "pos_power_rows_roofline", "prep.slot_fill",
        "prep.selector_sm_fill", "prep.input_bytes_per_link", "prep.ccn_row_fill",
        "prep.walk_mask_per_member"}
    p = cell.config["pos"]
    assert (p["m"], p["M"], p["k_heuristic"], p["k_node_set_strategy"]) == \
        (3, 20, 1, "intersection")


@pytest.mark.parametrize("seed", [SEED, 2**31 + 77])
def test_the_port_agrees_and_the_control_does_not(tiny, seed):
    result, checks = run(tiny, control=True, seed=seed)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"prep_links_per_s", "setup_s"}
    assert result["checks"]["row_mask_wrong"]["value"] == 0.0
    ctl = result["checks"]["control_ops_gap"]
    assert ctl["value"] > ctl["limit"]


def test_a_traced_run_checks_the_same_and_reads_the_walk_counters(tiny):
    from s3grl_tpu_torch.profiling import counters

    result, _ = run(tiny, traced=True)
    assert result["correct"], result["checks"]
    assert "breakdown" in result and "window_s" in result["device"]
    # No card, no device trace and no peaks: the shares are left out; the
    # counters read.
    assert "pos_power_rows_roofline" not in result["metrics"]
    c = counters()
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["prep.walk_mask_per_member"] == pytest.approx(
        c["pos.walks.mask_entries"] / c["pos.walks.members"])
    assert got["prep.slot_fill"] == pytest.approx(100.0 * c["pos.slots_used"] / c["pos.slots"])
    assert got["prep.ccn_row_fill"] == pytest.approx(100.0 * c["pos.ccn.rows"]
                                                     / c["pos.ccn.slots"])
    assert 0 < got["prep.slot_fill"] < 100 and 0 < got["prep.ccn_row_fill"] < 100
    assert got["prep.input_bytes_per_link"] > 0


FAULTS = [(faults_scaled, f) for f in faults_scaled.SCALED] + \
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


@pytest.mark.parametrize("name", ["reference_scaled.py", "workmodel_scaled.py"])
def test_the_scaled_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in set(_imports(os.path.join(BENCH, name)))


def test_walk_work_counts_a_hand_built_walk_subgraph():
    # A path 0-1-2-3 with 4 a neighbour of 0 and 1; 5 isolated. Walks of
    # one step from 0 and 1 visit 0, 1 and some of their neighbours.
    und = [(0, 1), (1, 2), (2, 3), (0, 4), (1, 4)]
    src = [a for a, b in und] + [b for a, b in und]
    dst = [b for a, b in und] + [a for a, b in und]
    g = RefGraph(6, np.array([src, dst]), np.zeros((6, 1), np.float32), "cpu")
    links = np.array([[0, 1], [5, 3]])
    seeds = reference_scaled.link_seeds(9, np.arange(2))
    w, ccn = workmodel_scaled.walk_work(g, links, seeds, rw_m=1, rw_M=8, strategy="intersection",
                                        max_ccn=32)
    members = reference_scaled.members(g, links, seeds, rw_m=1, rw_M=8)
    deg = np.bincount(src, minlength=6)
    for i, m in enumerate(members):
        inside = set(m.tolist())
        entries = sum(a in inside and b in inside for a, b in zip(src, dst))
        linked = tuple(links[i]) in und or tuple(links[i][::-1]) in und
        assert w["members"][i] == len(m)
        assert w["entries"][i] == entries - 2 * linked
        assert w["member_degree"][i] == deg[m].sum()
    # Link 0-1: 4 is their one common neighbour, a member once a walk from
    # 0 or 1 stepped on it; the isolated 5 walks nowhere, and 3's one step
    # reaches 2 alone.
    assert ccn[0] == int(4 in set(members[0].tolist())) and ccn[1] == 0
    assert members[1].tolist() == [5, 3, 2]
    _, union = workmodel_scaled.walk_work(g, links, seeds, rw_m=1, rw_M=8, strategy="union",
                                          max_ccn=1)
    assert union.tolist() == [1, 1]


@pytest.mark.parametrize("counts,want", [
    ({"pos.walks.mask_entries": 270_800, "pos.walks.members": 4_000}, 67.7), ({}, None),
    ({"pos.walks.mask_entries": 10}, None), ({"pos.slots": 5}, None)])
def test_walk_mask_per_member_reads_the_programs_counters(monkeypatch, counts, want):
    from s3grl_tpu_torch import profiling

    # The parent program keeps no pos.walks.* counters: nothing to read, no raise.
    monkeypatch.setattr(profiling, "counters", lambda: dict(counts))
    assert spec.reader("prep.walk_mask_per_member")(TraceContext()) == want
