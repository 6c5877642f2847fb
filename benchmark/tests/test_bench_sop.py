"""The SoP cell ``usair_sop.prep`` at a tiny size on the CPU, the program's
SpMM in its plain version: what its result line holds, traced and
untraced, beyond the cases every cell runs (``test_bench_cells_by_kind.py``:
agreement, control, planted faults); the kept rows' reservoir. Also the
SoP yardstick alone: ``reference_sop`` and ``workmodel_sop`` load nothing
of the program, the work model's counts on a hand-built graph, and the two
readers."""
import os

import numpy as np
import pytest

from benchmark import spec, workmodel, workmodel_sop
from benchmark.cellbase import TraceContext, make_inputs
from benchmark.kinds.sop_prep import Run
from benchmark.run import run_cell
from benchmark.tests.test_bench_imports import PROGRAM, _imports
from benchmark.tests.tiny import BENCH
from benchmark.tests.tiny_sop import make_tiny_sop
from benchmark.trace import Profile

CELL = "usair_sop.prep"
SEED = 2**33 + 5


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny_sop(str(tmp_path_factory.mktemp("tiny_sop")))


def run(tiny, traced=False, control=False):
    root, bench = tiny
    return run_cell(CELL, SEED, 0.3, traced, root=root, bench_dir=bench, device="cpu",
                    control=control)


def test_an_untraced_run_reports_its_metrics_and_every_row_kept(tiny):
    result, _ = run(tiny, control=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"prep_links_per_s", "setup_s"}
    assert result["checks"]["row_mask_wrong"]["value"] == 0.0
    assert result["checks"]["control_ops_gap"]["value"] > \
        result["checks"]["control_ops_gap"]["limit"]


def test_a_traced_run_counts_the_batches_of_its_profiled_units(tiny):
    from s3grl_tpu_torch.operators.sop import sop_batch_size

    root, bench = tiny
    result, _ = run(tiny, traced=True)
    assert result["correct"], result["checks"]
    # No card, no device trace: the roofline is left out; the counters read.
    assert "bsr_spmm_roofline" not in result["metrics"]
    cell = spec.load_cell(CELL, root, bench_dir=bench)
    inp = make_inputs(cell.config, SEED)
    bs = sop_batch_size(inp.n, inp.split.observed.shape[1])
    sizes = [len(inp.split.links(("train", "valid", "test")[i % 3])[0])
             for i in range(cell.traffic["trace_units"])]
    want = sum(sizes) / sum(-(-s // bs) for s in sizes)
    assert result["metrics"]["sop.links_per_batch"]["value"] == pytest.approx(want)


def test_the_reservoir_keeps_check_max_rows_drawn_fairly():
    kept = np.zeros(200)
    for seed in range(300):
        r = Run({"sop": {"sign_type": "SoP", "optimize_sign": True, "sign_k": 1}},
                {"source": "splits", "check_max": 4}, {}, seed, None)
        r.rng = np.random.default_rng(seed)
        for i in range(200):
            r._offer((i, None, None))
        assert len(r.checked) == 4 and r.offered == 200
        kept[[row[0] for row in r.checked]] += 1
    # Each of 200 rows is kept with chance 4/200: 6 of 300 draws on average.
    assert kept[:100].sum() == pytest.approx(kept[100:].sum(), rel=0.25)


@pytest.mark.parametrize("name", ["reference_sop.py", "workmodel_sop.py"])
def test_the_sop_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in set(_imports(os.path.join(BENCH, name)))


def test_sop_work_counts_the_formulation_not_the_batches():
    # A triangle 0-1-2 and a pendant 3 on 2, both orientations: 8 nonzeros.
    edges = np.array([[0, 1, 1, 2, 0, 2, 2, 3], [1, 0, 2, 1, 2, 0, 3, 2]])
    assert workmodel_sop.nonzeros(4, np.concatenate([edges, edges], axis=1)) == 8
    assert workmodel_sop.spmm_work(8, 4, 5) == (8 * 8 + 4 * 5 + 2 * 4 * 4 * 5, 2 * 8 * 5)
    n_bytes, flops = workmodel_sop.sop_work(8, 4, features=5, sign_k=3, call_links=[6, 1])
    parts = [workmodel_sop.spmm_work(8, 4, c) for c in (5, 12, 5, 2)]
    assert n_bytes == 3 * sum(b for b, _ in parts) and flops == 3 * sum(f for _, f in parts)


def test_bsr_spmm_roofline_reads_the_csr_kernels_alone():
    peaks = workmodel.PEAKS["NVIDIA H100 80GB HBM3"]
    prof = Profile(wall_s=1.0, busy_s=1.0, device_s={
        "void (anonymous namespace)::csr_spmm_kernel<4, 1, true>(int const*)": 0.5,
        "void (anonymous namespace)::pos_xpass_kernel<2>(int)": 9.0})
    read = spec.reader("bsr_spmm_roofline")
    ctx = TraceContext(profile=prof, peaks=peaks, work={"bsr_spmm": (3.35e12 * 0.1, 0.0)})
    assert read(ctx) == pytest.approx(20.0)
    ctx.profile = Profile(wall_s=1.0, busy_s=1.0, device_s={"spmm_edge_kernel": 1.0})
    assert read(ctx) is None  # the edge-list route launches no csr_spmm kernel


@pytest.mark.parametrize("counts,want", [
    ({"sop.links": 7914, "sop.batches": 4}, 1978.5), ({}, None),
    ({"pos.links": 5}, None), ({"sop.links": 0, "sop.batches": 0}, None)])
def test_links_per_batch_reads_the_traced_counts(counts, want):
    # The parent program keeps no sop.* counters: nothing to read, no raise.
    assert spec.reader("sop.links_per_batch")(TraceContext(counts=dict(counts))) == want
