"""SoP against the benchmark's plain reference (``benchmark/reference_sop.py``)
on the CPU: the reference equals ``reference_oracles.sop_oracle`` to float64
rounding; ``precompute_sop`` on both routes of ``should_use_bsr`` (the CSR
kernel's route, whose plain version runs here, and the edge list) agrees
with it within a float32 bar, and the same comparison fails that bar with
the reference in TF32 or with the [u,v] zeroing left out; and the spans and
counters of ``operators/sop.py`` are what the batch plan implies."""
import numpy as np
import pytest
import scipy.sparse as ssp
import torch
from torch.profiler import ProfilerActivity, profile

import s3grl_tpu_torch.operators.sop as tsop
from benchmark.cellbase import worst_relative_gap
from benchmark.reference import RefGraph
from benchmark.reference_sop import sop_rows
from s3grl_tpu_torch import profiling
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from tests.reference_oracles import sop_oracle
from tests.torch_port_helpers import one_torch_thread, random_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# The worst relative gap of a link's rows (the benchmark's ``ops_gap``)
# that float32 arithmetic leaves: each entry is a sum of at most a few
# hundred products (K <= 3 powers of rows with ~15 nonzeros, times 7
# features), so rounding at 2^-24 a step stays below ~1e-6 of the block's
# largest entry; TF32's 2^-11 on every operand reads ~1e-4 and more.
BAR = 1e-5


def _case(seed, n=60, e=200, f=7, n_links=23):
    """A random graph with normal features and links: half of them edges of
    the graph (their zeroed entry is non-zero from k = 1), half any pair."""
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=n, e=e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    some_edges = ei[:, rng.choice(ei.shape[1], n_links // 2, replace=False)].T
    pairs = rng.integers(0, n, (n_links - len(some_edges), 2))
    links = np.concatenate([some_edges, pairs]).astype(np.int64)
    return n, ei, x, links


@pytest.mark.parametrize("sign_k", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_equals_the_scipy_oracle(seed, sign_k):
    n, ei, x, links = _case(seed)
    got = sop_rows(RefGraph(n, ei, x, "cpu"), links, sign_k=sign_k).numpy()
    A = ssp.csr_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(n, n))
    for i, (s, d) in enumerate(links):
        x0, ops = sop_oracle(A, x.astype(np.float64), int(s), int(d), sign_k)
        want = np.stack([x0] + ops)
        np.testing.assert_allclose(got[i], want, rtol=1e-12, atol=1e-14)


def _zeroing_left_out(monkeypatch):
    """Plant the fault: each power's feature part is the whole row
    Â^k[u,:] · X = Y_k[u], the entry [u,v] not zeroed."""
    real = tsop._sop_batch

    def planted(propagate, x_global, ys, links, **kwargs):
        out = real(propagate, x_global, ys, links, **kwargs).clone()
        B, K = links.shape[0], ys.shape[0]
        out[:, 1:, :, 1:] = ys[:, links.reshape(-1)].reshape(K, B, 2, -1).transpose(0, 1)
        return out
    monkeypatch.setattr(tsop, "_sop_batch", planted)


def _program(monkeypatch, route, n, ei, x, links, sign_k, batch_size=0):
    monkeypatch.setattr(tsop, "should_use_bsr", lambda *a, **k: route == "csr")
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    y = np.zeros(len(links), np.float32)
    return tsop.precompute_sop(dg, links, y, sign_k=sign_k, batch_size=batch_size,
                               device="cpu")


@pytest.mark.parametrize("sign_k", [1, 2, 3])
@pytest.mark.parametrize("route", ["csr", "edges"])
def test_precompute_sop_agrees_with_the_reference(monkeypatch, route, sign_k):
    n, ei, x, links = _case(7)
    ds = _program(monkeypatch, route, n, ei, x, links, sign_k)
    want = sop_rows(RefGraph(n, ei, x, "cpu"), links, sign_k=sign_k).numpy()
    assert worst_relative_gap(ds.xs.numpy(), want) < BAR
    assert ds.row_mask.all()


@pytest.mark.parametrize("route", ["csr", "edges"])
@pytest.mark.parametrize("wrong", ["reference_in_tf32", "zeroing_left_out"])
def test_a_lower_precision_or_a_missing_zeroing_fails_the_bar(monkeypatch, wrong, route):
    n, ei, x, links = _case(7)
    g = RefGraph(n, ei, x, "cpu")
    want = sop_rows(g, links, sign_k=3).numpy()
    if wrong == "reference_in_tf32":
        got = sop_rows(g, links, sign_k=3, precision="tf32").numpy()
    else:
        _zeroing_left_out(monkeypatch)
        got = _program(monkeypatch, route, n, ei, x, links, 3).xs.numpy()
    assert worst_relative_gap(got, want) > BAR


def _sop_spans(prof):
    return [e for e in prof.events()
            if getattr(e, "is_user_annotation", False) and e.name.startswith("sop.")]


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("route", ["csr", "edges"])
def test_spans_and_counters_follow_the_batch_plan(monkeypatch, route):
    n, ei, x, links = _case(3)
    K, B, F = 3, 8, x.shape[1]
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _program(monkeypatch, route, n, ei, x, links, K, batch_size=B)
    after = profiling.counters()
    got = {k: after[k] - before.get(k, 0) for k in after
           if k.startswith("sop.") and after[k] != before.get(k, 0)}
    batches = -(-len(links) // B)
    calls = K + K * batches
    want = {"sop.calls": 1, "sop.links": len(links), "sop.batches": batches,
            "sop.spmm.calls": calls, "sop.spmm.cols": K * F + K * 2 * len(links)}
    if route == "csr":
        want["sop.spmm.csr_calls"] = calls
    assert got == want
    by = {}
    for e in _sop_spans(prof):
        by.setdefault(e.name, []).append(_ancestors(e))
    assert by == {"sop.precompute": [[]], f"sop.route/{route}": [["sop.precompute"]],
                  "sop.chain": [["sop.precompute"]],
                  "sop.batch": [["sop.precompute"]] * batches}, sorted(by)
