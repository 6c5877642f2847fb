"""The port's native host graph core and the large-graph PoS route.

``s3grl_tpu_torch/native`` (a byte-identical ``graphcore.cpp``, its own
loader) against scipy and Python oracles and against the JAX package's
core where that one built; six concurrent builds; the host-extract route of
``precompute_pos`` (whole-split, per-batch and a table narrower than the
cap) bit for bit against the
device route, and within the kernel's bar (rtol 2e-3, atol 2e-4) against
the JAX host route; its threshold; the CCN width and its warning.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.native as jnative
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch import native
from tests.torch_port_helpers import one_torch_thread

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-3, atol=2e-4)


def _coo(rng, n, e):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return src, dst, rng.random(e).astype(np.float32)


def _jax_native():
    """The JAX package's native module where its library built, else None
    (its loader returns None where a concurrent build lost a race)."""
    return jnative if jnative.available() else None


def test_graphcore_is_the_jax_packages_byte_for_byte():
    with open(os.path.join(ROOT, "s3grl_tpu", "native", "graphcore.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "s3grl_tpu_torch", "native", "graphcore.cpp"), "rb") as f:
        assert f.read() == want


def test_build_csr_matches_scipy():
    import scipy.sparse as ssp

    rng = np.random.default_rng(0)
    n, e = 700, 5000
    src, dst, w = _coo(rng, n, e)
    rp, ci, wv = native.build_csr(src, dst, w, n, coalesce=True)
    ref = ssp.csr_matrix((w, (src, dst)), shape=(n, n))
    ref.sum_duplicates()
    ref.sort_indices()
    np.testing.assert_array_equal(rp, ref.indptr)
    np.testing.assert_array_equal(ci, ref.indices)
    np.testing.assert_allclose(wv, ref.data, atol=1e-5)
    jn = _jax_native()
    if jn is not None:
        for a, b in zip(jn.build_csr(src, dst, w, n, coalesce=True), (rp, ci, wv)):
            np.testing.assert_array_equal(a, b)


def test_padded_adjacency_matches_numpy_and_jax(monkeypatch):
    """The port's numpy table against a per-row oracle and against the JAX
    package's, by its native core and by its numpy route."""
    rng = np.random.default_rng(1)
    src, dst, _ = _coo(rng, 200, 900)
    ei = tgraph.to_undirected(np.stack([src, dst]))
    g = tgraph.Graph(edge_index=ei, num_nodes=200)
    nbr, nbr_w, deg = g.padded_adjacency()
    rp, ci, wv = g.csr
    D = nbr.shape[1]
    for u in range(200):
        k = min(rp[u + 1] - rp[u], D)
        assert deg[u] == k
        np.testing.assert_array_equal(nbr[u, :k], ci[rp[u]:rp[u] + k])
        np.testing.assert_array_equal(nbr_w[u, :k], wv[rp[u]:rp[u] + k])
        assert (nbr[u, k:] == u).all() and (nbr_w[u, k:] == 0).all()
    jx = [jgraph.Graph(edge_index=ei, num_nodes=200).padded_adjacency()]
    monkeypatch.setenv("S3GRL_TPU_NO_NATIVE", "1")
    jx.append(jgraph.Graph(edge_index=ei, num_nodes=200).padded_adjacency())
    for want in jx:
        for a, b in zip((nbr, nbr_w, deg), want):
            np.testing.assert_array_equal(a, b)


def test_bfs_sizes_match_python_bfs_and_the_device_pass():
    rng = np.random.default_rng(2)
    src, dst, _ = _coo(rng, 300, 1200)
    keep = src != dst
    ei = tgraph.to_undirected(np.stack([src[keep], dst[keep]]))
    g = tgraph.Graph(edge_index=ei, num_nodes=300)
    dg = text.DeviceGraph.from_graph(g, device="cpu")
    links = rng.integers(0, 300, (64, 2)).astype(np.int32)
    rp, ci, _ = g.csr
    got = native.bfs_sizes(rp, ci, links, 2)

    def py_bfs(s, d, hops):
        vis = {int(s), int(d)}
        fr = set(vis)
        for _ in range(hops):
            nxt = set()
            for u in fr:
                nxt.update(ci[rp[u]:rp[u + 1]].tolist())
            fr = nxt - vis
            vis |= fr
        return len(vis)

    want = np.array([py_bfs(a, b, 2) for a, b in links], dtype=np.int32)
    np.testing.assert_array_equal(got, want)
    jn = _jax_native()
    if jn is not None:
        np.testing.assert_array_equal(got, jn.bfs_sizes(rp, ci, links, 2))
    np.testing.assert_array_equal(tpos.measure_subgraph_sizes(dg, links, num_hops=2), want)


def test_khop_nodes_truncation_and_order():
    rng = np.random.default_rng(3)
    n = 120
    src, dst, _ = _coo(rng, n, 600)
    rp, ci, _ = native.build_csr(src, dst, None, n)
    links = rng.integers(0, n, (10, 2)).astype(np.int32)
    nodes, sizes = native.khop_nodes(rp, ci, links, 2, max_nodes=16)
    full_sizes = native.bfs_sizes(rp, ci, links, 2)
    small = full_sizes < 16
    np.testing.assert_array_equal(sizes[small], full_sizes[small])
    assert (sizes[~small] >= 16).all()
    adj = {u: [] for u in range(n)}
    for u, v in zip(src.tolist(), dst.tolist()):
        adj[u].append(v)
    for i, (s, d) in enumerate(links):
        seen = {int(s), int(d)}
        order = [int(s)] + ([int(d)] if d != s else [])
        frontier = list(order)
        for _ in range(2):
            ring = {v for u in frontier for v in adj[u] if v not in seen}
            seen |= ring
            frontier = sorted(ring)
            order += frontier
        kept = nodes[i][nodes[i] >= 0]
        assert len(kept) == min(sizes[i], 16)
        np.testing.assert_array_equal(kept, np.array(order[: len(kept)]))
    jn = _jax_native()
    if jn is not None:
        for a, b in zip(jn.khop_nodes(rp, ci, links, 2, max_nodes=16), (nodes, sizes)):
            np.testing.assert_array_equal(a, b)


def test_six_concurrent_builds_all_load_the_library(tmp_path):
    """Six processes that find no library build at once, each into a name
    of its own, and all load a whole one."""
    code = (
        "import sys, numpy as np\n"
        "import s3grl_tpu_torch.native as n\n"
        f"n.BUILD_DIR = {str(tmp_path)!r}\n"
        "rp, ci, _ = n.build_csr(np.array([0, 1], np.int32), np.array([1, 0], np.int32), None, 2)\n"
        "print(rp.tolist(), ci.tolist())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[0, 1, 2] [1, 0]"
    left = sorted(os.listdir(tmp_path))
    assert len(left) == 1 and left[0].startswith("graphcore_") and left[0].endswith(".so"), left


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with g++'s output and leaves no library."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-no-such-flag",))
    with pytest.raises(RuntimeError, match="native graph core build failed"):
        native.bfs_sizes(np.zeros(2, np.int32), np.zeros(0, np.int32), np.zeros((1, 2)), 1)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def _pos_graph(seed=11, n=80):
    """tests/test_native.py:132's graph in both packages."""
    rng = np.random.default_rng(seed)
    src, dst, _ = _coo(rng, n, 400)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    x = rng.normal(size=(n, 7)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(edge_index=ei, num_nodes=n, x=x))
    td = text.DeviceGraph.from_graph(tgraph.Graph(edge_index=ei, num_nodes=n, x=x), device="cpu")
    links = rng.integers(0, n, (40, 2)).astype(np.int32)
    links = links[links[:, 0] != links[:, 1]]
    return jd, td, links, np.ones(len(links), dtype=np.float32)


POS_KW = dict(num_hops=2, sign_k=3, buckets=(16, 32, 64), batch_size=8,
              max_subgraph_nodes=64, seed=3, k_heuristic=1,
              k_node_set_strategy="intersection", max_ccn=4)


# route -> (num_hops, the host table's width W as KHOP_TABLE_ENTRIES // L,
# or None for the constant's own). At one hop the sizes are 12-25 in buckets
# 16 and 32 (cap 64); at two all reach the cap.
TABLE_ROUTES = {
    "whole-split": (2, None),  # W = cap
    "per-batch": (2, 0),  # no table
    "partial-table": (1, 20),  # bucket 16 sliced, 32 whole rows padded or own passes
    "rows-below-width": (1, 28),  # every row ends below W < cap: Cora's shape
}


def _counting(monkeypatch) -> list:
    """Wrap ``native.khop_nodes`` and ``native.bfs_sizes``: the returned
    list gets (name, number of links) of each call."""
    calls = []
    for name in ("khop_nodes", "bfs_sizes"):
        def shim(*args, _fn=getattr(native, name), _name=name, **kw):
            calls.append((_name, len(args[2])))
            return _fn(*args, **kw)
        monkeypatch.setattr(native, name, shim)
    return calls


@pytest.mark.parametrize("route", sorted(TABLE_ROUTES))
def test_host_extract_route_equals_the_device_route(monkeypatch, route):
    """Bit for bit against the device route (the same node sets, order and
    operators), and within the kernel's bar against the JAX host route;
    with the whole-split table at a width below the cap, one pass over the
    split and ``bfs_sizes`` on the links it cut short alone."""
    jd, td, links, y = _pos_graph()
    hops, width = TABLE_ROUTES[route]
    kw = {**POS_KW, "num_hops": hops}
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "0")
    dev = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1")
    if width is not None:
        monkeypatch.setattr(tpos, "KHOP_TABLE_ENTRIES", width * len(links))
    if width:
        sizes = native.bfs_sizes(*td.host_csr(), links, hops)
        plan = tpos.pos_plan(td, links, **kw)
        served = [plan.reads_table(b, idx) for b, idx in plan.batches]
        # The smallest bucket's rows are sliced; some wider one's are padded.
        assert served[0] and any(s and b > width for (b, _), s in zip(plan.batches, served))
        calls = _counting(monkeypatch)
    host = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    assert tpos.host_extract_route(td, len(links), scaled=False, ratio_per_hop=1.0,
                                   max_nodes_per_hop=None)
    torch.testing.assert_close(host.row_mask, dev.row_mask, rtol=0, atol=0)
    torch.testing.assert_close(host.xs, dev.xs, rtol=0, atol=0)
    if width:
        cut = int((sizes >= width).sum())
        own = [("khop_nodes", len(idx)) for (_, idx), s in zip(plan.batches, served) if not s]
        assert calls == [("khop_nodes", len(links))] + [("bfs_sizes", cut)] * (cut > 0) + own
        if route == "partial-table":
            assert cut and own
        else:
            assert not cut and all(served)
    want = jpos.precompute_pos(jd, links, y, **kw)
    np.testing.assert_array_equal(np.asarray(want.row_mask), host.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.xs), host.xs.numpy(), **TOL)


def test_host_extract_threshold(monkeypatch):
    _, td, links, _ = _pos_graph()
    E = int(td.edge_src.shape[0])
    kw = dict(scaled=False, ratio_per_hop=1.0, max_nodes_per_hop=None)
    monkeypatch.delenv("S3GRL_TPU_HOST_EXTRACT", raising=False)
    assert not tpos.host_extract_route(td, 10, **kw)
    monkeypatch.setattr(tpos, "HOST_EXTRACT_MIN_LE", 10 * E)
    assert tpos.host_extract_route(td, 10, **kw)
    assert not tpos.host_extract_route(td, 9, **kw)
    assert not tpos.host_extract_route(td, 10, **{**kw, "scaled": True})
    assert not tpos.host_extract_route(td, 10, **{**kw, "ratio_per_hop": 0.5})
    assert not tpos.host_extract_route(td, 10, **{**kw, "max_nodes_per_hop": 3})
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "0")
    assert not tpos.host_extract_route(td, 10, **kw)


def _ccn_warning(w) -> str:
    """A "CCN width capped" warning up to its advice (" Raise ...")."""
    return str(w.message).split(" Raise ")[0]


@pytest.mark.parametrize("cap", [64, 3])
def test_ccn_width_gives_the_jax_width_and_warning(cap):
    """The exact maximum CCN count, or ``cap`` below it with the JAX
    package's warning."""
    jd, td, links, _ = _pos_graph(5, n=60)
    for strategy in ("union", "intersection"):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            want = jpos.measure_ccn_width(jd, links, strategy, cap)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            got = tpos.measure_ccn_width(td, links, strategy, cap)
        assert got == want
        # The same warnings, word for word (the pad percentile included) up
        # to the advice, which names the JAX package's switch.
        assert [_ccn_warning(w) for w in wt] == [_ccn_warning(w) for w in wj]
        if cap == 3 and strategy == "union":
            assert any("CCN width capped" in str(w.message) for w in wt)


@pytest.mark.parametrize("pct", ["100", "90"])
def test_ccn_pad_percentile_gives_the_jax_width_and_warning(pct, monkeypatch):
    """``operators/pos.CCN_PAD_PCT`` against the JAX package's
    ``S3GRL_TPU_CCN_PAD_PCT``: at 100 (the constant's value) the exact
    maximum and no warning; at 90 the 90th percentile of the counts, with
    the JAX package's "CCN width capped" warning word for word up to its
    advice; and PoS+'s padded width on top of it."""
    jd, td, links, _ = _pos_graph(5, n=60)
    assert tpos.CCN_PAD_PCT == 100
    monkeypatch.setenv("S3GRL_TPU_CCN_PAD_PCT", pct)
    monkeypatch.setattr(tpos, "CCN_PAD_PCT", int(pct))
    for strategy in ("union", "intersection"):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            want = jpos.measure_ccn_width(jd, links, strategy, 64)
        with warnings.catch_warnings(record=True) as wt:
            warnings.simplefilter("always")
            got = tpos.measure_ccn_width(td, links, strategy, 64)
        assert got == want
        assert [_ccn_warning(w) for w in wt] == [_ccn_warning(w) for w in wj]
        if strategy == "union":
            assert bool(wt) == (pct == "90")
        # PoS+'s width: rounded up to a power of two from 8, capped.
        r = 8
        while r < want:
            r *= 2
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert tpos.padded_ccn_width(td, links, strategy, 64) == min(64, r)
