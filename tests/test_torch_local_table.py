"""The local-table PoS route: tables built by ``ops/local_table`` (its plain
version on the CPU), ``pos_operators_local`` and the route in
``precompute_pos``.

- ``local_table_reference`` against the native host table builds, the port's
  ``native.khop_local_tab`` and the JAX package's, on the same node sets.
  Both host builds list a row's entries in the order of the CSR that
  ``native.build_csr`` sorts by (row, column), and ``Graph.padded_adjacency``
  (whose order the card's table keeps) takes its rows from a CSR sorted
  the same way. So the two orders agree here and the tables are held equal
  exactly, entry for entry; the ``mdeg`` values are equal.
- The local route against the global route bit for bit (``rtol=0,
  atol=0``), PoS and PoS+ with union and intersection CCN, as
  ``tests/test_pos_pallas.py:105-155`` holds the JAX pair; against the JAX
  ``pos_operators_local`` fed the JAX native table, and the JAX
  ``precompute_pos`` under ``S3GRL_TPU_LOCAL_TAB=1``, within the kernel's bar
  (rtol 2e-3, atol 2e-4; ``tests/test_pos_pallas.py:37-39``), row masks
  equal.
- ``auto`` keeps the USAir-like main path on the global route.
"""
import jax.numpy as jnp
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
from s3grl_tpu_torch.ops import local_table as lt
from s3grl_tpu_torch.ops import pos_kernel
from s3grl_tpu_torch.ops.pos_kernel import (
    pos_power_rows,
    pos_power_rows_reference,
    pos_selector_rows,
    pos_selector_rows_reference,
)
from tests.test_torch_jax_native_build import build_the_jax_native_core_once
from tests.torch_port_helpers import (
    blogcatalog_like_edges,
    one_torch_thread,
    random_edges,
    usair_like_edges,
)

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=2e-3, atol=2e-4)
CCN = [(0, ""), (4, "union"), (4, "intersection")]
CCN_IDS = ["PoS", "PoS+union", "PoS+intersection"]


def _hub_narrow_edges(seed: int = 3, n: int = 300):
    """One wide hub (node 0, joined to every third node) beside narrow local
    degrees (a ring and a few random chords)."""
    rng = np.random.default_rng(seed)
    ring = np.stack([np.arange(1, n), np.r_[np.arange(2, n), 1]])
    chords = rng.integers(1, n, (2, n // 4))
    hub = np.stack([np.zeros(n // 3, np.int64), np.arange(1, n, 3)])
    e = np.concatenate([ring, chords, hub], axis=1)
    e = e[:, e[0] != e[1]].astype(np.int32)
    return tgraph.to_undirected(e)


GRAPHS = {
    "usair-like": lambda: usair_like_edges(2, n=200),
    "blogcatalog-like": lambda: blogcatalog_like_edges(1, n=400, n_undirected=4_000),
    "hub-narrow": _hub_narrow_edges,
}


def _graphs(name, f=6, seed=0):
    """(jax DeviceGraph, port DeviceGraph on the CPU, observed links [24, 2],
    rng) of one of GRAPHS with normal features."""
    ei = GRAPHS[name]()
    n = int(ei.max()) + 1
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei, x=x),
                                     device="cpu")
    links = ei[:, rng.choice(ei.shape[1], 24, replace=False)].T.astype(np.int32)
    return jd, td, links, rng


def _node_sets(td, links, hops, S):
    """The host BFS's node sets: (nd [B, S] with -1 pads, nodes, mask)."""
    nd, _ = native.khop_nodes(*td.host_csr(), links, hops, S)
    return nd, torch.as_tensor(np.where(nd >= 0, nd, 0)), torch.as_tensor(nd >= 0)


@pytest.fixture(scope="module")
def jax_native():
    assert build_the_jax_native_core_once(), "the JAX package's native core did not build"
    return jnative


# (hops, S): 1 and 2 hops, in buckets that truncate some subgraphs.
HOPS_S = [(1, 16), (1, 64), (2, 32), (2, 128)]


@pytest.mark.parametrize("hops,S", HOPS_S, ids=[f"{h}hop-S{s}" for h, s in HOPS_S])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_local_table_reference_equals_the_native_tables(graph, hops, S, jax_native):
    _, td, links, _ = _graphs(graph)
    nd, nodes, mask = _node_sets(td, links, hops, S)
    d_cap = min(S, int(td.nbr.shape[1]))
    W = tpos.local_table_width(td, S)
    assert not td.repeats_a_neighbor() and W == lt.table_width(d_cap)
    loc = lt.local_table_reference(td.nbr, td.degrees(), nodes, mask, torch.as_tensor(links),
                                   W)
    mdeg = (loc >= 0).sum(dim=2, dtype=torch.int32).amax(dim=1)
    assert loc.shape[2] == W and int(mdeg.max()) <= d_cap
    row_ptr, col_idx = td.host_csr()
    for core in (native, jax_native):
        h_nodes, _, h_loc, h_mdeg = core.khop_local_tab(row_ptr, col_idx, links, hops, S,
                                                           d_cap)
        np.testing.assert_array_equal(h_nodes, nd)
        np.testing.assert_array_equal(h_mdeg, mdeg.numpy())
        assert int(h_mdeg.max()) <= d_cap
        h_loc = h_loc.astype(np.int32)
        assert (h_loc[:, :, min(W, d_cap):] == -1).all()
        k = min(W, d_cap)
        np.testing.assert_array_equal(h_loc[:, :, :k], loc[:, :, :k].numpy())
        assert (loc[:, :, k:] == -1).all()
    assert loc.dtype == torch.int32 and loc.is_contiguous()  # slots only, no weights
    assert not (loc[~mask] >= 0).any()  # rows of empty slots are empty


def test_local_table_keeps_duplicates_skips_self_padding_and_drops_the_link():
    """A multigraph: a repeated edge stays twice (so the route's width is
    the global table's), a self loop is an entry of its row, the
    self-padding past a row's degree is never read, the target link leaves
    rows 0 and 1 only, and a repeated member id keeps its last slot; each
    row against a per-row Python oracle, and the wrapper on CPU tensors runs
    the plain version. Entries past a narrower width are not written."""
    ei = np.array([[0, 1, 0, 1, 1, 2, 2, 3, 2, 2, 3, 4],
                   [1, 0, 2, 2, 2, 1, 1, 2, 2, 3, 4, 3]], dtype=np.int32)
    g = tgraph.Graph(num_nodes=6, edge_index=ei, x=np.ones((6, 2), np.float32))
    td = text.DeviceGraph.from_graph(g, max_degree=8, device="cpu")
    nodes = torch.tensor([[0, 1, 2, 3, 5, 0], [2, 3, 1, 2, 0, 0]], dtype=torch.int32)
    mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 0, 0]], dtype=torch.bool)
    links = torch.tensor([[0, 1], [2, 3]])
    assert td.repeats_a_neighbor() and tpos.local_table_width(td, 6) == lt.table_width(8)
    width = tpos.local_table_width(td, 6)
    got = lt.local_table(td.nbr, td.degrees(), nodes, mask, links, width)
    loc = lt.local_table_reference(td.nbr, td.degrees(), nodes, mask, links, width)
    assert torch.equal(got, loc)
    cut = lt.local_table_reference(td.nbr, td.degrees(), nodes, mask, links, 2)
    assert torch.equal(cut, loc[:, :, :2])
    ldeg = (loc >= 0).sum(dim=2)
    rp, ci, _ = g.csr
    for b in range(2):
        slot = {int(nodes[b, j]): j for j in range(6) if mask[b, j]}  # last slot wins
        for s in range(6):
            want = []
            if mask[b, s]:
                g_id = int(nodes[b, s])
                drop = {0: int(links[b, 1]), 1: int(links[b, 0])}.get(s)
                want = [slot[int(v)] for v in ci[rp[g_id]:rp[g_id + 1]]
                        if int(v) in slot and int(v) != drop]
            row = loc[b, s].tolist()
            assert row[:len(want)] == want and all(v == -1 for v in row[len(want):]), (b, s)
            assert int(ldeg[b, s]) == len(want)
    assert loc[0, 2].tolist()[:4] == [1, 1, 2, 3]  # node 2: node 1 twice, itself, node 3
    assert loc.shape[2] == lt.WIDTH_MULTIPLE and ldeg.amax(dim=1).tolist() == [4, 4]


def test_table_width_rounds_up_to_the_multiple():
    assert [lt.table_width(d) for d in (0, 1, 32, 33, 1021)] == [32, 32, 32, 64, 1024]


def test_rows_per_block_gives_each_hash_enough_rows():
    """A block's rows: the least power of two, 16 to 256, whose rows of at
    most ``width`` entries add up to 16 S (the hub batch's 16, the main
    path's S = 256 batch's 64)."""
    assert lt.rows_per_block(1024, 1024) == 16 and lt.rows_per_block(256, 96) == 64
    assert lt.rows_per_block(32, 32) == 16 and lt.rows_per_block(4096, 32) == 256
    for S, width in ((1024, 1024), (256, 96), (512, 64), (100, 1024), (2048, 96)):
        r = lt.rows_per_block(S, width)
        assert r & (r - 1) == 0 and 16 <= r <= 256
        assert r * width >= 16 * S or r == 256
        assert r == 16 or (r // 2) * width < 16 * S


@pytest.mark.parametrize("count", ["live", "padded"])
def test_local_table_work_counts_bytes_by_brute_force(count):
    _, td, links, _ = _graphs("hub-narrow")
    _, nodes, mask = _node_sets(td, links, 1, 32)
    loc = lt.local_table_reference(td.nbr, td.degrees(), nodes, mask, torch.as_tensor(links),
                                   tpos.local_table_width(td, 32))
    B, S, W = loc.shape
    deg = td.degrees().numpy()
    read = 0
    for b in range(B):
        for s in range(S):
            if mask[b, s]:
                g_id = int(nodes[b, s])
                read += 4 + 4 * (deg[g_id] if count == "live" else td.nbr.shape[1])
    want = 5 * B * S + 8 * B + read + 4 * B * S * W  # the slots; no weight array
    got = lt.work(td.nbr, td.degrees(), nodes, mask, W, count=count)
    assert got.n_bytes == want and got.flops == 0.0


def test_plain_selector_gives_the_same_bits_on_a_wider_table():
    """The plain selector packs each row's live entries first: the same
    entries spread over a wider table, with zero weights and ids of no slot
    between them, give the same bits (the kernel does the same)."""
    rng = np.random.default_rng(4)
    B, S, D, R = 3, 40, 12, 6
    sel = torch.as_tensor(rng.integers(0, S, (B, R)).astype(np.int32))
    nbr = torch.as_tensor(rng.integers(0, S, (B, S, D)).astype(np.int32))
    w = torch.as_tensor(rng.random((B, S, D)).astype(np.float32)) * (torch.rand(B, S, D) < 0.5)
    wide_n = torch.full((B, S, 5 * D), -1, dtype=torch.int32)
    wide_w = torch.zeros((B, S, 5 * D))
    cols = torch.as_tensor(np.sort(rng.choice(5 * D, D, replace=False)))
    wide_n[:, :, cols], wide_w[:, :, cols] = nbr, w
    wide_n[:, :, 1] = torch.where(wide_w[:, :, 1] == 0, 7, wide_n[:, :, 1])  # weight 0 names slot 7
    a = pos_selector_rows_reference(sel, nbr, w, sign_k=3)
    b = pos_selector_rows_reference(sel, wide_n, wide_w, sign_k=3)
    assert torch.equal(a, b)


# (B, S, D, R, K): PoS and PoS+ rows, and K = 0 (no selector phase).
NO_WEIGHT_SHAPES = [(3, 40, 12, 2, 3), (2, 64, 33, 6, 2), (4, 16, 5, 3, 0)]


@pytest.mark.parametrize("B,S,D,R,K", NO_WEIGHT_SHAPES,
                         ids=[f"S{s}-D{d}-R{r}-K{k}" for _, s, d, r, k in NO_WEIGHT_SHAPES])
def test_no_weights_equal_the_weights_of_the_slots_bit_for_bit(B, S, D, R, K):
    """``w=None`` in local-slot mode weighs 1 every slot >= 0 and 0 the
    rest: the plain versions and the wrappers (on CPU tensors) give the
    bits of the same call with ``w = (loc >= 0)``, on a table with -1
    between its entries and slots out of range; the work counts drop the
    weight array and keep the same entries."""
    rng = np.random.default_rng(S + K)
    loc = torch.as_tensor(rng.integers(0, S + 1, (B, S, D)).astype(np.int32))  # S: no slot
    loc[torch.as_tensor(rng.random((B, S, D)) < 0.4)] = -1
    w = (loc >= 0).float()
    sel = torch.as_tensor(rng.integers(0, S, (B, R)).astype(np.int32))
    x = torch.as_tensor(rng.normal(size=(B, S, 7)).astype(np.float32))
    for fn in (pos_power_rows_reference, pos_power_rows):
        assert torch.equal(fn(sel, loc, None, x, sign_k=K), fn(sel, loc, w, x, sign_k=K))
    for fn in (pos_selector_rows_reference, pos_selector_rows):
        assert torch.equal(fn(sel, loc, None, sign_k=K), fn(sel, loc, w, sign_k=K))
    assert torch.equal(pos_kernel.resolved_entries(loc, None), pos_kernel.resolved_entries(loc, w))
    mask = torch.as_tensor(rng.random((B, S)) < 0.8)
    for count in ("members", "padded", "live"):
        a = pos_kernel.work(sel, loc, None, x, sign_k=K, node_mask=mask, count=count)
        b = pos_kernel.work(sel, loc, w, x, sign_k=K, node_mask=mask, count=count)
        table = {"members": int(mask.sum()) * D, "padded": B * S * D,
                 "live": int(((loc >= 0) & mask[:, :, None]).sum())}[count]
        assert (a.n_bytes, a.flops) == (b.n_bytes - 4 * table, b.flops)


def test_no_weights_with_row_ids_raises():
    """``w=None`` is for local slots: with ``row_ids`` every plain version
    and wrapper raises."""
    rng = np.random.default_rng(9)
    sel = torch.zeros((2, 2), dtype=torch.int32)
    nbr = torch.as_tensor(rng.integers(0, 50, (2, 8, 4)).astype(np.int32))
    x = torch.zeros((2, 8, 3))
    ids = torch.as_tensor(rng.permutation(50)[:16].reshape(2, 8).astype(np.int32))
    for fn in (pos_power_rows_reference, pos_power_rows):
        with pytest.raises(ValueError, match="local slots only"):
            fn(sel, nbr, None, x, sign_k=2, row_ids=ids)
    for fn in (pos_selector_rows_reference, pos_selector_rows):
        with pytest.raises(ValueError, match="local slots only"):
            fn(sel, nbr, None, sign_k=2, row_ids=ids)
    with pytest.raises(ValueError, match="local slots only"):
        pos_kernel.resolved_entries(nbr, None, ids)


@pytest.mark.parametrize("max_ccn,strategy", CCN, ids=CCN_IDS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_the_local_route_takes_no_weights_and_equals_global_and_jax(monkeypatch, graph,
                                                                    max_ccn, strategy,
                                                                    jax_native):
    """One batch of ``precompute_pos``' body on the host BFS's node sets:
    the local route hands ``pos_power_rows`` no weight array and gives the
    global route's bits, and is within the kernel's bar of the JAX
    ``pos_operators_local`` on the JAX native table of the same node sets."""
    jd, td, links, _ = _graphs(graph)
    S, hops = 64, 2
    nd, _ = native.khop_nodes(*td.host_csr(), links, hops, S)
    kw = dict(num_hops=hops, max_nodes=S, ratio_per_hop=1.0, max_nodes_per_hop=None,
              sign_k=3, max_ccn=max_ccn, strategy=strategy)
    weights = []
    monkeypatch.setattr(tpos, "pos_power_rows",
                        lambda *a, **k: weights.append(a[2]) or pos_power_rows(*a, **k))
    out = {}
    for mode in ("0", "1"):
        monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", mode)
        out[mode] = tpos._extract_and_operate(
            td, torch.as_tensor(links), torch.zeros(len(links), dtype=torch.int32),
            host_nodes=nd, **kw)
    assert weights[0] is not None and weights[1] is None
    for a, b in zip(out["1"], out["0"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rp, ci = td.host_csr()
    j_nd, _, jloc, mdeg = jax_native.khop_local_tab(rp, ci, links, hops, S,
                                                    min(S, int(td.nbr.shape[1])))
    np.testing.assert_array_equal(j_nd, nd)
    hm = nd >= 0
    xj, mj = jpos.pos_operators_local(jd, jnp.asarray(np.where(hm, nd, 0)), jnp.asarray(hm),
                                      jnp.asarray(jloc[:, :, :int(mdeg.max())]), sign_k=3,
                                      max_ccn=max_ccn, strategy=strategy)
    np.testing.assert_array_equal(np.asarray(mj), out["1"][1].numpy())
    np.testing.assert_allclose(np.asarray(xj), out["1"][0].numpy(), **TOL)


@pytest.mark.parametrize("max_ccn,strategy", CCN, ids=CCN_IDS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pos_operators_local_equals_global_bit_for_bit(graph, max_ccn, strategy):
    _, td, links, _ = _graphs(graph)
    kw = dict(sign_k=3, max_ccn=max_ccn, strategy=strategy)
    for hops, S in ((1, 32), (2, 64)):
        _, nodes, mask = _node_sets(td, links, hops, S)
        lb = torch.as_tensor(links)
        xs_g, rm_g = tpos.pos_operators_global(td, lb, nodes, mask, **kw)
        loc = lt.local_table_reference(td.nbr, td.degrees(), nodes, mask, lb,
                                       tpos.local_table_width(td, S))
        xs_l, rm_l = tpos.pos_operators_local(td, nodes, mask, loc, **kw)
        torch.testing.assert_close(rm_l, rm_g, rtol=0, atol=0)
        torch.testing.assert_close(xs_l, xs_g, rtol=0, atol=0)
        sel, nbr, w, x, rm = tpos.local_table_kernel_inputs(td, lb, nodes, mask,
                                                            max_ccn=max_ccn, strategy=strategy)
        assert torch.equal(nbr, loc) and torch.equal(rm, rm_l) and w is None


@pytest.mark.parametrize("max_ccn,strategy", CCN, ids=CCN_IDS)
def test_pos_operators_local_matches_jax(max_ccn, strategy, jax_native):
    """The JAX ``pos_operators_local`` on the JAX native table, the port's
    on its own table."""
    jd, td, links, _ = _graphs("blogcatalog-like")
    S = 64
    rp, ci = td.host_csr()
    nd, _, jloc, mdeg = jax_native.khop_local_tab(rp, ci, links, 2, S,
                                                  min(S, int(td.nbr.shape[1])))
    hm = nd >= 0
    kw = dict(sign_k=3, max_ccn=max_ccn, strategy=strategy)
    xj, mj = jpos.pos_operators_local(jd, jnp.asarray(np.where(hm, nd, 0)), jnp.asarray(hm),
                                      jnp.asarray(jloc[:, :, :int(mdeg.max())]), **kw)
    nodes, mask = torch.as_tensor(np.where(hm, nd, 0)), torch.as_tensor(hm)
    loc = lt.local_table(td.nbr, td.degrees(), nodes, mask, torch.as_tensor(links),
                         tpos.local_table_width(td, S))
    xt, mt = tpos.pos_operators_local(td, nodes, mask, loc, **kw)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(xj), xt.numpy(), **TOL)


POS_KW = dict(num_hops=2, sign_k=3, buckets=(16, 32, 64), batch_size=8,
              max_subgraph_nodes=64, seed=3)
PLUS = {"PoS": {}, "PoS+union": dict(k_heuristic=1, k_node_set_strategy="union", max_ccn=8),
        "PoS+intersection": dict(k_heuristic=1, k_node_set_strategy="intersection",
                                 max_ccn=8)}


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("kind", sorted(PLUS))
def test_precompute_pos_local_route_equals_the_global_route(monkeypatch, route, kind,
                                                           jax_native):
    """``S3GRL_TPU_LOCAL_TAB=1`` against ``=0`` bit for bit, on the host
    BFS's node sets and on the device BFS's; against the JAX package's local
    route (host extract, ``use_pallas=True``) within the kernel's bar."""
    jd, td, links, rng = _graphs("hub-narrow")
    y = rng.integers(0, 2, len(links)).astype(np.float32)
    kw = {**POS_KW, **PLUS[kind]}
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1" if route == "host" else "0")
    calls = []
    monkeypatch.setattr(tpos, "local_table", lambda *a: calls.append(1) or lt.local_table(*a))
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "0")
    glob = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    assert not calls
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "1")
    loc = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    assert len(calls) == len(tpos.pos_plan(td, links, **kw).batches)
    torch.testing.assert_close(loc.row_mask, glob.row_mask, rtol=0, atol=0)
    torch.testing.assert_close(loc.xs, glob.xs, rtol=0, atol=0)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1")
    want = jpos.precompute_pos(jd, links, y, use_pallas=True, **kw)
    np.testing.assert_array_equal(np.asarray(want.row_mask), loc.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.xs), loc.xs.numpy(), **TOL)


def test_local_table_route_modes(monkeypatch):
    monkeypatch.delenv("S3GRL_TPU_LOCAL_TAB", raising=False)
    D = 3392
    cut = int(tpos.LOCAL_TAB_MAX_S_OVER_D * D)
    assert tpos.local_table_route(cut, D) and not tpos.local_table_route(cut + 1, D)
    assert not tpos.local_table_route(32, D, sampled=True)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "0")
    assert not tpos.local_table_route(32, D)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "1")
    assert tpos.local_table_route(4096, 32) and not tpos.local_table_route(32, D, sampled=True)


@pytest.mark.parametrize("repeats", [False, True], ids=["simple", "repeated-edge"])
def test_a_local_bucket_is_sized_by_its_local_width(monkeypatch, repeats):
    """pos_plan's batch cap: the local tables' width (``local_table_width``,
    about ``min(bucket, D_tab)``; ``D_tab`` where the graph repeats an edge)
    in place of ``D_tab`` in a local bucket (JAX pos.py:775-797)."""
    rng = np.random.default_rng(2)
    ei = _hub_narrow_edges()
    if repeats:
        ei = np.concatenate([ei, ei[:, :1]], axis=1)
    n = int(ei.max()) + 1
    td = text.DeviceGraph.from_graph(
        tgraph.Graph(num_nodes=n, edge_index=ei, x=np.ones((n, 3), np.float32)), device="cpu")
    D = int(td.nbr.shape[1])
    assert td.repeats_a_neighbor() == repeats
    links = rng.integers(1, n, (256, 2)).astype(np.int32)
    kw = dict(num_hops=1, sign_k=2, buckets=(16, 32, 64), max_subgraph_nodes=64,
              batch_size=2**20)
    monkeypatch.setattr(tpos, "ELEM_BUDGET", 2**15)  # batches of 8 to 64 links
    caps = {}
    for mode, width in (("0", lambda b: D), ("1", lambda b: tpos.local_table_width(td, b))):
        monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", mode)
        sizes = {}
        for bucket, idx in tpos.pos_plan(td, links, **kw).batches:
            sizes.setdefault(bucket, []).append(len(idx))
        for bucket, lens in sizes.items():
            cap = tpos.batch_cap(bucket, 3, width(bucket), 0, 2**20)
            assert max(lens) <= cap and (len(lens) == 1 or lens[0] == cap), (mode, bucket)
        caps[mode] = sizes[16][0]
    assert (caps["1"] > caps["0"]) != repeats, caps
    assert (tpos.local_table_width(td, 32) == D) == repeats


def test_auto_leaves_the_main_path_on_the_global_route(monkeypatch):
    """bench.py's workload on the USAir-like graph (D_tab 96; its train
    links fill the 128-512 buckets): ``auto`` takes no local table."""
    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.utils.seeding import seed_everything

    monkeypatch.delenv("S3GRL_TPU_LOCAL_TAB", raising=False)
    monkeypatch.setattr(tpos, "local_table", lambda *a: pytest.fail("took a local table"))
    ei = usair_like_edges(1)
    n = int(ei.max()) + 1
    g = tgraph.Graph(num_nodes=n, edge_index=ei, x=np.ones((n, 4), np.float32))
    cfg = RunConfig()
    observed, split = do_edge_split(g, rng=seed_everything(1)[0])
    td = text.DeviceGraph.from_graph(observed, device="cpu")
    links = split.train_pos.astype(np.int32)[:512]
    plan = tpos.pos_plan(td, links, num_hops=2, sign_k=3, buckets=cfg.subgraph_buckets,
                         max_subgraph_nodes=cfg.max_subgraph_nodes,
                         batch_size=cfg.extract_batch_size)
    buckets = sorted({b for b, _ in plan.batches})
    assert int(td.nbr.shape[1]) == 96 and buckets and min(buckets) >= 128, buckets
    assert not any(tpos.local_table_route(b, 96) for b in buckets)
    ds = tpos.precompute_pos(td, links, np.ones(len(links), np.float32), num_hops=2,
                             sign_k=3, buckets=cfg.subgraph_buckets,
                             max_subgraph_nodes=cfg.max_subgraph_nodes,
                             batch_size=cfg.extract_batch_size, device="cpu")
    assert ds.xs.shape[0] == len(links)
