"""The global route's by-id call of ``pos_power_rows`` on the CPU: the
graph's own table, degrees and features read by node id stand for the
gathered per-batch arrays of ``operators/pos.global_kernel_inputs``, bit for
bit; its work count; the route's ``pos.inputs`` counters and the benchmark's
reader of them."""
import numpy as np
import pytest
import torch

import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch import profiling
from s3grl_tpu_torch.ops import pos_kernel
from s3grl_tpu_torch.ops.pos_kernel import gather_by_id, pos_power_rows
from tests.torch_port_helpers import one_torch_thread, random_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

POS_KW = dict(num_hops=2, sign_k=2, buckets=(16, 32, 64), batch_size=8, max_subgraph_nodes=64,
              seed=3, device="cpu")


def _graph(seed=5, n=90, e=300, F=5, hub=False):
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n, e)
    if hub:  # node 0 names every other node: a row far wider than the rest
        ei = np.concatenate([ei, np.stack([np.zeros(n - 1), np.arange(1, n)]).astype(np.int32),
                             np.stack([np.arange(1, n), np.zeros(n - 1)]).astype(np.int32)],
                            axis=1)
        ei = np.unique(ei, axis=1)
    x = rng.normal(size=(n, F)).astype(np.float32)
    return text.DeviceGraph.from_graph(tgraph.Graph(edge_index=ei, num_nodes=n, x=x),
                                       device="cpu"), ei


def _batch(dg, ei, S, kind, B=12, seed=0):
    """(links [B, 2] int32, nodes, mask): observed edges, random pairs (most
    of them non-edges) or both in turn, and their 2-hop node sets at S."""
    rng = np.random.default_rng(seed)
    edges = ei[:, rng.choice(ei.shape[1], B, replace=False)].T
    pairs = rng.integers(0, dg.num_nodes, (B, 2))
    pairs[:, 1] = np.where(pairs[:, 0] == pairs[:, 1], (pairs[:, 0] + 1) % dg.num_nodes,
                           pairs[:, 1])
    links = {"edges": edges, "pairs": pairs,
             "mixed": np.where((np.arange(B) % 2)[:, None] == 0, edges, pairs)}[kind]
    links = torch.as_tensor(np.ascontiguousarray(links, dtype=np.int32))
    nodes, mask, _, _ = text.extract_node_sets(dg, links, num_hops=2, max_nodes=S)
    return links, nodes, mask


def _by_id_args(dg, links, nodes, mask, **kw):
    sel, row_ids, lk, rm = tpos.by_id_kernel_inputs(dg, links, nodes, mask, **kw)
    return (sel, dg.nbr, dg.degrees(), dg.x_with_indicator()), dict(row_ids=row_ids, links=lk), rm


@pytest.mark.parametrize("kind", ["edges", "pairs"])
@pytest.mark.parametrize("S", [16, 64])
def test_gather_by_id_gives_the_gathered_arrays(S, kind):
    """What a by-id call stands for is ``global_kernel_inputs``' weighted
    entries, weights and features, to the bit: the target link dropped from
    rows 0 and 1, weight 0 past a row's degree and on empty slots (whose ids
    then name nothing), the indicator in column 0."""
    dg, ei = _graph()
    links, nodes, mask = _batch(dg, ei, S, kind)
    assert S == 16 or not bool(mask.all())
    sel, nbr, w, x, row_ids, _ = tpos.global_kernel_inputs(dg, links, nodes, mask)
    g_nbr, g_w, g_x = gather_by_id(dg.nbr, dg.degrees(), dg.x_with_indicator(), row_ids, links)
    assert torch.equal(g_w, w) and torch.equal(g_x, x)
    assert torch.equal(torch.where(g_w > 0, g_nbr, -1), torch.where(w > 0, nbr, -1))
    if kind == "edges":  # each link's own edge is dropped from both rows
        assert float(w[:, :2].sum()) < float(dg.nbr_mask[nodes[:, :2].long()].sum())


@pytest.mark.parametrize("sign_k", [0, 3])
@pytest.mark.parametrize("max_ccn,strategy", [(0, ""), (8, "union"), (8, "intersection")])
@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
def test_by_id_call_equals_the_gathered_call_bit_for_bit(hub, max_ccn, strategy, sign_k):
    dg, ei = _graph(seed=7, hub=hub)
    links, nodes, mask = _batch(dg, ei, 64, "mixed", seed=2)
    kw = dict(max_ccn=max_ccn, strategy=strategy)
    sel, nbr, w, x, row_ids, rm = tpos.global_kernel_inputs(dg, links, nodes, mask, **kw)
    want = pos_power_rows(sel, nbr, w, x, sign_k=sign_k, row_ids=row_ids)
    args, call_kw, rm_id = _by_id_args(dg, links, nodes, mask, **kw)
    assert torch.equal(args[0], sel) and torch.equal(rm_id, rm)
    assert torch.equal(pos_power_rows(*args, sign_k=sign_k, **call_kw), want)
    xs, got_rm = tpos.pos_operators_global(dg, links, nodes, mask, sign_k=sign_k, **kw)
    assert torch.equal(xs, want * rm[:, None, :, None]) and torch.equal(got_rm, rm)


def test_a_by_id_call_needs_its_degrees_row_ids_and_links():
    dg, ei = _graph()
    links, nodes, mask = _batch(dg, ei, 16, "edges")
    args, kw, _ = _by_id_args(dg, links, nodes, mask)
    with pytest.raises(ValueError, match="by-id"):
        pos_power_rows(*args, sign_k=2, row_ids=kw["row_ids"])
    with pytest.raises(ValueError, match="by-id"):
        pos_power_rows(args[0], args[1], None, args[3], sign_k=2, **kw)
    with pytest.raises(ValueError, match="by-id"):
        pos_power_rows(*args, sign_k=2, links=kw["links"])
    with pytest.raises(ValueError, match="by-id"):
        pos_kernel.pos_selector_rows(*args[:3], sign_k=2, row_ids=kw["row_ids"])


def test_x_with_indicator_is_made_once_per_graph():
    dg, _ = _graph()
    x1 = dg.x_with_indicator()
    assert x1 is dg.x_with_indicator()
    assert x1.shape == (dg.num_nodes, dg.x.shape[1] + 1) and x1.is_contiguous()
    assert not x1[:, 0].any() and torch.equal(x1[:, 1:], dg.x)


def _brute_by_id_work(sel, nbr, deg, x, row_ids, links, K):
    """Entry by entry: 4 bytes per live id of each member row (its degree's
    count), per feature of its row of X, per its degree, per row id of every
    slot, per link end, per selected row id and per output value; 2·K·R FLOP
    per live entry that names a member of the subgraph (the target link's
    entries on rows 0 and 1 excepted) and 2·K·R·F per member row."""
    B, S = row_ids.shape
    R, F = sel.shape[1], x.shape[1]
    n_bytes = 4 * (B * S + 2 * B + B * R + B * (K + 1) * R * F)
    flops = 0
    for b in range(B):
        members = {int(i) for i in row_ids[b] if i >= 0}
        for s in range(S):
            node = int(row_ids[b, s])
            if node < 0:
                continue
            n_bytes += 4 * (int(deg[node]) + F + 1)
            flops += 2 * K * R * F
            drop = int(links[b, 1]) if s == 0 else int(links[b, 0]) if s == 1 else None
            for d in range(int(deg[node])):
                j = int(nbr[node, d])
                if j in members and j != drop:
                    flops += 2 * K * R
    return n_bytes, flops


@pytest.mark.parametrize("kind", ["edges", "pairs"])
def test_by_id_work_counts_live_entries_by_degree(kind):
    """``pos_kernel.work`` of a by-id call against a brute-force count: the
    live entries by each member's degree and its row of X by id, no
    padding and no weights."""
    dg, ei = _graph(hub=True)
    links, nodes, mask = _batch(dg, ei, 64, kind, B=5)
    args, kw, _ = _by_id_args(dg, links, nodes, mask)
    got = pos_kernel.work(*args, sign_k=3, **kw)
    want = _brute_by_id_work(*(a.numpy() for a in (args[0], dg.nbr, dg.degrees(), args[3])),
                             kw["row_ids"].numpy(), kw["links"].numpy(), 3)
    assert (got.n_bytes, got.flops) == want
    assert pos_kernel.work(*args, sign_k=3, count="live", **kw) == got
    with pytest.raises(ValueError, match="padding"):
        pos_kernel.work(*args, sign_k=3, count="padded", **kw)


@pytest.mark.parametrize("route", ["global", "local", "walks"])
def test_inputs_counters_count_by_id_batches_and_built_bytes(monkeypatch, route):
    """``pos.inputs.by_id`` counts every batch of the global route and none
    of a local one; ``pos.inputs.bytes`` adds the kernel inputs built for a
    batch: on the global route its row ids, selected rows and links alone."""
    rng = np.random.default_rng(4)
    dg, _ = _graph(seed=4)
    links = rng.integers(0, dg.num_nodes, (40, 2)).astype(np.int32)
    links = links[links[:, 0] != links[:, 1]]
    y = np.zeros(len(links), np.float32)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "1" if route == "local" else "0")
    walk_kw = dict(rw_m=2, rw_M=4) if route == "walks" else {}
    plan = tpos.pos_plan(dg, links, **{k: v for k, v in POS_KW.items() if k != "device"},
                         **walk_kw)
    before = profiling.counters()
    tpos.precompute_pos(dg, links, y, **POS_KW, **walk_kw)
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0) for k in ("pos.inputs.by_id",
                                                           "pos.inputs.bytes", "pos.batches")}
    assert got["pos.batches"] == len(plan.batches)
    assert got["pos.inputs.by_id"] == (len(plan.batches) if route == "global" else 0)
    by_id_bytes = sum(4 * len(idx) * (b + 2 + 2) for b, idx in plan.batches)
    if route == "global":
        assert got["pos.inputs.bytes"] == by_id_bytes
    else:  # a local table and the features [B, S, F+1] are built on top
        F1 = dg.x.shape[1] + 1
        assert got["pos.inputs.bytes"] > sum(4 * len(idx) * b * F1 for b, idx in plan.batches)


def test_input_bytes_reader_reads_the_programs_counters(monkeypatch):
    from benchmark import spec
    from benchmark.cellbase import TraceContext

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"pos.inputs.bytes": 1_000, "pos.links": 8})
    assert spec.reader("prep.input_bytes_per_link")(TraceContext()) == pytest.approx(125.0)


@pytest.mark.parametrize("counters", [{}, {"pos.links": 5}, {"pos.inputs.bytes": 9}, None])
def test_input_bytes_reader_is_none_without_its_counters(monkeypatch, counters):
    from benchmark import spec
    from benchmark.cellbase import TraceContext

    if counters is None:  # a program with no counters at all
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    assert spec.reader("prep.input_bytes_per_link")(TraceContext()) is None


@pytest.mark.parametrize("hub", [False, True], ids=["plain", "hub"])
def test_by_id_selector_rows_equal_the_gathered_ones(hub):
    """``pos_selector_rows`` by id gives the selector rows of the call on the
    gathered table and weights, bit for bit."""
    dg, ei = _graph(seed=9, hub=hub)
    links, nodes, mask = _batch(dg, ei, 64, "mixed", seed=4)
    sel, nbr, w, _, row_ids, _ = tpos.global_kernel_inputs(dg, links, nodes, mask)
    want = pos_kernel.pos_selector_rows(sel, nbr, w, sign_k=3, row_ids=row_ids)
    args, kw, _ = _by_id_args(dg, links, nodes, mask)
    assert torch.equal(pos_kernel.pos_selector_rows(*args[:3], sign_k=3, **kw), want)
