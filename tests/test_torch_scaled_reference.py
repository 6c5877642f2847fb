"""S3GRL's PoS Plus on ScaLed's walk subgraphs against the benchmark's
plain reference (``benchmark/reference_scaled.py``) on the CPU: the
reference's walk law, written out again in numpy, is the port's
(``hash_uniforms``, ``rw_membership``, the members and their order) bit for
bit; ``precompute_pos`` with walks (intersection and union CCN rows, and
none) agrees with it within a float32 bar and its row masks exactly; the
same comparison fails that bar with the reference in TF32 and with each
fault the benchmark plants in the walk route; the walk batches' counters
equal the reference's sums, are read from the card once a call, and the
readers read them; and the walk route's spans nest in its batch's. The
paper's ``Cora_PoS_Plus_ScaLed`` entry reaches ``precompute_pos`` through
the runner with the keywords the benchmark passes."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import s3grl_tpu_torch.operators.pos as tpos
from benchmark import faults_scaled, spec
from benchmark.cellbase import TraceContext, pos_keywords, worst_relative_gap
from benchmark.reference import RefGraph
from benchmark.reference_scaled import link_seeds, members, scaled_rows, uniforms
from s3grl_tpu_torch import profiling, runner
from s3grl_tpu_torch.config import ExperimentSuite
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.sampling.extraction import DeviceGraph, link_seeds_of
from s3grl_tpu_torch.sampling.random_walk import (
    extract_rw_subgraphs,
    hash_uniforms,
    rw_membership,
)
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The worst relative gap of a link's rows (the benchmark's ``ops_gap``)
# that float32 arithmetic leaves: each entry sums at most a few hundred
# products (K = 3 powers over walk subgraphs of at most 160 nodes, degrees
# up to ~60 inside them, times 7 features), so rounding at 2^-24 a step
# stays below ~1e-6 of the block's largest entry; TF32's 2^-11 on every
# operand reads ~1e-4 and more, and other walks, a short step or the link
# left in change whole rows, 1e-2 and more.
BAR = 1e-5
# The paper's walks (m 3, M 20: at most 160 members, the 256 bucket) on a
# graph of 200 nodes.
KW = dict(num_hops=0, sign_k=3, buckets=(32, 64, 128, 256), batch_size=16,
          max_subgraph_nodes=256, max_ccn=64, seed=3, rw_m=3, rw_M=20, device="cpu")
STRATEGIES = [("intersection", 1), ("union", 1), ("", 0)]


def _case(seed=7, n=200, f=7, n_links=40):
    """A Holme-Kim graph (common neighbours on most edges) with normal
    features; half its links edges of the graph (the link removed from
    the subgraph), half any pair of distinct nodes."""
    rng = np.random.default_rng(seed)
    ei = usair_like_edges(seed, n=n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    some_edges = ei[:, rng.choice(ei.shape[1], n_links // 2, replace=False)].T
    pairs = rng.integers(0, n, (n_links - len(some_edges), 2))
    links = np.concatenate([some_edges, pairs])
    links = links[links[:, 0] != links[:, 1]].astype(np.int32)
    return n, ei, x, links


CASE = _case()


def _graph():
    n, ei, x, _ = CASE
    return DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")


def _program(strategy="intersection", k_heuristic=1, **kw):
    links = CASE[3]
    y = np.zeros(len(links), np.float32)
    return tpos.precompute_pos(_graph(), links, y, k_node_set_strategy=strategy,
                               k_heuristic=k_heuristic, **{**KW, **kw})


def _reference(strategy, k_heuristic, width, precision="float64"):
    n, ei, x, links = CASE
    return scaled_rows(RefGraph(n, ei, x, "cpu"), links, np.arange(len(links)),
                       seed=KW["seed"], rw_m=KW["rw_m"], rw_M=KW["rw_M"], sign_k=KW["sign_k"],
                       strategy=strategy, max_ccn=KW["max_ccn"] if k_heuristic else 0,
                       width=width, precision=precision)


@pytest.mark.parametrize("seed", [3, 2**31 - 1])
def test_the_references_walk_law_is_the_programs_bit_for_bit(seed):
    n, ei, x, links = CASE
    m, M = KW["rw_m"], KW["rw_M"]
    seeds = link_seeds(seed, np.arange(len(links)))
    assert np.array_equal(seeds, link_seeds_of(seed, len(links)))
    got = hash_uniforms(torch.as_tensor(seeds), m, 2 * M).numpy()
    assert np.array_equal(uniforms(seeds, m, 2 * M).view(np.uint32), got.view(np.uint32))
    dg = _graph()
    want = members(RefGraph(n, ei, x, "cpu"), links, seeds, rw_m=m, rw_M=M)
    t_links, t_seeds = torch.as_tensor(links), torch.as_tensor(seeds)
    member = rw_membership(dg, t_links, t_seeds, rw_m=m, rw_M=M)
    sub = extract_rw_subgraphs(dg, t_links, t_seeds, rw_m=m, rw_M=M, max_nodes=256)
    for i, w in enumerate(want):
        assert np.array_equal(np.sort(w), torch.nonzero(member[i]).squeeze(1).numpy())
        assert np.array_equal(sub.nodes[i][sub.node_mask[i]].numpy(), w)
    sizes = [len(w) for w in want]
    assert sub.sub_size.tolist() == sizes and max(sizes) <= 2 * M * (m + 1)


@pytest.mark.parametrize("strategy,k_heuristic", STRATEGIES)
def test_precompute_pos_with_walks_agrees_with_the_reference(strategy, k_heuristic):
    ds = _program(strategy, k_heuristic)
    want, want_mask = _reference(strategy, k_heuristic, ds.xs.shape[2])
    assert want.shape == ds.xs.shape, "the program's CCN width holds every link's rows"
    assert torch.equal(ds.row_mask, want_mask)
    if k_heuristic:
        assert want_mask[:, 2:].any(), "the fixture must have CCN rows"
    assert worst_relative_gap(ds.xs.numpy(), want.numpy()) < BAR


@pytest.mark.parametrize("wrong", ["reference_in_tf32"] + list(faults_scaled.SCALED))
def test_a_lower_precision_or_a_planted_fault_fails_the_bar(monkeypatch, wrong):
    if wrong == "reference_in_tf32":
        ds = _program()
        got = _reference("intersection", 1, ds.xs.shape[2], precision="tf32")[0].numpy()
    else:
        getattr(faults_scaled, wrong)(monkeypatch)
        ds = _program()
        got = ds.xs.float().numpy()
    want = _reference("intersection", 1, ds.xs.shape[2])[0].numpy()
    assert worst_relative_gap(got, want) > BAR


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith("pos.") and after[k] != before.get(k, 0)}


@pytest.mark.parametrize("strategy,k_heuristic", STRATEGIES)
def test_walk_counters_equal_the_references_sums(monkeypatch, strategy, k_heuristic):
    n, ei, x, links = CASE
    plan = tpos.pos_plan(_graph(), links, k_node_set_strategy=strategy,
                         k_heuristic=k_heuristic,
                         **{k: v for k, v in KW.items() if k != "device"})
    ds, got = _counted(lambda: _program(strategy, k_heuristic))
    _, want_mask = _reference(strategy, k_heuristic, ds.xs.shape[2])
    sizes = [len(w) for w in members(RefGraph(n, ei, x, "cpu"), links,
                                     link_seeds(KW["seed"], np.arange(len(links))),
                                     rw_m=KW["rw_m"], rw_M=KW["rw_M"])]
    (bucket,) = {b for b, _ in plan.batches}
    assert bucket == 256 and len(plan.batches) > 1
    assert got["pos.walks.members"] == got["pos.slots_used"] == sum(sizes)
    assert got["pos.slots"] == bucket * len(links)
    assert got["pos.walks.mask_entries"] == sum(len(idx) * n for _, idx in plan.batches)
    assert got["pos.links.walks"] == len(links)
    eff = ds.xs.shape[2] - 2
    if k_heuristic:
        assert got["pos.ccn.rows"] == int(want_mask[:, 2:].sum()) > 0
        assert got["pos.ccn.slots"] == eff * len(links)
    else:
        assert "pos.ccn.rows" not in got and "pos.ccn.slots" not in got
    # The readers read these counters.
    monkeypatch.setattr(profiling, "counters", lambda: dict(got))
    read = {m: spec.reader(m)(TraceContext()) for m in (
        "prep.slot_fill", "prep.ccn_row_fill", "prep.walk_mask_per_member")}
    assert read["prep.slot_fill"] == pytest.approx(100.0 * sum(sizes) / (bucket * len(links)))
    assert read["prep.walk_mask_per_member"] == pytest.approx(n * len(links) / sum(sizes))
    assert read["prep.ccn_row_fill"] == (
        pytest.approx(100.0 * int(want_mask[:, 2:].sum()) / (eff * len(links)))
        if k_heuristic else None)


@pytest.mark.parametrize("cap", [32, 64])
def test_walk_members_count_what_a_capped_bucket_leaves_out(cap):
    """A bucket below the 2 + 2·M·m nodes the walks can visit fills at
    most ``cap`` slots a link; ``pos.walks.members`` still counts every
    member the reference's walks visit."""
    n, ei, x, links = CASE
    sizes = np.array([len(w) for w in members(RefGraph(n, ei, x, "cpu"), links,
                                              link_seeds(KW["seed"], np.arange(len(links))),
                                              rw_m=KW["rw_m"], rw_M=KW["rw_M"])])
    assert sizes.max() > cap, "the fixture must overfill the bucket"
    _, got = _counted(lambda: _program(max_subgraph_nodes=cap))
    assert got["pos.slots"] == cap * len(links)
    assert got["pos.slots_used"] == int(np.minimum(sizes, cap).sum())
    assert got["pos.walks.members"] == int(sizes.sum())


@pytest.mark.parametrize("batch_size", [8, 16, 64])
def test_a_call_reads_the_card_side_sums_once(monkeypatch, batch_size):
    reads = []
    real = tpos.read_walk_sums

    def spy(sums):
        reads.append(sums.clone())
        return real(sums)
    monkeypatch.setattr(tpos, "read_walk_sums", spy)
    plan = tpos.pos_plan(_graph(), CASE[3], k_node_set_strategy="intersection", k_heuristic=1,
                         **{k: v for k, v in {**KW, "batch_size": batch_size}.items()
                            if k != "device"})
    _program(batch_size=batch_size)
    assert len(reads) == 1 and reads[0].shape == (3,)
    assert len(plan.batches) == -(-len(CASE[3]) // batch_size)


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_the_walk_spans_nest_in_the_walk_batch():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _program()
    spans = [e for e in prof.events()
             if getattr(e, "is_user_annotation", False) and e.name.startswith("pos.")]
    batches = [e for e in spans if e.name.startswith("pos.batch/")]
    assert batches and {e.name for e in batches} == {"pos.batch/walks/local/256"}
    for name in ("pos.walks", "pos.inputs", "pos.kernel"):
        parents = [_ancestors(e) for e in spans if e.name == name]
        assert len(parents) == len(batches), name
        assert all(a[0] == "pos.batch/walks/local/256" and a[-1] == "pos.precompute"
                   for a in parents), (name, parents)
    ccn = [_ancestors(e) for e in spans if e.name == "pos.ccn"]
    assert len(ccn) == len(batches) and all(a[0] == "pos.inputs" for a in ccn)


def test_the_paper_entry_reaches_precompute_pos_with_the_benchmarks_keywords(monkeypatch):
    suite = ExperimentSuite.load(os.path.join(ROOT, "configs", "paper", "scaled.json"))
    cfg = next(c for ident, _, _, c in suite.runs() if ident == "Cora_PoS_Plus_ScaLed")
    calls = []
    monkeypatch.setattr(runner, "precompute_pos", lambda *a, **kw: calls.append(kw))
    runner.precompute_split(_graph(), CASE[3], np.zeros(len(CASE[3])), cfg, device="cpu")
    (kw,) = calls
    assert (kw["rw_m"], kw["rw_M"], kw["k_heuristic"], kw["k_node_set_strategy"]) == \
        (3, 20, 1, "intersection")
    with open(os.path.join(ROOT, "benchmark", "configs", "cora_pos_plus_scaled.json")) as f:
        config = json.load(f)
    p = config["pos"]
    bench = pos_keywords(config, cfg.seed, "cpu")
    bench.update(k_heuristic=p["k_heuristic"], k_node_set_strategy=p["k_node_set_strategy"],
                 max_ccn=p["max_ccn_nodes"], rw_m=p["m"], rw_M=p["M"])
    for key in ("ratio_per_hop", "max_nodes_per_hop"):  # the runner's defaults of the call
        assert kw.pop(key) == {"ratio_per_hop": 1.0, "max_nodes_per_hop": None}[key]
    assert kw == bench
