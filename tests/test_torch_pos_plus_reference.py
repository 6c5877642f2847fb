"""PoS Plus against the benchmark's plain reference
(``benchmark/reference_pos_plus.py``) on the CPU: ``precompute_pos`` with
common-neighbour rows (intersection and union) on the host and device BFS
and on the global and local tables agrees with it within a float32 bar,
and the same comparison fails that bar with the reference in TF32 or with
one CCN row dropped; SIGNNet's mean and sum CCN pooling agree with its
forward on the same weights; the storage tier keeps the Cora cell's train
split in float32 at its full CCN width on an 80 GB card and is unchanged on
the CPU; and the CCN and storage counters and spans are what the plan and
the reference imply."""
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import s3grl_tpu_torch.operators.pos as tpos
from benchmark.cellbase import worst_relative_gap
from benchmark.reference import Arith, RefGraph, flat
from benchmark.reference_pos_plus import pos_plus_rows, signnet_plus
from s3grl_tpu_torch import profiling
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.models.signnet import SIGNNet
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from tests.torch_port_helpers import one_torch_thread, random_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

# The worst relative gap of a link's rows (the benchmark's ``ops_gap``) that
# float32 arithmetic leaves: each entry sums at most a few hundred products
# (K = 3 powers over subgraphs of <= 80 nodes with ~10 neighbours a row,
# times 7 features), so rounding at 2^-24 a step stays below ~1e-6 of the
# block's largest entry; TF32's 2^-11 on every operand reads ~1e-4 and
# more, and a dropped row reads its own size, 1e-2 and more.
BAR = 1e-5
KW = dict(num_hops=2, sign_k=3, buckets=(32, 64, 128), batch_size=16, max_subgraph_nodes=128,
          k_heuristic=1, max_ccn=64, seed=3, device="cpu")
ROUTES = {"host": "1", "device": "0"}  # S3GRL_TPU_HOST_EXTRACT
TABLES = {"global": "0", "local": "1"}  # S3GRL_TPU_LOCAL_TAB


def _case(seed=7, n=80, e=400, f=7, n_links=40):
    """A random graph with normal features; half its links edges of the
    graph (common neighbours and a removed link), half any pair."""
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=n, e=e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    some_edges = ei[:, rng.choice(ei.shape[1], n_links // 2, replace=False)].T
    pairs = rng.integers(0, n, (n_links - len(some_edges), 2))
    links = np.concatenate([some_edges, pairs])
    links = links[links[:, 0] != links[:, 1]].astype(np.int32)
    return n, ei, x, links


def _program(monkeypatch, strategy, route="device", table="global", case=None):
    n, ei, x, links = case or _case()
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", ROUTES[route])
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", TABLES[table])
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    y = np.zeros(len(links), np.float32)
    return tpos.precompute_pos(dg, links, y, k_node_set_strategy=strategy, **KW)


def _reference(strategy, width, precision="float64", case=None):
    n, ei, x, links = case or _case()
    return pos_plus_rows(RefGraph(n, ei, x, "cpu"), links, num_hops=KW["num_hops"],
                         sign_k=KW["sign_k"], max_nodes=KW["max_subgraph_nodes"],
                         strategy=strategy, width=width, precision=precision)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("strategy", ["intersection", "union"])
def test_precompute_pos_plus_agrees_with_the_reference(monkeypatch, strategy, route, table):
    ds = _program(monkeypatch, strategy, route, table)
    want, want_mask = _reference(strategy, ds.xs.shape[2])
    assert want.shape == ds.xs.shape, "the program's CCN width holds every link's rows"
    assert torch.equal(ds.row_mask, want_mask)
    assert want_mask[:, 2:].any(), "the fixture must have CCN rows"
    assert worst_relative_gap(ds.xs.numpy(), want.numpy()) < BAR


def _drop_last_ccn_row(monkeypatch):
    """Plant the fault: each link's last CCN row left out (its mask False,
    so the operators zero it)."""
    real = tpos._ccn_select

    def planted(*args):
        sel_idx, row_mask = real(*args)
        row_mask = row_mask.clone()
        kept = row_mask.sum(dim=1)
        has = kept > 2
        row_mask[torch.nonzero(has).squeeze(1), kept[has] - 1] = False
        return sel_idx, row_mask
    monkeypatch.setattr(tpos, "_ccn_select", planted)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("wrong", ["reference_in_tf32", "one_ccn_row_dropped"])
def test_a_lower_precision_or_a_dropped_row_fails_the_bar(monkeypatch, wrong, table):
    if wrong == "reference_in_tf32":
        ds = _program(monkeypatch, "intersection", table=table)
        got = _reference("intersection", ds.xs.shape[2], precision="tf32")[0].numpy()
    else:
        _drop_last_ccn_row(monkeypatch)
        ds = _program(monkeypatch, "intersection", table=table)
        got = ds.xs.numpy()
    want = _reference("intersection", ds.xs.shape[2])[0].numpy()
    assert worst_relative_gap(got, want) > BAR


# SIGNNet's logits against the reference's on the same weights: float32
# sums of at most 128 products a unit (D_in = 4 x 8, hidden 16, pooled 32)
# stay near 1e-6 of logits of order 1; 1e-5 leaves room.
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = {"w1": "operator_diff.lins.0.weight", "b1": "operator_diff.lins.0.bias",
          "g1": "operator_diff.norms.0.weight", "be1": "operator_diff.norms.0.bias",
          "rm1": "operator_diff.norms.0.running_mean", "rv1": "operator_diff.norms.0.running_var",
          "w2": "link_pred_mlp.lins.0.weight", "b2": "link_pred_mlp.lins.0.bias",
          "g2": "link_pred_mlp.norms.0.weight", "be2": "link_pred_mlp.norms.0.bias",
          "rm2": "link_pred_mlp.norms.0.running_mean", "rv2": "link_pred_mlp.norms.0.running_var",
          "w3": "link_pred_mlp.lins.1.weight", "b3": "link_pred_mlp.lins.1.bias"}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("pool", ["mean", "sum"])
def test_signnet_ccn_pooling_agrees_with_the_reference(monkeypatch, pool, train):
    ds = _program(monkeypatch, "intersection")
    x = flat(ds.xs)
    gen = torch.Generator().manual_seed(11)
    model = SIGNNet(x.shape[2], 16, KW["sign_k"], dropout=0.0, k_heuristic=1,
                    k_pool_strategy=pool, generator=gen)
    with torch.no_grad():  # running statistics away from 0 and 1
        for norm in (model.operator_diff.norms[0], model.link_pred_mlp.norms[0]):
            norm.running_mean.normal_(generator=gen)
            norm.running_var.uniform_(0.5, 2.0, generator=gen)
    state = model.state_dict()
    p = {k: state[v].detach().to(torch.float64).clone() for k, v in PARAMS.items()}
    model.train(train)
    with torch.no_grad():
        got = model(x, ds.row_mask)
    keep = (torch.ones(x.shape[:2] + (16,)), torch.ones(x.shape[0], 16))
    want = signnet_plus(p, x.to(torch.float64), ds.row_mask, Arith("float64"), pool=pool,
                        train=train, keep=keep, dropout=0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)


# Cora's PoS+ train split in the benchmark cell: 17,952 links, sign_k 3,
# 1,433 features, CCN width 16 (R = 18): 7.4 GB in float32.
CORA_TRAIN = dict(L=17_952, sign_k=3, F=1_433, eff_ccn=16)


def _tier(dev):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = tpos._storage_tier(dev=torch.device(dev), **CORA_TRAIN)
    return got, [str(w.message) for w in seen]


def test_the_storage_tier_follows_the_card_and_is_unchanged_elsewhere(monkeypatch):
    monkeypatch.delenv("S3GRL_TPU_DEVICE_DS_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(total_memory=80 * 10**9))
    (eff, dtype, place), seen = _tier("cuda")
    assert (eff, dtype, place.type) == (16, torch.float32, "cuda") and not seen
    # On the CPU the budget is DEVICE_DS_BYTES (3.5e9): the pad halved, bf16.
    (eff, dtype, place), seen = _tier("cpu")
    assert (eff, dtype, place.type) == (8, torch.bfloat16, "cpu")
    assert any("CCN pad halved" in m for m in seen)
    # With the variable set, the card's budget is the variable, as before.
    monkeypatch.setenv("S3GRL_TPU_DEVICE_DS_BYTES", "3.5e9")
    (eff, dtype, place), seen = _tier("cuda")
    assert (eff, dtype, place.type) == (8, torch.bfloat16, "cuda")
    assert any("CCN pad halved" in m for m in seen)


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if k.startswith(("pos.ccn.", "pos.store.")) and after[k] != before.get(k, 0)}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("strategy", ["intersection", "union"])
def test_ccn_counters_equal_the_references_rows(monkeypatch, strategy, table):
    ds, got = _counted(lambda: _program(monkeypatch, strategy, table=table))
    eff = ds.xs.shape[2] - 2
    _, want_mask = _reference(strategy, ds.xs.shape[2])
    ccn = want_mask[:, 2:].sum(dim=1)
    assert got == {"pos.ccn.rows": int(ccn.clamp(max=eff).sum()),
                   "pos.ccn.slots": eff * len(ds.xs), "pos.store.f32": 1}
    assert 0 < got["pos.ccn.rows"] < got["pos.ccn.slots"]


@pytest.mark.parametrize("tier", ["bf16", "host"])
def test_store_counters_name_the_tier(monkeypatch, tier):
    f32_bytes = _program(monkeypatch, "intersection").xs.nbytes
    monkeypatch.setenv("S3GRL_TPU_DEVICE_DS_BYTES", str(f32_bytes // 2 if tier == "bf16" else 1))
    ds, got = _counted(lambda: _program(monkeypatch, "intersection"))
    assert got[f"pos.store.{tier}"] == 1
    assert not {k for k in got if k.startswith("pos.store.")} - {f"pos.store.{tier}"}
    assert ds.xs.dtype == (torch.bfloat16 if tier == "bf16" else torch.float32)


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


@pytest.mark.parametrize("table", sorted(TABLES))
def test_the_ccn_spans_nest_inside_the_precompute(monkeypatch, table):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _program(monkeypatch, "intersection", table=table)
    spans = [e for e in prof.events()
             if getattr(e, "is_user_annotation", False) and e.name.startswith("pos.")]
    width = [_ancestors(e) for e in spans if e.name == "pos.ccn_width"]
    assert width == [["pos.plan", "pos.precompute"]]
    ccn = [_ancestors(e) for e in spans if e.name == "pos.ccn"]
    batches = [e for e in spans if e.name.startswith("pos.batch/")]
    assert len(ccn) == len(batches) > 0
    assert all(a[0] == "pos.inputs" and a[1] == f"pos.batch/device/{table}/{a[1].split('/')[-1]}"
               and a[-1] == "pos.precompute" for a in ccn), ccn
