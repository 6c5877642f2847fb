"""Port parity, per-hop sampling (``ratio_per_hop``, ``max_nodes_per_hop``).

The JAX package ranks each hop's newly reached nodes by
``jax.random.uniform(fold_in(PRNGKey(link_seed), hop), (N,))``;
``sampling/prng.py`` reproduces those uniforms bit for bit, so the sampled
node sets, masks, hop distances and local tables are equal to the JAX
package's, exactly, and do not depend on how links are batched. The
operator datasets built on them agree at the kernel's bar (rtol 2e-3, atol
2e-4); one SEAL step on the dynamic route and one WalkPool step, each on a
sampled batch, agree within 1e-5. Every runner route that reads the flags
takes them.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.models.gnn as jgnn
import s3grl_tpu.models.walkpool as jwp
import s3grl_tpu.operators.fullrow as jfull
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu.sampling.labeling as jlab
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.models.gnn as tgnn
import s3grl_tpu_torch.models.walkpool as twp
import s3grl_tpu_torch.operators.fullrow as tfull
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu.train.loop import bce_with_logits as j_bce
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.models.convert import gnn_state_dict_from_flax, walkpool_state_dict_from_flax
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.sampling.prng import uniforms
from s3grl_tpu_torch.train.gnn_loop import extract_and_label
from s3grl_tpu_torch.train.loop import bce_with_logits
from s3grl_tpu_torch.train.walkpool_loop import walkpool_batch
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.test_extraction import random_graph
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=2e-3, atol=2e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLING = [(0.5, None), (1.0, 4), (0.5, 4)]
SEEDS = np.array([0, 11, 2**20 + 7, -5, 3_000_012, 2**31 - 1], dtype=np.int32)


def _graphs(which: str):
    """(edge index, n): tests/test_extraction.py:67's dense graph, or the
    sparser random graph of tests/test_pos_pallas.py."""
    if which == "dense":
        g = random_graph(n=60, p=0.3, seed=3)
        return g.edge_index, 60
    return random_edges(np.random.default_rng(5), n=150, e=500), 150


def _pair(ei, n, f=0):
    x = np.random.default_rng(9).normal(size=(n, f)).astype(np.float32) if f else None
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    return jd, td


@pytest.mark.parametrize("hop", [1, 2, 3])
def test_uniforms_equal_jax_random_bit_for_bit(hop):
    n = 1000
    want = np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(int(s)), hop), (n,)))
        for s in SEEDS
    ])
    ids = torch.arange(n).expand(len(SEEDS), n)
    got = uniforms(torch.as_tensor(SEEDS), hop, ids).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # Evaluated at scattered ids only, each value is the same.
    pick = np.random.default_rng(hop).integers(0, n, (len(SEEDS), 7))
    part = uniforms(torch.as_tensor(SEEDS), hop, torch.as_tensor(pick)).numpy()
    np.testing.assert_array_equal(part, np.take_along_axis(got, pick, axis=1))


@pytest.mark.parametrize("ratio,cap", SAMPLING)
@pytest.mark.parametrize("hops", [2, 3])
@pytest.mark.parametrize("graph", ["dense", "sparse"])
def test_sampled_extraction_equals_jax(graph, hops, ratio, cap):
    ei, n = _graphs(graph)
    jd, td = _pair(ei, n)
    rng = np.random.default_rng(hops)
    links = rng.integers(0, n, (len(SEEDS), 2)).astype(np.int32)
    links[0] = ei[:, 0]  # an observed edge
    links[1, 1] = links[1, 0]  # a self-link
    kw = dict(num_hops=hops, max_nodes=64, ratio_per_hop=ratio, max_nodes_per_hop=cap)
    want = jext.extract_subgraphs(jd, jnp.asarray(links), link_seeds=jnp.asarray(SEEDS), **kw)
    got = text.extract_subgraphs(td, torch.as_tensor(links), link_seeds=torch.as_tensor(SEEDS),
                                 **kw)
    for name, w, g in zip(want._fields, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    full = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=hops, max_nodes=64)
    assert (got.sub_size <= full.sub_size).all()
    if cap is not None:
        assert int(got.node_mask.sum(1).max()) <= 2 + hops * cap


@pytest.mark.parametrize("ratio,cap", SAMPLING)
def test_sampled_set_does_not_depend_on_the_batch(ratio, cap):
    ei, n = _graphs("sparse")
    _, td = _pair(ei, n)
    links = np.random.default_rng(3).integers(0, n, (12, 2)).astype(np.int32)
    seeds = (np.int64(7) * 1_000_003 + np.arange(12)).astype(np.int32)
    kw = dict(num_hops=2, max_nodes=128, ratio_per_hop=ratio, max_nodes_per_hop=cap)
    whole = text.extract_node_sets(td, torch.as_tensor(links),
                                   link_seeds=torch.as_tensor(seeds), **kw)
    for order in (np.arange(12)[::-1], np.random.default_rng(4).permutation(12)):
        for part in np.array_split(order, 3):
            got = text.extract_node_sets(td, torch.as_tensor(links[part]),
                                         link_seeds=torch.as_tensor(seeds[part]), **kw)
            for w, g in zip(whole, got):
                np.testing.assert_array_equal(g.numpy(), w.numpy()[part])


@pytest.mark.parametrize("ratio,cap", SAMPLING)
def test_sampled_sizes_equal_extraction_and_jax(ratio, cap):
    ei, n = _graphs("sparse")
    jd, td = _pair(ei, n)
    links = np.random.default_rng(8).integers(0, n, (40, 2)).astype(np.int32)
    seeds = (np.int64(2) * 1_000_003 + np.arange(40)).astype(np.int32)
    kw = dict(num_hops=2, ratio_per_hop=ratio, max_nodes_per_hop=cap)
    got = tpos.measure_subgraph_sizes(td, links, seeds, batch_size=16, **kw)
    sub = text.extract_subgraphs(td, torch.as_tensor(links), max_nodes=150,
                                 link_seeds=torch.as_tensor(seeds), **kw)
    np.testing.assert_array_equal(got, sub.sub_size.numpy())
    np.testing.assert_array_equal(got, jpos.measure_subgraph_sizes(jd, links, seeds, **kw))


@pytest.mark.parametrize("ccn", [{}, dict(k_heuristic=1, max_ccn=8,
                                          k_node_set_strategy="intersection")])
@pytest.mark.parametrize("ratio,cap", SAMPLING)
def test_sampled_precompute_pos_matches_jax(ratio, cap, ccn):
    ei, n = _graphs("sparse")
    jd, td = _pair(ei, n, f=7)
    rng = np.random.default_rng(1)
    links = rng.integers(0, n, (24, 2)).astype(np.int32)
    y = rng.integers(0, 2, 24).astype(np.float32)
    kw = dict(num_hops=2, sign_k=2, buckets=(16, 32, 64), batch_size=8, max_subgraph_nodes=64,
              ratio_per_hop=ratio, max_nodes_per_hop=cap, seed=3, **ccn)
    a = jpos.precompute_pos(jd, links, y, **kw)
    b = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(a.row_mask), b.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(a.xs), b.xs.numpy(), **TOL)


@pytest.mark.parametrize("ratio,cap", SAMPLING)
def test_sampled_fullrow_matches_jax(ratio, cap):
    ei, n = _graphs("dense")
    jd, td = _pair(ei, n, f=6)
    links = np.random.default_rng(33).integers(0, n, (10, 2)).astype(np.int32)
    y = np.ones(10, np.float32)
    kw = dict(num_hops=2, sign_k=2, buckets=(16, 32, 64), batch_size=4, max_subgraph_nodes=64,
              node_label="drnl", ratio_per_hop=ratio, max_nodes_per_hop=cap, seed=5)
    want = jfull.precompute_pos_fullrow(jd, links, y, **kw)
    got = tfull.precompute_pos_fullrow(td, links, y, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(want.row_mask), got.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.xs), got.xs.numpy(), **TOL)


def _sampled_batch(max_nodes_per_hop=3, ratio=0.5):
    """A link batch of the synthetic USAir-shaped graph (200 nodes): the
    graph in both packages, links, their seeds."""
    n, ei = 200, usair_like_edges(3, n=200)
    jd, td = _pair(ei, n)
    rng = np.random.default_rng(42)
    links = np.concatenate([ei[:, rng.choice(ei.shape[1], 6)].T,
                            rng.integers(0, n, (6, 2))]).astype(np.int32)
    seeds = (np.int64(1) * 1_000_003 + np.arange(12)).astype(np.int32)
    return jd, td, links, seeds, np.arange(12) % 2 == 0


def test_sampled_seal_step_matches_jax():
    """The SEAL dynamic route's batch (extraction with both flags, dense
    adjacency, DRNL) equals the JAX package's; GCN's BCE gradients in train
    mode (dropout 0) on it within 1e-5."""
    jd, td, links, seeds, y = _sampled_batch()
    kw = dict(num_hops=2, ratio_per_hop=0.5, max_nodes_per_hop=3)
    S = 32
    jsub = jext.extract_subgraphs(jd, jnp.asarray(links), max_nodes=S,
                                  link_seeds=jnp.asarray(seeds), **kw)
    jadj = jext.dense_adjacency(jsub)
    jz = jlab.label_nodes(jadj, jsub.dist, jsub.node_mask, node_label="drnl", max_iters=S)
    adj, z, mask, _ = extract_and_label(td, torch.as_tensor(links), max_nodes=S, node_label="drnl",
                                        max_iters=S, link_seeds=torch.as_tensor(seeds), **kw)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jsub.node_mask))

    jm = jgnn.GCNModel(16, 3, dropout=0.0)
    v = jm.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                jadj, jz, jsub.node_mask, train=True)
    v = jax.tree_util.tree_map(np.array, v)
    tm = tgnn.GCNModel(16, 3, dropout=0.0)
    tm.load_state_dict(gnn_state_dict_from_flax(v, "GCN"))
    yj = jnp.asarray(y.astype(np.float32))

    def loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jadj, jz,
                          jsub.node_mask, train=True, mutable=["batch_stats"])
        return j_bce(out, yj).mean()

    grads = jax.grad(loss)(v["params"])
    want = gnn_state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, grads), "batch_stats": v["batch_stats"]},
        "GCN",
    )
    tm.train()
    bce_with_logits(tm(adj, z, mask), torch.as_tensor(y.astype(np.float32))).mean().backward()
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), err_msg=key, **STEP_TOL)


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = False

    def __call__(self, x, deterministic=None):
        return x


def test_sampled_walkpool_step_matches_jax(monkeypatch):
    """WalkPool's batch with max_nodes_per_hop (the candidate injected
    before DRNL) equals the JAX loop's; one train-mode step, dropout taken
    out of both packages, gives gradients and running statistics within
    1e-5."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(twp, "_dropout", lambda x, p, training, generator: x)
    jd, td, links, seeds, y = _sampled_batch()
    S = 32
    jsub = jext.extract_subgraphs(jd, jnp.asarray(links), num_hops=2, max_nodes=S,
                                  max_nodes_per_hop=3, link_seeds=jnp.asarray(seeds))
    jadj = jext.dense_adjacency(jsub).at[:, 0, 1].set(1.0).at[:, 1, 0].set(1.0)
    jz = jlab.label_nodes(jadj, jsub.dist, jsub.node_mask, node_label="drnl", max_iters=S)
    jx = jnp.ones((len(links), S, 1))
    cfg = RunConfig(num_hops=2, node_label="drnl", ratio_per_hop=0.5, max_nodes_per_hop=3)
    adj, z, mask, x = walkpool_batch(td, torch.as_tensor(links), cfg, S,
                                     torch.as_tensor(seeds))
    for got, want in ((adj, jadj), (z, jz), (mask, jsub.node_mask), (x, jx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jm = jwp.WalkPoolLinkPred(hidden_channels=8, heads=2, walk_len=7, drnl=True)
    v = jm.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                jadj, jz, jsub.node_mask, x=jx)
    v = jax.tree_util.tree_map(np.array, v)
    tm = twp.WalkPoolLinkPred(1, 8, heads=2, walk_len=7, drnl=True)
    tm.load_state_dict(walkpool_state_dict_from_flax(v), strict=True)
    yj = jnp.asarray(y.astype(np.float32))

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jadj, jz,
                            jsub.node_mask, x=jx, train=True, mutable=["batch_stats"])
        return j_bce(out, yj).mean(), mut["batch_stats"]

    (_, new_bs), g = jax.value_and_grad(loss, has_aux=True)(v["params"])
    want = walkpool_state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, g),
                                          "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)})
    tm.train()
    bce_with_logits(tm(adj, z, mask, x), torch.as_tensor(y.astype(np.float32))).mean().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **STEP_TOL)
    for name, t in tm.named_buffers():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), err_msg=name, **STEP_TOL)


SMALL = dict(
    dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
    init_features="degree", use_feature=True, sign_k=2, node_label="zo", hidden_channels=32,
    batch_size=32, lr=1e-3, num_hops=2, seed=1, extract_batch_size=64,
    max_subgraph_nodes=256, subgraph_buckets=(64, 256), delete_dataset=True, epochs=1,
    train_percent=5.0, val_percent=20.0, test_percent=20.0,
    ratio_per_hop=0.5, max_nodes_per_hop=6,
)
ROUTES = {
    "PoS": {},
    "PoS+": dict(k_heuristic=1, k_node_set_strategy="intersection", k_pool_strategy="mean",
                 pool_operatorwise=True),
    "hybrid": dict(sign_type="hybrid", pool_operatorwise=True),
    "fullrow": dict(optimize_sign=False, node_label="drnl"),
    "SEAL": dict(model="DGCNN", node_label="drnl", init_features="", use_feature=False,
                 hidden_channels=16, num_layers=3),
}


@pytest.fixture(scope="module")
def usair_split():
    rng, _ = seed_everything(1)
    return do_edge_split(tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)


@pytest.mark.parametrize("route", list(ROUTES))
def test_runner_takes_per_hop_sampling(usair_split, route, tmp_path):
    graph, split = usair_split
    cfg = RunConfig(**{**SMALL, **ROUTES[route]}, results_dir=str(tmp_path))
    _, best, ttimes, _, _ = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert np.isfinite(best) and best > 0.0 and len(ttimes) == 1
