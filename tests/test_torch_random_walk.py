"""Port parity, random walks and ScaLed's random-walk subgraphs.

Fed the uniforms that the JAX package's ``random_walks`` draws, the port's
walks equal its walks bit for bit. The port draws its own uniforms from a
counter-based hash of (link seed, step, walk): a link's node set is the same
alone and inside any batch, the uniforms pass a KS test against U(0, 1) and
a hub's next nodes a chi-square test for uniformity. From the same
membership mask the ScaLed structure is bit-exact with the JAX package's;
on the same subgraph batch the operators (the gather path, and the kernel's
plain version in local-slot mode) match its ``pos_operators`` within rtol
2e-3, atol 2e-4, PoS+ included. A seeded ScaLed PoS run learns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.models.n2v as jn2v
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu.sampling.random_walk as jrw
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.n2v import walk_steps
from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.sampling.random_walk import (
    extract_rw_subgraphs,
    hash_uniforms,
    rw_local_structure,
    rw_membership,
)
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=2e-3, atol=2e-4)
M_WALKS, M_LEN = 5, 3  # ScaLed's M and m at test size


def _graphs(seed=0, n=150, e=400, isolated=6, f=5):
    """The same graph for both packages: random edges on n nodes plus
    ``isolated`` nodes without edges, with normal features."""
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=n, e=e)
    n_all = n + isolated
    x = rng.normal(size=(n_all, f)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n_all, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(
        tgraph.Graph(num_nodes=n_all, edge_index=ei, x=x), device="cpu"
    )
    return rng, jd, td


def _deg(td):
    return td.nbr_mask.sum(dim=1).to(torch.int32)


@pytest.mark.parametrize("walk_length", [1, 20])
def test_walks_from_jax_uniforms_are_bit_exact(walk_length):
    rng, jd, td = _graphs()
    n_all = td.num_nodes
    starts = np.concatenate([rng.integers(0, n_all, 200), np.arange(n_all - 6, n_all)])
    starts = starts.astype(np.int32)
    jdeg = jnp.asarray(_deg(td).numpy())
    key = jax.random.PRNGKey(7)
    want = np.asarray(jn2v.random_walks(jd.nbr, jdeg, jnp.asarray(starts), key, walk_length))
    # The uniforms the JAX scan draws: split(key, L), then uniform per step.
    keys = jax.random.split(key, walk_length)
    u = np.stack([np.asarray(jax.random.uniform(k, (len(starts),))) for k in keys])
    got = walk_steps(td.nbr, _deg(td), torch.as_tensor(starts), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    # Isolated nodes stay in place; every step follows an edge otherwise.
    iso = starts >= n_all - 6
    assert (got.numpy()[iso] == starts[iso, None]).all()
    adj = {(int(a), int(b)) for a, b in zip(*td.host_edges()[:2])}
    g = got.numpy()[~iso]
    assert all((int(a), int(b)) in adj for a, b in zip(g[:, :-1].ravel(), g[:, 1:].ravel()))


def test_hash_uniforms_are_uniform_and_independent_of_the_batch():
    seeds = torch.arange(-50, 4950, dtype=torch.int32)
    u = hash_uniforms(seeds, 3, 40)
    assert u.shape == (5000, 3, 40) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert stats.kstest(u.numpy().ravel(), "uniform").pvalue > 0.01
    # Each link's uniforms depend on its own seed only.
    perm = torch.randperm(5000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(hash_uniforms(seeds[perm], 3, 40), u[perm])
    assert torch.equal(hash_uniforms(seeds[7:8], 3, 40), u[7:8])
    # Neighbouring seeds, steps and walks are not correlated.
    flat = u.reshape(5000, -1).numpy()
    assert abs(np.corrcoef(flat[:-1].ravel(), flat[1:].ravel())[0, 1]) < 0.01
    assert abs(np.corrcoef(flat[:, :-1].ravel(), flat[:, 1:].ravel())[0, 1]) < 0.01


def test_next_nodes_from_a_hub_are_uniform():
    _, _, td = _graphs(1, n=60, e=900)
    hub = int(_deg(td).argmax())
    d = int(_deg(td)[hub])
    links = torch.tensor([[hub, hub]] * 600)
    u = hash_uniforms(torch.arange(600, dtype=torch.int32), 1, 2 * M_WALKS)
    starts = links.repeat(1, M_WALKS).reshape(-1)
    nxt = walk_steps(td.nbr, _deg(td), starts, u.permute(1, 0, 2).reshape(1, -1))[:, 1]
    counts = np.bincount(
        np.searchsorted(np.sort(td.nbr[hub, :d].numpy()), nxt.numpy()), minlength=d
    )
    assert counts.sum() == 6000 and len(counts) == d
    assert stats.chisquare(counts).pvalue > 0.01


def test_a_links_node_set_is_the_same_alone_and_in_any_batch():
    rng, _, td = _graphs(2)
    links = torch.as_tensor(rng.integers(0, 150, (24, 2)))
    seeds = torch.as_tensor((np.int64(3) * 1_000_003 + np.arange(24)).astype(np.int32))
    kw = dict(rw_m=M_LEN, rw_M=M_WALKS)
    member = rw_membership(td, links, seeds, **kw)
    assert (member.sum(dim=1) <= 2 * M_WALKS * (M_LEN + 1)).all()
    assert member[torch.arange(24), links[:, 0]].all() and member[torch.arange(24), links[:, 1]].all()
    for idx in (torch.arange(5, 6), torch.arange(24).flip(0), torch.arange(0, 24, 3)):
        assert torch.equal(rw_membership(td, links[idx], seeds[idx], **kw), member[idx])


def _jax_membership(jd, links, seeds):
    """The membership of the JAX package's ScaLed walks (random_walk.py:56-63)."""
    deg = jd.nbr_mask.sum(axis=1).astype(jnp.int32)
    out = np.zeros((len(links), jd.num_nodes), dtype=bool)
    for b, (link, seed) in enumerate(zip(links, seeds)):
        rw = jn2v.random_walks(jd.nbr, deg, jnp.tile(jnp.asarray(link), M_WALKS),
                               jax.random.PRNGKey(int(seed)), M_LEN)
        out[b, np.asarray(rw).ravel()] = True
    return out


@pytest.fixture(scope="module")
def scaled_batch():
    """JAX's ScaLed subgraphs of 16 links (S = 64), their membership, and
    the port's structure from that membership."""
    rng, jd, td = _graphs(3)
    links = rng.integers(0, 150, (16, 2)).astype(np.int32)
    links[:4] = np.asarray(td.host_edges()[:2]).T[:4]  # four observed links
    seeds = np.arange(100, 116, dtype=np.int32)
    jsub = jrw.extract_rw_subgraphs(jd, jnp.asarray(links), jnp.asarray(seeds),
                                    rw_m=M_LEN, rw_M=M_WALKS, max_nodes=64)
    member = torch.as_tensor(_jax_membership(jd, links, seeds))
    tsub = rw_local_structure(td, torch.as_tensor(links), member, max_nodes=64)
    return jd, td, jsub, tsub


def test_scaled_structure_from_the_same_membership_is_bit_exact(scaled_batch):
    _, _, jsub, tsub = scaled_batch
    for name in ("nodes", "node_mask", "dist", "nbr_local", "nbr_w", "sub_size"):
        np.testing.assert_array_equal(getattr(tsub, name).numpy(), np.asarray(getattr(jsub, name)),
                                      err_msg=name)
    assert int(tsub.node_mask.sum(dim=1).max()) <= 2 * M_WALKS * (M_LEN + 1)


@pytest.mark.parametrize("max_ccn,strategy", [(0, ""), (8, "union"), (8, "intersection")])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_scaled_operators_match_jax(scaled_batch, max_ccn, strategy, use_kernel):
    jd, td, jsub, tsub = scaled_batch
    kw = dict(sign_k=3, max_ccn=max_ccn, strategy=strategy)
    xj, mj = jpos.pos_operators(jsub, jd.x, use_pallas=False, **kw)
    xt, mt = tpos.pos_operators(tsub, td.x, use_kernel=use_kernel, **kw)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), **TOL)


def test_scaled_precompute_is_batch_independent_and_needs_no_bfs(monkeypatch):
    def no_bfs(*args, **kwargs):
        raise AssertionError("ScaLed ran the BFS sizing pass")

    monkeypatch.setattr(tpos, "measure_subgraph_sizes", no_bfs)
    rng, _, td = _graphs(4)
    links = rng.integers(0, 150, (40, 2)).astype(np.int32)
    y = rng.integers(0, 2, 40).astype(np.float32)
    kw = dict(num_hops=0, sign_k=2, seed=5, rw_m=M_LEN, rw_M=M_WALKS,
              buckets=(16, 64, 128), max_subgraph_nodes=128, device="cpu")
    a = tpos.precompute_pos(td, links, y, batch_size=8, **kw)
    b = tpos.precompute_pos(td, links, y, batch_size=64, **kw)
    assert a.xs.shape == (40, 3, 2, 6)
    assert torch.equal(a.row_mask, b.row_mask)
    np.testing.assert_allclose(a.xs.numpy(), b.xs.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k_heuristic,strategy", [(0, ""), (1, "intersection")])
def test_scaled_batch_plan_rebuilds_the_first_batch(k_heuristic, strategy):
    """A batch built from ``scaled_batch_plan`` (bucket, batch size, link
    seeds), as chip_smoke.py builds the kernel check's, gives
    ``precompute_pos``'s own rows for its links."""
    rng, _, td = _graphs(4)
    links = rng.integers(0, 150, (40, 2)).astype(np.int32)
    y = rng.integers(0, 2, 40).astype(np.float32)
    buckets, cap, seed = (16, 64, 128), 128, 5
    eff_ccn = tpos.padded_ccn_width(td, links, strategy, 8) if k_heuristic else 0
    S, B, seeds = tpos.scaled_batch_plan(
        td, 40, rw_m=M_LEN, rw_M=M_WALKS, seed=seed, eff_ccn=eff_ccn, buckets=buckets,
        max_subgraph_nodes=cap, batch_size=8,
    )
    assert S == 64 and B == 8  # 2M(m+1) = 40 nodes at most
    np.testing.assert_array_equal(seeds, (np.int64(seed) * 1_000_003 + np.arange(40)).astype(np.int32))
    ds = tpos.precompute_pos(
        td, links, y, num_hops=0, sign_k=2, k_heuristic=k_heuristic,
        k_node_set_strategy=strategy, max_ccn=8, buckets=buckets, batch_size=8,
        max_subgraph_nodes=cap, seed=seed, rw_m=M_LEN, rw_M=M_WALKS, device="cpu",
    )
    sub = extract_rw_subgraphs(td, torch.as_tensor(links[:B]), torch.as_tensor(seeds[:B]),
                               rw_m=M_LEN, rw_M=M_WALKS, max_nodes=S)
    sel, nbr, w, x, mask = tpos.local_kernel_inputs(sub, td.x, max_ccn=eff_ccn, strategy=strategy)
    xs = pos_power_rows(sel, nbr, w, x, sign_k=2) * mask[:, None, :, None]
    assert torch.equal(ds.row_mask[:B], mask)
    np.testing.assert_allclose(ds.xs[:B].numpy(), xs.numpy(), rtol=1e-6, atol=1e-7)


def test_scaled_pos_learns(tmp_path):
    """tests/test_models_extra.py::test_scaled_pos_end_to_end's bar (best
    test AUC > 55) and config, on the synthetic graph with 2 epochs over all
    train links at hidden 32: at its 1 epoch over 15 % of them at hidden 16
    the JAX package stays below the bar here too (50.8)."""
    cfg = RunConfig(
        dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
        init_features="degree", use_feature=True, sign_k=2, node_label="zo",
        hidden_channels=32, batch_size=32, lr=1e-3, epochs=2, seed=1,
        m=3, M=5, train_percent=100.0, val_percent=40.0, test_percent=40.0,
        max_subgraph_nodes=64, subgraph_buckets=(64,), delete_dataset=True,
        results_dir=str(tmp_path),
    )
    rng, _ = seed_everything(cfg.seed)
    graph, split = do_edge_split(
        tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng
    )
    _, best, _, _, _ = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert best > 55.0
