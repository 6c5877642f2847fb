"""Port parity, multi-device: ``s3grl_tpu_torch/parallel`` in spawned gloo
ranks on the CPU, against ``s3grl_tpu/parallel`` on the conftest's
8-device CPU mesh and against the port's own single-process results.

The ranks run in fresh processes that import no JAX
(``tests/torch_dist_ranks.py``): one spawn of 2 ranks (the chain, the
chain of a graph whose dense blocks pass the block budget, PoS, SoP, a
data-parallel step and its collective census) and one of 4 (the chain, and
tensor-parallel SIGNNet on a (2, 2) mesh); the weak-scaling harness spawns
its own. Every group has a collective timeout and the spawn a bounded join
(``parallel/mesh.py``).

Bars: the chain within rtol 1e-5, atol 1e-6 of the JAX chain; PoS
operators within the parity bar rtol 2e-3, atol 2e-4, row masks exact; SoP
within rtol 1e-4, atol 1e-5; SIGNNet's forward and step within 1e-5.
Against the port's single-process results PoS is equal bit for bit (a
link's rows do not depend on its batch), and so is the chain against the
square matrix's CSR walk, one process's chain (a shard's CSR holds each
row's nonzeros in the square one's order, and the CPU runs the kernel's
walk, ``csr_spmm_reference``, on both). One process's SoP takes the CSR
walk or the edge list, which adds a row's terms in another order: within
1e-6 of the shards. On the card both sides walk the same CSR in the
kernel, bit for bit (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.parallel.dist as jdist
import s3grl_tpu.sampling.extraction as jext
from s3grl_tpu.models.signnet import SIGNNet as JSIGNNet
from s3grl_tpu.parallel.mesh import make_mesh as j_make_mesh
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.models.convert import signnet_state_dict_from_flax
from s3grl_tpu_torch.operators.pos import precompute_pos
from s3grl_tpu_torch.operators.sop import precompute_sop
from s3grl_tpu_torch.ops.spmm import normalized_adjacency_weights
from s3grl_tpu_torch.ops.spmm_kernel import (
    BLOCK_SIZE,
    BUDGET_BYTES,
    bsr_spmm,
    csr_matrix,
    csr_spmm_reference,
    num_blocks,
    power_chain_of,
    should_use_bsr,
)
from s3grl_tpu_torch.parallel import dist as pdist
from s3grl_tpu_torch.parallel.mesh import run_ranks, share
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from torch_dist_ranks import four_rank_checks, signnet, two_rank_checks
from torch_port_helpers import one_torch_thread

one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

POS_KW = dict(num_hops=2, sign_k=3, buckets=(32, 64, 128), batch_size=16,
              max_subgraph_nodes=128, seed=7)
HIDDEN = 32
SPAWN_TIMEOUT_S = 240


def _toy_graph(seed, n=150, e=600, f=9):
    """tests/test_distributed.py's graph: (symmetrized edge index, x)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ei = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    return ei, rng.normal(size=(n, f)).astype(np.float32), rng


def _jdg(ei, x):
    return jext.DeviceGraph.from_graph(jgraph.Graph(edge_index=ei, num_nodes=len(x), x=x))


def _tdg(ei, x):
    return DeviceGraph.from_graph(Graph(num_nodes=len(x), edge_index=ei, x=x), device="cpu")


def _chain_inputs(n=151, e=600, f=9):
    """A graph of 151 nodes by default: no world size here divides it."""
    ei, x, _ = _toy_graph(1, n=n, e=e, f=f)
    w = normalized_adjacency_weights(torch.as_tensor(ei[0], dtype=torch.int64),
                                     torch.as_tensor(ei[1], dtype=torch.int64), len(x)).numpy()
    return ei[0], ei[1], w, x


def _big_chain_inputs():
    """The weak-scaling harness's graph at 50,001 nodes, degree 12 (600k
    directed edges): scattered, so each rank's rows hit ~75k of the 128x128
    blocks, far past the dense-block budget."""
    return _chain_inputs(n=50_001, e=300_000, f=4)


def _csr_chain(src, dst, w, x, k=3):
    """The square matrix's CSR walk, k powers: what a shard's rows add."""
    m = csr_matrix(src, dst, w, len(x), len(x), device="cpu")
    ys = [torch.as_tensor(x)]
    for _ in range(k):
        ys.append(csr_spmm_reference(m, ys[-1]))
    return torch.stack(ys[1:]).numpy()


def _pos_inputs():
    ei, x, rng = _toy_graph(2)
    links = rng.integers(0, len(x), (40, 2)).astype(np.int32)
    y = rng.integers(0, 2, 40).astype(np.float32)
    return (ei, x), links, y, POS_KW


# SoP on the JAX test's graph, where one process takes the edge-list route,
# and on a denser one, where it takes bsr_spmm's.
SOP_EDGES = {"sparse": 600, "dense": 3000}


def _sop_inputs(name):
    ei, x, rng = _toy_graph(3, e=SOP_EDGES[name])
    links = rng.integers(0, len(x), (24, 2)).astype(np.int32)
    y = rng.integers(0, 2, 24).astype(np.float32)
    return (ei, x), links, y


# Tensor-parallel poolings: the JAX test's (k_heuristic 1, mean: the
# row-parallel weight's input is two hidden-wide blocks) and concat over two
# CCN slots (three blocks).
TP_POOLS = {"mean": (1, "mean"), "concat": (2, "concat")}


def _flax_signnet(seed, xs, rm, train, k_heuristic=1, k_pool_strategy="mean"):
    """SIGNNet (by default with k_heuristic 1 and mean pooling, the JAX
    test's), its flax variables (random running statistics) and the port's
    state_dict of them."""
    jm = JSIGNNet(hidden_channels=HIDDEN, num_layers=2, dropout=0.0, k_heuristic=k_heuristic,
                  k_pool_strategy=k_pool_strategy)
    v = jm.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(xs), jnp.asarray(rm), train=train)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(seed)
    for st in v["batch_stats"].values():
        st["MaskedBatchNorm_0"]["mean"] = rng.normal(size=HIDDEN).astype(np.float32)
        st["MaskedBatchNorm_0"]["var"] = rng.uniform(0.5, 2, HIDDEN).astype(np.float32)
    kw = dict(in_channels=xs.shape[-1], hidden_channels=HIDDEN, num_layers=2, dropout=0.0,
              k_heuristic=k_heuristic, k_pool_strategy=k_pool_strategy)
    state = {k: v_.numpy() for k, v_ in signnet_state_dict_from_flax(v).items()}
    return jm, v, kw, state


def _batch(seed, B, R=4, D=48):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, R, D)).astype(np.float32)
    rm = np.ones((B, R), dtype=bool)
    rm[:, 2:] = rng.random((B, R - 2)) < 0.6
    y = rng.integers(0, 2, B).astype(np.float32)
    return xs, rm, y


def _dp_inputs():
    xs, rm, y = _batch(11, B=16)
    _, _, kw, state = _flax_signnet(11, xs, rm, train=True)
    return kw, state, xs, rm, y


def _tp_inputs(name):
    xs, rm, _ = _batch(12, B=8)
    jm, v, kw, state = _flax_signnet(12, xs, rm, train=False, k_heuristic=TP_POOLS[name][0],
                                     k_pool_strategy=TP_POOLS[name][1])
    return kw, state, xs, rm


@pytest.fixture(scope="module")
def two_ranks():
    inputs = {"chain": _chain_inputs(), "big_chain": _big_chain_inputs(), "pos": _pos_inputs(),
              "sop": {name: _sop_inputs(name) for name in SOP_EDGES}, "dp": _dp_inputs()}
    return run_ranks(two_rank_checks, 2, inputs, timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def four_ranks():
    inputs = {"chain": _chain_inputs(), "tp": {name: _tp_inputs(name) for name in TP_POOLS}}
    return run_ranks(four_rank_checks, 4, inputs, timeout_s=SPAWN_TIMEOUT_S)


def test_partition_edges_covers_all_and_equals_jax():
    rng = np.random.default_rng(0)
    e = 500
    src = rng.integers(0, 97, e)
    dst = rng.integers(0, 97, e)
    w = rng.normal(size=e).astype(np.float32)
    got = pdist.partition_edges_by_owner(src, dst, w, 97, 4)
    want = jdist.partition_edges_by_owner(src, dst, w, 97, 4)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3] == want[3]
    src_p, dstl_p, w_p, rows = got
    found = []
    for s in range(4):
        nz = w_p[s] != 0
        found += list(zip(src_p[s][nz], dstl_p[s][nz] + s * rows, w_p[s][nz]))
    assert sorted(found) == sorted(zip(src, dst, w))


@pytest.mark.parametrize("world", [2, 4])
def test_dist_power_chain_matches_jax_and_one_process(world, two_ranks, four_ranks):
    results = two_ranks if world == 2 else four_ranks
    src, dst, w, x = _chain_inputs()
    n = len(x)
    mesh = j_make_mesh(n_data=world, devices=jax.devices()[:world])
    want = np.asarray(jdist.dist_power_chain(mesh, src, dst, w, jnp.asarray(x), 3))
    adj = csr_matrix(src, dst, w, n, n, device="cpu")
    one = power_chain_of(lambda y: bsr_spmm(adj, y), torch.as_tensor(x), 3).numpy()
    walk = _csr_chain(src, dst, w, x)
    rows = -(-n // world)
    for r, res in enumerate(results):
        np.testing.assert_allclose(res["chain"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["chain"], walk)
        np.testing.assert_array_equal(res["chain"], one)
        shard = res["chain_shard"]
        assert shard.shape == (3, rows, x.shape[1])
        lo, hi = r * rows, min((r + 1) * rows, n)
        np.testing.assert_array_equal(shard[:, : hi - lo], walk[:, lo:hi])
        assert not shard[:, hi - lo :].any()  # the padding rows past N


def test_dist_power_chain_past_the_block_budget_matches_jax(two_ranks):
    """A graph whose square and shard layouts both need more dense blocks
    than ``BUDGET_BYTES`` allows (so one process takes the edge list): the
    shards are CSR and the chain still matches the JAX chain, and the
    square CSR walk bit for bit."""
    src, dst, w, x = _big_chain_inputs()
    n = len(x)
    block_bytes = 4 * BLOCK_SIZE * BLOCK_SIZE
    rows = -(-n // 2)
    for r in range(2):
        mine = (dst >= r * rows) & (dst < (r + 1) * rows)
        assert num_blocks(src[mine], dst[mine] - r * rows, 2 * rows) * block_bytes > BUDGET_BYTES
    assert not should_use_bsr(src, dst, n, x.shape[1])
    mesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    want = np.asarray(jdist.dist_power_chain(mesh, src, dst, w, jnp.asarray(x), 3))
    walk = _csr_chain(src, dst, w, x)
    for r, res in enumerate(two_ranks):
        np.testing.assert_allclose(res["big_chain"], want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(res["big_chain"], walk)
        assert res["big_chain_shard"].shape == (3, rows, x.shape[1])


def test_precompute_pos_sharded_matches_jax_and_one_process(two_ranks):
    (ei, x), links, y, kw = _pos_inputs()
    mesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    want = jdist.precompute_pos_sharded(mesh, _jdg(ei, x), links, y, **kw)
    one = precompute_pos(_tdg(ei, x), links, y, device="cpu", **kw)
    for r, res in enumerate(two_ranks):
        assert res["pos_shard_links"] == np.subtract(*share(len(links), 2, r)[::-1])
        np.testing.assert_allclose(res["pos_xs"], np.asarray(want.xs), rtol=2e-3, atol=2e-4)
        np.testing.assert_array_equal(res["pos_mask"], np.asarray(want.row_mask))
        np.testing.assert_array_equal(res["pos_xs"], one.xs.numpy())
        np.testing.assert_array_equal(res["pos_mask"], one.row_mask.numpy())
        np.testing.assert_array_equal(res["pos_y"], y)
        # The owners' exchange in rounds of one row per peer: the same shard.
        lo, hi = share(len(links), 2, r)
        np.testing.assert_array_equal(res["pos_rounds_xs"], one.xs.numpy()[lo:hi])
        np.testing.assert_array_equal(res["pos_rounds_mask"], one.row_mask.numpy()[lo:hi])


@pytest.mark.parametrize("name", list(SOP_EDGES))
def test_precompute_sop_sharded_matches_jax_and_one_process(name, two_ranks):
    """Within 1e-6 of one process on either of its routes, and equal bit
    for bit where one process takes the kernel's route: there both walk
    the same CSR. On the edge list one process adds each row's terms in
    another order (the segment sum). On the card both routes of the
    sharded chain walk the CSR in the kernel (``tests/test_torch_gpu.py``)."""
    (ei, x), links, y = _sop_inputs(name)
    mesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    want = jdist.precompute_sop_sharded(mesh, _jdg(ei, x), links, y, sign_k=3)
    one = precompute_sop(_tdg(ei, x), links, y, sign_k=3, device="cpu")
    w = normalized_adjacency_weights(torch.as_tensor(ei[0], dtype=torch.int64),
                                     torch.as_tensor(ei[1], dtype=torch.int64), len(x))
    bsr = should_use_bsr(ei[0], ei[1], len(x), x.shape[1])
    assert bsr == (name == "dense") and w.numel() == ei.shape[1]
    for r, res in enumerate(two_ranks):
        res = res[f"sop_{name}"]
        assert res["shard_links"] == np.subtract(*share(len(links), 2, r)[::-1])
        np.testing.assert_allclose(res["xs"], np.asarray(want.xs), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res["xs"], one.xs.numpy(), rtol=0, atol=1e-6)
        if bsr:
            np.testing.assert_array_equal(res["xs"], one.xs.numpy())
        np.testing.assert_array_equal(res["y"], y)


@pytest.mark.parametrize("name", list(TP_POOLS))
def test_signnet_tensor_parallel_matches_replicated_and_jax(name, four_ranks):
    kw, state, xs, rm = _tp_inputs(name)
    k, strategy = TP_POOLS[name]
    jm, v, _, _ = _flax_signnet(12, xs, rm, train=False, k_heuristic=k,
                                k_pool_strategy=strategy)
    want = np.asarray(jm.apply(v, jnp.asarray(xs), jnp.asarray(rm), train=False))
    blocks = 2 if strategy == "mean" else 1 + k  # h_a, then h_k's hidden-wide blocks
    by_data = {}
    for res in four_ranks:
        res = res[f"tp_{name}"]
        d, m = res["coord"]
        # Each shard is half as wide: the column-parallel Linear's outputs,
        # the row-parallel Linear's inputs (half of each block).
        assert res["up_shape"] == (HIDDEN // 2, xs.shape[-1])
        assert res["down_shape"] == (HIDDEN, blocks * HIDDEN // 2)
        np.testing.assert_allclose(res["replicated"], want, rtol=1e-5, atol=1e-5)
        lo, hi = share(len(xs), 2, d)
        np.testing.assert_allclose(res["out"], res["replicated"][lo:hi], rtol=1e-5, atol=1e-5)
        by_data.setdefault(d, res["out"])
        np.testing.assert_array_equal(res["out"], by_data[d])  # model ranks agree
    np.testing.assert_allclose(np.concatenate([by_data[0], by_data[1]]), want,
                               rtol=1e-5, atol=1e-5)


def test_data_parallel_step_matches_one_process(two_ranks):
    """Two ranks, each on half the batch, against one process on the whole
    batch: the loss, the gradients, the parameters after Adam and the
    BatchNorm running statistics; the census counts one all-reduce of the
    parameters' bytes and one per BatchNorm layer each way."""
    from s3grl_tpu_torch.train.loop import bce_with_logits, make_optimizer

    kw, state, xs, rm, y = _dp_inputs()
    model = signnet(kw, state).train()
    opt = make_optimizer(model.parameters(), 1e-3)
    loss = bce_with_logits(model(torch.as_tensor(xs), torch.as_tensor(rm)),
                           torch.as_tensor(y)).mean()
    loss.backward()
    opt.step()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    params = {k: t.detach().numpy() for k, t in model.state_dict().items()}
    assert np.mean([res["dp_loss"] for res in two_ranks]) == pytest.approx(loss.item(),
                                                                            abs=1e-5)
    for res in two_ranks:
        for k, g in grads.items():
            np.testing.assert_allclose(res["dp_grads"][k], g, rtol=1e-5, atol=1e-5, err_msg=k)
        for k, p in params.items():
            np.testing.assert_allclose(res["dp_params"][k], p, rtol=1e-5, atol=1e-5, err_msg=k)
        census = res["dp_census"]
        bn = 4 * (1 + 2 * HIDDEN)  # [count, sum, sum of squares] of one norm layer
        assert census["all_reduce_sizes"] == [bn, bn, bn, bn, 4 * res["dp_n_params"]]
        assert census["all-reduce"] == 5
        assert census["all-gather"] == census["broadcast"] == 0


def test_scaling_harness_prints_the_jax_rows_and_summary(capsys):
    """``python -m s3grl_tpu_torch.parallel.scaling`` on gloo ranks at a
    small size: one row a count with the JAX harness's keys, then its
    summary; the census counts the training step's one all-reduce of the
    parameters' bytes and one per BatchNorm layer each way, and the DP
    control's one all-reduce of W."""
    import json

    from s3grl_tpu_torch.parallel import scaling

    scaling.main(["--device", "cpu", "--devices", "1", "2", "--links_per_device", "128",
                  "--nodes", "400", "--census"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    rows, summary = lines[:2], lines[2]
    # The keys of s3grl_tpu/parallel/scaling.py:368-384's row.
    jax_keys = {"devices", "links", "pos_links_per_sec", "pos_sizing_secs", "pos_extract_secs",
                "sop_links_per_sec", "train_links_per_sec", "train_b128_links_per_sec",
                "train_n_params", "matmul_control_rows_per_sec", "dp_control_links_per_sec"}
    for n, row in zip((1, 2), rows):
        assert jax_keys <= set(row) and row["devices"] == n and row["links"] == 128 * n
        assert row["backend"] == "gloo" and all(row[k] > 0 for k in jax_keys)
    census = rows[1]["collective_census"]
    hidden, n_params = 256, rows[1]["train_n_params"]
    bn = 4 * (1 + 2 * hidden)
    assert census["train_b32"]["all_reduce_sizes"] == [bn, bn, bn, bn, 4 * n_params]
    assert census["dp_control"]["all-reduce"] == 1
    assert census["matmul_control"]["all-reduce"] == 0
    assert set(summary) == {"weak_scaling_efficiency", "platform_control_efficiency",
                            "efficiency_vs_platform_control", "train_b32_vs_zero_comm_control",
                            "train_b32_vs_matched_dp_control", "from", "to"}
    assert (summary["from"], summary["to"]) == (1, 2)
