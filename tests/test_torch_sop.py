"""Port parity, SoP and hybrid operators, against the JAX package.

The two routes of the global chain (``sop_route``'s by each route, and
the kernel's CSR walk over ``csr_matrix``) against the JAX package's chain;
``sop_route``'s product on the kernel's route against that walk bit for
bit; ``precompute_sop`` on the CPU
(the selector takes each route on one of the graphs) against the JAX
package's edge-list route at the operator bar (rtol 2e-3, atol 2e-4)
and against ``reference_oracles.sop_oracle`` at the oracle bar (atol 1e-4,
op 0 at 1e-5, as tests/test_extraction.py holds the JAX package);
``hybrid_with`` exactly; and the SoP and hybrid runs of
``run_sgrl_learning``: each split's dataset equals the JAX package's, and a
seeded run learns (best test AUC > 65, the bar of tests/test_end_to_end.py).
"""
import glob
import os

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.operators.common as jcommon
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.operators.sop as jsop
import s3grl_tpu.sampling.extraction as jext
from s3grl_tpu.data.features import init_features as j_init_features
from s3grl_tpu.ops.spmm import normalized_adjacency_weights as j_norm_weights
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.operators.common import OperatorDataset
import s3grl_tpu_torch.operators.sop as tsop
from s3grl_tpu_torch.operators.sop import host_normalized_edges, precompute_sop
from s3grl_tpu_torch.ops.spmm import normalized_adjacency_weights
from s3grl_tpu_torch.ops.spmm_kernel import (
    blockify,
    bsr_spmm,
    csr_matrix,
    csr_spmm_reference,
    power_chain_of,
    should_use_bsr,
)
from s3grl_tpu_torch.runner import build_split_links, run_sgrl_learning
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.reference_oracles import sop_oracle
from tests.test_torch_end_to_end import BASE, _split
from tests.torch_port_helpers import random_edges, usair_like_edges

TOL = dict(rtol=2e-3, atol=2e-4)


def _graphs(seed, n, e, f):
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=n, e=e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    links = rng.integers(0, n, (23, 2)).astype(np.int32)
    y = rng.integers(0, 2, len(links)).astype(np.float32)
    jdg = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    return jdg, dg, ei, x, links, y


# The selector takes the block-sparse chain on the first graph (one row
# block) and the edge list on the second.
GRAPHS = [(90, 400, 12, True), (300, 900, 5, False)]


@pytest.mark.parametrize("n,e,f,bsr", GRAPHS)
def test_precompute_sop_matches_jax(n, e, f, bsr):
    jdg, dg, ei, _, links, y = _graphs(3, n, e, f)
    assert should_use_bsr(ei[0], ei[1], n, f) == bsr
    want = jsop.precompute_sop(jdg, links, y, sign_k=3, use_pallas=False)
    # batch_size 8 leaves a ragged last batch of 7 links.
    got = precompute_sop(dg, links, y, sign_k=3, batch_size=8, device="cpu")
    assert got.xs.shape == (len(links), 4, 2, f + 1) and got.xs.dtype == torch.float32
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), **TOL)
    np.testing.assert_array_equal(got.row_mask.numpy(), np.asarray(want.row_mask))
    np.testing.assert_array_equal(got.y, want.y)


@pytest.mark.parametrize("sign_k", [1, 3])
@pytest.mark.parametrize("n,e,f,bsr", GRAPHS)
def test_chain_routes_match_jax(monkeypatch, n, e, f, bsr, sign_k):
    # Both routes of the global chain on every graph, whichever the
    # selector would take: ``sop_route``'s chain by each route, and the
    # chain of bsr_spmm over the CSR form.
    jdg, dg, ei, x, _, _ = _graphs(3, n, e, f)
    src, dst = torch.as_tensor(ei[0]).long(), torch.as_tensor(ei[1]).long()
    w = normalized_adjacency_weights(src, dst, n)
    jw = j_norm_weights(jdg.edge_src, jdg.edge_dst, n)
    want = np.asarray(jsop._sop_power_features(
        jdg.edge_src, jdg.edge_dst, jw, jdg.x, sign_k=sign_k, num_nodes=n))
    routes = {}
    for csr in (True, False):
        monkeypatch.setattr(tsop, "should_use_bsr", lambda *a, csr=csr, **k: csr)
        routes[csr] = tsop.sop_route(dg)[1](dg.x, sign_k)
    adj = csr_matrix(ei[0], ei[1], w.numpy(), n, n, device="cpu")
    walk = power_chain_of(lambda y: bsr_spmm(adj, y), torch.as_tensor(x), sign_k)
    assert routes[False].shape == routes[True].shape == walk.shape == (sign_k, n, f)
    assert torch.equal(routes[True], walk)
    np.testing.assert_allclose(routes[False].numpy(), want, **TOL)
    np.testing.assert_allclose(walk.numpy(), want, **TOL)


@pytest.mark.parametrize("sign_k", [1, 3])
def test_precompute_sop_matches_oracle(sign_k):
    rng = np.random.default_rng(9)
    n, f = 30, 7
    upper = np.triu(rng.random((n, n)) < 0.2, k=1)
    r, c = np.nonzero(upper)
    ei = np.concatenate([np.stack([r, c]), np.stack([c, r])], axis=1).astype(np.int32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    A = ssp.csr_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(n, n))
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    links = np.array([[0, 1], [4, 7], [10, 20]], dtype=np.int64)
    ds = precompute_sop(dg, links, np.array([1.0, 0.0, 1.0]), sign_k=sign_k, device="cpu")
    assert ds.xs.shape == (3, sign_k + 1, 2, f + 1)
    for b, (s, d) in enumerate(links):
        x0_ref, ops_ref = sop_oracle(A, x, int(s), int(d), sign_k)
        np.testing.assert_allclose(ds.xs[b, 0].numpy(), x0_ref, atol=1e-5)
        for k in range(sign_k):
            np.testing.assert_allclose(ds.xs[b, k + 1].numpy(), ops_ref[k], atol=1e-4)


def _empty_row_block_edges(rng):
    """300 nodes, 128..255 isolated: Â's second row block is empty."""
    ei = random_edges(rng, n=172, e=1500)
    return np.where(ei >= 128, ei + 128, ei).astype(np.int32), 300


@pytest.mark.parametrize("graph", ["usair_like", "empty_row_block"])
def test_sop_route_propagates_by_the_kernels_walk(graph):
    """On the kernel's route, ``sop_route``'s product on the CPU is the
    kernel's own walk over Â's ``csr_matrix`` bit for bit: the order in
    which the card adds each row's terms."""
    rng = np.random.default_rng(4)
    ei, n = (usair_like_edges(1), 332) if graph == "usair_like" else _empty_row_block_edges(rng)
    f = 33
    assert should_use_bsr(ei[0], ei[1], n, f)
    dg = DeviceGraph.from_graph(
        Graph(num_nodes=n, edge_index=ei, x=rng.normal(size=(n, f)).astype(np.float32)),
        device="cpu")
    src, dst, w = host_normalized_edges(dg)
    adj = csr_matrix(src, dst, w, n, n, device="cpu")
    y = torch.as_tensor(rng.normal(size=(n, 40)).astype(np.float32))
    propagate, chain = tsop.sop_route(dg)
    got = propagate(y)
    assert torch.equal(got, csr_spmm_reference(adj, y))
    assert torch.equal(chain(dg.x, 2)[1], csr_spmm_reference(adj, csr_spmm_reference(adj, dg.x)))
    if graph == "empty_row_block":
        assert not got[128:256].any()


def test_over_budget_graph_takes_the_edge_list():
    # 200 x 200 row blocks, about 34,000 of them hit: over the 1 GiB budget
    # of 16,384 dense blocks. The selector takes the edge list, and the
    # layout itself refuses to be built.
    rng = np.random.default_rng(5)
    n = 128 * 200
    ei = random_edges(rng, n=n, e=40_000)
    x = np.ones((n, 1), np.float32)
    assert not should_use_bsr(ei[0], ei[1], n, 1)
    with pytest.raises(ValueError, match="budget"):
        blockify(ei[0], ei[1], np.ones(ei.shape[1], np.float32), n, device="cpu")
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    jdg = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    links = np.array([[0, 1], [5, 9]], dtype=np.int32)
    y = np.ones(2, np.float32)
    got = precompute_sop(dg, links, y, sign_k=1, device="cpu")
    want = jsop.precompute_sop(jdg, links, y, sign_k=1, use_pallas=False)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), **TOL)


@pytest.mark.parametrize("pos_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f_pos,f_sop", [(9, 9), (6, 9), (9, 6)])
def test_hybrid_with_matches_jax(pos_dtype, f_pos, f_sop):
    rng = np.random.default_rng(f_pos * 10 + f_sop)
    L, K = 11, 3
    pos_xs = torch.as_tensor(rng.normal(size=(L, K + 1, 2, f_pos)).astype(np.float32))
    pos_xs = pos_xs.to(pos_dtype)
    sop_xs = rng.normal(size=(L, K + 1, 2, f_sop)).astype(np.float32)
    mask = rng.random((L, 2)) < 0.9
    y = rng.integers(0, 2, L).astype(np.float32)
    pos_np = pos_xs.float().numpy()
    want = jcommon.OperatorDataset(xs=pos_np, row_mask=mask, y=y).hybrid_with(
        jcommon.OperatorDataset(xs=sop_xs, row_mask=np.ones((L, 2), bool), y=y)
    )
    got = OperatorDataset(pos_xs, torch.as_tensor(mask), y).hybrid_with(
        OperatorDataset(torch.as_tensor(sop_xs), torch.ones((L, 2), dtype=torch.bool), y)
    )
    assert got.xs.dtype == torch.float32 and got.num_operators == 2 * K
    np.testing.assert_array_equal(got.xs.numpy(), np.asarray(want.xs))
    np.testing.assert_array_equal(got.row_mask.numpy(), mask)
    np.testing.assert_array_equal(got.y, y)
    with pytest.raises(ValueError, match="vanilla PoS"):
        OperatorDataset(torch.zeros((L, K + 1, 3, 4)), torch.ones((L, 3)), y).hybrid_with(got)


@pytest.mark.parametrize("sign_type", ["SoP", "hybrid"])
def test_run_learns_and_its_datasets_match_jax(sign_type, tmp_path):
    cfg = RunConfig(**{**BASE, "sign_type": sign_type, "pool_operatorwise": True},
                    results_dir=str(tmp_path))
    graph, split = _split(cfg)
    _, best, ttimes, _, nparams = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert best > 65.0
    assert nparams > 0 and len(ttimes) == 2

    # The same links, drawn as run_sgrl_learning draws them.
    rng, _ = seed_everything(cfg.seed)
    jg = j_init_features(
        jgraph.Graph(num_nodes=graph.num_nodes, edge_index=graph.edge_index), "degree"
    )
    jd = jext.DeviceGraph.from_graph(jg)
    for name, pct in (("train", 100.0), ("valid", 50.0), ("test", 50.0)):
        links, y = build_split_links(name, split, pct, rng)
        (path,) = glob.glob(os.path.join(tmp_path, "dataset_cache", f"USAir_{name}_*.npz"))
        got = OperatorDataset.load(path)
        want = jsop.precompute_sop(jd, links, y, sign_k=2, use_pallas=False)
        if sign_type == "hybrid":
            want = jpos.precompute_pos(
                jd, links, y, num_hops=1, sign_k=2, buckets=(64, 256), batch_size=64,
                max_subgraph_nodes=256, seed=1, use_pallas=False,
            ).hybrid_with(want)
        assert got.xs.shape == np.asarray(want.xs).shape
        np.testing.assert_array_equal(np.asarray(want.row_mask), got.row_mask)
        np.testing.assert_allclose(np.asarray(want.xs), got.xs, **TOL)
        np.testing.assert_array_equal(want.y, got.y)
