"""The port's CUDA kernels against their plain torch versions, and the
plain-torch label paths (labels, full-row, GNN baselines) against the CPU,
on a card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from s3grl_tpu_torch.ops.pos_kernel import (
    pos_power_rows,
    pos_power_rows_reference,
    pos_selector_rows,
    pos_selector_rows_reference,
)
from s3grl_tpu_torch.ops.spmm_kernel import (
    blockify,
    bsr_spmm,
    bsr_spmm_reference,
    csr_matrix,
    csr_spmm_reference,
    power_chain_of,
)
from torch_port_helpers import kernel_inputs

TOL = dict(rtol=2e-3, atol=2e-4)
BSR_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas_spmm.py's bar

SHAPES = [
    dict(B=5, S=128, D=24, F=300, R=10),
    dict(B=3, S=64, D=7, F=5, R=3),
    dict(B=16, S=512, D=96, F=1026, R=2),  # the main path's width
    dict(B=4, S=4096, D=40, F=33, R=34),  # the compact list spills to global scratch
    dict(B=8, S=256, D=96, F=1026, R=34),  # PoS+ at the main path's width
    dict(B=3, S=100, D=10, F=1, R=3),  # one feature column
]


def _cuda(why="the kernel has no CPU mode"):
    if not torch.cuda.is_available():
        pytest.skip(f"needs a CUDA card: {why}")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S{S}-R{R}-F{F}".format(**s))
@pytest.mark.parametrize("sign_k", [0, 3])
def test_cuda_kernel_matches_plain_version(mode, shape, sign_k):
    dev = _cuda()
    sel, nbr, w, x, row_ids = kernel_inputs(4, mode=mode, **shape)
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w, x)]
    ids = None if row_ids is None else torch.as_tensor(row_ids, device=dev)
    before = pos_power_rows.launches
    got = pos_power_rows(*t, sign_k=sign_k, row_ids=ids)
    torch.cuda.synchronize()
    assert pos_power_rows.launches == before + 1
    want = pos_power_rows_reference(*t, sign_k=sign_k, row_ids=ids)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S{S}-R{R}-F{F}".format(**s))
def test_selector_kernel_matches_plain_version(mode, shape):
    """Phase 1 alone: H [B, K·R, S] against its plain version."""
    dev = _cuda()
    sel, nbr, w, _, row_ids = kernel_inputs(5, mode=mode, **shape)
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w)]
    ids = None if row_ids is None else torch.as_tensor(row_ids, device=dev)
    before = pos_selector_rows.launches
    got = pos_selector_rows(*t, sign_k=3, row_ids=ids)
    torch.cuda.synchronize()
    assert pos_selector_rows.launches == before + 1
    want = pos_selector_rows_reference(*t, sign_k=3, row_ids=ids)
    assert got.shape == want.shape == (shape["B"], 3 * shape["R"], shape["S"])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    sel, nbr, w, x, _ = kernel_inputs(5, B=2, S=16, D=4, F=3, R=2, mode="local")
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w, x)]
    with pytest.raises(TypeError):
        pos_power_rows(t[0].long(), *t[1:], sign_k=1)
    with pytest.raises(ValueError):
        pos_power_rows(t[0], t[1], t[2], t[3].transpose(1, 2).contiguous().transpose(1, 2),
                       sign_k=1)


# (n, e, c): tests/test_pallas_spmm.py's shapes, then the main path's width
# (C = 1,025) at N not a multiple of 128, with one row block left empty.
BSR_SHAPES = [(50, 200, 7), (300, 2500, 64), (513, 4000, 129), (332, 3600, 1025)]
# Cora's shape; one column; four columns (the float4 route); SoP's
# per-batch width (the one-hot endpoint columns of 4,096 links). With 500
# edges on 300 nodes about a fifth of the rows are empty.
BSR_MORE = [(2708, 10556, 1433), (300, 500, 1), (300, 500, 4), (332, 3600, 8192)]


def _bsr_inputs(seed, n, e, c, empty_row_block=False):
    """A non-symmetric M with weights of both signs, as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if empty_row_block:
        dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    return src, dst, w, x


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,c", BSR_SHAPES + BSR_MORE, ids=lambda v: str(v))
def test_bsr_kernel_matches_plain_version(n, e, c):
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(n, n, e, c, empty_row_block=n > 256)
    adj = csr_matrix(src, dst, w, n, n, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm_reference(blockify(src, dst, w, n, device=dev), xt)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **BSR_TOL)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    np.testing.assert_allclose(got.cpu().numpy(), dense @ x, **BSR_TOL)
    np.testing.assert_allclose(got.cpu().numpy(), csr_spmm_reference(adj, xt).cpu().numpy(),
                               **BSR_TOL)
    if n > 256:
        assert bool((got[128:256] == 0).all())
    empty = (adj.csr_row_ptr[1:] == adj.csr_row_ptr[:-1]).cpu().numpy()
    assert (got.cpu().numpy()[empty] == 0).all()
    # A fixed summation order: the same call gives the same bits.
    assert torch.equal(bsr_spmm(adj, xt), got)


@pytest.mark.gpu
def test_bsr_kernel_splits_long_rows():
    """A hub row of some 200 nonzeros (300 edges, some repeated): the kernel
    splits rows over 4 warps when one is longer than 32, and still repeats
    bit for bit."""
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(3, 400, 3000, 257)
    dst[:300] = 7
    adj = csr_matrix(src, dst, w, 400, 400, device=dev)
    assert adj.csr_max_row > 32
    xt = torch.as_tensor(x, device=dev)
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    want = bsr_spmm_reference(blockify(src, dst, w, 400, device=dev), xt)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **BSR_TOL)
    assert torch.equal(bsr_spmm(adj, xt), got)


@pytest.mark.gpu
def test_bsr_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(1, 200, 800, 9)
    adj = csr_matrix(src, dst, w, 200, 200, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    wide = dataclasses.replace(adj, csr_cols=adj.csr_cols.long())
    with pytest.raises(TypeError):
        bsr_spmm(wide, xt)
    with pytest.raises(ValueError):
        bsr_spmm(adj, torch.as_tensor(x.T.copy(), device=dev).T)
    on_cpu = csr_matrix(src, dst, w, 200, 200, device="cpu")
    with pytest.raises(ValueError):
        bsr_spmm(on_cpu, xt)
    assert bsr_spmm.launches == before


# ---- The paths of structural labels (plain torch on the card) ----

GNN_TOL = dict(rtol=1e-4, atol=1e-5)
LABELS = ["zo", "hop", "degree", "drnl", "de", "de+"]
CARD_VS_CPU = "it holds the card's result against the CPU's"


def _label_inputs(num_hops=2, max_nodes=128, B=24):
    """A CPU device graph of the synthetic USAir-shaped graph with 5 normal
    features, and links (half of them observed edges)."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import usair_like_edges

    ei = usair_like_edges(1)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(332, 5)).astype(np.float32)
    dg = DeviceGraph.from_graph(Graph(num_nodes=332, edge_index=ei, x=x), device="cpu")
    links = np.concatenate([ei[:, rng.choice(ei.shape[1], B // 2)].T,
                            rng.integers(0, 332, (B - B // 2, 2))]).astype(np.int64)
    return dg, ei, x, torch.as_tensor(links)


def _on(dev, ei, x):
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph

    return DeviceGraph.from_graph(Graph(num_nodes=332, edge_index=ei, x=x), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("num_hops,max_nodes", [(1, 64), (2, 512)])
def test_labels_and_dense_adjacency_on_the_card_are_bit_exact(num_hops, max_nodes):
    from s3grl_tpu_torch.sampling.extraction import dense_adjacency, extract_subgraphs
    from s3grl_tpu_torch.sampling.labeling import label_nodes

    dev = _cuda(CARD_VS_CPU)
    dg, ei, x, links = _label_inputs()
    dgc = _on(dev, ei, x)
    subs = [extract_subgraphs(g, links.to(g.device), num_hops=num_hops, max_nodes=max_nodes)
            for g in (dg, dgc)]
    adjs = [dense_adjacency(s) for s in subs]
    assert torch.equal(adjs[1].cpu(), adjs[0])
    for label in LABELS:
        z = [label_nodes(a, s.dist, s.node_mask, node_label=label) for a, s in zip(adjs, subs)]
        assert torch.equal(z[1].cpu(), z[0]), label


@pytest.mark.gpu
@pytest.mark.parametrize("num_hops,max_nodes", [(1, 64), (2, 512)])
def test_static_cache_batch_on_the_card_equals_the_fresh_one(num_hops, max_nodes):
    from s3grl_tpu_torch.train.gnn_loop import batch_from_cache, extract_and_label

    dev = _cuda(CARD_VS_CPU)
    _, ei, x, links = _label_inputs()
    dgc = _on(dev, ei, x)
    lb = links.to(dev)
    adj, _, mask, nodes = extract_and_label(dgc, lb, num_hops=num_hops, max_nodes=max_nodes,
                                            node_label="drnl", max_iters=32)
    got = batch_from_cache(dgc, lb, nodes, mask)
    assert got.is_cuda and torch.equal(got, adj)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["GCN", "SAGE", "GIN", "DGCNN"])
def test_gnn_forward_on_the_card_matches_the_cpu(model):
    import copy

    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.sampling.extraction import dense_adjacency, extract_subgraphs
    from s3grl_tpu_torch.sampling.labeling import label_nodes
    from s3grl_tpu_torch.train.gnn_loop import build_gnn_model

    dev = _cuda(CARD_VS_CPU)
    dg, _, _, links = _label_inputs()
    sub = extract_subgraphs(dg, links, num_hops=2, max_nodes=512)
    adj = dense_adjacency(sub)
    label = "de" if model == "GCN" else "drnl"
    z = label_nodes(adj, sub.dist, sub.node_mask, node_label=label)
    x = dg.x[sub.nodes.long()] * sub.node_mask[:, :, None]
    cfg = RunConfig(model=model, hidden_channels=32, num_layers=3, use_feature=True)
    cpu = build_gnn_model(cfg, 100, 5, generator=torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to(dev)
    for m in (cpu, card):
        m.eval()
    with torch.no_grad():
        want = cpu(adj, z, sub.node_mask, x)
        got = card(adj.to(dev), z.to(dev), sub.node_mask.to(dev), x.to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **GNN_TOL)


@pytest.mark.gpu
def test_fullrow_pos_on_the_card_matches_the_cpu():
    from s3grl_tpu_torch.operators.fullrow import precompute_pos_fullrow

    dev = _cuda(CARD_VS_CPU)
    dg, ei, x, links = _label_inputs()
    y = np.ones(len(links), np.float32)
    kw = dict(num_hops=1, sign_k=3, node_label="drnl", buckets=(32, 64, 128),
              max_subgraph_nodes=128)
    want = precompute_pos_fullrow(dg, links.numpy(), y, device="cpu", **kw)
    got = precompute_pos_fullrow(_on(dev, ei, x), links.numpy(), y, device=dev, **kw)
    assert got.xs.is_cuda
    assert torch.equal(got.row_mask.cpu(), want.row_mask)
    np.testing.assert_allclose(got.xs.cpu().numpy(), want.xs.numpy(), **TOL)


@pytest.mark.gpu
def test_run_gnn_learning_defaults_to_the_card(monkeypatch):
    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.train import gnn_loop
    from s3grl_tpu_torch.utils.seeding import seed_everything
    from torch_port_helpers import usair_like_edges

    _cuda("it checks where the run puts its tensors")
    built = []

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    build = gnn_loop.build_gnn_model
    monkeypatch.setattr(gnn_loop, "build_gnn_model", spy)
    rng, _ = seed_everything(1)
    graph, split = do_edge_split(Graph(num_nodes=332, edge_index=usair_like_edges(1)),
                                 val_ratio=0.05, test_ratio=0.1, rng=rng)
    cfg = RunConfig(model="DGCNN", node_label="drnl", hidden_channels=16, num_hops=1,
                    epochs=1, train_percent=10.0, val_percent=50.0, test_percent=50.0)
    _, best, _, _, _ = gnn_loop.run_gnn_learning(graph, split, cfg, rng)
    assert np.isfinite(best)
    assert all(p.is_cuda for p in built[0].parameters())


# ---- Walks, ScaLed's local-slot kernel route, heuristics, vMF numerics ----


@pytest.mark.gpu
def test_hash_uniforms_and_walks_on_the_card_are_bit_exact():
    from s3grl_tpu_torch.sampling.random_walk import hash_uniforms, rw_membership

    dev = _cuda(CARD_VS_CPU)
    seeds = torch.arange(-50, 4950, dtype=torch.int32)
    u = hash_uniforms(seeds, 3, 40)
    assert torch.equal(hash_uniforms(seeds.to(dev), 3, 40).cpu(), u)
    dg, ei, x, links = _label_inputs()
    dgc = _on(dev, ei, x)
    ls = torch.arange(len(links), dtype=torch.int32) * 7 + 3
    want = rw_membership(dg, links, ls, rw_m=3, rw_M=20)
    got = rw_membership(dgc, links.to(dev), ls.to(dev), rw_m=3, rw_M=20)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("max_ccn,strategy", [(0, ""), (32, "intersection")])
def test_scaled_operators_from_the_kernel_equal_the_plain_version(max_ccn, strategy):
    from s3grl_tpu_torch.operators.pos import pos_operators
    from s3grl_tpu_torch.sampling.random_walk import extract_rw_subgraphs

    dev = _cuda()
    dg, ei, x, links = _label_inputs(B=64)
    dgc = _on(dev, ei, x)
    ls = torch.arange(len(links), dtype=torch.int32)
    sub = extract_rw_subgraphs(dgc, links.to(dev), ls.to(dev), rw_m=3, rw_M=20, max_nodes=256)
    kw = dict(sign_k=3, max_ccn=max_ccn, strategy=strategy)
    before = (pos_power_rows.launches, pos_power_rows.local_launches)
    got, mask = pos_operators(sub, dgc.x, use_kernel=True, **kw)
    torch.cuda.synchronize()
    assert (pos_power_rows.launches, pos_power_rows.local_launches) == (before[0] + 1,
                                                                         before[1] + 1)
    want, want_mask = pos_operators(sub, dgc.x, **kw)  # the gather path on the card
    assert torch.equal(mask, want_mask)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    cpu_sub = type(sub)(*(t.cpu() for t in sub))
    on_cpu, _ = pos_operators(cpu_sub, dg.x, use_kernel=True, **kw)  # the plain version
    np.testing.assert_allclose(got.cpu().numpy(), on_cpu.numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["CN", "AA", "PPR"])
def test_heuristics_on_the_card_match_the_cpu(name):
    from s3grl_tpu_torch.heuristics import HEURISTICS

    dev = _cuda(CARD_VS_CPU)
    dg, ei, x, links = _label_inputs(B=64)
    want = HEURISTICS[name](dg, links)
    got = HEURISTICS[name](_on(dev, ei, x), links.to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [9, 65, 129])
def test_vmf_numerics_on_the_card_match_the_cpu(m):
    from s3grl_tpu_torch.models.svgae import bessel_ratio, log_iv, vmf_kl

    dev = _cuda(CARD_VS_CPU)
    kappa = torch.tensor([0.5, 1.0, 5.0, 20.0, 80.0, 300.0, 650.0, 1000.0])
    nu = m / 2.0 - 1.0
    for fn in (lambda k: bessel_ratio(nu + 1.0, k), lambda k: log_iv(nu, k)):
        np.testing.assert_allclose(fn(kappa.to(dev)).cpu().numpy(), fn(kappa).numpy(),
                                   rtol=1e-5)
    # tests/test_torch_initrep.py's bar for the KL, a sum of terms up to 130
    # (4 float32 ulps there).
    np.testing.assert_allclose(vmf_kl(kappa.to(dev), m).cpu().numpy(), vmf_kl(kappa, m).numpy(),
                               rtol=1e-5, atol=6e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["GAE", "GIC", "SVGAE"])
def test_init_representation_on_the_card_repeats(kind, monkeypatch):
    """The pretraining's sums add in a fixed order, with no global
    deterministic switch: twice on the card, the same features bit for bit."""
    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.models.init_representation import pretrain_representation
    from s3grl_tpu_torch.utils.seeding import seed_everything
    from torch_port_helpers import usair_like_edges

    dev = _cuda("it runs the pretraining on the card")
    monkeypatch.setenv("S3GRL_TPU_SVGAE_EPOCHS", "30")
    rng, _ = seed_everything(1)
    graph, split = do_edge_split(Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)
    cfg = RunConfig(init_representation=kind, hidden_channels=64, epochs=5, lr=1e-2)
    a, b = (pretrain_representation(graph, split, cfg, device=dev).x for _ in range(2))
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.gpu
def test_walkpool_forward_on_the_card_matches_the_cpu():
    """USAir_WalkPool's widths (hidden 32, 2 heads, walk length 7, DRNL) at
    S = 512: the card's logits within 1e-4 of the CPU's."""
    import copy

    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.models.walkpool import WalkPoolLinkPred
    from s3grl_tpu_torch.train.walkpool_loop import walkpool_batch

    dev = _cuda(CARD_VS_CPU)
    dg, _, _, links = _label_inputs()
    cfg = RunConfig(model="WalkPool", node_label="drnl", num_hops=2)
    adj, z, mask, x = walkpool_batch(dg, links, cfg, 512)
    cpu = WalkPoolLinkPred(x.shape[-1], 32, drnl=True, generator=torch.Generator().manual_seed(3))
    card = copy.deepcopy(cpu).to(dev)
    for m in (cpu, card):
        m.eval()
    with torch.no_grad():
        want = cpu(adj, z, mask, x)
        got = card(adj.to(dev), z.to(dev), mask.to(dev), x.to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# The paths whose seeded runs did not repeat on the card (ROADMAP §3 item
# 1), as RunConfig fields over chip_smoke.py's bench config, at 2 epochs.
REPEAT_PATHS = {
    "SoP": dict(sign_type="SoP", pool_operatorwise=True),
    "hybrid": dict(sign_type="hybrid", pool_operatorwise=True),
    "SEAL": dict(model="DGCNN", node_label="drnl", init_features="", use_feature=False,
                 hidden_channels=32, num_layers=3),
    "PoS-n2v": dict(init_features="n2v", n2v_dim=16, pool_operatorwise=True),
    "PoS-sampled": dict(ratio_per_hop=0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(REPEAT_PATHS))
def test_seeded_run_repeats_on_the_card(path, tmp_path):
    """Two seeded 2-epoch runs on the card, each in its own results
    directory (so node2vec trains anew), give the same best test AUC."""
    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.runner import run_sgrl_learning
    from s3grl_tpu_torch.utils.seeding import seed_everything
    from torch_port_helpers import usair_like_edges

    dev = _cuda("it runs the path on the card")
    rng, _ = seed_everything(1)
    graph, split = do_edge_split(Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)
    best = []
    for i in range(2):
        cfg = RunConfig(dataset="USAir", init_features="degree", sign_type="PoS",
                        optimize_sign=True, sign_k=3, hidden_channels=256, num_hops=2,
                        epochs=2, delete_dataset=True, results_dir=str(tmp_path / str(i)))
        cfg = cfg.replace(**REPEAT_PATHS[path])
        best.append(run_sgrl_learning(cfg, graph, split, device=dev)[1])
    assert np.isfinite(best[0])
    assert best[0] == best[1], best


def _usair_like_fit_datasets(dev, n_train=3638, n_valid=106, n_test=213):
    """PoS datasets (sign_k 3, 2 hops, one-hot degree features) of the
    USAir-like graph on the card: ``n_*`` positives of each split drawn from
    its edges and as many non-edges. 7,276 train links make the fit cell's
    228 steps of 32."""
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import usair_like_edges

    n = 332
    ei = usair_like_edges(1)
    graph = init_features(Graph(num_nodes=n, edge_index=ei), "degree", device=dev)
    dg = DeviceGraph.from_graph(graph, device=dev)
    edges = set(zip(ei[0].tolist(), ei[1].tolist()))
    rng = np.random.default_rng(5)

    def split(k):
        pos = ei[:, rng.choice(ei.shape[1], k, replace=False)].T
        neg = []
        while len(neg) < k:
            u, v = (int(a) for a in rng.integers(0, n, 2))
            if u != v and (u, v) not in edges:
                neg.append((u, v))
        links = np.concatenate([pos, np.array(neg)]).astype(np.int32)
        y = np.concatenate([np.ones(k), np.zeros(k)]).astype(np.float32)
        return precompute_pos(dg, links, y, num_hops=2, sign_k=3, device=dev)

    return [split(k) for k in (n_train, n_valid, n_test)]


@pytest.mark.gpu
def test_graphed_fit_equals_the_eager_fit_bit_for_bit(monkeypatch):
    """``fit_signnet``'s step replayed from a CUDA graph against the same
    call forced eager (its capture entry monkeypatched away), 2 epochs at
    USAir-like shapes: per-epoch losses, every parameter and BatchNorm
    statistic, Adam's moments and steps and the evaluation predictions
    equal bit for bit; one capture and 2 x 228 - 3 replayed steps."""
    import s3grl_tpu_torch.train.loop as loop
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.train.metrics import evaluate_auc

    dev = _cuda("it captures the training step in a CUDA graph")
    ds = _usair_like_fit_datasets(dev)
    steps = -(-ds[0].num_links // 32)
    assert steps == 228
    real_optimizer = loop.make_optimizer
    runs = {}
    for mode in ("graph", "eager"):
        if mode == "eager":
            monkeypatch.setattr(loop, "_capture_step", lambda *args: None)
        rec = {"losses": [], "preds": []}

        def keep_optimizer(params, lr, weight_decay=1e-4):
            rec["opt"] = real_optimizer(params, lr, weight_decay)
            return rec["opt"]

        def eval_fn(val_pred, val_true, test_pred, test_true):
            rec["preds"].append((val_pred.copy(), test_pred.copy()))
            return evaluate_auc(val_pred, val_true, test_pred, test_true)

        monkeypatch.setattr(loop, "make_optimizer", keep_optimizer)
        before = profiling.counters()
        fit = loop.fit_signnet(*ds, sign_k=3, hidden_channels=256, batch_size=32, lr=1e-4,
                               dropout=0.5, epochs=2, seed=7, eval_fn=eval_fn, device=dev,
                               logger_hook=lambda e, loss, r: rec["losses"].append(loss))
        after = profiling.counters()
        rec["counts"] = {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("fit.steps", "fit.captures", "fit.graph_steps")}
        rec["state"] = {k: v.clone() for k, v in fit.model.state_dict().items()}
        rec["adam"] = [{k: rec["opt"].state[p][k].clone() for k in ("exp_avg", "exp_avg_sq", "step")}
                       for p in fit.model.parameters()]
        runs[mode] = rec
    got, want = runs["graph"], runs["eager"]
    assert got["counts"] == {"fit.steps": 2 * steps, "fit.captures": 1,
                             "fit.graph_steps": 2 * steps - loop.GRAPH_WARMUP_STEPS}
    assert want["counts"] == {"fit.steps": 2 * steps, "fit.captures": 0, "fit.graph_steps": 0}
    assert len(got["losses"]) == 2 and got["losses"] == want["losses"]
    assert got["state"].keys() == want["state"].keys()
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k
    for i, (g, w) in enumerate(zip(got["adam"], want["adam"])):
        for k in w:
            assert torch.equal(g[k], w[k]), (i, k)
    assert float(got["adam"][0]["step"]) == 2 * steps
    assert len(got["preds"]) == 2
    for g, w in zip(got["preds"], want["preds"]):
        assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


# ---- Per-hop sampling and the large-graph route ----


@pytest.mark.gpu
def test_uniforms_on_the_card_equal_the_cpu():
    from s3grl_tpu_torch.sampling.prng import uniforms

    dev = _cuda(CARD_VS_CPU)
    seeds = torch.tensor([0, 11, 2**20 + 7, -5, 3_000_012, 2**31 - 1], dtype=torch.int32)
    ids = torch.randint(0, 200_000, (6, 5000), generator=torch.Generator().manual_seed(1))
    for hop in (1, 2, 3):
        want = uniforms(seeds, hop, ids)
        got = uniforms(seeds.to(dev), hop, ids.to(dev)).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _hub_batch(dev, B=4, S=1024, F=128):
    """B observed links of the BlogCatalog-sized power-law graph (hub degree
    3,377; a global table 3,392 wide) with F normal feature columns on the
    card, and their 2-hop node sets at S = 1,024 from the host core."""
    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import blogcatalog_like_edges

    ei = blogcatalog_like_edges(1)
    n = int(ei.max()) + 1
    rng = np.random.default_rng(3)
    x = rng.normal(size=(n, F)).astype(np.float32)
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device=dev)
    links = ei[:, rng.choice(ei.shape[1], B)].T.astype(np.int32)
    nd, _ = native.khop_nodes(*dg.host_csr(), links, 2, S)
    return dg, links, nd


@pytest.mark.gpu
def test_kernel_at_the_hub_shape_matches_plain_version():
    """``pos_power_rows`` at the hub-dense shape: the 3,392-wide global
    table read by id, each member row up to its degree (a row longer than
    the selector kernel's staging row read twice); PoS+ rows (intersection
    CCN, R = 34) included."""
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs

    dev = _cuda()
    dg, links, nd = _hub_batch(dev)
    nodes = torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev)
    mask = torch.as_tensor(nd >= 0, device=dev)
    for ccn in (0, 32):
        sel, row_ids, lk, _ = by_id_kernel_inputs(
            dg, torch.as_tensor(links, device=dev), nodes, mask,
            max_ccn=ccn, strategy="intersection")
        args = (sel, dg.nbr, dg.degrees(), dg.x_with_indicator())
        got = pos_power_rows(*args, sign_k=3, row_ids=row_ids, links=lk)
        want = pos_power_rows_reference(*args, sign_k=3, row_ids=row_ids, links=lk)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_host_and_device_routes_give_the_same_dataset_on_the_card(monkeypatch):
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import random_edges

    dev = _cuda("it holds the card's two routes against each other")
    rng = np.random.default_rng(5)
    n = 3000
    ei = random_edges(rng, n=n, e=30_000)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device=dev)
    links = rng.integers(0, n, (600, 2)).astype(np.int32)
    y = np.ones(600, np.float32)
    kw = dict(num_hops=2, sign_k=3, max_subgraph_nodes=512, k_heuristic=1,
              k_node_set_strategy="union", max_ccn=16, device=dev)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "0")
    want = precompute_pos(dg, links, y, **kw)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1")
    got = precompute_pos(dg, links, y, **kw)
    assert torch.equal(got.row_mask, want.row_mask)
    assert torch.equal(got.xs, want.xs)


@pytest.mark.gpu
def test_a_host_table_narrower_than_the_cap_gives_the_device_routes_dataset_on_the_card(
        monkeypatch):
    """The host route with its whole-split table 700 wide under a cap of
    1,024 (sizes 442-1,050): bucket 512 sliced from it, the first batch of
    bucket 1,024 (rows that ended below 700) padded from it, the others by
    passes of their own; the device route's dataset bit for bit."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.operators import pos as tpos
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import random_edges

    dev = _cuda("it holds the card's two routes against each other")
    rng = np.random.default_rng(5)
    n = 3000
    ei = random_edges(rng, n=n, e=30_000)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device=dev)
    links = rng.integers(0, n, (600, 2)).astype(np.int32)
    y = np.ones(600, np.float32)
    kw = dict(num_hops=2, sign_k=3, max_subgraph_nodes=1024, k_heuristic=1,
              k_node_set_strategy="union", max_ccn=16)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "0")
    want = tpos.precompute_pos(dg, links, y, device=dev, **kw)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1")
    monkeypatch.setattr(tpos, "KHOP_TABLE_ENTRIES", 700 * len(links))
    plan = tpos.pos_plan(dg, links, **kw)
    served = [(b, plan.reads_table(b, idx)) for b, idx in plan.batches]
    assert (512, True) in served and (1024, True) in served and (1024, False) in served
    got = tpos.precompute_pos(dg, links, y, device=dev, **kw)
    assert torch.equal(got.row_mask, want.row_mask)
    assert torch.equal(got.xs, want.xs)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1025, 4, 1])
def test_bsr_kernel_on_a_row_shard_matches_plain_version(c):
    """``bsr_spmm`` on one rank's [rows, N_pad] shard of a 2-way row
    partition (``parallel/dist.py``), built as the chain builds it
    (``csr_matrix``, CSR alone): X has N_pad rows, Y one per shard row;
    against its plain version, the dense product, and the square matrix's
    rows bit for bit."""
    from s3grl_tpu_torch.parallel.dist import partition_edges_by_owner

    dev = _cuda()
    n = 333  # rows = 167, N_pad = 334: X's last row is padding
    src, dst, w, _ = _bsr_inputs(7, n, 4000, 1)
    src_p, dstl_p, w_p, rows = partition_edges_by_owner(src, dst, w, n, 2)
    rng = np.random.default_rng(8)
    x = np.zeros((2 * rows, c), np.float32)
    x[:n] = rng.normal(size=(n, c))
    xt = torch.as_tensor(x, device=dev)
    square = bsr_spmm(csr_matrix(src, dst, w, n, n, device=dev), xt[:n])
    for r in range(2):
        keep = w_p[r] != 0
        adj = csr_matrix(src_p[r][keep], dstl_p[r][keep], w_p[r][keep], rows, 2 * rows,
                         device=dev)
        before = bsr_spmm.launches
        got = bsr_spmm(adj, xt)
        torch.cuda.synchronize()
        assert bsr_spmm.launches == before + 1 and got.shape == (rows, c)
        np.testing.assert_allclose(got.cpu().numpy(), csr_spmm_reference(adj, xt).cpu().numpy(),
                                   **BSR_TOL)
        dense = np.zeros((rows, 2 * rows), np.float32)
        np.add.at(dense, (dstl_p[r][keep], src_p[r][keep]), w_p[r][keep])
        np.testing.assert_allclose(got.cpu().numpy(), dense @ x, **BSR_TOL)
        lo, hi = r * rows, min((r + 1) * rows, n)
        assert torch.equal(got[: hi - lo], square[lo:hi])


@pytest.mark.gpu
def test_world_one_nccl_sharded_precompute_equals_one_process(tmp_path, monkeypatch):
    """At world size 1 over NCCL the collectives are present and trivial:
    ``precompute_pos_sharded``, ``dist_power_chain`` and
    ``precompute_sop_sharded`` equal their single-process counterparts bit
    for bit, and the kernels launch. A PoS dataset over the device budget
    stays in the host tier, as one process keeps it."""
    import torch.distributed as dist

    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.operators.sop import host_normalized_edges, precompute_sop
    from s3grl_tpu_torch.parallel import dist as pdist
    from s3grl_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import usair_like_edges

    _cuda("it runs NCCL on the card")
    rng = np.random.default_rng(3)
    ei = usair_like_edges(1)
    x = rng.normal(size=(332, 33)).astype(np.float32)
    links = rng.integers(0, 332, (300, 2)).astype(np.int32)
    y = rng.integers(0, 2, 300).astype(np.float32)
    init_distributed(0, 1, "cuda", init_method=f"file://{tmp_path / 'store'}")
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        dg = DeviceGraph.from_graph(Graph(num_nodes=332, edge_index=ei, x=x), device="cuda")
        kw = dict(num_hops=2, sign_k=3, batch_size=64, max_subgraph_nodes=256, seed=1)
        want = precompute_pos(dg, links, y, **kw)
        before = pos_power_rows.launches
        got = pdist.precompute_pos_sharded(mesh, dg, links, y, **kw)
        assert pos_power_rows.launches > before
        assert torch.equal(got.xs, want.xs) and torch.equal(got.row_mask, want.row_mask)
        with monkeypatch.context() as m:
            m.setenv("S3GRL_TPU_DEVICE_DS_BYTES", "1")
            want = precompute_pos(dg, links, y, **kw)
            got = pdist.precompute_pos_sharded(mesh, dg, links, y, **kw)
        assert want.xs.device.type == got.xs.device.type == got.row_mask.device.type == "cpu"
        assert torch.equal(got.xs, want.xs) and torch.equal(got.row_mask, want.row_mask)
        src, dst, w = host_normalized_edges(dg)
        before = bsr_spmm.launches
        chain = pdist.dist_power_chain(mesh, src, dst, w, dg.x, 3)
        assert bsr_spmm.launches == before + 3
        adj = csr_matrix(src, dst, w, 332, 332, device="cuda")
        assert torch.equal(pdist.gather_rows(mesh, chain, 332),
                           power_chain_of(lambda v: bsr_spmm(adj, v), dg.x, 3))
        sop = pdist.precompute_sop_sharded(mesh, dg, links, y, sign_k=3)
        assert torch.equal(sop.xs, precompute_sop(dg, links, y, sign_k=3).xs)
    finally:
        dist.destroy_process_group()


def _main_path_batch(dev, B=64, S=256):
    """B train links of the USAir-like graph (bench config: 2 hops, degree
    features; the global table 96 wide) and their device-BFS node sets at S."""
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph, extract_node_sets
    from torch_port_helpers import usair_like_edges

    ei = usair_like_edges(1)
    n = int(ei.max()) + 1
    g = init_features(Graph(num_nodes=n, edge_index=ei), "degree")
    dg = DeviceGraph.from_graph(g, device=dev)
    links = torch.as_tensor(ei[:, :: ei.shape[1] // B][:, :B].T.copy(), device=dev)
    nodes, mask, _, _ = extract_node_sets(dg, links, num_hops=2, max_nodes=S)
    return dg, links, nodes, mask


def _card_batches(dev):
    """{label: (dg, links, nodes, mask)}: the main path's S = 256 batch and
    a hub batch (S = 1,024 on the 3,392-wide table)."""
    dg, links, nd = _hub_batch(dev, B=8)
    hub = (dg, torch.as_tensor(links, device=dev),
           torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev),
           torch.as_tensor(nd >= 0, device=dev))
    return {"S256": _main_path_batch(dev), "hub": hub}


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["S256", "hub"])
def test_local_table_kernel_equals_plain_version(which):
    """The card-built local table (slots only) equal to the plain version's
    bit for bit (integer output), at the route's width, at every rows a
    block the kernel can be asked for."""
    from s3grl_tpu_torch.operators.pos import local_table_width
    from s3grl_tpu_torch.ops import local_table as lt
    from s3grl_tpu_torch.ops.local_table import local_table, local_table_reference

    dev = _cuda()
    dg, links, nodes, mask = _card_batches(dev)[which]
    args = (dg.nbr, dg.degrees(), nodes.to(torch.int32).contiguous(), mask, links,
            local_table_width(dg, nodes.shape[1]))
    before = local_table.launches
    got = local_table(*args)
    torch.cuda.synchronize()
    assert local_table.launches == before + 1
    want = local_table_reference(*args)
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    assert got.shape[2] == args[-1]
    assert int((got >= 0).sum(dim=2).max()) <= args[-1]
    rule = lt.rows_per_block
    try:
        for rows in (1, 32, 100, 256):
            lt.rows_per_block = lambda S, width, rows=rows: rows
            assert torch.equal(local_table(*args), want), rows
    finally:
        lt.rows_per_block = rule


@pytest.mark.gpu
def test_local_table_kernel_rejects_a_width_it_cannot_store():
    """The kernel writes 16-byte stores: a width that is not a multiple of
    4 raises, and launches nothing."""
    from s3grl_tpu_torch.ops.local_table import local_table

    dev = _cuda()
    dg, links, nodes, mask = _main_path_batch(dev, B=4, S=32)
    before = local_table.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        local_table(dg.nbr, dg.degrees(), nodes.to(torch.int32).contiguous(), mask, links, 30)
    assert local_table.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["S256", "hub"])
def test_pos_power_rows_without_weights_equals_the_slots_weights_on_the_card(which):
    """``pos_power_rows`` and its selector phase on the card-built table
    with ``w=None`` give the bits of the same calls with ``w = loc >= 0``."""
    from s3grl_tpu_torch.operators.pos import local_table_kernel_inputs

    dev = _cuda()
    dg, links, nodes, mask = _card_batches(dev)[which]
    sel, loc, w, x, _ = local_table_kernel_inputs(dg, links, nodes, mask, max_ccn=8,
                                                  strategy="union")
    assert w is None
    spelled = (loc >= 0).float()
    assert torch.equal(pos_power_rows(sel, loc, None, x, sign_k=3),
                       pos_power_rows(sel, loc, spelled, x, sign_k=3))
    assert torch.equal(pos_selector_rows(sel, loc, None, sign_k=3),
                       pos_selector_rows(sel, loc, spelled, sign_k=3))
    with pytest.raises(ValueError, match="local slots only"):
        pos_power_rows(sel, loc, None, x, sign_k=3, row_ids=nodes.to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["S256", "hub"])
@pytest.mark.parametrize("ccn", [0, 32])
def test_pos_power_rows_on_the_local_table_equals_the_global_call(which, ccn):
    """``pos_power_rows`` in local-slot mode on the card-built table gives
    the bits of the by-id call on the same node sets."""
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs, local_table_kernel_inputs
    from s3grl_tpu_torch.ops.pos_kernel import gather_by_id

    dev = _cuda()
    dg, links, nodes, mask = _card_batches(dev)[which]
    kw = dict(max_ccn=ccn, strategy="union")
    sel, row_ids, lk, rm = by_id_kernel_inputs(dg, links, nodes, mask, **kw)
    graph = (dg.nbr, dg.degrees(), dg.x_with_indicator())
    want = pos_power_rows(sel, *graph, sign_k=3, row_ids=row_ids, links=lk)
    x = gather_by_id(*graph, row_ids, lk)[2]
    lsel, loc, lw, lx, lrm = local_table_kernel_inputs(dg, links, nodes, mask, **kw)
    assert torch.equal(lsel, sel) and torch.equal(lrm, rm) and torch.equal(lx, x)
    assert lw is None
    assert loc.shape[2] <= dg.nbr.shape[1]
    got = pos_power_rows(lsel, loc, lw, lx, sign_k=3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["host", "device"])
def test_precompute_pos_local_route_equals_the_global_route_on_the_card(monkeypatch, route):
    from s3grl_tpu_torch.ops.local_table import local_table
    from s3grl_tpu_torch.operators.pos import precompute_pos

    dev = _cuda("it holds the card's two routes against each other")
    dg, links, _ = _hub_batch(dev, B=48)
    y = np.ones(len(links), np.float32)
    kw = dict(num_hops=2, sign_k=3, k_heuristic=1, k_node_set_strategy="intersection",
              max_ccn=16, device=dev)
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", "1" if route == "host" else "0")
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "0")
    want = precompute_pos(dg, links, y, **kw)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "1")
    before = local_table.launches
    got = precompute_pos(dg, links, y, **kw)
    assert local_table.launches > before
    assert torch.equal(got.row_mask, want.row_mask) and torch.equal(got.xs, want.xs)


@pytest.mark.gpu
def test_a_failed_kernel_build_raises(monkeypatch, tmp_path):
    """nvcc refusing a flag: the build raises naming nvcc's output, and no
    library is left."""
    from s3grl_tpu_torch.ops import _build
    from s3grl_tpu_torch.ops.local_table import local_table

    dev = _cuda("nvcc runs where the card is")
    dg, links, nodes, mask = _main_path_batch(dev, B=4, S=32)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("--no-such-flag",))
    _build.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="kernel build failed"):
            local_table(dg.nbr, dg.degrees(), nodes, mask, links, 32)
    finally:
        _build.load.cache_clear()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


@pytest.mark.gpu
def test_a_span_holds_its_kernel_on_the_profilers_timeline():
    """A span around a launch and a synchronize contains that kernel's
    device interval: the program's spans and the card's kernels share the
    profiler's clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from s3grl_tpu_torch.profiling import span

    dev = _cuda("the card's timeline")
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum().item()  # warm: the library's first call is not profiled
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("pos.kernel"):
            b = a @ a
            torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name == "pos.kernel" and e.device_type != DeviceType.CUDA]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset"))]
    assert len(spans) == 1 and kernels, [e.name for e in events]
    s = spans[0].time_range
    for k in kernels:
        assert s.start <= k.time_range.start <= k.time_range.end <= s.end, (k.name, s, k.time_range)
    del b



# The selector split over (row block, subgraph): shapes of the main path's
# batches that leave SMs idle (BlogCatalog's S = 4,096 on its 2,912-wide
# global table, the card-built hub tables at cap 1,024), PoS+ rows, and
# edge cases. P is the rule's on an H100 (132 SMs) unless given.
SPLIT_CASES = {
    "global-B8": dict(B=8, S=4096, D=2912, R=2, mode="global"),
    "global-B1": dict(B=1, S=4096, D=2912, R=2, mode="global"),
    "global-B3": dict(B=3, S=4096, D=2912, R=2, mode="global"),
    "local-slots-w-none": dict(B=64, S=1024, D=1024, R=2, mode="local", no_weights=True),
    "pos-plus-R34": dict(B=4, S=2048, D=512, R=34, mode="global"),
    "S-not-a-multiple": dict(B=5, S=1000, D=40, R=3, mode="global", P=16),
    "rows-without-entries": dict(B=4, S=1024, D=64, R=2, mode="local", empty_rows=True, P=8),
}


def _split_case(name, dev):
    """(sel, nbr, w, row_ids, P) on the card for SPLIT_CASES[name]."""
    from s3grl_tpu_torch.ops.pos_kernel import selector_row_blocks

    c = dict(SPLIT_CASES[name])
    P = c.pop("P", None) or selector_row_blocks(c["B"], c["S"], 132)
    no_weights, empty_rows = c.pop("no_weights", False), c.pop("empty_rows", False)
    sel, nbr, w, _, row_ids = kernel_inputs(6, F=1, **c)
    if no_weights:  # a card-built table: slots where live, -1 elsewhere
        nbr, w = np.where(w > 0, nbr, -1).astype(np.int32), None
    if empty_rows:  # every third row and the whole first subgraph
        w[:, ::3] = 0.0
        w[0] = 0.0
    t = [None if a is None else torch.as_tensor(a, device=dev) for a in (sel, nbr, w, row_ids)]
    return (*t, P)


def _selector_h(sel, nbr, w, row_ids, sign_k, P):
    from s3grl_tpu_torch.ops.pos_kernel import _lib, _selector_rows_cuda

    B, S, D = nbr.shape
    h = _selector_rows_cuda(_lib(), sel, nbr, w, row_ids, sign_k, B, S, D, sel.shape[1],
                            row_blocks=P)
    torch.cuda.synchronize()
    return h


@pytest.mark.gpu
@pytest.mark.parametrize("sign_k", [1, 3])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_selector_equals_the_one_block_kernel_bit_for_bit(name, sign_k):
    """On 0/1 weights the split selector's h equals the one-block kernel's
    bit for bit (its zero columns included), and H matches the plain
    version."""
    dev = _cuda()
    sel, nbr, w, row_ids, P = _split_case(name, dev)
    assert P > 1
    before = pos_selector_rows.split_launches
    got = _selector_h(sel, nbr, w, row_ids, sign_k, P)
    assert pos_selector_rows.split_launches == before + 1
    want = _selector_h(sel, nbr, w, row_ids, sign_k, 1)
    assert pos_selector_rows.split_launches == before + 1
    assert torch.equal(got, want)
    kr = sign_k * sel.shape[1]
    assert not got[:, :, kr:].any()
    ref = pos_selector_rows_reference(sel, nbr, w, sign_k=sign_k, row_ids=row_ids)
    torch.testing.assert_close(got[:, :, :kr].transpose(1, 2), ref, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["global", "local"])
def test_split_selector_repeats_bit_for_bit_with_general_weights(mode):
    """Weights that are no small integers (and rows that name one slot more
    than once): two runs of the split selector give the same bits, and H
    matches the plain version."""
    dev = _cuda()
    sel, nbr, w, _, row_ids = kernel_inputs(7, B=4, S=2048, D=256, F=1, R=2, mode=mode)
    w = w * np.random.default_rng(8).uniform(0.05, 3.0, w.shape).astype(np.float32)
    t = [None if a is None else torch.as_tensor(a, device=dev) for a in (sel, nbr, w, row_ids)]
    first = _selector_h(*t, 3, 64)
    for _ in range(3):
        assert torch.equal(_selector_h(*t, 3, 64), first)
    ref = pos_selector_rows_reference(*t[:3], sign_k=3, row_ids=t[3])
    torch.testing.assert_close(first[:, :, :6].transpose(1, 2), ref, **TOL)


@pytest.mark.gpu
def test_pos_power_rows_split_equals_the_one_block_path_on_the_hub(monkeypatch):
    """``pos_power_rows`` on a BlogCatalog-shaped batch (B = 8 at S = 4,096
    on the 3,392-wide global table, read by id) takes the split selector by
    the rule, and its output equals the one-block path's bit for bit."""
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs
    from s3grl_tpu_torch.ops import pos_kernel as pk

    dev = _cuda()
    dg, links, nd = _hub_batch(dev, B=8, S=4096)
    nodes = torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev)
    mask = torch.as_tensor(nd >= 0, device=dev)
    sel, row_ids, lk, _ = by_id_kernel_inputs(dg, torch.as_tensor(links, device=dev), nodes, mask)
    args = (sel, dg.nbr, dg.degrees(), dg.x_with_indicator())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert pk.selector_row_blocks(8, 4096, sms) > 1
    c0 = profiling.counters()
    got = pos_power_rows(*args, sign_k=3, row_ids=row_ids, links=lk)
    c1 = profiling.counters()
    assert c1["pos.selector.split_calls"] - c0.get("pos.selector.split_calls", 0) == 1
    assert c1["pos.selector.blocks"] - c0.get("pos.selector.blocks", 0) == sms
    monkeypatch.setattr(pk, "selector_row_blocks", lambda B, S, sms: 1)
    want = pos_power_rows(*args, sign_k=3, row_ids=row_ids, links=lk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _blog_graph(F):
    """The BlogCatalog-sized power-law graph (hub degree 3,377; a global
    table 3,392 wide) with F seeded normal feature columns on the card."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import blogcatalog_like_edges

    ei = blogcatalog_like_edges(1)
    n = int(ei.max()) + 1
    x = np.random.default_rng(5).normal(size=(n, F)).astype(np.float32)
    return DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei, x=x), device="cuda"), ei


def _by_id_batch(B, S, F=128, links="edges", sign_k=3, ccn=0):
    """(dg, links [B, 2], nodes, mask) on the card: B links of the
    BlogCatalog-sized graph and their 2-hop node sets at S from the host
    core. ``links``: "edges" (observed), "mixed" (edges and non-edges in
    turn), "hub" (the hub's own edges, the hub at slot 0 or 1 in turn) or
    "sparse" (the edges of the lowest-degree nodes, so subgraphs leave
    slots empty)."""
    from s3grl_tpu_torch import native

    dg, ei = _blog_graph(F)
    rng = np.random.default_rng(B * 7919 + S)
    deg = np.bincount(ei[0], minlength=dg.num_nodes)
    if links == "hub":
        pick = np.flatnonzero(ei[0] == int(np.argmax(deg)))[:B]
        lk = ei[:, pick].T.copy()
        lk[1::2] = lk[1::2, ::-1].copy()
    elif links == "sparse":
        lk = ei[:, np.argsort(deg[ei[0]] + deg[ei[1]], kind="stable")[:B]].T.copy()
    else:
        lk = ei[:, rng.choice(ei.shape[1], B, replace=False)].T.copy()
        if links == "mixed":
            lk[1::2, 1] = rng.integers(0, dg.num_nodes, len(lk[1::2]))
            lk[1::2, 1] = np.where(lk[1::2, 1] == lk[1::2, 0], (lk[1::2, 0] + 1) % dg.num_nodes,
                                   lk[1::2, 1])
    lk = np.ascontiguousarray(lk.astype(np.int32))
    nd, _ = native.khop_nodes(*dg.host_csr(), lk, 2, S)
    dev = dg.device
    return (dg, torch.as_tensor(lk, device=dev),
            torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev),
            torch.as_tensor(nd >= 0, device=dev))


# The by-id call against the gathered one: the split selector at BlogCatalog's
# batch (B = 8 and 1 at S = 4,096), hub rows longer than the staging row on
# the one-block kernel, the target link's rows for edges and non-edges,
# empty slots, PoS+ (R = 34, the tiled X pass), an odd column count (F + 1 =
# 33, one float a lane) and the X pass alone (sign_k 0).
BY_ID_CASES = {
    "split-B8": dict(B=8, S=4096, F=1025),
    "split-B1": dict(B=1, S=4096, F=1025),
    "hub-rows": dict(B=16, S=256, links="hub"),
    "edges-and-non-edges": dict(B=64, S=512, links="mixed"),
    "empty-slots": dict(B=16, S=4096, links="sparse"),
    "pos-plus-R34": dict(B=8, S=256, ccn=32, links="mixed"),
    "odd-F": dict(B=8, S=512, F=32, links="mixed"),
    "sign-k-0": dict(B=8, S=512, sign_k=0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(BY_ID_CASES))
def test_by_id_call_equals_the_gathered_call_bit_for_bit(name):
    """``pos_power_rows`` reading the graph's own table, degrees and
    features by node id gives the bits of the same kernel on the gathered
    per-batch arrays of ``global_kernel_inputs`` (the route before it read
    by id), and matches the plain version."""
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs, global_kernel_inputs
    from s3grl_tpu_torch.ops.pos_kernel import selector_row_blocks

    dev = _cuda()
    c = BY_ID_CASES[name]
    dg, links, nodes, mask = _by_id_batch(**c)
    K = c.get("sign_k", 3)
    kw = dict(max_ccn=c.get("ccn", 0), strategy="union")
    B, S = nodes.shape
    degs = dg.degrees()[nodes[mask].long()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if name.startswith("split"):
        assert selector_row_blocks(B, S, sms) > 1
    if name == "hub-rows":
        assert selector_row_blocks(B, S, sms) == 1 and int(degs.max()) > 1024
    if name == "empty-slots":
        assert not bool(mask.all())
    gsel, gnbr, gw, gx, gids, grm = global_kernel_inputs(dg, links, nodes, mask, **kw)
    want = pos_power_rows(gsel, gnbr, gw, gx, sign_k=K, row_ids=gids)
    sel, row_ids, lk, rm = by_id_kernel_inputs(dg, links, nodes, mask, **kw)
    assert torch.equal(sel, gsel) and torch.equal(row_ids, gids) and torch.equal(rm, grm)
    assert sel.shape[1] == 2 + kw["max_ccn"]
    args = (sel, dg.nbr, dg.degrees(), dg.x_with_indicator())
    before = pos_power_rows.launches
    got = pos_power_rows(*args, sign_k=K, row_ids=row_ids, links=lk)
    torch.cuda.synchronize()
    assert pos_power_rows.launches == before + 1
    assert torch.equal(got, want)
    ref = pos_power_rows_reference(*args, sign_k=K, row_ids=row_ids, links=lk)
    torch.testing.assert_close(got, ref, **TOL)


@pytest.mark.gpu
def test_precompute_pos_by_id_equals_the_gathered_route_on_the_card(monkeypatch):
    """``precompute_pos``' global route, which reads the graph by id, gives
    the dataset of the same route on ``global_kernel_inputs``' gathered
    arrays bit for bit, and counts every batch in ``pos.inputs.by_id``."""
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.operators import pos as tpos

    dev = _cuda("it holds the card's by-id route against the gathered one")
    dg, links, _ = _hub_batch(dev, B=48)
    y = np.ones(len(links), np.float32)
    kw = dict(num_hops=2, sign_k=3, max_subgraph_nodes=1024, batch_size=16, device=dev)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "0")
    c0 = profiling.counters()
    got = tpos.precompute_pos(dg, links, y, **kw)
    c1 = profiling.counters()
    n_batches = c1["pos.batches"] - c0.get("pos.batches", 0)
    assert c1["pos.inputs.by_id"] - c0.get("pos.inputs.by_id", 0) == n_batches > 0

    def gathered(dg, links, nodes, node_mask, *, sign_k, max_ccn=0, strategy=""):
        sel, nbr, w, x, ids, rm = tpos.global_kernel_inputs(dg, links, nodes, node_mask,
                                                           max_ccn=max_ccn, strategy=strategy)
        return pos_power_rows(sel, nbr, w, x, sign_k=sign_k, row_ids=ids) * rm[:, None, :, None], rm

    monkeypatch.setattr(tpos, "pos_operators_global", gathered)
    want = tpos.precompute_pos(dg, links, y, **kw)
    assert torch.equal(got.xs, want.xs) and torch.equal(got.row_mask, want.row_mask)


# The worst relative gap of a link's SoP rows (``benchmark.cellbase.
# worst_relative_gap``) allowed against the float64 reference: on an H100
# (80GB HBM3, 700 W) ``precompute_sop`` read at most 1.63e-7 over 31 seeded
# splits of the USAir-sized graph, and the same reference computed in TF32
# read at least 1.21e-4.
SOP_GAP = 5e-6


@pytest.mark.gpu
@pytest.mark.parametrize("features", ["one_hot_degree", "normal_16"])
def test_precompute_sop_at_usair_size_against_the_plain_reference(features):
    """``precompute_sop`` on the card at USAir's size (the benchmark's
    generated 332-node graph and split, sign_k 3) over the train links, on
    the route ``should_use_bsr`` picks (the CSR kernel's at 1,025 feature
    columns, the edge list's at 16), against the float64 reference of
    ``benchmark/reference_sop.py`` within :data:`SOP_GAP`, on 256 links:
    the 128 of the largest endpoint degrees and 128 drawn. Features: the
    benchmark's 1,025 one-hot degree columns, or 16 seeded normal columns,
    the width of the paper's node2vec-16 features."""
    import json

    from benchmark.cellbase import make_inputs, program_graph, ref_graph, worst_relative_gap
    from benchmark.reference_sop import sop_rows
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.operators.sop import precompute_sop

    dev = _cuda()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "usair_pos.json")) as f:
        config = json.load(f)
    inp = make_inputs(config, 2**33 + 17)
    if features == "normal_16":
        inp.x = np.random.default_rng(2**33 + 19).normal(size=(inp.n, 16)).astype(np.float32)
    links, y = inp.split.links("train")
    c0 = profiling.counters()
    ds = precompute_sop(program_graph(inp, dev), links, y, sign_k=3, device=dev)
    c1 = profiling.counters()
    calls = c1["sop.spmm.calls"] - c0.get("sop.spmm.calls", 0)
    csr_calls = c1.get("sop.spmm.csr_calls", 0) - c0.get("sop.spmm.csr_calls", 0)
    assert calls > 0 and csr_calls == (calls if features == "one_hot_degree" else 0)
    deg = np.bincount(inp.split.observed[0], minlength=inp.n)
    wide = np.argsort(-(deg[links[:, 0]] + deg[links[:, 1]]), kind="stable")[:128]
    drawn = np.random.default_rng(3).choice(len(links), 128, replace=False)
    pick = np.concatenate([wide, drawn])
    got = ds.xs[torch.as_tensor(pick, device=dev)].cpu().numpy()
    want = sop_rows(ref_graph(inp, dev), links[pick], sign_k=3).cpu().numpy()
    assert worst_relative_gap(got, want) <= SOP_GAP


# The worst relative gap of a link's PoS Plus rows between the card and the
# CPU path (plain versions of the kernels), both float32: the same sums in
# another order, ~1e-7 of a block's largest entry.
POS_PLUS_GAP = 5e-6


@pytest.mark.gpu
def test_cora_pos_plus_train_split_on_the_card(monkeypatch):
    """The benchmark's Cora-shaped PoS Plus train split (17,952 links, 3
    hops, intersection CCN, 1,433 features) through ``precompute_pos`` on
    the card with the storage budget unset: float32 at R = 2 + the padded
    CCN width (16 on this split), no "CCN pad halved" warning, the tiled X
    pass (K·R = 54 > 32) launched, and 48 of its links (the 24 with the
    most common neighbours, 24 drawn) equal to the CPU path within
    :data:`POS_PLUS_GAP`, their row masks exactly."""
    import json
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from benchmark.cellbase import program_graph, worst_relative_gap
    from benchmark.kinds.pos_plus_prep import make_inputs
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.operators import pos as tpos

    dev = _cuda()
    monkeypatch.delenv("S3GRL_TPU_DEVICE_DS_BYTES", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "cora_pos_plus.json")) as f:
        config = json.load(f)
    p = config["pos"]
    kw = dict(num_hops=p["num_hops"], sign_k=p["sign_k"], buckets=tuple(p["buckets"]),
              batch_size=p["extract_batch_size"], max_subgraph_nodes=p["max_subgraph_nodes"],
              k_heuristic=p["k_heuristic"], k_node_set_strategy=p["k_node_set_strategy"],
              max_ccn=p["max_ccn_nodes"], seed=1)
    inp = make_inputs(config, 2**33 + 29)
    links, y = inp.split.links("train")
    dg = program_graph(inp, dev)
    counts = tpos.ccn_counts(dg, links, p["k_node_set_strategy"])
    assert tpos.padded_ccn_width(dg, links, p["k_node_set_strategy"], p["max_ccn_nodes"],
                                 counts) == 16
    c0 = profiling.counters()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ds = tpos.precompute_pos(dg, links, y, device=dev, **kw)
            torch.cuda.synchronize()
    c1 = profiling.counters()
    assert not [w for w in seen if "CCN" in str(w.message)], [str(w.message) for w in seen]
    assert ds.xs.dtype == torch.float32 and ds.xs.device.type == "cuda"
    assert tuple(ds.xs.shape) == (len(links), p["sign_k"] + 1, 18, inp.x.shape[1] + 1)
    assert c1["pos.store.f32"] - c0.get("pos.store.f32", 0) == 1
    assert c1.get("pos.store.bf16", 0) == c0.get("pos.store.bf16", 0)
    assert c1.get("pos.store.host", 0) == c0.get("pos.store.host", 0)
    names = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    assert any("pos_xpass_tiled_kernel" in n for n in names), sorted(names)
    rng = np.random.default_rng(5)
    pick = np.concatenate([np.argsort(-counts, kind="stable")[:24],
                           rng.choice(len(links), 24, replace=False)])
    want = tpos.precompute_pos(program_graph(inp, "cpu"), links[pick], y[pick], device="cpu",
                               **kw)
    idx = torch.as_tensor(pick, device=dev)
    assert torch.equal(ds.row_mask[idx].cpu(), want.row_mask)
    assert worst_relative_gap(ds.xs[idx].cpu().numpy(), want.xs.numpy()) <= POS_PLUS_GAP


@pytest.mark.gpu
def test_cora_pos_plus_scaled_train_split_on_the_card(monkeypatch):
    """The benchmark's ScaLed PoS Plus train split (17,952 links, walks of
    m 3 and M 20, intersection CCN, 1,433 features) through
    ``precompute_pos`` on the card: float32 at R = 18 in the one 256
    bucket; the walk counters equal the plain reference's sums over every
    link (``benchmark/workmodel_scaled.walk_work``), read from the card
    once in the call; and 48 of its links (the 24 with the most CCN rows,
    24 drawn) equal to the plain reference within the cell's ``ops_gap``
    limit, their row masks exactly."""
    import json

    from benchmark import reference_scaled, workmodel_scaled
    from benchmark.cellbase import program_graph, ref_graph, worst_relative_gap
    from benchmark.kinds.scaled_prep import make_inputs
    from s3grl_tpu_torch import profiling
    from s3grl_tpu_torch.operators import pos as tpos

    dev = _cuda()
    monkeypatch.delenv("S3GRL_TPU_DEVICE_DS_BYTES", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "cora_pos_plus_scaled.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "limits", "cora_pos_plus_scaled.prep.json")) as f:
        limit = json.load(f)["ops_gap"]
    p = config["pos"]
    seed = 2**31 - 9
    kw = dict(num_hops=p["num_hops"], sign_k=p["sign_k"], buckets=tuple(p["buckets"]),
              batch_size=p["extract_batch_size"], max_subgraph_nodes=p["max_subgraph_nodes"],
              k_heuristic=p["k_heuristic"], k_node_set_strategy=p["k_node_set_strategy"],
              max_ccn=p["max_ccn_nodes"], rw_m=p["m"], rw_M=p["M"], seed=seed)
    inp = make_inputs(config)
    links, y = inp.split.links("train")
    dg = program_graph(inp, dev)
    reads = []
    real = tpos.read_walk_sums
    monkeypatch.setattr(tpos, "read_walk_sums", lambda sums: reads.append(1) or real(sums))
    c0 = profiling.counters()
    ds = tpos.precompute_pos(dg, links, y, device=dev, **kw)
    torch.cuda.synchronize()
    c1 = profiling.counters()
    got = {k: c1[k] - c0.get(k, 0) for k in c1 if k.startswith("pos.")}
    assert ds.xs.dtype == torch.float32 and ds.xs.device.type == "cuda"
    assert tuple(ds.xs.shape) == (len(links), p["sign_k"] + 1, 18, inp.x.shape[1] + 1)
    assert reads == [1] and got["pos.batches"] == 71
    g = ref_graph(inp, "cpu")
    seeds = reference_scaled.link_seeds(seed, np.arange(len(links)))
    w, ccn = workmodel_scaled.walk_work(g, links, seeds, rw_m=p["m"], rw_M=p["M"],
                                        strategy=p["k_node_set_strategy"], max_ccn=16)
    assert got["pos.walks.members"] == got["pos.slots_used"] == int(w["members"].sum())
    assert got["pos.slots"] == 256 * len(links)
    assert got["pos.walks.mask_entries"] == len(links) * inp.n
    assert got["pos.ccn.rows"] == int(ccn.sum()) and got["pos.ccn.slots"] == 16 * len(links)
    rng = np.random.default_rng(5)
    pick = np.concatenate([np.argsort(-ccn, kind="stable")[:24],
                           rng.choice(len(links), 24, replace=False)])
    want, want_mask = reference_scaled.scaled_rows(
        ref_graph(inp, dev), links[pick], pick, seed=seed, rw_m=p["m"], rw_M=p["M"],
        sign_k=p["sign_k"], strategy=p["k_node_set_strategy"], max_ccn=p["max_ccn_nodes"],
        width=18)
    idx = torch.as_tensor(pick, device=dev)
    assert torch.equal(ds.row_mask[idx].cpu(), want_mask.cpu())
    assert worst_relative_gap(ds.xs[idx].cpu().numpy(), want.cpu().numpy()) <= limit
