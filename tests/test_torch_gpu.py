"""The port's CUDA kernels against their plain torch versions, and the
plain-torch label paths (labels, full-row, GNN baselines) against the CPU,
on a card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
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
    csr_spmm_reference,
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
    adj = blockify(src, dst, w, n, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm_reference(adj, xt)
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
    adj = blockify(src, dst, w, 400, device=dev)
    assert adj.csr_max_row > 32
    xt = torch.as_tensor(x, device=dev)
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    want = bsr_spmm_reference(adj, xt)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **BSR_TOL)
    assert torch.equal(bsr_spmm(adj, xt), got)


@pytest.mark.gpu
def test_bsr_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(1, 200, 800, 9)
    adj = blockify(src, dst, w, 200, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    wide = dataclasses.replace(adj, csr_cols=adj.csr_cols.long())
    with pytest.raises(TypeError):
        bsr_spmm(wide, xt)
    with pytest.raises(ValueError):
        bsr_spmm(adj, torch.as_tensor(x.T.copy(), device=dev).T)
    on_cpu = blockify(src, dst, w, 200, device="cpu")
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
    """``pos_power_rows`` at the hub-dense shape: global ids on the
    3,392-wide global table, whose rows the selector kernel reads twice;
    PoS+ rows (intersection CCN, R = 34) included."""
    from s3grl_tpu_torch.operators.pos import global_kernel_inputs

    dev = _cuda()
    dg, links, nd = _hub_batch(dev)
    nodes = torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev)
    mask = torch.as_tensor(nd >= 0, device=dev)
    for ccn in (0, 32):
        sel, nbr, w, x, row_ids, _ = global_kernel_inputs(
            dg, torch.as_tensor(links, device=dev), nodes, mask,
            max_ccn=ccn, strategy="intersection")
        got = pos_power_rows(sel, nbr, w, x, sign_k=3, row_ids=row_ids)
        want = pos_power_rows_reference(sel, nbr, w, x, sign_k=3, row_ids=row_ids)
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
@pytest.mark.parametrize("c", [1025, 4, 1])
def test_bsr_kernel_on_a_row_shard_matches_plain_version(c):
    """``bsr_spmm`` on one rank's [rows, N_pad] shard of a 2-way row
    partition (``parallel/dist.py``), built as the chain builds it
    (``csr_matrix``, CSR alone): X has N_pad rows, Y one per shard row;
    against its plain version, the dense product, and the square matrix's
    rows bit for bit."""
    from s3grl_tpu_torch.ops.spmm_kernel import csr_matrix
    from s3grl_tpu_torch.parallel.dist import partition_edges_by_owner

    dev = _cuda()
    n = 333  # rows = 167, N_pad = 334: X's last row is padding
    src, dst, w, _ = _bsr_inputs(7, n, 4000, 1)
    src_p, dstl_p, w_p, rows = partition_edges_by_owner(src, dst, w, n, 2)
    rng = np.random.default_rng(8)
    x = np.zeros((2 * rows, c), np.float32)
    x[:n] = rng.normal(size=(n, c))
    xt = torch.as_tensor(x, device=dev)
    square = bsr_spmm(blockify(src, dst, w, n, device=dev), xt[:n])
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
    from s3grl_tpu_torch.ops.spmm_kernel import power_chain
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
        assert torch.equal(pdist.gather_rows(mesh, chain, 332),
                           power_chain(blockify(src, dst, w, 332, device="cuda"), dg.x, 3))
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
    the bits of the global-id call on the same node sets."""
    from s3grl_tpu_torch.operators.pos import global_kernel_inputs, local_table_kernel_inputs

    dev = _cuda()
    dg, links, nodes, mask = _card_batches(dev)[which]
    kw = dict(max_ccn=ccn, strategy="union")
    sel, nbr, w, x, row_ids, rm = global_kernel_inputs(dg, links, nodes, mask, **kw)
    want = pos_power_rows(sel, nbr, w, x, sign_k=3, row_ids=row_ids)
    lsel, loc, lw, lx, lrm = local_table_kernel_inputs(dg, links, nodes, mask, **kw)
    assert torch.equal(lsel, sel) and torch.equal(lrm, rm) and torch.equal(lx, x)
    assert lw is None
    assert loc.shape[2] <= nbr.shape[2]
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

