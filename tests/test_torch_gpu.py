"""The port's CUDA kernels against their plain torch versions, and the
plain-torch label paths (labels, full-row, GNN baselines) against the CPU,
on a card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

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
