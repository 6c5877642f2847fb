"""Port parity, the SEAL GNN baselines (DGCNN, GCN, SAGE, GIN).

Flax weights are carried into the port with ``gnn_state_dict_from_flax``.
Forward passes in eval mode agree within rtol 1e-4, atol 1e-5 (GCN and
SAGE, with dropout and dropedge at 0, in train mode too); DGCNN's and GIN's
score MLP fixes dropout at 0.5, so their eval-mode BCE gradients are held
against ``jax.grad`` within 1e-4 instead. Parameter counts are equal. The
static-cache batch, S and sortpool_k are bit-exact; each model/label pair
of tests/test_gnn_baselines.py learns on the synthetic USAir-shaped graph.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.models.gnn as jgnn
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.sampling.extraction as jext
from s3grl_tpu.runner_utils import round_up_pow2 as j_round_up_pow2
from s3grl_tpu.train.loop import _count_params
from s3grl_tpu.train.loop import bce_with_logits as j_bce
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.models.gnn as tgnn
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.convert import gnn_state_dict_from_flax
from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
from s3grl_tpu_torch.runner import build_split_links, run_sgrl_learning
from s3grl_tpu_torch.runner_utils import round_up_pow2
from s3grl_tpu_torch.sampling.labeling import label_nodes
from s3grl_tpu_torch.train.gnn_loop import (
    batch_from_cache,
    extract_and_label,
    pad_size_and_sortpool_k,
)
from s3grl_tpu_torch.train.loop import bce_with_logits
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
H, LAYERS, B, S, F = 16, 3, 12, 32, 5


@pytest.fixture(scope="module")
def graph_batch():
    """A link batch of the synthetic graph (1 hop, S = 32): the port's
    torch graph, and numpy (adj, z by label, mask, x, y)."""
    n, ei = 200, usair_like_edges(3, n=200)
    x = np.random.default_rng(41).normal(size=(n, F)).astype(np.float32)
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    rng = np.random.default_rng(42)
    links = np.concatenate([ei[:, rng.choice(ei.shape[1], B // 2)].T,
                            rng.integers(0, n, (B - B // 2, 2))]).astype(np.int32)
    sub = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=1, max_nodes=S)
    adj = text.dense_adjacency(sub)
    z = {lb: label_nodes(adj, sub.dist, sub.node_mask, node_label=lb).numpy()
         for lb in ("drnl", "de")}
    xs = (td.x[sub.nodes.long()] * sub.node_mask[:, :, None]).numpy()
    y = (np.arange(B) < B // 2).astype(np.float32)
    return td, links, adj.numpy(), z, sub.node_mask.numpy(), xs, y


def _models(name, k=10, use_feature=False, dropout=0.0):
    """(flax model, torch model) of one architecture at the test widths."""
    nf = F if use_feature else 0
    if name == "GCN":
        return (jgnn.GCNModel(H, LAYERS, use_feature=use_feature, dropout=dropout),
                tgnn.GCNModel(H, LAYERS, use_feature=use_feature, num_features=nf,
                              dropout=dropout))
    if name == "SAGE":
        return (jgnn.SAGEModel(H, LAYERS, use_feature=use_feature, dropout=dropout),
                tgnn.SAGEModel(H, LAYERS, use_feature=use_feature, num_features=nf,
                               dropout=dropout))
    if name == "GIN":
        return (jgnn.GINModel(H, LAYERS, use_feature=use_feature),
                tgnn.GINModel(H, LAYERS, use_feature=use_feature, num_features=nf))
    return (jgnn.DGCNN(H, LAYERS, k=k, use_feature=use_feature),
            tgnn.DGCNN(H, LAYERS, k, use_feature=use_feature, num_features=nf))


def _setup(graph_batch, name, label="drnl", k=10, use_feature=False, ties=False):
    """Flax variables (with random running statistics) carried into the port."""
    _, _, adj, z, mask, xs, _ = graph_batch
    jm, tm = _models(name, k=k, use_feature=use_feature)
    x = xs if use_feature else None
    v = jm.init({"params": jax.random.PRNGKey(5), "dropout": jax.random.PRNGKey(6)},
                jnp.asarray(adj), jnp.asarray(z[label]), jnp.asarray(mask),
                x=None if x is None else jnp.asarray(x), train=True)
    v = jax.tree_util.tree_map(lambda a: np.array(a), v)
    rng = np.random.default_rng(7)
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["batch_stats"]):
        leaf[...] = (rng.normal(size=leaf.shape) if path[-1].key == "mean"
                     else rng.uniform(0.5, 2.0, leaf.shape))
    if ties:
        # The last GCN layer outputs tanh(0) = 0 on every node: sort-pool
        # must keep the lowest k valid slots, in slot order.
        last = v["params"][f"BatchedGCNConv_{LAYERS}"]["Dense_0"]["Dense_0"]
        last["kernel"][...] = 0.0
        last["bias"][...] = 0.0
    tm.load_state_dict(gnn_state_dict_from_flax(v, name))
    inputs = (adj, z[label], mask, x)
    return jm, v, tm, inputs


def _j(inputs):
    adj, z, mask, x = inputs
    return (jnp.asarray(adj), jnp.asarray(z), jnp.asarray(mask)), (
        None if x is None else jnp.asarray(x))


def _t(inputs):
    adj, z, mask, x = inputs
    return (torch.as_tensor(adj), torch.as_tensor(z), torch.as_tensor(mask),
            None if x is None else torch.as_tensor(x))


CASES = [  # (model, label, k, use_feature, ties)
    ("GCN", "drnl", 10, False, False),
    ("SAGE", "drnl", 10, False, False),
    ("GIN", "drnl", 10, False, False),
    ("GCN", "de", 10, False, False),
    ("GCN", "drnl", 10, True, False),  # node features concatenated
    ("DGCNN", "drnl", 10, False, False),
    ("DGCNN", "drnl", 10, False, True),  # sort-pool ties on every node
    ("DGCNN", "de", 40, True, False),  # k > S: padded rows
]


def _id(c):
    return f"{c[0]}-{c[1]}-k{c[2]}" + ("-x" if c[3] else "") + ("-ties" if c[4] else "")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_eval_matches_flax(graph_batch, case):
    name, label, k, use_feature, ties = case
    jm, v, tm, inputs = _setup(graph_batch, name, label, k, use_feature, ties)
    jin, jx = _j(inputs)
    want = jm.apply(v, *jin, x=jx, train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(*_t(inputs))
    assert got.shape == (B,)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)
    assert sum(p.numel() for p in tm.parameters()) == _count_params(v["params"])


def test_sort_pool_ties_keep_the_lowest_slots(graph_batch, monkeypatch):
    """With every node tied, the pooled rows are the first k valid slots in
    slot order (jax.lax.top_k's order), the rest zero."""
    k = 20
    _, _, tm, inputs = _setup(graph_batch, "DGCNN", k=k, ties=True)
    adj, z, mask, _ = _t(inputs)
    seen = {"convs": []}
    for conv in tm.convs:
        conv.register_forward_hook(lambda mod, inp, out: seen["convs"].append(out))
    real = tgnn.conv1d_by_matmul

    def first_stage_input(x, conv):
        if conv is tm.conv1:
            seen["pooled"] = x
        return real(x, conv)

    monkeypatch.setattr(tgnn, "conv1d_by_matmul", first_stage_input)
    tm.eval()
    with torch.no_grad():
        tm(adj, z, mask)
    hcat = torch.tanh(torch.cat(seen["convs"], dim=-1))
    assert (hcat[:, :, -1] == 0).all()
    pooled = seen["pooled"].reshape(B, k, -1)
    assert int(mask.sum(dim=1).min()) < k  # a subgraph smaller than k
    for b in range(B):
        keep = torch.nonzero(mask[b])[:k, 0]
        want = torch.zeros(k, hcat.shape[-1])
        want[: len(keep)] = hcat[b, keep]
        torch.testing.assert_close(pooled[b], want, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_forward_train_matches_flax(graph_batch, name):
    """Dropout and dropedge at 0: batch statistics and the running
    statistics they update agree too."""
    jm, v, tm, inputs = _setup(graph_batch, name)
    jin, _ = _j(inputs)
    want, mut = jm.apply(v, *jin, train=True, mutable=["batch_stats"])
    tm.train()
    got = tm(*_t(inputs))
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), **TOL)
    new = gnn_state_dict_from_flax(
        {"params": v["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, mut["batch_stats"])},
        name,
    )
    for key, val in tm.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(val.numpy(), new[key].numpy(), err_msg=key, **TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("DGCNN", "GIN")], ids=_id)
def test_eval_gradients_match_jax(graph_batch, case):
    name, label, k, use_feature, ties = case
    jm, v, tm, inputs = _setup(graph_batch, name, label, k, use_feature, ties)
    jin, jx = _j(inputs)
    y = graph_batch[-1]

    def loss(p):
        out = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, *jin, x=jx, train=False)
        return j_bce(out, jnp.asarray(y)).mean()

    grads = jax.grad(loss)(v["params"])
    want = gnn_state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, grads), "batch_stats": v["batch_stats"]},
        name,
    )
    tm.eval()
    bce_with_logits(tm(*_t(inputs)), torch.as_tensor(y)).mean().backward()
    for key, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), err_msg=key, **GRAD_TOL)


# tests/test_gnn_baselines.py's config, on the synthetic USAir-shaped graph.
BASE = dict(
    dataset="USAir", num_hops=1, hidden_channels=16, num_layers=3, batch_size=32,
    lr=1e-3, epochs=2, seed=1, train_percent=20.0, val_percent=50.0,
    test_percent=50.0, max_subgraph_nodes=128, delete_dataset=True,
)


def _split(seed=1):
    g = tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(seed))
    rng, _ = seed_everything(seed)
    return do_edge_split(g, val_ratio=0.05, test_ratio=0.1, rng=rng)


def test_pad_size_and_sortpool_k_match_jax():
    """S and k from the port's sizes equal the JAX package's rule
    (gnn_loop.py:109-119) on the JAX package's sizes, bit for bit."""
    graph, split = _split()
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=332, edge_index=graph.edge_index))
    td = text.DeviceGraph.from_graph(graph, device="cpu")
    rng, _ = seed_everything(1)
    for num_hops, cap, sortpool_k in ((1, 128, 0.6), (2, 4096, 0.6), (2, 256, 0.3), (1, 64, 25)):
        cfg = RunConfig(**{**BASE, "model": "DGCNN", "num_hops": num_hops,
                           "max_subgraph_nodes": cap, "sortpool_k": sortpool_k})
        sizes, jsizes = {}, {}
        for s, pct in (("train", 20.0), ("valid", 50.0), ("test", 50.0)):
            links, _ = build_split_links(s, split, pct, rng)
            sizes[s] = measure_subgraph_sizes(td, links.astype(np.int32), num_hops=num_hops)
            jsizes[s] = jpos.measure_subgraph_sizes(jd, links.astype(np.int32), num_hops=num_hops)
            np.testing.assert_array_equal(sizes[s], jsizes[s])
        S_j = min(j_round_up_pow2(max(int(v.max()) for v in jsizes.values())), cap)
        if sortpool_k <= 1:
            ts = np.sort(jsizes["train"])
            k_j = max(10, int(ts[int(np.ceil(sortpool_k * len(ts))) - 1]))
        else:
            k_j = int(sortpool_k)
        assert pad_size_and_sortpool_k(cfg, sizes) == (S_j, k_j)
    for x in (0, 1, 8, 9, 100, 128, 129):
        assert round_up_pow2(x) == j_round_up_pow2(x)


@pytest.mark.parametrize("num_hops,max_nodes", [(1, 32), (2, 128), (2, 512)])
def test_static_cache_batch_equals_fresh_extraction(graph_batch, num_hops, max_nodes):
    """The re-densified cached batch is bit-exact with dense_adjacency of a
    fresh extraction, in the port and in the JAX package."""
    td, links, *_ = graph_batch
    lb = torch.as_tensor(links)
    adj, z, mask, nodes = extract_and_label(td, lb, num_hops=num_hops, max_nodes=max_nodes,
                                            node_label="drnl", max_iters=32)
    got = batch_from_cache(td, lb, nodes, mask)
    np.testing.assert_array_equal(got.numpy(), adj.numpy())
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(
        num_nodes=td.num_nodes, edge_index=np.stack(td.host_edges()[:2])))
    js = jext.extract_subgraphs(jd, jnp.asarray(links), num_hops=num_hops, max_nodes=max_nodes)
    np.testing.assert_array_equal(np.asarray(jext.dense_adjacency(js)), got.numpy())


@pytest.mark.parametrize(
    "model,label",
    [("GCN", "drnl"), ("SAGE", "drnl"), ("GIN", "drnl"), ("GCN", "de"), ("DGCNN", "drnl")],
)
def test_gnn_baseline_learns(tmp_path, model, label):
    graph, split = _split()
    cfg = RunConfig(**BASE, model=model, node_label=label, results_dir=str(tmp_path))
    _, best, ttimes, _, nparams = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert nparams > 0 and len(ttimes) == 2
    assert best > 60.0, f"{model}/{label} failed to learn: {best}"


def test_static_cache_and_per_epoch_extraction_give_the_same_run(tmp_path):
    from s3grl_tpu_torch.train.gnn_loop import run_gnn_learning

    graph, split = _split()
    cfg = RunConfig(**{**BASE, "epochs": 1}, model="DGCNN", node_label="drnl",
                    results_dir=str(tmp_path))
    runs = []
    for static in (False, True):
        rng, _ = seed_everything(1)
        runs.append(run_gnn_learning(graph, split, cfg, rng, device="cpu", static_cache=static))
    assert runs[0][1] == runs[1][1]  # the same batches give the same run, bit for bit
    assert runs[0][4] == runs[1][4]
    with pytest.raises(ValueError, match="static_cache"):
        run_gnn_learning(graph, split, cfg.replace(use_edge_weight=True), seed_everything(1)[0],
                         device="cpu", static_cache=True)


@pytest.mark.parametrize("c_in,c_out,kw,stride,length", [
    (1, 16, 97, 97, 97 * 30),  # DGCNN's first stage: one window a pooled row
    (16, 32, 5, 1, 15),  # its second stage
])
def test_conv1d_by_matmul_equals_the_convolution(c_in, c_out, kw, stride, length):
    """The matmul stages compute the Conv1d they replace, forward and
    gradients, in the length-major layout [B, L_out, C_out]."""
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(c_in, c_out, kw, stride)
    x = torch.randn(3, c_in, length, requires_grad=True)
    g = torch.randn(3, c_out, (length - kw) // stride + 1)
    want = conv(x)
    (want * g).sum().backward()
    want_grads = [t.grad.clone() for t in (x, conv.weight, conv.bias)]
    for t in (x, conv.weight, conv.bias):
        t.grad = None
    got = tgnn.conv1d_by_matmul(x, conv)
    (got * g.transpose(1, 2)).sum().backward()
    np.testing.assert_allclose(got.transpose(1, 2).detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    for t, w in zip((x, conv.weight, conv.bias), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
