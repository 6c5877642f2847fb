"""Port parity, WalkPool (``models/walkpool.py``, ``train/walkpool_loop.py``).

Flax weights are carried into the port with
``convert.walkpool_state_dict_from_flax``. In eval mode the forward pass and
the BCE gradients agree within 1e-4; in one train-mode step (dropout taken
out of both packages) the gradients and running statistics within 1e-5,
and Adam on those gradients within 1e-6; the 72 walk-profile features alone
within 1e-5, also for a valid node with no edges and for a graph whose only
edge is the candidate. `walkpool_batch` injects the candidate link before
the labels, and both WalkPool settings of tests/test_models_extra.py learn
on the synthetic USAir-shaped graph.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import s3grl_tpu.models.walkpool as jwp
import s3grl_tpu_torch.models.walkpool as twp
from s3grl_tpu.train.loop import bce_with_logits as j_bce
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.convert import walkpool_state_dict_from_flax
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.sampling.extraction import DeviceGraph, dense_adjacency, extract_subgraphs
from s3grl_tpu_torch.sampling.labeling import label_nodes
from s3grl_tpu_torch.train.loop import bce_with_logits
from s3grl_tpu_torch.train.walkpool_loop import walkpool_batch
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

H, HEADS, TAU, B, S = 8, 2, 7, 6, 32
WIDTH = HEADS * (5 * TAU + 1)  # 72 walk-profile features


def _batch(seed=0, isolated=False, candidate_only=False):
    """(adj, z, mask, x, y) numpy: random symmetric subgraphs with the
    candidate link at slots (0, 1), DRNL-like labels, a ones column."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(S // 2, S + 1, B)
    sizes[0] = S
    mask = np.arange(S)[None, :] < sizes[:, None]
    a = (rng.random((B, S, S)) < 0.15).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.transpose(0, 2, 1)
    a *= mask[:, :, None] * mask[:, None, :]
    if isolated:  # slot 5 of every graph is valid and has no edge
        a[:, 5, :] = 0.0
        a[:, :, 5] = 0.0
    if candidate_only:
        a[:] = 0.0
    a[:, 0, 1] = a[:, 1, 0] = 1.0
    z = (rng.integers(0, 12, (B, S)) * mask).astype(np.int32)
    x = np.ones((B, S, 1), np.float32) * mask[:, :, None]
    y = (np.arange(B) % 2).astype(np.float32)
    return a, z, mask, x, y


def _models(drnl=True, batch=None, stats_seed=7):
    """(flax model, variables with random running stats, torch model)."""
    adj, z, mask, x, _ = batch if batch is not None else _batch()
    jm = jwp.WalkPoolLinkPred(hidden_channels=H, heads=HEADS, walk_len=TAU, drnl=drnl)
    v = jm.init({"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
                jnp.asarray(adj), jnp.asarray(z), jnp.asarray(mask), x=jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda t: np.array(t), v)
    rng = np.random.default_rng(stats_seed)
    bs = v["batch_stats"]["WalkPoolClassifier_0"]["MaskedBatchNorm_0"]
    bs["mean"][...] = rng.normal(size=WIDTH) * 0.1
    bs["var"][...] = rng.uniform(0.5, 2.0, WIDTH)
    tm = twp.WalkPoolLinkPred(1, H, heads=HEADS, walk_len=TAU, drnl=drnl)
    tm.load_state_dict(walkpool_state_dict_from_flax(v), strict=True)
    return jm, v, tm


def _j(batch):
    adj, z, mask, x, _ = batch
    return jnp.asarray(adj), jnp.asarray(z), jnp.asarray(mask), jnp.asarray(x)


def _t(batch):
    adj, z, mask, x, _ = batch
    return torch.as_tensor(adj), torch.as_tensor(z), torch.as_tensor(mask), torch.as_tensor(x)


def test_parameter_names_and_count():
    jm, v, tm = _models()
    n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert tm.classifier.lins[0].in_features == WIDTH


@pytest.mark.parametrize("drnl", [True, False])
def test_forward_eval_matches_flax(drnl):
    batch = _batch(1)
    jm, v, tm = _models(drnl, batch)
    adj, z, m, x = _j(batch)
    want = np.asarray(jm.apply(v, adj, z, m, x=x, train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(*_t(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_eval_bce_gradients_match_flax():
    batch = _batch(2)
    jm, v, tm = _models(True, batch)
    adj, z, m, x = _j(batch)
    y = batch[4]

    def loss(p):
        out = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, adj, z, m, x=x,
                       train=False)
        return j_bce(out, jnp.asarray(y)).mean()

    g = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, v["params"]))
    want = walkpool_state_dict_from_flax({"params": jax.tree_util.tree_map(np.asarray, g),
                                          "batch_stats": v["batch_stats"]})
    tm.eval()
    bce_with_logits(tm(*_t(batch)), torch.as_tensor(y)).mean().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


class _NoDropout(fnn.Module):
    """flax's Dropout with its mask taken out (rate and flag unread)."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


def test_train_adam_step_matches_flax(monkeypatch):
    """One train-mode step, dropout taken out of both packages: the
    gradients and the updated running statistics within 1e-5, and Adam at
    lr 1e-3 (optax.adam's defaults, no decay) on those gradients within
    1e-6. Adam's first step is lr * g / (|g| + eps), which turns a 1e-9
    difference of a gradient near eps into one of 1e-5 in the weight, so
    the step is held on the same gradients."""
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(twp, "_dropout", lambda x, p, training, generator: x)
    batch = _batch(3)
    jm, v, tm = _models(True, batch)
    adj, z, m, x = _j(batch)
    y = jnp.asarray(batch[4])

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, adj, z, m, x=x,
                            train=True, mutable=["batch_stats"])
        return j_bce(out, y).mean(), mut["batch_stats"]

    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    (_, new_bs), g = jax.value_and_grad(loss, has_aux=True)(params)
    tx = optax.adam(1e-3)
    upd, _ = tx.update(g, tx.init(params), params)
    as_torch = lambda tree, stats: walkpool_state_dict_from_flax(  # noqa: E731
        {"params": jax.tree_util.tree_map(np.asarray, tree),
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)})
    want_grad = as_torch(g, new_bs)
    want_step = as_torch(optax.apply_updates(params, upd), new_bs)

    tm.train()
    bce_with_logits(tm(*_t(batch)), torch.as_tensor(batch[4])).mean().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grad[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    for name, t in tm.named_buffers():
        np.testing.assert_allclose(t.numpy(), want_grad[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            p.grad.copy_(want_grad[name])
    torch.optim.Adam(tm.parameters(), lr=1e-3).step()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_step[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


class _Features(fnn.Module):
    """Stand-in for the flax classifier: returns its input."""

    input_size: int
    mse: bool = False

    def __call__(self, x, train=True):
        return x


@pytest.mark.parametrize("case", ["random", "isolated_node", "candidate_only"])
def test_walk_profile_features_match_flax(monkeypatch, case):
    """The 72 classifier inputs, heads-major: a valid node with no edges
    softmaxes over -1e30 and is zeroed; a graph whose only edge is the
    candidate has an all-zero minus matrix."""
    batch = _batch(4, isolated=case == "isolated_node", candidate_only=case == "candidate_only")
    jm, v, tm = _models(True, batch)
    monkeypatch.setattr(jwp, "WalkPoolClassifier", _Features)
    adj, z, m, x = _j(batch)
    params = {k: p for k, p in v["params"].items() if k != "WalkPoolClassifier_0"}
    want = np.asarray(jm.apply({"params": params}, adj, z, m, x=x, train=False))
    got = {}
    tm.classifier.register_forward_pre_hook(lambda mod, args: got.setdefault("f", args[0]))
    tm.eval()
    with torch.no_grad():
        tm(*_t(batch))
    feats = got["f"].numpy()
    assert feats.shape == want.shape == (B, WIDTH)
    assert np.isfinite(feats).all()
    np.testing.assert_allclose(feats, want, rtol=1e-5, atol=1e-5)
    if case == "candidate_only":
        # No edge but the candidate: the node and link minus profiles are 0.
        start = 2 * HEADS * TAU + HEADS  # after graph, omega, node plus
        np.testing.assert_array_equal(feats[:, start : start + HEADS * TAU], 0.0)
        np.testing.assert_array_equal(feats[:, -HEADS * TAU:], 0.0)


def test_edge_weights_column_without_edges():
    """plus/minus edge weights of a column with no incoming edge are 0, and
    each column with edges sums to 1."""
    adj, z, mask, x, _ = _batch(5, isolated=True)
    w = torch.randn((B, S, S, HEADS), generator=torch.Generator().manual_seed(0))
    wp, wm, omega = twp.edge_weights(w, torch.as_tensor(adj), torch.as_tensor(mask))
    assert torch.all(wp[:, :, 5] == 0) and torch.all(wm[:, :, 5] == 0)
    col = wp.sum(dim=1)  # [B, S, heads]
    has = torch.as_tensor((adj > 0).any(axis=1) & mask)[..., None].expand_as(col)
    torch.testing.assert_close(col[has], torch.ones_like(col[has]), rtol=1e-5, atol=1e-5)
    assert omega.shape == (B, HEADS)


def test_walkpool_batch_injects_candidate_before_labels():
    """Positive links lose their edge in extraction and get it back at
    (0, 1) before DRNL: the labels are those of the adjacency with the
    candidate link present."""
    n, ei = 120, usair_like_edges(2, n=120)
    dg = DeviceGraph.from_graph(Graph(num_nodes=n, edge_index=ei), device="cpu")
    links = torch.as_tensor(ei[:, :8].T.astype(np.int64))
    cfg = RunConfig(model="WalkPool", node_label="drnl", num_hops=1)
    adj, z, mask, x = walkpool_batch(dg, links, cfg, 64)
    sub = extract_subgraphs(dg, links, num_hops=1, max_nodes=64, remove_target_link=True)
    raw = dense_adjacency(sub)
    assert torch.all(raw[:, 0, 1] == 0)  # the target link was removed
    assert torch.all(adj[:, 0, 1] == 1) and torch.all(adj[:, 1, 0] == 1)
    want = raw.clone()
    want[:, 0, 1] = want[:, 1, 0] = 1.0
    torch.testing.assert_close(adj, want)
    torch.testing.assert_close(z, label_nodes(want, sub.dist, sub.node_mask,
                                              node_label="drnl", max_iters=32))
    assert x.shape == (8, 64, 1) and torch.all(x == 1)


def _walkpool_run(results_dir, **fields):
    g = Graph(num_nodes=332, edge_index=usair_like_edges(1))
    cfg = RunConfig(dataset="USAir", model="WalkPool", num_hops=1, hidden_channels=8,
                    batch_size=32, lr=1e-3, seed=1, max_subgraph_nodes=128,
                    delete_dataset=True, results_dir=str(results_dir), **fields)
    rng, _ = seed_everything(cfg.seed)
    graph, split = do_edge_split(g, val_ratio=cfg.split_val_ratio,
                                 test_ratio=cfg.split_test_ratio, rng=rng)
    return run_sgrl_learning(cfg, graph, split, device="cpu")


@pytest.mark.parametrize("fields,bar", [
    (dict(epochs=2, train_percent=15.0, val_percent=40.0, test_percent=40.0,
          node_label=""), 60.0),
    (dict(epochs=1, train_percent=10.0, val_percent=30.0, test_percent=30.0,
          node_label="drnl"), 50.0),
], ids=["ones", "drnl"])
def test_walkpool_learns(tmp_path, fields, bar):
    """tests/test_models_extra.py:21-45's settings and bars."""
    _, best, train_times, _, n_params = _walkpool_run(tmp_path, **fields)
    assert n_params > 0 and len(train_times) == fields["epochs"]
    assert best > bar
