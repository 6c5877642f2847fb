"""Port parity, node2vec pretraining and the n2v feature init.

For the same embedding and walks, the skip-gram loss and its gradient match
the JAX package's loss (n2v.py:99-114) within 1e-5. From the JAX package's
own initial embedding, walks and negatives, the port's Adam steps of an
epoch match ``node2vec_pretrain``'s output within 1e-5, which also holds
the epoch schedule (its ``rng.choice`` padding included) to the JAX one;
the schedules are compared directly too. The saturated case stays finite
(tests/test_models_extra.py:209), the feature cache never crosses devices
or packages, and an n2v-initialized PoS run learns.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.models.n2v as jn2v
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
from s3grl_tpu.data.features import n2v_cache_path as j_n2v_cache_path
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.features import init_features, n2v_cache_path
from s3grl_tpu_torch.data.graph import normalize_features
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.convert import n2v_embedding_from_jax
from s3grl_tpu_torch.models.n2v import epoch_schedule, node2vec_pretrain, skipgram_loss
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

N, DIM, WALK, CTX, WPN = 60, 8, 6, 3, 2


def _graph(seed=0):
    ei = random_edges(np.random.default_rng(seed), n=N, e=150)
    return ei, jgraph.Graph(num_nodes=N, edge_index=ei), tgraph.Graph(num_nodes=N, edge_index=ei)


def _jax_loss(e, pos_rw, neg_rw):
    """The JAX package's skip-gram loss (n2v.py:92-114)."""
    n_windows = pos_rw.shape[1] - CTX + 1

    def windows(rw):
        return jnp.stack([rw[:, j : j + CTX] for j in range(n_windows)], axis=1).reshape(-1, CTX)

    def skipgram(w):
        return (e[w[:, 0]][:, None, :] * e[w[:, 1:]]).sum(-1).reshape(-1)

    pos_loss = -jax.nn.log_sigmoid(skipgram(windows(pos_rw))).mean()
    neg_loss = -jax.nn.log_sigmoid(-skipgram(windows(neg_rw))).mean()
    return pos_loss + neg_loss


def _jax_walks(jd, starts, key):
    """The positive and negative walks of one JAX train step (n2v.py:79-90)."""
    kw, kn = jax.random.split(key)
    deg = jd.nbr_mask.sum(axis=1).astype(jnp.int32)
    pos = jn2v.random_walks(jd.nbr, deg, jnp.asarray(starts), kw, WALK)
    neg = jax.random.randint(kn, (len(starts), WALK + 1), 0, N)
    return np.array(pos), np.array(neg.at[:, 0].set(jnp.asarray(starts)))


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_skipgram_loss_and_gradient_match_jax(scale):
    """scale 30 saturates the sigmoids: both stay finite and agree."""
    _, jg, _ = _graph()
    jd = jext.DeviceGraph.from_graph(jg)
    rng = np.random.default_rng(1)
    emb = (scale * rng.normal(size=(N, DIM))).astype(np.float32)
    starts = rng.integers(0, N, 40).astype(np.int32)
    pos, neg = _jax_walks(jd, starts, jax.random.PRNGKey(3))
    want, want_g = jax.value_and_grad(_jax_loss)(jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(neg))
    e = n2v_embedding_from_jax(emb)
    loss = skipgram_loss(e, torch.as_tensor(pos).long(), torch.as_tensor(neg).long(), CTX)
    loss.backward()
    assert np.isfinite(loss.item()) and torch.isfinite(e.grad).all()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)


def test_epoch_schedule_is_the_jax_one():
    all_starts = np.repeat(np.arange(N), WPN)
    steps = [epoch_schedule(np.random.default_rng(4), all_starts, bs) for bs in (64, 512)]
    for bs, got in zip((64, 512), steps):
        rng = np.random.default_rng(4)  # n2v.py:127-136
        n_steps = -(-len(all_starts) // bs)
        perm = rng.permutation(len(all_starts))
        perm = np.concatenate([perm, rng.choice(len(all_starts), n_steps * bs - len(all_starts))])
        np.testing.assert_array_equal(got, all_starts[perm].reshape(n_steps, bs))


def test_adam_steps_of_an_epoch_match_node2vec_pretrain():
    """One epoch of two padded batches: the JAX package's output against the
    port's two steps from its initial embedding, walks and negatives."""
    _, jg, _ = _graph(2)
    jd = jext.DeviceGraph.from_graph(jg)
    seed, bs = 5, 64
    want = jn2v.node2vec_pretrain(jg, DIM, walk_length=WALK, context_size=CTX,
                                  walks_per_node=WPN, epochs=1, batch_size=bs, seed=seed)
    # n2v.py:69-71 and :152-156: the keys of the initial embedding and the epoch.
    key, ik = jax.random.split(jax.random.PRNGKey(seed))
    emb0 = np.asarray(jax.random.normal(ik, (N, DIM)))
    _, ek = jax.random.split(key)
    sched = epoch_schedule(np.random.default_rng(seed), np.repeat(np.arange(N), WPN), bs)
    assert sched.shape == (2, bs)
    e = n2v_embedding_from_jax(emb0)
    opt = torch.optim.Adam([e], lr=0.01)
    for starts, k in zip(sched, jax.random.split(ek, len(sched))):
        pos, neg = _jax_walks(jd, starts.astype(np.int32), k)
        opt.zero_grad()
        skipgram_loss(e, torch.as_tensor(pos).long(), torch.as_tensor(neg).long(), CTX).backward()
        opt.step()
    np.testing.assert_allclose(e.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    # One optax step on the same gradient agrees too.
    pos, neg = _jax_walks(jd, sched[0].astype(np.int32), jax.random.split(ek, 2)[0])
    g = jax.grad(_jax_loss)(jnp.asarray(emb0), jnp.asarray(pos), jnp.asarray(neg))
    tx = optax.adam(0.01)
    upd, _ = tx.update(g, tx.init(jnp.asarray(emb0)))
    e1 = n2v_embedding_from_jax(emb0)
    opt = torch.optim.Adam([e1], lr=0.01)
    skipgram_loss(e1, torch.as_tensor(pos).long(), torch.as_tensor(neg).long(), CTX).backward()
    opt.step()
    np.testing.assert_allclose(e1.detach().numpy(), np.asarray(emb0 + upd), rtol=1e-5, atol=1e-5)


def test_node2vec_pretrain_finite_when_saturated():
    """tests/test_models_extra.py:209 on the synthetic USAir-shaped graph:
    two epochs at the default widths stay finite and move off the init."""
    g = tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1))
    emb = node2vec_pretrain(g, 16, epochs=2, seed=1, device="cpu")
    assert emb.shape == (332, 16) and emb.dtype == np.float32
    assert np.isfinite(emb).all() and emb.std() > 0
    again = node2vec_pretrain(g, 16, epochs=2, seed=1, device="cpu")
    np.testing.assert_array_equal(emb, again)


def test_n2v_features_cache_on_their_own_root(tmp_path):
    _, _, tg = _graph(3)
    kw = dict(n2v_dim=4, seed=2, epochs=1, device="cpu")
    got = init_features(tg, "n2v", cache_key="G", cache_root=str(tmp_path), **kw)
    path = n2v_cache_path(str(tmp_path), "G", tg, 4, 2, 1, "cpu")
    assert os.path.exists(path) and path.endswith("_cpu.npz")
    assert os.path.basename(path) != os.path.basename(
        j_n2v_cache_path("G", jgraph.Graph(num_nodes=N, edge_index=tg.edge_index), 4, 2, 1))
    again = init_features(tg, "n2v", cache_key="G", cache_root=str(tmp_path), **kw)
    np.testing.assert_array_equal(got.x, again.x)
    assert got.x.shape == (N, 4)
    np.testing.assert_array_equal(got.x, normalize_features(np.load(path)["emb"]))


def test_n2v_pos_learns(tmp_path):
    """configs/paper/auc_s3grl.json's USAir_PoS (n2v features of dimension
    16) at test size, with tests/test_models_extra.py's bar: best test AUC
    > 55."""
    cfg = RunConfig(
        dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
        init_features="n2v", n2v_dim=16, use_feature=True, sign_k=2, node_label="zo",
        pool_operatorwise=True, hidden_channels=32, batch_size=32, lr=1e-3, epochs=2,
        num_hops=1, seed=1, extract_batch_size=64, max_subgraph_nodes=256,
        subgraph_buckets=(64, 256), train_percent=50.0, val_percent=50.0, test_percent=50.0,
        results_dir=str(tmp_path),
    )
    rng, _ = seed_everything(cfg.seed)
    graph, split = do_edge_split(
        tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng
    )
    _, best, _, _, _ = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert best > 55.0
    # The runner cached the embedding under its own results directory.
    assert os.listdir(os.path.join(tmp_path, "emb_cache"))
