"""Port parity, SIGNNet: forward passes and optimizer steps.

The flax weights are copied into the port with ``models/convert.py``;
dropout is 0. Forward outputs, the gradients of each of two Adam steps, and
the parameters and BatchNorm running statistics after them agree to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s3grl_tpu.models.signnet import SIGNNet as JSIGNNet
from s3grl_tpu.train.loop import bce_with_logits as j_bce
from s3grl_tpu.train.loop import make_optimizer as j_make_optimizer
from s3grl_tpu_torch.models.convert import signnet_state_dict_from_flax
from s3grl_tpu_torch.models.signnet import SIGNNet
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.train.loop import bce_with_logits, make_optimizer

TOL = dict(rtol=1e-5, atol=1e-5)
POOLS = [(0, ""), (2, "mean"), (2, "sum"), (2, "concat")]


def _setup(k_heuristic, k_pool_strategy, B=12, R=5, F_in=18, hidden=16, seed=0,
           num_layers=2):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, R, F_in)).astype(np.float32)
    mask = np.ones((B, R), dtype=bool)
    mask[:, 2:] = rng.random((B, R - 2)) < 0.6
    y = rng.integers(0, 2, B).astype(np.float32)
    jm = JSIGNNet(hidden_channels=hidden, num_layers=num_layers, dropout=0.0,
                  k_heuristic=k_heuristic, k_pool_strategy=k_pool_strategy)
    v = jm.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                jnp.asarray(xs), jnp.asarray(mask), train=True)
    # Non-trivial running statistics, so eval mode tests their use.
    v = jax.tree_util.tree_map(np.asarray, v)
    for st in v["batch_stats"].values():
        st["MaskedBatchNorm_0"]["mean"] = rng.normal(size=hidden).astype(np.float32)
        st["MaskedBatchNorm_0"]["var"] = rng.uniform(0.5, 2, hidden).astype(np.float32)
    tm = SIGNNet(F_in, hidden, num_layers, dropout=0.0, k_heuristic=k_heuristic,
                 k_pool_strategy=k_pool_strategy)
    tm.load_state_dict(signnet_state_dict_from_flax(v))
    return jm, v, tm, xs, mask, y


@pytest.mark.parametrize("k_heuristic,k_pool_strategy", POOLS)
def test_signnet_forward_matches_flax(k_heuristic, k_pool_strategy):
    _forward_matches_flax(*_setup(k_heuristic, k_pool_strategy))


@pytest.mark.parametrize("sign_k", [2, 3])
def test_signnet_forward_matches_flax_at_hybrid_width(sign_k):
    """Hybrid runs num_layers = 2K - 1 over 2K operators of F' features."""
    num_layers = 2 * sign_k - 1
    ds = OperatorDataset(torch.zeros((12, 2 * sign_k, 2, 7)), torch.ones((12, 2)), None)
    assert ds.model_inputs(num_layers).shape == (12, 2, 7 * (num_layers + 1))
    _forward_matches_flax(*_setup(0, "", R=2, F_in=7 * (num_layers + 1),
                                  num_layers=num_layers))


def _forward_matches_flax(jm, v, tm, xs, mask, _):
    j_eval = jm.apply(v, jnp.asarray(xs), jnp.asarray(mask), train=False)
    j_train, _ = jm.apply(v, jnp.asarray(xs), jnp.asarray(mask), train=True,
                          mutable=["batch_stats"])
    tm.eval()
    t_eval = tm(torch.as_tensor(xs), torch.as_tensor(mask))
    tm.train()
    t_train = tm(torch.as_tensor(xs), torch.as_tensor(mask))
    np.testing.assert_allclose(np.asarray(j_eval), t_eval.detach().numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(j_train), t_train.detach().numpy(), **TOL)


@pytest.mark.parametrize("k_heuristic,k_pool_strategy", POOLS[:2])
@pytest.mark.parametrize("n_real", [12, 7])  # 7: a padded last batch
def test_one_optimizer_step_matches_flax(k_heuristic, k_pool_strategy, n_real):
    """Two Adam steps on one batch. The gradients are compared at each step,
    since Adam's first update is about lr * sign(g) and would hide a
    gradient wrong by a positive factor (a wrong loss denominator); the
    second step's moments separate the magnitudes too."""
    jm, v, tm, xs, mask, y = _setup(k_heuristic, k_pool_strategy)
    w = (np.arange(len(y)) < n_real).astype(np.float32)
    if n_real < len(y):  # padded rows repeat link 0, as the train loop does
        xs[n_real:], mask[n_real:], y[n_real:] = xs[0], mask[0], y[0]
    lr = 1e-3

    def loss_fn(p, bs):
        out, mut = jm.apply({"params": p, "batch_stats": bs},
                            jnp.asarray(xs), jnp.asarray(mask), train=True,
                            mutable=["batch_stats"])
        losses = j_bce(out, jnp.asarray(y))
        return (losses * w).sum() / jnp.maximum(w.sum(), 1.0), mut["batch_stats"]

    tx = j_make_optimizer(lr)
    params, bs = v["params"], v["batch_stats"]
    opt_state = tx.init(params)
    tm.train()
    opt = make_optimizer(tm.parameters(), lr)
    wt = torch.as_tensor(w)
    for step in range(2):
        (_, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, bs)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        out = tm(torch.as_tensor(xs), torch.as_tensor(mask))
        loss = (bce_with_logits(out, torch.as_tensor(y)) * wt).sum() / torch.clamp(wt.sum(), min=1.0)
        opt.zero_grad()
        loss.backward()
        want_grads = signnet_state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, {"params": grads, "batch_stats": bs})
        )
        got_grads = {k: p.grad for k, p in tm.named_parameters()}
        assert set(got_grads) <= set(want_grads)
        for k, g in got_grads.items():
            np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(),
                                       err_msg=f"grad {k}, step {step}", **TOL)
        opt.step()

    want = signnet_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, {"params": params, "batch_stats": bs})
    )
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
