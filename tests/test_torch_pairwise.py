"""Port parity: pairwise training (reference ``train_pairwise``,
sgrl_link_pred.py:475-526, with the PLNLP losses of custom_losses.py:5-21)
and ``use_valedges_as_input`` (sgrl_link_pred.py:1018-1028).

An epoch of pairwise training in both packages' ``fit_signnet`` from the
same flax weights (``models/convert.py``), dropout 0: both loops draw
their permutations from ``np.random.default_rng(seed)``, and the epoch's
loss, the parameters and the BatchNorm running statistics after it agree
within 1e-5. Then the falling loss of ``tests/test_pairwise.py:43-75`` on
the synthetic USAir-shaped graph, and the runner's observed graph and
datasets with the validation edges against the JAX runner's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.config as jconfig
import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.operators.common as jcommon
import s3grl_tpu.runner as jrunner
import s3grl_tpu.train.loop as jloop
import s3grl_tpu_torch.runner as trunner
import s3grl_tpu_torch.train.loop as tloop
from s3grl_tpu.models.signnet import SIGNNet as JSIGNNet
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.features import init_features
from s3grl_tpu_torch.data.graph import Graph, to_undirected
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models.convert import signnet_state_dict_from_flax
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=1e-5, atol=1e-5)
OP_TOL = dict(rtol=2e-3, atol=2e-4)
LOSSES = ["auc_loss", "weighted_auc_loss", "hinge_auc_loss"]
FIT = dict(sign_k=2, hidden_channels=16, batch_size=16, lr=1e-3, epochs=1, dropout=0.0,
           pairwise=True)


def _arrays(rng, n_pos, n_neg, O=3, R=4, F=5):
    xs = rng.normal(size=(n_pos + n_neg, O, R, F)).astype(np.float32)
    mask = np.ones((n_pos + n_neg, R), dtype=bool)
    mask[:, 2:] = rng.random((n_pos + n_neg, R - 2)) < 0.6
    y = np.concatenate([np.ones(n_pos), np.zeros(n_neg)]).astype(np.float32)
    perm = rng.permutation(len(y))  # labels interleaved, as a split's are
    return xs[perm], mask[perm], y[perm]


def _jax_init(seed, xs, mask):
    """The variables the JAX ``fit_signnet`` starts from (loop.py:127-142)."""
    model = JSIGNNet(hidden_channels=FIT["hidden_channels"], num_layers=FIT["sign_k"],
                     dropout=0.0)
    _, init_key, drop_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    B, O, R, F = xs[:2].shape
    flat = jnp.asarray(xs[:2]).transpose(0, 2, 1, 3).reshape(B, R, O * F)
    v = model.init({"params": init_key, "dropout": drop_key}, flat, jnp.asarray(mask[:2]),
                   train=True)
    return jax.tree_util.tree_map(np.asarray, v)


@pytest.mark.parametrize("loss_fn", LOSSES)
def test_pairwise_epoch_matches_jax(loss_fn, monkeypatch):
    """One negative a positive, as the runner's pairwise route draws them.
    (With more, the positive and negative passes differ in size: the last
    layer's bias and the norm before it, whose gradients are zero by the
    losses' symmetry, get rounding noise of either sign, and Adam turns its
    sign into a step of ``lr``; the two packages then part by ~lr there.)"""
    seed, neg_ratio = 3, 1
    rng = np.random.default_rng(11)
    n_pos = 40
    tr = _arrays(rng, n_pos, neg_ratio * n_pos + 7)
    va, te = _arrays(rng, 12, 12), _arrays(rng, 12, 12)
    kw = dict(FIT, loss_fn=loss_fn, neg_ratio=neg_ratio, seed=seed)

    j_losses, t_losses = [], []
    j_ds = [jcommon.OperatorDataset(xs=x, row_mask=m, y=y) for x, m, y in (tr, va, te)]
    want = jloop.fit_signnet(*j_ds, logger_hook=lambda e, l, r: j_losses.append(l), **kw)

    state = signnet_state_dict_from_flax(_jax_init(seed, tr[0], tr[1]))
    real = tloop.SIGNNet

    def from_jax_weights(*a, **k):
        model = real(*a, **k)
        model.load_state_dict(state)
        return model

    monkeypatch.setattr(tloop, "SIGNNet", from_jax_weights)
    t_ds = [OperatorDataset(xs=torch.as_tensor(x), row_mask=torch.as_tensor(m), y=y)
            for x, m, y in (tr, va, te)]
    got = tloop.fit_signnet(*t_ds, logger_hook=lambda e, l, r: t_losses.append(l),
                            device="cpu", **kw)

    assert len(t_losses) == len(j_losses) == 1
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    want_state = signnet_state_dict_from_flax(want.final_variables)
    got_state = got.model.state_dict()
    assert set(got_state) == set(want_state)
    for k, v in want_state.items():
        np.testing.assert_allclose(got_state[k].numpy(), v.numpy(), err_msg=k, **TOL)
    # The step moved the weights: the comparison is not of two starting points.
    assert any(not torch.equal(state[k], v) for k, v in got_state.items())


def _cfg(cls, loss_fn="", epochs=12, **extra):
    """tests/test_pairwise.py:13-23's config, as the given package's
    RunConfig."""
    return cls(
        dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
        init_features="degree", use_feature=True, node_label="zo",
        sign_k=2, num_hops=1, epochs=epochs, hidden_channels=32,
        batch_size=32, lr=1e-3, pairwise=bool(loss_fn), loss_fn=loss_fn, neg_ratio=1,
        train_percent=20.0, val_percent=50.0, test_percent=50.0,
        max_subgraph_nodes=128, subgraph_buckets=(32, 64, 128),
        delete_dataset=True, seed=1, **extra,
    )


@pytest.fixture(scope="module")
def synthetic_datasets():
    """The port's train/valid/test PoS datasets of ``_cfg`` on the
    synthetic USAir-shaped graph, built as the runner builds them."""
    cfg = _cfg(RunConfig, "auc_loss")
    rng, _ = seed_everything(1)
    graph, split = do_edge_split(Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)
    dg = DeviceGraph.from_graph(init_features(graph, "degree", seed=1), device="cpu")
    ds = {}
    for name, pct in (("train", 20.0), ("valid", 50.0), ("test", 50.0)):
        links, y = trunner.build_split_links(name, split, pct, rng)
        ds[name] = trunner.precompute_split(dg, links, y, cfg, device="cpu")
    return ds


@pytest.mark.parametrize("loss_fn", LOSSES)
def test_pairwise_loss_falls_on_the_synthetic_graph(loss_fn, synthetic_datasets):
    """tests/test_pairwise.py:43-75's check on the synthetic graph, for each
    loss: 12 epochs, and the mean loss of the last three below the first
    three's. (An AUC bar cannot hold this route: the reference's two
    forward passes a step, each with its own BatchNorm batch, leave both
    packages near chance on this graph.)"""
    losses = []
    ds = synthetic_datasets
    fit = tloop.fit_signnet(
        ds["train"], ds["valid"], ds["test"], sign_k=2, hidden_channels=32, batch_size=32,
        lr=1e-3, epochs=12, pairwise=True, loss_fn=loss_fn, neg_ratio=1, seed=1,
        logger_hook=lambda e, l, r: losses.append(l), device="cpu",
    )
    assert len(fit.train_times) == 12
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


class _Stop(Exception):
    pass


def _observed_and_datasets(runner, cfg, graph, split, monkeypatch, **kw):
    """The runner's observed graph (the one ``DeviceGraph.from_graph``
    takes) and each split's (links, dataset), stopping before training."""
    seen, built = [], []
    real_dg, real_pre = runner.DeviceGraph, runner.precompute_split

    class Recorder:
        @staticmethod
        def from_graph(g, **k):
            seen.append(g)
            return real_dg.from_graph(g, **k)

    def precompute(dg, links, y, cfg, **k):
        built.append((np.asarray(links), real_pre(dg, links, y, cfg, **k)))
        return built[-1][1]

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(runner, "DeviceGraph", Recorder)
    monkeypatch.setattr(runner, "precompute_split", precompute)
    monkeypatch.setattr(runner, "fit_signnet", stop)
    with pytest.raises(_Stop):
        runner.run_sgrl_learning(cfg, graph, split, **kw)
    assert len(seen) == 1 and len(built) == 3
    return seen[0], built


def test_use_valedges_as_input_matches_the_jax_runner(monkeypatch, tmp_path):
    """The observed graph gains the validation positives, both ways, after
    the feature init; the runner's datasets on it equal the JAX runner's
    (links bit for bit, operators within the kernel's bar)."""
    rng, _ = seed_everything(1)
    ei = usair_like_edges(2)
    graph, split = do_edge_split(Graph(num_nodes=332, edge_index=ei), rng=rng)
    j_graph = jgraph.Graph(num_nodes=332, edge_index=graph.edge_index)
    extra = dict(use_valedges_as_input=True, results_dir=str(tmp_path))
    t_obs, t_built = _observed_and_datasets(
        trunner, _cfg(RunConfig, epochs=1, **extra), graph, split, monkeypatch, device="cpu")
    j_obs, j_built = _observed_and_datasets(
        jrunner, _cfg(jconfig.RunConfig, epochs=1, **extra), j_graph, split, monkeypatch)

    want = np.concatenate([graph.edge_index, to_undirected(split.valid_pos.T.astype(np.int32))],
                          axis=1)
    np.testing.assert_array_equal(t_obs.edge_index, want)
    np.testing.assert_array_equal(np.asarray(j_obs.edge_index), want)
    np.testing.assert_array_equal(t_obs.x, np.asarray(j_obs.x))
    for (t_links, t_ds), (j_links, j_ds) in zip(t_built, j_built):
        np.testing.assert_array_equal(t_links, j_links)
        np.testing.assert_array_equal(t_ds.row_mask.numpy(), np.asarray(j_ds.row_mask))
        np.testing.assert_allclose(t_ds.xs.numpy(), np.asarray(j_ds.xs), **OP_TOL)

    # Without the flag the same run sees the graph as split.
    t_plain, _ = _observed_and_datasets(
        trunner, _cfg(RunConfig, epochs=1, results_dir=str(tmp_path)),
        graph, split, monkeypatch, device="cpu")
    np.testing.assert_array_equal(t_plain.edge_index, graph.edge_index)
