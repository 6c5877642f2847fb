"""Port parity, the non-subgraph baselines (``models/baselines.py``).

MF and the GCN/SAGE/GIN link predictors are held to the JAX package's
``train_mf`` / ``train_gnn`` by one full-batch step: the JAX package's
initial weights (a run at lr 0) are carried in with ``convert.py``, the
negatives are the JAX run's own (drawn again from its key sequence),
dropout is 0, and the weights after one Adam step agree within 1e-5. Then
MF and GCN learn on the synthetic USAir-shaped graph past
tests/test_models_extra.py's bars (> 50, > 60), and SAGE and GIN come
within the JAX package's spread of its mean over seeds 1-3. The torch logistic regression reaches sklearn's
optimum (objective within 1e-6 relative; sklearn imports here, in the test
only) and predicts sklearn's default fit's classes on at least 99 % of the
links.
"""
import jax
import numpy as np
import pytest
import torch

from s3grl_tpu.data.graph import Graph as JGraph
from s3grl_tpu.models import baselines as jbase
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.models import baselines as tbase
from s3grl_tpu_torch.models.convert import (
    gnn_baseline_state_dict_from_jax,
    mf_state_dict_from_jax,
)
from s3grl_tpu_torch.models.n2v import node2vec_pretrain
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

H = 16


@pytest.fixture(scope="module")
def graphs():
    """(torch-port graph and split, JAX graph) of the synthetic graph."""
    g = Graph(num_nodes=332, edge_index=usair_like_edges(1))
    rng, _ = seed_everything(1)
    graph, split = do_edge_split(g, rng=rng)
    jg = JGraph(num_nodes=graph.num_nodes, edge_index=graph.edge_index)
    return graph, split, jg


def _jax_negatives(seed: int, n_init_keys: int, E: int, N: int) -> np.ndarray:
    """The negatives of the JAX run's first epoch: ``key, sk = split(key)``
    after the init keys, then ``k1, k2 = split(sk)``, ``randint(k2)``."""
    key = jax.random.PRNGKey(seed)
    jax.random.split(key, n_init_keys)  # the init keys; key itself is kept
    key, sk = jax.random.split(key)
    _, k2 = jax.random.split(sk)
    return np.asarray(jax.random.randint(k2, (E, 2), 0, N))


def _np_params(params) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def test_mf_step_matches_jax(graphs):
    graph, split, jg = graphs
    kw = dict(hidden_channels=H, num_layers=3, dropout=0.0, epochs=1, seed=1)
    _, j0 = jbase.train_mf(jg, split, lr=0.0, **kw)
    _, j1 = jbase.train_mf(jg, split, lr=0.01, **kw)
    pos = np.asarray(split.train_pos, np.int64)
    neg = _jax_negatives(1, 3 + 2, len(pos), graph.num_nodes)

    model = tbase.MFModel(graph.num_nodes, H, 3, dropout=0.0)
    model.load_state_dict(mf_state_dict_from_jax(_np_params(j0["params"])))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    tbase.mf_loss(model, torch.as_tensor(pos), torch.as_tensor(neg.astype(np.int64))).backward()
    opt.step()
    want = mf_state_dict_from_jax(_np_params(j1["params"]))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("layer", ["GCN", "SAGE", "GIN"])
def test_gnn_step_matches_jax(graphs, layer):
    graph, split, jg = graphs
    kw = dict(layer=layer, hidden_channels=H, dropout=0.0, epochs=1, seed=1)
    _, j0 = jbase.train_gnn(jg, split, lr=0.0, **kw)
    _, j1 = jbase.train_gnn(jg, split, lr=0.01, **kw)
    pos = np.asarray(split.train_pos, np.int64)
    neg = _jax_negatives(1, 32, len(pos), graph.num_nodes)

    inputs = tbase.gnn_graph_inputs(graph, torch.device("cpu"))
    model = tbase.GNNEncoder(layer, graph.num_nodes, H, dropout=0.0)
    model.load_state_dict(gnn_baseline_state_dict_from_jax(_np_params(j0["params"])))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    tbase.gnn_loss(model(*inputs), torch.as_tensor(pos),
                   torch.as_tensor(neg.astype(np.int64))).backward()
    opt.step()
    want = gnn_baseline_state_dict_from_jax(_np_params(j1["params"]))
    assert set(want) == set(model.state_dict())
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_mf_learns(graphs):
    """tests/test_models_extra.py:79-86's settings and bar."""
    graph, split, _ = graphs
    best, out = tbase.train_mf(graph, split, hidden_channels=32, epochs=10, lr=0.01, seed=1,
                               device="cpu")
    assert isinstance(out["model"], tbase.MFModel)
    assert best > 50.0


def test_gcn_learns(graphs):
    """tests/test_models_extra.py:89-96's settings and bar."""
    graph, split, _ = graphs
    best, _ = tbase.train_gnn(graph, split, layer="GCN", hidden_channels=32, epochs=15,
                              lr=0.01, seed=1, device="cpu")
    assert best > 60.0


# The JAX package's best test AUC over seeds 1-3 at the same settings, from
#   JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed S --baseline gnn-SAGE|gnn-GIN
JAX_GNN_AUC = {"SAGE": (66.10460887390069, 59.920080356363, 58.8391999301249),
               "GIN": (67.99356388723578, 67.37269630535417, 64.76984889510001)}


@pytest.mark.parametrize("layer", ["SAGE", "GIN"])
def test_sage_and_gin_learn_as_jax(layer):
    """The reference has no bar for SAGE and GIN: the port's mean best test
    AUC over seeds 1-3 (each seed's own synthetic graph and split, as the
    JAX script makes them) is at most max(3, the JAX spread) below the JAX
    package's mean. The two draw from different generators, so single seeds
    differ by their spread."""
    aucs = []
    for seed in (1, 2, 3):
        g = Graph(num_nodes=332, edge_index=usair_like_edges(seed))
        rng, _ = seed_everything(seed)
        graph, split = do_edge_split(g, rng=rng)
        aucs.append(tbase.train_gnn(graph, split, layer=layer, hidden_channels=32, epochs=15,
                                    lr=0.01, seed=seed, device="cpu")[0])
    ref = JAX_GNN_AUC[layer]
    assert np.mean(aucs) >= np.mean(ref) - max(3.0, max(ref) - min(ref)), aucs


@pytest.fixture(scope="module")
def lr_problem(graphs):
    """Hadamard features of the train links from a short node2vec run, and
    their labels (run_n2v's logistic-regression problem)."""
    graph, split, _ = graphs
    emb = node2vec_pretrain(graph, 16, epochs=2, seed=1, device="cpu")
    sd = split.as_dict()
    e = np.concatenate([sd["train"]["edge"], sd["train"]["edge_neg"]])
    y = np.concatenate([np.ones(len(sd["train"]["edge"])), np.zeros(len(sd["train"]["edge_neg"]))])
    return (emb[e[:, 0]] * emb[e[:, 1]]).astype(np.float64), y


def test_logistic_regression_reaches_sklearn_optimum(lr_problem):
    from sklearn.linear_model import LogisticRegression

    x, y = lr_problem
    w, b = tbase.fit_logistic_regression(torch.as_tensor(x), torch.as_tensor(y))
    tight = LogisticRegression(tol=1e-12, max_iter=100_000).fit(x, y)

    def objective(w_, b_):
        return float(tbase.logistic_objective(torch.as_tensor(x), torch.as_tensor(y),
                                              torch.as_tensor(w_), torch.as_tensor(b_)))

    ours = objective(w, b)
    best = objective(tight.coef_[0], tight.intercept_[0])
    assert abs(ours - best) <= 1e-6 * best
    # The same objective: an unpenalized intercept, C = 1.
    np.testing.assert_allclose(w.numpy(), tight.coef_[0], atol=1e-4)
    np.testing.assert_allclose(float(b), tight.intercept_[0], atol=1e-4)


def test_logistic_regression_predicts_sklearn_classes(lr_problem):
    from sklearn.linear_model import LogisticRegression

    x, y = lr_problem
    w, b = tbase.fit_logistic_regression(torch.as_tensor(x), torch.as_tensor(y))
    ours = ((torch.as_tensor(x) @ w + b) > 0).numpy().astype(float)
    theirs = LogisticRegression().fit(x, y).predict(x)
    assert (ours == theirs).mean() >= 0.99


def test_run_n2v_scores_hard_classes(graphs, monkeypatch):
    """run_n2v trains node2vec, fits the regression and scores valid and
    test by 0/1 predictions."""
    graph, split, _ = graphs
    seen = []
    real = tbase.evaluate_auc

    def spy(vp, vy, tp, ty):
        seen.append((vp, tp))
        return real(vp, vy, tp, ty)

    monkeypatch.setattr(tbase, "evaluate_auc", spy)
    best = tbase.run_n2v(graph, split, hidden_channels=16, epochs=2, seed=1, device="cpu")
    assert np.isfinite(best) and 0.0 <= best <= 100.0
    (vp, tp), = seen
    assert set(np.unique(np.concatenate([vp, tp]))) <= {0.0, 1.0}
