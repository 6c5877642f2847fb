"""Port parity, the CN / AA / PPR link heuristics.

Scores match the JAX package's ``cn_scores``, ``aa_scores`` and
``ppr_scores`` within 1e-5 and the scipy formulas of
tests/test_models_extra.py:58-76 within 1e-4; ``run_heuristic`` returns the
raw test AUC in [0, 1], equal to the JAX package's on the same split within
1e-4, also through the runner.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.heuristics as jheur
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.heuristics as theur
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu.config import RunConfig as JRunConfig
from s3grl_tpu.data.split import EdgeSplit as JEdgeSplit
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

NAMES = ["CN", "AA", "PPR"]


def _graphs(kind):
    """A random graph with dangling (isolated) nodes, or the synthetic
    USAir-shaped one; the same graph for both packages, and 64 links."""
    rng = np.random.default_rng(5)
    if kind == "random":
        n, ei = 160, random_edges(rng, n=150, e=300)
    else:
        n, ei = 332, usair_like_edges(1)
    links = np.concatenate([ei[:, rng.choice(ei.shape[1], 32)].T,
                            rng.integers(0, n, (32, 2))]).astype(np.int32)
    return (jgraph.Graph(num_nodes=n, edge_index=ei), tgraph.Graph(num_nodes=n, edge_index=ei),
            links)


@pytest.mark.parametrize("kind", ["random", "usair_like"])
@pytest.mark.parametrize("name", NAMES)
def test_scores_match_jax(kind, name, monkeypatch):
    jg, tg, links = _graphs(kind)
    jd = jext.DeviceGraph.from_graph(jg)
    td = text.DeviceGraph.from_graph(tg, device="cpu")
    want = np.asarray(jheur.HEURISTICS[name](jd, jnp.asarray(links)))
    got = theur.HEURISTICS[name](td, torch.as_tensor(links)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Batched as heuristic_scores batches them (one short last batch).
    monkeypatch.setattr(theur, "BATCH_SIZE", 24)
    np.testing.assert_allclose(
        theur.heuristic_scores(tg, links, name, device="cpu"), want,
        rtol=1e-5, atol=1e-5,
    )


def test_cn_aa_match_the_scipy_formulas():
    """tests/test_models_extra.py:58-76 on the synthetic graph."""
    _, tg, links = _graphs("usair_like")
    A = tg.scipy_csr()
    got = theur.heuristic_scores(tg, links, "CN", device="cpu")
    exp = np.array([A[s].multiply(A[d]).sum() for s, d in links])
    np.testing.assert_allclose(got, exp, atol=1e-4)
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.log(np.asarray(A.sum(axis=0)).ravel())
    mult[~np.isfinite(mult)] = 0.0
    A_ = A.multiply(mult).tocsr()
    exp_aa = np.array([A[s].multiply(A_[d]).sum() for s, d in links])
    np.testing.assert_allclose(theur.heuristic_scores(tg, links, "AA", device="cpu"), exp_aa,
                               atol=1e-4)


@pytest.fixture(scope="module")
def split():
    rng, _ = seed_everything(1)
    return do_edge_split(tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1)), rng=rng)


@pytest.mark.parametrize("name", NAMES)
def test_run_heuristic_returns_the_raw_jax_auc(split, name, tmp_path):
    graph, sp = split
    jg = jgraph.Graph(num_nodes=graph.num_nodes, edge_index=graph.edge_index)
    _, want, _, _, _ = jheur.run_heuristic(jg, JEdgeSplit(**vars(sp)),
                                           JRunConfig(use_heuristic=name))
    out = theur.run_heuristic(graph, sp, RunConfig(use_heuristic=name), device="cpu")
    assert out[0] == 0.0 and out[2:] == ([], [], 0)
    assert 0.5 < out[1] <= 1.0
    assert out[1] == pytest.approx(want, abs=1e-4)
    # The runner routes use_heuristic there, before any model.
    cfg = RunConfig(use_heuristic=name, init_features="degree", sign_type="PoS",
                    optimize_sign=True, results_dir=str(tmp_path))
    assert run_sgrl_learning(cfg, graph, sp, device="cpu")[1] == pytest.approx(want, abs=1e-4)
