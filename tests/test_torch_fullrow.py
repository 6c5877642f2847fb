"""Port parity, the full-row (optimize_sign=False) SIGN flows.

The PoS flow (five labels) and the SoP flow (six labels) against the JAX
package at rtol 2e-3, atol 2e-4; with ``zo`` the full-row target rows equal
the port's own optimized PoS dataset (the check of tests/test_fullrow.py);
a full-row DRNL run learns end to end on the CPU.
"""
import numpy as np
import pytest

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.operators.fullrow as jfull
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.fullrow as tfull
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.split import do_edge_split
from s3grl_tpu_torch.operators.pos import precompute_pos
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOL = dict(rtol=2e-3, atol=2e-4)
POS_KW = dict(num_hops=2, sign_k=2, buckets=(16, 32, 64), batch_size=4, max_subgraph_nodes=64)


@pytest.fixture(scope="module")
def graphs():
    """A random graph with 6 normal features, in both packages, and links."""
    n = 60
    ei = random_edges(np.random.default_rng(31), n=n, e=200)
    x = np.random.default_rng(32).normal(size=(n, 6)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei, x=x), device="cpu")
    rng = np.random.default_rng(33)
    links = rng.integers(0, n, (11, 2)).astype(np.int32)
    links = links[links[:, 0] != links[:, 1]]
    links[0] = ei[:, 0]  # an observed edge
    return jd, td, links, np.ones(len(links), np.float32)


@pytest.mark.parametrize("node_label", ["drnl", "de", "de+", "hop", "degree"])
def test_fullrow_pos_matches_jax(graphs, node_label):
    jd, td, links, y = graphs
    want = jfull.precompute_pos_fullrow(jd, links, y, node_label=node_label, seed=3, **POS_KW)
    got = tfull.precompute_pos_fullrow(td, links, y, node_label=node_label, device="cpu",
                                       **POS_KW)
    assert got.xs.shape == want.xs.shape
    assert got.xs.shape[-1] == 7 + (node_label in ("de", "de+"))
    np.testing.assert_array_equal(np.asarray(want.row_mask), got.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.xs), got.xs.numpy(), **TOL)
    np.testing.assert_array_equal(want.y, got.y)


def test_fullrow_zo_target_rows_equal_optimized_pos(graphs):
    """With zo the z column is the optimized flows' target indicator
    (tuned_SIGN.py:177-179), so full-row rows 0-1 are the optimized dataset."""
    _, td, links, y = graphs
    kw = {**POS_KW, "sign_k": 3}
    full = tfull.precompute_pos_fullrow(td, links, y, node_label="zo", device="cpu", **kw)
    opt = precompute_pos(td, links, y, device="cpu", **kw)
    assert bool(full.row_mask[:, :2].all())
    np.testing.assert_allclose(full.xs[:, :, :2].numpy(), opt.xs.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("node_label", ["zo", "hop", "drnl", "de", "de+", "degree"])
def test_fullrow_sop_matches_jax(graphs, node_label):
    jd, td, links, y = graphs
    want = jfull.precompute_sop_fullrow(jd, links, y, sign_k=3, node_label=node_label,
                                        batch_size=4)
    got = tfull.precompute_sop_fullrow(td, links, y, sign_k=3, node_label=node_label,
                                       batch_size=4, device="cpu")
    assert got.xs.shape == want.xs.shape == (len(links), 4, 2, 7 + (node_label in ("de", "de+")))
    np.testing.assert_array_equal(np.asarray(want.row_mask), got.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(want.xs), got.xs.numpy(), **TOL)


def test_fullrow_sop_rejects_positive_hops(graphs):
    _, td, links, y = graphs
    with pytest.raises(NotImplementedError, match="num_hops=-1"):
        tfull.precompute_sop_fullrow(td, links, y, sign_k=2, num_hops=2, device="cpu")


def test_fullrow_drnl_run_learns(tmp_path):
    """optimize_sign=False reaches the full-row flow through the runner and
    learns on the synthetic USAir-shaped graph (1 hop, eye features)."""
    cfg = RunConfig(
        dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=False,
        node_label="drnl", init_features="eye", use_feature=True, sign_k=2,
        num_hops=1, epochs=2, hidden_channels=32, batch_size=32, lr=1e-3,
        train_percent=10.0, val_percent=50.0, test_percent=50.0,
        max_subgraph_nodes=128, subgraph_buckets=(32, 64, 128),
        delete_dataset=True, seed=1, results_dir=str(tmp_path),
    )
    g = tgraph.Graph(num_nodes=332, edge_index=usair_like_edges(1))
    rng, _ = seed_everything(cfg.seed)
    graph, split = do_edge_split(g, val_ratio=cfg.split_val_ratio,
                                 test_ratio=cfg.split_test_ratio, rng=rng)
    _, best, ttimes, _, nparams = run_sgrl_learning(cfg, graph, split, device="cpu")
    assert nparams > 0 and len(ttimes) == 2
    assert best > 60.0, best
