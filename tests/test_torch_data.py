"""Port parity, host data layer: config, graph tables, splits, features.

The port's copies must give the JAX package's arrays bit for bit.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch

import s3grl_tpu.config as jcfg
import s3grl_tpu.data.features as jfeat
import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.data.split as jsplit
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.config as tcfg
import s3grl_tpu_torch.data.features as tfeat
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.data.split as tsplit
import s3grl_tpu_torch.sampling.extraction as text
from tests.torch_port_helpers import random_edges, usair_like_edges


def _graphs(ei, n, x=None):
    return (
        jgraph.Graph(num_nodes=n, edge_index=ei, x=x),
        tgraph.Graph(num_nodes=n, edge_index=ei, x=x),
    )


def test_run_config_fields_and_defaults_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jcfg.RunConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcfg.RunConfig)]
    assert jf == tf
    assert [f.name for f in dataclasses.fields(jcfg.ExperimentSuite)] == [
        f.name for f in dataclasses.fields(tcfg.ExperimentSuite)
    ]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("neg_ratio", [1, 2])
def test_edge_split_and_links_bit_exact(seed, neg_ratio):
    ei = usair_like_edges(seed + 1, n=120)
    jg, tg = _graphs(ei, 120)
    jgr, jspl = jsplit.do_edge_split(
        jg, neg_ratio=neg_ratio, rng=np.random.default_rng(seed)
    )
    tgr, tspl = tsplit.do_edge_split(
        tg, neg_ratio=neg_ratio, rng=np.random.default_rng(seed)
    )
    np.testing.assert_array_equal(jgr.edge_index, tgr.edge_index)
    for name in ("train_pos", "train_neg", "valid_pos", "valid_neg", "test_pos", "test_neg"):
        np.testing.assert_array_equal(getattr(jspl, name), getattr(tspl, name))
    for split, pct in (("train", 100.0), ("valid", 50.0), ("test", 30.0)):
        a = jsplit.get_pos_neg_edges(split, jspl, percent=pct, rng=np.random.default_rng(7))
        b = tsplit.get_pos_neg_edges(split, tspl, percent=pct, rng=np.random.default_rng(7))
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("kind", ["degree", "eye"])
def test_init_features_bit_exact(kind):
    ei = usair_like_edges(2, n=90)
    jg, tg = _graphs(ei, 90)
    xj = jfeat.init_features(jg, kind).x
    xt = tfeat.init_features(tg, kind).x
    assert xj.dtype == xt.dtype == np.float32
    np.testing.assert_array_equal(xj, xt)


def test_init_features_n2v_names_its_roadmap_item():
    """ROADMAP module item 9 ported the n2v route: node2vec features, then
    the reference's re-normalization."""
    from s3grl_tpu_torch.data.graph import normalize_features
    from s3grl_tpu_torch.models.n2v import node2vec_pretrain

    _, tg = _graphs(usair_like_edges(2, n=40), 40)
    got = tfeat.init_features(tg, "n2v", n2v_dim=4, epochs=1, device="cpu")
    want = node2vec_pretrain(tg, 4, epochs=1, seed=1, device="cpu")
    np.testing.assert_array_equal(got.x, normalize_features(want))


@pytest.mark.parametrize("max_degree", [None, 5])
def test_padded_adjacency_and_device_graph_bit_exact(max_degree):
    rng = np.random.default_rng(4)
    ei = random_edges(rng, n=150, e=500)
    x = rng.normal(size=(150, 7)).astype(np.float32)
    jg, tg = _graphs(ei, 150, x)
    for u, v in zip(jg.padded_adjacency(max_degree), tg.padded_adjacency(max_degree)):
        np.testing.assert_array_equal(u, v)
    jd = jext.DeviceGraph.from_graph(jg, max_degree)
    td = text.DeviceGraph.from_graph(tg, max_degree, device="cpu")
    for name in ("nbr", "nbr_w", "nbr_mask", "x"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jd, name)), getattr(td, name).numpy()
        )
    np.testing.assert_array_equal(np.asarray(jd.edge_src), td.edge_src.numpy())
    np.testing.assert_array_equal(np.asarray(jd.edge_dst), td.edge_dst.numpy())
    assert td.nbr.dtype == torch.int32
