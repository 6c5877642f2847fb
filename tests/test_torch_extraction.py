"""Port parity, extraction: BFS node sets and local tables, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.sampling.extraction as text
from tests.torch_port_helpers import random_edges, usair_like_edges


def _pair(ei, n, f=5, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(
        tgraph.Graph(num_nodes=n, edge_index=ei, x=x), device="cpu"
    )
    return jd, td


def _links(rng, n, B):
    links = rng.integers(0, n, (B, 2)).astype(np.int32)
    links[0] = (links[0, 0], links[0, 0])  # src == dst
    return links


@pytest.mark.parametrize(
    "graph,num_hops,max_nodes",
    [
        ("random", 1, 64),
        ("random", 2, 128),
        ("random", 2, 16),  # bucket narrower than most subgraphs: truncation
        ("usair", 2, 256),
        ("usair", 1, 32),
    ],
)
def test_extract_node_sets_bit_exact(graph, num_hops, max_nodes):
    rng = np.random.default_rng(11)
    if graph == "random":
        n, ei = 150, random_edges(rng, n=150, e=500)
    else:
        n, ei = 200, usair_like_edges(3, n=200)
    jd, td = _pair(ei, n)
    links = _links(rng, n, 24)
    j = jext.extract_node_sets(
        jd, jnp.asarray(links), num_hops=num_hops, max_nodes=max_nodes
    )
    t = text.extract_node_sets(
        td, torch.as_tensor(links), num_hops=num_hops, max_nodes=max_nodes
    )
    for a, b in zip(j, t):  # nodes, node_mask, sel_dist, sub_size
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if max_nodes == 16:
        assert (t[3] > 16).any(), "the truncation case must truncate"


@pytest.mark.parametrize("max_nodes", [64, 300])  # 300: wider than the graph
def test_extract_subgraphs_and_assembly_bit_exact(max_nodes):
    rng = np.random.default_rng(12)
    ei = random_edges(rng, n=150, e=500)
    jd, td = _pair(ei, 150)
    links = _links(rng, 150, 16)
    j = jext.extract_subgraphs(jd, jnp.asarray(links), num_hops=2, max_nodes=max_nodes)
    t = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=2, max_nodes=max_nodes)
    for name in j._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(j, name)), getattr(t, name).numpy(), err_msg=name
        )


def test_sym_normalize_and_pick_bucket():
    adj = np.random.default_rng(2).random((3, 9, 9)).astype(np.float32)
    adj[:, 4] = 0.0
    np.testing.assert_allclose(
        np.asarray(jext.sym_normalize(jnp.asarray(adj))),
        text.sym_normalize(torch.as_tensor(adj)).numpy(),
        rtol=1e-6, atol=1e-7,
    )
    for size in (1, 32, 33, 5000):
        assert jext.pick_bucket(size, (32, 64, 128)) == text.pick_bucket(size, (32, 64, 128))


def test_per_hop_sampling_raises():
    """Per-hop sampling is ported (tests/test_torch_sampling.py); without
    per-link seeds it raises, as the JAX package asserts."""
    _, td = _pair(random_edges(np.random.default_rng(1), n=50, e=100), 50)
    with pytest.raises(ValueError, match="per-hop sampling needs link_seeds"):
        text.extract_node_sets(
            td, torch.zeros((2, 2), dtype=torch.int32), num_hops=1,
            max_nodes=8, ratio_per_hop=0.5,
        )
