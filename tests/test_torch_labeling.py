"""Port parity, labeling: the dense sub-adjacency and all six structural
labels, bit for bit against the JAX package; DRNL also against the scipy
oracle of tests/reference_oracles.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as ssp
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu.sampling.labeling as jlab
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.sampling.extraction as text
import s3grl_tpu_torch.sampling.labeling as tlab
from tests.reference_oracles import bfs_subgraph_nodes, drnl_oracle, induced_subgraph
from tests.torch_port_helpers import one_torch_thread, random_edges, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

LABELS = ["zo", "hop", "degree", "drnl", "de", "de+"]
# (graph, num_hops, max_nodes): 16 truncates most subgraphs of the random graph.
CASES = [("random", 2, 64), ("usair", 1, 32), ("random", 2, 16)]


def _graph(name):
    if name == "random":
        return 150, random_edges(np.random.default_rng(21), n=150, e=500)
    return 200, usair_like_edges(3, n=200)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-h{c[1]}-S{c[2]}")
def batch(request):
    """One link batch extracted by both packages: (jax sub, torch sub, edges, links)."""
    name, num_hops, max_nodes = request.param
    n, ei = _graph(name)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei))
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei), device="cpu")
    rng = np.random.default_rng(7)
    links = rng.integers(0, n, (20, 2)).astype(np.int32)
    links[0] = (links[0, 0], links[0, 0])  # src == dst
    links[1] = ei[:, 0]  # an observed edge: the target link is removed
    js = jext.extract_subgraphs(jd, jnp.asarray(links), num_hops=num_hops, max_nodes=max_nodes)
    ts = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=num_hops,
                                max_nodes=max_nodes)
    return js, ts, (n, ei), links, num_hops


def test_dense_adjacency_bit_exact(batch):
    js, ts, *_ = batch
    got = text.dense_adjacency(ts)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jext.dense_adjacency(js)), got.numpy())


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("max_iters", [32, 2])  # 2: distances past the cap count as unreached
def test_labels_bit_exact(batch, label, max_iters):
    js, ts, *_ = batch
    want = jlab.label_nodes(jext.dense_adjacency(js), js.dist, js.node_mask,
                            node_label=label, max_iters=max_iters)
    got = tlab.label_nodes(text.dense_adjacency(ts), ts.dist, ts.node_mask,
                           node_label=label, max_iters=max_iters)
    assert got.dtype == torch.float32
    assert got.shape == ((20, ts.nodes.shape[1], 2) if label in ("de", "de+") else ts.nodes.shape)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_masked_bfs_dist_bit_exact(batch):
    js, ts, *_ = batch
    B = ts.nodes.shape[0]
    start = np.arange(B) % 2
    forbidden = 1 - start
    for fb in (None, forbidden):
        want = jlab.masked_bfs_dist(
            jext.dense_adjacency(js), jnp.asarray(start), js.node_mask,
            None if fb is None else jnp.asarray(fb), 32,
        )
        got = tlab.masked_bfs_dist(
            text.dense_adjacency(ts), torch.as_tensor(start), ts.node_mask,
            None if fb is None else torch.as_tensor(fb), 32,
        )
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("name,num_hops", [("random", 2), ("usair", 1)])
def test_drnl_matches_scipy_oracle(name, num_hops):
    """At a pad wide enough that no subgraph is cut, each link's DRNL labels
    equal the oracle's on its induced subgraph."""
    n, ei = _graph(name)
    td = text.DeviceGraph.from_graph(tgraph.Graph(num_nodes=n, edge_index=ei), device="cpu")
    A = ssp.csr_matrix((np.ones(ei.shape[1]), (ei[0], ei[1])), shape=(n, n))
    rng = np.random.default_rng(8)
    links = rng.integers(0, n, (12, 2)).astype(np.int32)
    links = links[links[:, 0] != links[:, 1]]
    links[0] = ei[:, 0]
    ts = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=num_hops, max_nodes=n)
    z = tlab.label_nodes(text.dense_adjacency(ts), ts.dist, ts.node_mask,
                         node_label="drnl").numpy()
    for b, (s, d) in enumerate(links):
        nodes, _ = bfs_subgraph_nodes(A, int(s), int(d), num_hops)
        assert ts.nodes[b, : len(nodes)].tolist() == nodes
        np.testing.assert_array_equal(z[b, : len(nodes)], drnl_oracle(induced_subgraph(A, nodes)))
        assert (z[b, len(nodes):] == 0).all()
