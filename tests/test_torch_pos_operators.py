"""Port parity, PoS operators and the precompute driver.

Operator features at the JAX kernel's bar (rtol 2e-3, atol 2e-4); row
masks bit for bit.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import s3grl_tpu.data.graph as jgraph
import s3grl_tpu.operators.pos as jpos
import s3grl_tpu.sampling.extraction as jext
import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from tests.torch_port_helpers import random_edges

TOL = dict(rtol=2e-3, atol=2e-4)
CCN = [(0, ""), (8, "union"), (8, "intersection")]


def _pair(seed, n=150, e=500, f=7):
    """tests/test_pos_pallas.py::_graph shapes; n=300, e=2400, f=9 reaches S=256."""
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n=n, e=e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    jd = jext.DeviceGraph.from_graph(jgraph.Graph(num_nodes=n, edge_index=ei, x=x))
    td = text.DeviceGraph.from_graph(
        tgraph.Graph(num_nodes=n, edge_index=ei, x=x), device="cpu"
    )
    return rng, jd, td


@pytest.mark.parametrize("max_ccn,strategy", CCN)
@pytest.mark.parametrize("S", [128, 256])
def test_pos_operators_gather_and_global_match_jax(max_ccn, strategy, S):
    n, e, f = (150, 500, 7) if S == 128 else (300, 2400, 9)
    rng, jd, td = _pair(0, n, e, f)
    links = rng.integers(0, n, (16, 2)).astype(np.int32)
    kw = dict(sign_k=3, max_ccn=max_ccn, strategy=strategy)

    jsub = jext.extract_subgraphs(jd, jnp.asarray(links), num_hops=2, max_nodes=S)
    tsub = text.extract_subgraphs(td, torch.as_tensor(links), num_hops=2, max_nodes=S)
    xj, mj = jpos.pos_operators(jsub, jd.x, use_pallas=False, **kw)
    xt, mt = tpos.pos_operators(tsub, td.x, **kw)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(xj), xt.numpy(), rtol=1e-5, atol=1e-6)

    # Global-id route; at S = 256 JAX takes its staircase permutation,
    # which the port leaves out.
    nodes, mask = jsub.nodes, jsub.node_mask
    xj, mj = jpos.pos_operators_global(jd, jnp.asarray(links), nodes, mask, **kw)
    xt, mt = tpos.pos_operators_global(
        td, torch.as_tensor(links), torch.as_tensor(np.array(nodes)),
        torch.as_tensor(np.array(mask)), **kw,
    )
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(xj), xt.numpy(), **TOL)


@pytest.mark.parametrize("ccn", [
    {},
    dict(k_heuristic=1, max_ccn=8, k_node_set_strategy="intersection"),
    dict(k_heuristic=1, max_ccn=8, k_node_set_strategy="union"),
])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_precompute_pos_matches_jax(ccn, use_pallas):
    rng, jd, td = _pair(1)
    links = rng.integers(0, 150, (24, 2)).astype(np.int32)
    y = rng.integers(0, 2, 24).astype(np.float32)
    kw = dict(num_hops=2, sign_k=2, buckets=(32, 64, 128), batch_size=8,
              max_subgraph_nodes=128, **ccn)
    a = jpos.precompute_pos(jd, links, y, use_pallas=use_pallas, seed=3, **kw)
    b = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(a.row_mask), b.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(a.xs), b.xs.numpy(), **TOL)
    np.testing.assert_array_equal(a.y, b.y)


def test_precompute_pos_staircase_bucket_matches_jax():
    """S = 256: the JAX kernel route runs its staircase densify."""
    rng, jd, td = _pair(5, n=300, e=2400, f=9)
    links = rng.integers(0, 300, (16, 2)).astype(np.int32)
    y = rng.integers(0, 2, 16).astype(np.float32)
    kw = dict(num_hops=2, sign_k=3, buckets=(256,), batch_size=8,
              max_subgraph_nodes=256)
    a = jpos.precompute_pos(jd, links, y, use_pallas=True, seed=7, **kw)
    b = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(a.row_mask), b.row_mask.numpy())
    np.testing.assert_allclose(np.asarray(a.xs), b.xs.numpy(), **TOL)


def test_subgraph_sizes_and_ccn_width_match_jax():
    rng, jd, td = _pair(2)
    links = rng.integers(0, 150, (40, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        jpos.measure_subgraph_sizes(jd, links, num_hops=2),
        tpos.measure_subgraph_sizes(td, links, num_hops=2),
    )
    for strategy in ("union", "intersection"):
        assert jpos.measure_ccn_width(jd, links, strategy, 64) == tpos.measure_ccn_width(
            td, links, strategy, 64
        )


def _tier_budgets(f32_bytes: int) -> dict:
    """``S3GRL_TPU_DEVICE_DS_BYTES`` values that force each storage tier for
    a dataset of ``f32_bytes`` at its full CCN width: bf16 at that width
    (its f32 size over the budget, its bf16 size within it), bf16 with the
    CCN pad halved (the bf16 size just over it), and the host."""
    return {"bf16": f32_bytes // 2, "halved": f32_bytes // 2 - 1, "host": 1}


@pytest.mark.parametrize("tier", ["bf16", "halved", "host"])
def test_storage_tier_follows_the_budget_variable_as_jax(monkeypatch, tier):
    """The port reads ``S3GRL_TPU_DEVICE_DS_BYTES`` at each call, as the JAX
    package does (pos.py:818): in each forced tier the dataset's dtype, CCN
    width and place equal the JAX package's, and its values stay within the
    bars of tests/test_assembly.py:97-113 (bf16 to storage precision)."""
    rng, jd, td = _pair(1)
    links = rng.integers(0, 150, (24, 2)).astype(np.int32)
    y = rng.integers(0, 2, 24).astype(np.float32)
    kw = dict(num_hops=2, sign_k=2, buckets=(32, 64, 128), batch_size=8,
              max_subgraph_nodes=128, k_heuristic=1, max_ccn=8,
              k_node_set_strategy="intersection")
    monkeypatch.delenv("S3GRL_TPU_DEVICE_DS_BYTES", raising=False)
    base_j = jpos.precompute_pos(jd, links, y, seed=3, **kw).to_host()
    base_t = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    assert base_t.xs.dtype == torch.float32 and base_t.xs.shape == base_j.xs.shape
    full_r = base_t.xs.shape[2]
    assert full_r - 2 >= 8, "the fixture must have a CCN pad to halve"

    monkeypatch.setenv("S3GRL_TPU_DEVICE_DS_BYTES", str(_tier_budgets(base_j.xs.nbytes)[tier]))
    if tier == "halved":
        with pytest.warns(UserWarning, match="CCN pad halved"):
            a = jpos.precompute_pos(jd, links, y, seed=3, **kw)
        with pytest.warns(UserWarning, match="CCN pad halved"):
            b = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    else:
        a = jpos.precompute_pos(jd, links, y, seed=3, **kw)
        b = tpos.precompute_pos(td, links, y, device="cpu", **kw)
    on_host = isinstance(a.xs, np.ndarray)
    assert on_host == (tier == "host")
    want_dtype = {"bf16": torch.bfloat16, "halved": torch.bfloat16, "host": torch.float32}
    assert str(a.xs.dtype) == str(b.xs.dtype).removeprefix("torch.") == str(
        want_dtype[tier]).removeprefix("torch.")
    assert a.xs.shape == tuple(b.xs.shape) and a.row_mask.shape == tuple(b.row_mask.shape)
    assert b.xs.shape[2] == ((full_r - 2) // 2 + 2 if tier == "halved" else full_r)
    # The place: the plan's device for a dataset on the card is the card's,
    # and the host tier's the CPU, whatever device the graph lies on.
    L, K, F = len(links), kw["sign_k"], int(td.x.shape[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eff, dtype, place = tpos._storage_tier(L, K, F, full_r - 2, torch.device("cuda"))
    assert (eff + 2, dtype, place.type == "cpu") == (b.xs.shape[2], b.xs.dtype, on_host)

    np.testing.assert_array_equal(np.asarray(a.row_mask), b.row_mask.numpy())
    xa = np.asarray(a.xs, dtype=np.float32)
    xb = b.xs.float().numpy()
    if tier == "host":
        np.testing.assert_allclose(xa, xb, **TOL)
    else:
        np.testing.assert_allclose(xa, xb, rtol=2e-2, atol=2e-2)
    r = b.xs.shape[2]
    np.testing.assert_allclose(xb, np.asarray(base_j.xs)[:, :, :r], rtol=2e-2, atol=2e-2)
