"""Port parity, SpMM: the edge-list route, the BSR layout, the block-sparse
kernel's plain version and the route selector, against the JAX package.

On the CPU ``bsr_spmm`` runs its plain version (``bsr_spmm_reference``);
the JAX ``bsr_spmm`` runs its Pallas kernel in interpret mode, as
tests/test_pallas_spmm.py runs it. Tolerances are that file's: rtol/atol
1e-4 for one product, rtol 1e-3 / atol 1e-5 for the power chain. The
layout must be bit-exact; the edge-list route agrees to 1e-5 (both add in
float32, in different orders).
"""
import numpy as np
import pytest
import torch

from s3grl_tpu.ops.spmm import normalized_adjacency_weights as j_norm_weights
from s3grl_tpu.ops.spmm import spmm as j_spmm
import s3grl_tpu.ops.spmm_pallas as jsp
from s3grl_tpu_torch.ops.segment import segment_lengths, segment_sum
from s3grl_tpu_torch.ops.spmm import edge_list, normalized_adjacency_weights, spmm
from s3grl_tpu_torch.ops.spmm_kernel import (
    blockify,
    bsr_spmm,
    bsr_spmm_reference,
    csr_spmm_reference,
    num_blocks,
    power_chain,
    should_use_bsr,
)
from tests.torch_port_helpers import cora_like_edges, usair_like_edges

SHAPES = [(50, 200, 7), (300, 2500, 64), (513, 4000, 129)]


def _random_coo(rng, n, e):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    return src, dst, w, dense


@pytest.mark.parametrize("n,e,c", SHAPES)
def test_blockify_is_bit_exact(n, e, c):
    rng = np.random.default_rng(n)
    src, dst, w, _ = _random_coo(rng, n, e)
    want = jsp.blockify(src, dst, w, n)
    got = blockify(src, dst, w, n, device="cpu")
    np.testing.assert_array_equal(np.asarray(want.blocks), got.blocks.numpy())
    np.testing.assert_array_equal(np.asarray(want.block_rows), got.block_rows.numpy())
    np.testing.assert_array_equal(np.asarray(want.block_cols), got.block_cols.numpy())
    assert got.block_rows.dtype == got.block_cols.dtype == torch.int32
    assert (got.num_nodes, got.num_row_blocks) == (want.num_nodes, want.num_row_blocks)
    rows = got.block_rows.numpy()
    ptr = got.row_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == got.num_blocks
    for r in range(got.num_row_blocks):
        assert (rows[ptr[r] : ptr[r + 1]] == r).all() and ptr[r + 1] > ptr[r]


@pytest.mark.parametrize("n,e,c", SHAPES)
def test_bsr_spmm_matches_jax_and_dense(n, e, c):
    rng = np.random.default_rng(n)
    src, dst, w, dense = _random_coo(rng, n, e)
    x = rng.normal(size=(n, c)).astype(np.float32)
    got = bsr_spmm(blockify(src, dst, w, n, device="cpu"), torch.as_tensor(x)).numpy()
    assert got.shape == (n, c)
    want = np.asarray(jsp.bsr_spmm(jsp.blockify(src, dst, w, n), x, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense @ x, rtol=1e-4, atol=1e-4)


def _dense_from_blocks(adj):
    """M [N, N] rebuilt from the dense blocks (rows and columns past N cut)."""
    n, bs = adj.num_nodes, adj.blocks.shape[1]
    n_cb = max(adj.num_row_blocks, int(adj.block_cols.max()) + 1)
    m = np.zeros((adj.num_row_blocks * bs, n_cb * bs), np.float32)
    for blk, r, c in zip(adj.blocks.numpy(), adj.block_rows.tolist(), adj.block_cols.tolist()):
        m[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] += blk
    return m[:n, :n]


def _dense_from_csr(adj):
    n = adj.num_nodes
    ptr = adj.csr_row_ptr.numpy()
    m = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), np.diff(ptr))
    m[rows, adj.csr_cols.numpy()] = adj.csr_vals.numpy()  # (row, col) pairs are unique
    return m


def _csr_case(name):
    """(src, dst, w, n) for the CSR-layout cases."""
    rng = np.random.default_rng(11)
    if name == "empty_row_block":  # no edge ends in rows 128..255
        src = rng.integers(0, 300, 900)
        dst = rng.integers(0, 300, 900)
        dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst)
        return src, dst, rng.normal(size=900), 300
    if name == "duplicate_edges":  # each edge three times; the first 50 sum to 0
        src = np.tile(rng.integers(0, 200, 300), 3)
        dst = np.tile(rng.integers(0, 200, 300), 3)
        w = rng.normal(size=300)
        v = np.where(np.arange(300) < 50, 0.0, w)
        return src, dst, np.concatenate([w, v, -w]), 200
    if name == "zero_weights":
        src, dst = rng.integers(0, 150, 600), rng.integers(0, 150, 600)
        w = rng.normal(size=600) * (rng.random(600) < 0.5)
        return src, dst, w, 150
    # n not a multiple of 128, and a source id past n (a column block past X)
    src, dst = rng.integers(0, 333, 2000), rng.integers(0, 333, 2000)
    return np.append(src, 400), np.append(dst, 5), rng.normal(size=2001), 333


@pytest.mark.parametrize("case", ["empty_row_block", "duplicate_edges", "zero_weights",
                                  "n_not_multiple_of_128"])
def test_blockify_csr_fields_match_the_blocks(case):
    src, dst, w, n = _csr_case(case)
    adj = blockify(src.astype(np.int32), dst.astype(np.int32), w.astype(np.float32), n,
                   device="cpu")
    ptr, cols = adj.csr_row_ptr.numpy(), adj.csr_cols.numpy()
    assert adj.csr_row_ptr.dtype == adj.csr_cols.dtype == torch.int32
    assert adj.csr_vals.dtype == torch.float32
    assert ptr.shape == (n + 1,) and ptr[0] == 0 and ptr[-1] == len(cols)
    assert (np.diff(ptr) >= 0).all() and adj.csr_max_row == np.diff(ptr).max()
    for i in range(n):
        assert (np.diff(cols[ptr[i]:ptr[i + 1]]) > 0).all()  # sorted, no repeats
    assert ((cols >= 0) & (cols < n)).all() and (adj.csr_vals.numpy() != 0).all()
    np.testing.assert_array_equal(_dense_from_csr(adj), _dense_from_blocks(adj))
    if case == "empty_row_block":
        assert (ptr[128:257] == ptr[128]).all()


@pytest.mark.parametrize("n,e,c", SHAPES)
def test_csr_reference_matches_bsr_reference_and_jax(n, e, c):
    rng = np.random.default_rng(n + 3)
    src, dst, w, dense = _random_coo(rng, n, e)
    x = rng.normal(size=(n, c)).astype(np.float32)
    adj = blockify(src, dst, w, n, device="cpu")
    got = csr_spmm_reference(adj, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, bsr_spmm_reference(adj, torch.as_tensor(x)).numpy(),
                               rtol=1e-4, atol=1e-4)
    want = np.asarray(jsp.bsr_spmm(jsp.blockify(src, dst, w, n), x, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, dense @ x, rtol=1e-4, atol=1e-4)


def test_power_chain_matches_jax_and_repeated_dense():
    rng = np.random.default_rng(7)
    n, e, c, k = 200, 1500, 16, 3
    src, dst, w, dense = _random_coo(rng, n, e)
    w *= 0.1  # keep the powers well-conditioned
    dense *= 0.1
    x = rng.normal(size=(n, c)).astype(np.float32)
    ys = power_chain(blockify(src, dst, w, n, device="cpu"), torch.as_tensor(x), k).numpy()
    want = np.asarray(jsp.power_chain(jsp.blockify(src, dst, w, n), x, k, interpret=True))
    np.testing.assert_allclose(ys, want, rtol=1e-3, atol=1e-5)
    r = x
    for i in range(k):
        r = dense @ r
        np.testing.assert_allclose(ys[i], r, rtol=1e-3, atol=1e-5)


def test_empty_row_blocks_zeroed():
    # Nodes 128..255 have no incident edges: the second row block holds only
    # the explicit zero block and its output rows are 0.
    n = 260
    src = np.array([0, 1, 2], np.int32)
    dst = np.array([1, 2, 0], np.int32)
    w = np.ones(3, np.float32)
    adj = blockify(src, dst, w, n, device="cpu")
    assert adj.row_ptr.tolist() == [0, 1, 2, 3]
    y = bsr_spmm(adj, torch.ones((n, 5))).numpy()
    assert np.all(y[128:256] == 0)
    assert y[:3].sum() == 3 * 5


def test_reference_reads_column_blocks_past_x_as_zero():
    # A source id >= N puts a block past X's last row block; it adds nothing.
    n = 100
    adj = blockify(np.array([130, 5]), np.array([3, 4]), np.array([2.0, 1.0]), n,
                   device="cpu")
    assert adj.block_cols.tolist() == [0, 1] and adj.num_row_blocks == 1
    y = bsr_spmm_reference(adj, torch.ones((n, 3)))
    assert y[3].tolist() == [0.0, 0.0, 0.0] and y[4].tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("n,e,c", SHAPES[:2])
def test_edge_list_spmm_and_weights_match_jax(n, e, c):
    rng = np.random.default_rng(n + 1)
    src, dst, w, _ = _random_coo(rng, n, e)
    x = rng.normal(size=(n, c)).astype(np.float32)
    s, d = torch.as_tensor(src, dtype=torch.int64), torch.as_tensor(dst, dtype=torch.int64)
    got = spmm(edge_list(s, d, torch.as_tensor(w), n), torch.as_tensor(x)).numpy()
    want = np.asarray(j_spmm(src, dst, w, x, n))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_w = normalized_adjacency_weights(s, d, n).numpy()
    want_w = np.asarray(j_norm_weights(src, dst, n))
    np.testing.assert_allclose(got_w, want_w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,e,c", SHAPES[:2])
def test_edge_list_spmm_gradient_matches_jax(n, e, c):
    """The backward of the sorted edge list's product (A G, summed by
    source) against jax.grad of the JAX package's edge-list SpMM."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n + 2)
    src, dst, w, dense = _random_coo(rng, n, e)
    x = rng.normal(size=(n, c)).astype(np.float32)
    g = rng.normal(size=(n, c)).astype(np.float32)
    edges = edge_list(torch.as_tensor(src).long(), torch.as_tensor(dst).long(),
                      torch.as_tensor(w), n)
    xt = torch.as_tensor(x).requires_grad_()
    (spmm(edges, xt) * torch.as_tensor(g)).sum().backward()
    want = jax.grad(lambda v: jnp.sum(j_spmm(src, dst, w, v, n) * g))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), dense.T @ g, rtol=1e-4, atol=1e-4)


def test_edge_list_is_sorted_once_with_its_counts():
    """Each direction holds the edges in a stable order by the row they add
    into, and the counts per row (empty rows included); the sums equal the
    per-call sort of ``segment_sum`` bit for bit."""
    rng = np.random.default_rng(5)
    n = 40
    src, dst, w, _ = _random_coo(rng, n, 150)
    s, d = torch.as_tensor(src).long(), torch.as_tensor(dst).long()
    edges = edge_list(s, d, torch.as_tensor(w), n)
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(edges.by_dst.gather.numpy(), src[order])
    np.testing.assert_array_equal(edges.by_dst.weight.numpy(), w[order])
    np.testing.assert_array_equal(edges.by_dst.lengths.numpy(), np.bincount(dst, minlength=n))
    np.testing.assert_array_equal(edges.by_src.lengths.numpy(), np.bincount(src, minlength=n))
    assert (edges.by_dst.lengths == 0).any()
    x = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32))
    want = segment_sum(x[s] * torch.as_tensor(w)[:, None], d, n)
    assert torch.equal(spmm(edges, x), want)
    idx = torch.as_tensor(np.sort(rng.integers(0, 7, 30)))
    np.testing.assert_array_equal(segment_lengths(idx, 9).numpy(),
                                  np.bincount(idx.numpy(), minlength=9))


def test_selector_picks_bsr_on_usair_shape_and_edge_list_on_cora_shape():
    ei = usair_like_edges(1)
    assert should_use_bsr(ei[0], ei[1], 332, 1025)
    ei = cora_like_edges(1)
    assert ei.shape == (2, 10556)
    assert not should_use_bsr(ei[0], ei[1], 2708, 1433)
    # Every block pair of the 22 x 22 grid is hit.
    assert blockify(ei[0], ei[1], np.ones(ei.shape[1]), 2708, device="cpu").num_blocks == 484
    # No edges: nothing to gain from blocks.
    assert not should_use_bsr(np.zeros(0), np.zeros(0), 10, 8)
    # The memory budget refuses a layout whose blocks exceed it.
    assert not should_use_bsr(ei[0], ei[1], 2708, 1, budget_bytes=1 << 20)


def test_blockify_refuses_a_layout_over_budget():
    src, dst, w, _ = _random_coo(np.random.default_rng(2), 300, 900)
    with pytest.raises(ValueError, match="budget"):
        blockify(src, dst, w, 300, budget_bytes=128 * 128 * 4, device="cpu")


@pytest.mark.parametrize("n,e,c", SHAPES)
def test_num_blocks_matches_blockify(n, e, c):
    # The selector counts the blocks by the layout's own key rule. Half the
    # nodes lie past the edges' range, so some row blocks are empty.
    rng = np.random.default_rng(n + 2)
    src, dst, w, _ = _random_coo(rng, max(1, n // 2), e)
    assert num_blocks(src, dst, n) == blockify(src, dst, w, n, device="cpu").num_blocks
