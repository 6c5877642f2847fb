"""The port's CUDA kernels against their plain torch versions, on a card.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. Imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest -p no:cacheprovider -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from s3grl_tpu_torch.ops.pos_kernel import (
    pos_power_rows,
    pos_power_rows_reference,
    pos_selector_rows,
    pos_selector_rows_reference,
)
from s3grl_tpu_torch.ops.spmm_kernel import (
    blockify,
    bsr_spmm,
    bsr_spmm_reference,
    csr_spmm_reference,
)
from torch_port_helpers import kernel_inputs

TOL = dict(rtol=2e-3, atol=2e-4)
BSR_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas_spmm.py's bar

SHAPES = [
    dict(B=5, S=128, D=24, F=300, R=10),
    dict(B=3, S=64, D=7, F=5, R=3),
    dict(B=16, S=512, D=96, F=1026, R=2),  # the main path's width
    dict(B=4, S=4096, D=40, F=33, R=34),  # the compact list spills to global scratch
    dict(B=8, S=256, D=96, F=1026, R=34),  # PoS+ at the main path's width
    dict(B=3, S=100, D=10, F=1, R=3),  # one feature column
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S{S}-R{R}-F{F}".format(**s))
@pytest.mark.parametrize("sign_k", [0, 3])
def test_cuda_kernel_matches_plain_version(mode, shape, sign_k):
    dev = _cuda()
    sel, nbr, w, x, row_ids = kernel_inputs(4, mode=mode, **shape)
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w, x)]
    ids = None if row_ids is None else torch.as_tensor(row_ids, device=dev)
    before = pos_power_rows.launches
    got = pos_power_rows(*t, sign_k=sign_k, row_ids=ids)
    torch.cuda.synchronize()
    assert pos_power_rows.launches == before + 1
    want = pos_power_rows_reference(*t, sign_k=sign_k, row_ids=ids)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "S{S}-R{R}-F{F}".format(**s))
def test_selector_kernel_matches_plain_version(mode, shape):
    """Phase 1 alone: H [B, K·R, S] against its plain version."""
    dev = _cuda()
    sel, nbr, w, _, row_ids = kernel_inputs(5, mode=mode, **shape)
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w)]
    ids = None if row_ids is None else torch.as_tensor(row_ids, device=dev)
    before = pos_selector_rows.launches
    got = pos_selector_rows(*t, sign_k=3, row_ids=ids)
    torch.cuda.synchronize()
    assert pos_selector_rows.launches == before + 1
    want = pos_selector_rows_reference(*t, sign_k=3, row_ids=ids)
    assert got.shape == want.shape == (shape["B"], 3 * shape["R"], shape["S"])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    sel, nbr, w, x, _ = kernel_inputs(5, B=2, S=16, D=4, F=3, R=2, mode="local")
    t = [torch.as_tensor(a, device=dev) for a in (sel, nbr, w, x)]
    with pytest.raises(TypeError):
        pos_power_rows(t[0].long(), *t[1:], sign_k=1)
    with pytest.raises(ValueError):
        pos_power_rows(t[0], t[1], t[2], t[3].transpose(1, 2).contiguous().transpose(1, 2),
                       sign_k=1)


# (n, e, c): tests/test_pallas_spmm.py's shapes, then the main path's width
# (C = 1,025) at N not a multiple of 128, with one row block left empty.
BSR_SHAPES = [(50, 200, 7), (300, 2500, 64), (513, 4000, 129), (332, 3600, 1025)]
# Cora's shape; one column; four columns (the float4 route). With 500 edges
# on 300 nodes about a fifth of the rows are empty.
BSR_MORE = [(2708, 10556, 1433), (300, 500, 1), (300, 500, 4)]


def _bsr_inputs(seed, n, e, c, empty_row_block=False):
    """A non-symmetric M with weights of both signs, as numpy."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if empty_row_block:
        dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, c)).astype(np.float32)
    return src, dst, w, x


@pytest.mark.gpu
@pytest.mark.parametrize("n,e,c", BSR_SHAPES + BSR_MORE, ids=lambda v: str(v))
def test_bsr_kernel_matches_plain_version(n, e, c):
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(n, n, e, c, empty_row_block=n > 256)
    adj = blockify(src, dst, w, n, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm_reference(adj, xt)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **BSR_TOL)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (dst, src), w)
    np.testing.assert_allclose(got.cpu().numpy(), dense @ x, **BSR_TOL)
    np.testing.assert_allclose(got.cpu().numpy(), csr_spmm_reference(adj, xt).cpu().numpy(),
                               **BSR_TOL)
    if n > 256:
        assert bool((got[128:256] == 0).all())
    empty = (adj.csr_row_ptr[1:] == adj.csr_row_ptr[:-1]).cpu().numpy()
    assert (got.cpu().numpy()[empty] == 0).all()
    # A fixed summation order: the same call gives the same bits.
    assert torch.equal(bsr_spmm(adj, xt), got)


@pytest.mark.gpu
def test_bsr_kernel_splits_long_rows():
    """A hub row of some 200 nonzeros (300 edges, some repeated): the kernel
    splits rows over 4 warps when one is longer than 32, and still repeats
    bit for bit."""
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(3, 400, 3000, 257)
    dst[:300] = 7
    adj = blockify(src, dst, w, 400, device=dev)
    assert adj.csr_max_row > 32
    xt = torch.as_tensor(x, device=dev)
    got = bsr_spmm(adj, xt)
    torch.cuda.synchronize()
    want = bsr_spmm_reference(adj, xt)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **BSR_TOL)
    assert torch.equal(bsr_spmm(adj, xt), got)


@pytest.mark.gpu
def test_bsr_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    src, dst, w, x = _bsr_inputs(1, 200, 800, 9)
    adj = blockify(src, dst, w, 200, device=dev)
    xt = torch.as_tensor(x, device=dev)
    before = bsr_spmm.launches
    wide = dataclasses.replace(adj, csr_cols=adj.csr_cols.long())
    with pytest.raises(TypeError):
        bsr_spmm(wide, xt)
    with pytest.raises(ValueError):
        bsr_spmm(adj, torch.as_tensor(x.T.copy(), device=dev).T)
    on_cpu = blockify(src, dst, w, 200, device="cpu")
    with pytest.raises(ValueError):
        bsr_spmm(on_cpu, xt)
    assert bsr_spmm.launches == before
