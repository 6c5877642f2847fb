"""Port parity, the PoS kernel function.

On the CPU the port's ``pos_power_rows`` runs its plain version; it is held
against the JAX kernel in interpret mode at the bar the JAX kernel meets
against its own XLA path (rtol 2e-3, atol 2e-4; tests/test_pos_pallas.py).
The CUDA kernel's own test is tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s3grl_tpu.ops.pos_pallas import pos_power_rows as jax_pos_power_rows
from s3grl_tpu_torch.ops.pos_kernel import (
    _resolve_slots,
    pos_power_rows,
    pos_selector_rows,
    pos_selector_rows_reference,
)
from tests.torch_port_helpers import kernel_inputs as _inputs

TOL = dict(rtol=2e-3, atol=2e-4)


def _jax(sel, nbr, w, x, row_ids, K, **kw):
    out = jax_pos_power_rows(
        jnp.asarray(sel), jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
        sign_k=K, row_ids=None if row_ids is None else jnp.asarray(row_ids),
        interpret=True, **kw,
    )
    return np.asarray(out)


def _port(sel, nbr, w, x, row_ids, K):
    t = torch.as_tensor
    return pos_power_rows(
        t(sel), t(nbr), t(w), t(x), sign_k=K,
        row_ids=None if row_ids is None else t(row_ids),
    ).numpy()


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("select_rows", [False, True])
def test_kernel_function_matches_jax(mode, select_rows):
    """Non-symmetric random tables, both id modes, both JAX chains."""
    sel, nbr, w, x, row_ids = _inputs(1, B=3, S=64, D=16, F=9, R=4, mode=mode)
    want = _jax(sel, nbr, w, x, row_ids, 3, select_rows=select_rows)
    got = _port(sel, nbr, w, x, row_ids, 3)
    assert got.shape == want.shape == (3, 4, 4, 9)
    # Measured max abs error ~1e-6 here; the stated bar is the JAX kernel's.
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_function_symmetric_table_wide_features():
    """A symmetric table at F > 127, where JAX auto-picks the
    selected-row chain, as on the main path (F = 1,026)."""
    sel, nbr, w, x, row_ids = _inputs(2, B=2, S=32, D=8, F=150, R=2, mode="global",
                                      symmetric=True)
    np.testing.assert_allclose(
        _port(sel, nbr, w, x, row_ids, 2), _jax(sel, nbr, w, x, row_ids, 2), **TOL
    )


def test_port_without_chunk_tiles_matches_jax_staircase():
    """JAX given degree-sorted slots and staircase tile counts, the port
    (which ignores chunk_tiles) without them."""
    B, S, D, F, K = 2, 256, 16, 7, 3
    rng = np.random.default_rng(5)
    deg = np.sort(rng.integers(0, D + 1, (B, S)), axis=1)[:, ::-1]
    nbr = rng.integers(0, S, (B, S, D)).astype(np.int32)
    w = (np.arange(D)[None, None, :] < deg[:, :, None]).astype(np.float32)
    x = rng.normal(size=(B, S, F)).astype(np.float32)
    sel = rng.integers(0, S, (B, 2)).astype(np.int32)
    DC = (D + 7) // 8
    n_c = (deg[:, None, :] > (np.arange(DC) * 8)[None, :, None]).sum(-1)
    tiles = ((n_c + 127) // 128).astype(np.int32)
    want = np.asarray(jax_pos_power_rows(
        jnp.asarray(sel), jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
        sign_k=K, chunk_tiles=jnp.asarray(tiles), interpret=True,
    ))
    got = pos_power_rows(
        torch.as_tensor(sel), torch.as_tensor(nbr), torch.as_tensor(w),
        torch.as_tensor(x), sign_k=K, chunk_tiles=torch.as_tensor(tiles),
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_tensors_never_launch():
    before = pos_power_rows.launches
    sel, nbr, w, x, row_ids = _inputs(3, B=2, S=16, D=4, F=3, R=2, mode="global")
    _port(sel, nbr, w, x, row_ids, 2)
    assert pos_power_rows.launches == before == 0


def _one_pass_reference(sel, nbr, w, x, row_ids, K):
    """The plain version as it stood before the selector phase was split
    out: the selected rows carried and multiplied by X at every step."""
    sel, nbr, w, x = (torch.as_tensor(a) for a in (sel, nbr, w, x))
    row_ids = None if row_ids is None else torch.as_tensor(row_ids)
    B, S, D = nbr.shape
    R = sel.shape[1]
    loc, found = _resolve_slots(nbr, row_ids, S)
    wv = torch.where(found, w.reshape(B, S * D), torch.zeros(()))
    coldeg = wv.reshape(B, S, D).sum(dim=-1)
    rowdeg = torch.zeros((B, S)).scatter_add_(1, loc, wv)

    def inv_sqrt(deg):
        return torch.where(deg > 0, torch.rsqrt(torch.clamp(deg, min=1e-30)),
                           torch.zeros_like(deg))

    cd, rd = inv_sqrt(coldeg), inv_sqrt(rowdeg)
    wn = (wv * torch.gather(rd, 1, loc)).reshape(B, S, D) * cd[:, :, None]
    h = (torch.arange(S)[None, None, :] == sel.long()[:, :, None]).float()
    outs = [torch.bmm(h, x)]
    loc_r = loc[:, None, :].expand(B, R, S * D)
    for _ in range(K):
        h = (torch.gather(h, 2, loc_r).reshape(B, R, S, D) * wn[:, None]).sum(dim=-1)
        outs.append(torch.bmm(h, x))
    return torch.stack(outs, dim=1).numpy()


@pytest.mark.parametrize("mode", ["local", "global"])
@pytest.mark.parametrize("R", [4, 34], ids=["R4", "posplus-R34"])
def test_selector_rows_times_x_match_one_pass_reference_and_jax(mode, R):
    """H from the plain selector phase, times X, with row 0 = X[sel], gives
    the one-pass plain version and the JAX kernel (interpret mode), PoS+'s
    R = 34 included."""
    K, S = 3, 64
    sel, nbr, w, x, row_ids = _inputs(6, B=2, S=S, D=16, F=9, R=R, mode=mode)
    sel[0, 0] = S + 3  # a selected row out of range gives a zero row
    t = torch.as_tensor
    ids = None if row_ids is None else t(row_ids)
    h = pos_selector_rows_reference(t(sel), t(nbr), t(w), sign_k=K, row_ids=ids)
    assert h.shape == (2, K * R, S)
    assert torch.equal(pos_selector_rows(t(sel), t(nbr), t(w), sign_k=K, row_ids=ids), h)
    assert float(h[0, 0::R].abs().max()) == 0.0
    x0 = np.stack([np.where((sel[b] < S)[:, None], x[b, np.minimum(sel[b], S - 1)], 0.0)
                   for b in range(2)])
    got = np.concatenate([x0[:, None], (h.numpy() @ x).reshape(2, K, R, 9)], axis=1)
    np.testing.assert_allclose(got, _one_pass_reference(sel, nbr, w, x, row_ids, K), **TOL)
    # The JAX selected-row chain (the main path's, F > 127) also gives a zero
    # row for a selected row out of range; its full chain reads a clamped row.
    np.testing.assert_allclose(got, _jax(sel, nbr, w, x, row_ids, K, select_rows=True),
                               **TOL)
    np.testing.assert_allclose(_port(sel, nbr, w, x, row_ids, K), got, **TOL)
