"""Port, the kernels' work counts (``ops/pos_kernel.work``,
``ops/spmm_kernel.work``) against a brute-force numpy count over the same
tensors, and the card's bound over them (``utils/device.bound_ms``)."""
import numpy as np
import pytest
import torch

from s3grl_tpu_torch.ops import pos_kernel, spmm_kernel
from s3grl_tpu_torch.utils.device import PEAK_RATES, Work, bound_ms, peak_rates
from tests.torch_port_helpers import kernel_inputs, random_edges


def brute_pos_work(sel, nbr, w, x, K, row_ids, node_mask, count):
    """Entry by entry: 8 bytes per table entry read (id and weight; 4, the
    id alone, where ``w`` is None and an entry weighs 1 where its slot is
    >= 0), 4 per feature of each row of X read, 4 per row id read, 4 per
    selected row id, 4 per output value; 2·K·R FLOP per entry that names a
    slot with a nonzero weight, 2·K·R·F per slot read."""
    entry_bytes = 4 if w is None else 8
    if w is None:
        w = (nbr >= 0).astype(np.float32)
    B, S, D = nbr.shape
    R, F = sel.shape[1], x.shape[2]
    n_bytes = 4 * B * R + 4 * B * (K + 1) * R * F
    flops = 0
    for b in range(B):
        slots = set(range(S)) if row_ids is None else {int(i) for i in row_ids[b] if i >= 0}
        for s in range(S):
            read = count == "padded" or bool(node_mask[b, s])
            if read:
                n_bytes += 4 * F + (4 if row_ids is not None else 0)
                flops += 2 * K * R * F
            for d in range(D):
                if read and (count != "live" or w[b, s, d] != 0):
                    n_bytes += entry_bytes
                if w[b, s, d] != 0 and int(nbr[b, s, d]) in slots:
                    flops += 2 * K * R
    return n_bytes, flops


@pytest.mark.parametrize("count", ["members", "padded", "live"])
@pytest.mark.parametrize("mode", ["global", "local", "local slots only"])
def test_pos_work_equals_a_brute_force_count(mode, count):
    """"local slots only": the table of ``ops/local_table`` (-1 where the
    weight was 0) with ``w`` None, which counts no weight array."""
    sel, nbr, w, x, row_ids = kernel_inputs(3, B=2, S=7, D=5, F=3, R=2,
                                            mode=mode.split()[0])
    if mode == "local slots only":
        nbr, w = np.where(w != 0, nbr, -1).astype(np.int32), None
    rng = np.random.default_rng(4)
    mask = row_ids >= 0 if row_ids is not None else rng.random((2, 7)) < 0.7
    t = {k: None if v is None else torch.as_tensor(v)
         for k, v in dict(sel_idx=sel, nbr=nbr, w=w, subg_x=x).items()}
    got = pos_kernel.work(**t, sign_k=3, row_ids=None if row_ids is None else
                          torch.as_tensor(row_ids), node_mask=torch.as_tensor(mask), count=count)
    assert (got.n_bytes, got.flops) == brute_pos_work(sel, nbr, w, x, 3, row_ids, mask, count)


def test_pos_work_without_a_mask_takes_every_slot():
    sel, nbr, w, x, _ = kernel_inputs(5, B=2, S=6, D=4, F=3, R=2, mode="local")
    t = {k: torch.as_tensor(v) for k, v in dict(sel_idx=sel, nbr=nbr, w=w, subg_x=x).items()}
    got = pos_kernel.work(**t, sign_k=2)
    assert (got.n_bytes, got.flops) == brute_pos_work(
        sel, nbr, w, x, 2, None, np.ones((2, 6), bool), "members")
    with pytest.raises(ValueError, match="count"):
        pos_kernel.work(**t, sign_k=2, count="all")


@pytest.mark.parametrize("shard", [False, True])
def test_spmm_work_equals_a_brute_force_count(shard):
    """Over the dense M: 8 bytes and 2·C FLOP per nonzero, the row pointers,
    X read and Y written once."""
    rng = np.random.default_rng(6)
    n, c = 300, 5
    ei = random_edges(rng, n=n, e=700)
    w = rng.random(ei.shape[1]).astype(np.float32)
    rows = 140 if shard else n
    keep = ei[1] < rows
    src, dst, wk = ei[0][keep], ei[1][keep], w[keep]
    adj = spmm_kernel.csr_matrix(src, dst, wk, rows, n, device="cpu")
    dense = np.zeros((rows, n), np.float32)
    np.add.at(dense, (dst, src), wk)
    nnz = int(np.count_nonzero(dense))
    x = torch.zeros((n, c))
    got = spmm_kernel.work(adj, x)
    assert (got.n_bytes, got.flops) == (8 * nnz + 4 * (rows + 1) + 4 * (n + rows) * c,
                                        2 * nnz * c)


def test_bound_takes_the_larger_time_and_an_unknown_card_has_none():
    rates = peak_rates("NVIDIA H100 80GB HBM3")
    assert rates is PEAK_RATES["NVIDIA H100 80GB HBM3"]
    ms, by = bound_ms(Work(n_bytes=3.35e9, flops=1.0), rates)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = bound_ms(Work(n_bytes=1.0, flops=134e9), rates)
    assert (ms, by) == (pytest.approx(2.0), "operations")
    assert peak_rates("Some Other Card") is None
    assert bound_ms(Work(n_bytes=1.0, flops=1.0), None) == (None, None)
