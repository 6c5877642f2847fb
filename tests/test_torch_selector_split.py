"""The rule that splits ``pos_power_rows``' selector phase over (row block,
subgraph), the wrapper's counters on a stubbed launch path, and the
benchmark's reader of those counters, on the CPU. The split kernels
themselves run only on a card (``tests/test_torch_gpu.py``)."""
import numpy as np
import pytest
import torch

from s3grl_tpu_torch import profiling
from s3grl_tpu_torch.ops import pos_kernel as pk

H100_SMS = 132


def _covers(S, P):
    """The row blocks s = p + P·t cover each of the S rows once."""
    rows = [(S - p + P - 1) // P for p in range(P)]
    return sum(rows) == S and min(rows) >= pk.SPLIT_MIN_ROWS


# (B, S, sms, what the rule must give): "one" a single block a subgraph;
# "splits" the least P with two blocks an SM; "floor" as many row blocks
# as keep 32 rows each; "covers" every SM busy, or 96 % where the row
# floor binds (B = 1 at S = 4,096 keeps 32 rows in 128 blocks).
RULE_CASES = (
    [(B, S, H100_SMS, "one") for S in (32, 64, 128, 256, 512) for B in (1, 3, 8, 64, 256, 512)]
    + [(B, S, sms, "one") for B, S, sms in
       [(132, 4096, 132), (133, 1024, 132), (512, 4096, 132), (256, 2048, 132), (114, 4096, 114)]]
    + [(8, 4096, H100_SMS, "splits"), (64, 1024, H100_SMS, "splits"),
       (16, 2048, H100_SMS, "splits"), (32, 1024, H100_SMS, "splits"),
       (131, 4096, H100_SMS, "splits"), (8, 4096, 114, "splits")]
    + [(5, 3000, H100_SMS, "splits")]
    + [(B, 4096, H100_SMS, "covers") for B in range(1, 9)]
    + [(B, S, H100_SMS, "floor") for B, S in [(1, 1024), (2, 1500), (1, 1100), (3, 2048)]]
)


@pytest.mark.parametrize("B,S,sms,want", RULE_CASES,
                         ids=[f"B{b}-S{s}-sms{m}-{w}" for b, s, m, w in RULE_CASES])
def test_selector_row_blocks(B, S, sms, want):
    P = pk.selector_row_blocks(B, S, sms)
    assert P >= 1 and P & (P - 1) == 0
    if want == "one":
        assert P == 1
        return
    assert P > 1 and _covers(S, P)
    at_floor = S // (2 * P) < pk.SPLIT_MIN_ROWS
    if want == "splits":
        assert B * P >= 2 * sms
        assert B * P // 2 < 2 * sms  # the least such power of two
    elif want == "floor":
        assert at_floor and B * P < 2 * sms
    else:
        assert B * P >= sms or (at_floor and min(B * P, sms) >= 0.96 * sms)


def test_selector_row_blocks_follows_its_threshold(monkeypatch):
    assert pk.selector_row_blocks(8, pk.SPLIT_MIN_S // 2, H100_SMS) == 1
    assert pk.selector_row_blocks(8, pk.SPLIT_MIN_S, H100_SMS) > 1
    monkeypatch.setattr(pk, "SPLIT_MIN_S", 512)
    assert pk.selector_row_blocks(8, 512, H100_SMS) > 1


class _StubLib:
    """The kernels' C entries as no-ops that record their calls: the
    wrapper's host path runs whole on the CPU."""

    def __init__(self):
        self.calls = []

    def s3grl_pos_h_width(self, R, K):
        return max(8, -(-K * R // 8) * 8)

    def s3grl_pos_list_cap(self, S, D):
        return min(S * D, 4096)

    def s3grl_pos_selector_smem(self, *args):
        return 1024

    def s3grl_pos_stage_width(self, *args):
        return 0

    def s3grl_pos_selector_split_smem(self, S, has_ids, P):
        return 1024

    def s3grl_pos_selector_rows(self, *args):
        self.calls.append(("one_block", args[8]))
        return 0

    def s3grl_pos_selector_split(self, *args):
        self.calls.append(("split", args[11], args[16]))
        return 0


def _stub_call(monkeypatch, B, S, D=4, R=2, row_blocks=None):
    monkeypatch.setattr(pk, "_sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(pk, "_stream", lambda dev: 0)
    lib = _StubLib()
    sel = torch.zeros((B, R), dtype=torch.int32)
    nbr = torch.zeros((B, S, D), dtype=torch.int32)
    w = torch.ones((B, S, D), dtype=torch.float32)
    ids = torch.arange(B * S, dtype=torch.int32).reshape(B, S)
    before, split_before = profiling.counters(), pk.pos_selector_rows.split_launches
    h = pk._selector_rows_cuda(lib, sel, nbr, w, ids, 3, B, S, D, R, row_blocks=row_blocks)
    after = profiling.counters()
    diff = {k: after[k] - before.get(k, 0) for k in after if k.startswith("pos.selector.")}
    return lib.calls, diff, pk.pos_selector_rows.split_launches - split_before, h


@pytest.mark.parametrize("B,S,P", [(8, 4096, 64), (1, 4096, 128), (64, 1024, 8),
                                   (256, 256, 1), (8, 512, 1), (132, 4096, 1)])
def test_selector_counters_on_a_stubbed_launch(monkeypatch, B, S, P):
    """One selector call adds 1 to ``pos.selector.calls``, P > 1 to
    ``split_calls`` and ``pos_selector_rows.split_launches``, min(B·P, SMs)
    to ``blocks`` and the SMs to ``sm_slots``, and launches the path the
    rule names."""
    calls, diff, split, h = _stub_call(monkeypatch, B, S)
    assert diff == {"pos.selector.calls": 1, "pos.selector.split_calls": int(P > 1),
                    "pos.selector.blocks": min(B * P, H100_SMS),
                    "pos.selector.sm_slots": H100_SMS}
    assert split == int(P > 1)
    assert calls == ([("split", B, P)] if P > 1 else [("one_block", B)])
    assert h.shape == (B, S, 8)


def test_forced_row_blocks_take_the_path_asked_for(monkeypatch):
    calls, diff, split, _ = _stub_call(monkeypatch, 8, 4096, row_blocks=1)
    assert calls == [("one_block", 8)] and split == 0
    assert diff["pos.selector.blocks"] == 8 and diff["pos.selector.split_calls"] == 0
    calls, diff, split, _ = _stub_call(monkeypatch, 300, 256, row_blocks=4)
    assert calls == [("split", 300, 4)] and split == 1
    assert diff["pos.selector.blocks"] == H100_SMS
    with pytest.raises(ValueError, match="row blocks"):
        _stub_call(monkeypatch, 2, 64, row_blocks=65)


def test_cpu_tensors_count_nothing():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing, so the selector's counters stay as they are."""
    before = profiling.counters()
    rng = np.random.default_rng(0)
    sel = torch.as_tensor(rng.integers(0, 16, (2, 2)), dtype=torch.int32)
    nbr = torch.as_tensor(rng.integers(0, 16, (2, 16, 4)), dtype=torch.int32)
    pk.pos_selector_rows(sel, nbr, torch.ones((2, 16, 4)), sign_k=2)
    after = profiling.counters()
    assert {k: v for k, v in after.items() if k.startswith("pos.selector.")} == \
           {k: v for k, v in before.items() if k.startswith("pos.selector.")}


@pytest.mark.parametrize("counters,want", [
    ({"pos.selector.blocks": 8, "pos.selector.sm_slots": 132}, 100.0 * 8 / 132),
    ({"pos.selector.blocks": 132 * 5, "pos.selector.sm_slots": 132 * 5}, 100.0),
    ({"pos.selector.blocks": 8 + 132, "pos.selector.sm_slots": 264, "pos.links": 3},
     100.0 * 140 / 264),
    ({}, None),
    ({"pos.links": 5, "pos.slots": 9}, None),
    ({"pos.selector.blocks": 0, "pos.selector.sm_slots": 0}, None),
    (None, None),
])
def test_selector_sm_fill_reads_the_programs_counters(monkeypatch, counters, want):
    """``prep.selector_sm_fill``: 100 x blocks / SM slots of the program's
    counters; None where the program keeps no such counters (a commit
    before them, or no counters at all)."""
    from benchmark import spec
    from benchmark.cellbase import TraceContext

    if counters is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    got = spec.reader("prep.selector_sm_fill")(TraceContext())
    assert got == (None if want is None else pytest.approx(want))
