"""The readers of the program's own counters: a value where the program
keeps them, None where it keeps none (as at a commit before them)."""
import pytest

from benchmark import spec
from benchmark.cellbase import TraceContext


def test_slot_fill_reads_the_programs_counters(monkeypatch):
    import s3grl_tpu_torch.profiling as profiling

    monkeypatch.setattr(profiling, "counters", lambda: {"pos.slots": 8, "pos.slots_used": 2})
    assert spec.reader("prep.slot_fill")(TraceContext()) == pytest.approx(25.0)


@pytest.mark.parametrize("counters", [{}, {"pos.links": 5}, None])
def test_slot_fill_is_none_without_its_counters(monkeypatch, counters):
    import s3grl_tpu_torch.profiling as profiling

    if counters is None:  # a program with no counters at all
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    assert spec.reader("prep.slot_fill")(TraceContext()) is None
