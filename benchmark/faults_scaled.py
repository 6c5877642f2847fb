"""Faults planted under the timed path of PoS Plus on ScaLed's walk
subgraphs, for the tests that see ``correct`` come out false and for
reading a fault's numbers on the card. Each takes an object whose
``setattr`` plants it (pytest's ``monkeypatch``, or one that keeps it),
and wraps a function that ``precompute_pos`` looks up at each call.
``benchmark/faults.py``'s ``PREP`` faults apply too."""
from __future__ import annotations

from benchmark.faults_pos_plus import bf16_storage, union_for_intersection  # noqa: F401


def _wrap_walks(mp, change) -> None:
    import s3grl_tpu_torch.operators.pos as pos

    real = pos.extract_rw_subgraphs

    def planted(dg, links, link_seeds, **kw):
        link_seeds, kw = change(link_seeds, kw)
        return real(dg, links, link_seeds, **kw)
    mp.setattr(pos, "extract_rw_subgraphs", planted)


def walks_from_the_next_seed(mp) -> None:
    """Each link's walks seeded from the next link's seed."""
    _wrap_walks(mp, lambda seeds, kw: (seeds + 1, kw))


def one_step_short(mp) -> None:
    """Walks of length m - 1."""
    _wrap_walks(mp, lambda seeds, kw: (seeds, {**kw, "rw_m": kw["rw_m"] - 1}))


def link_left_in(mp) -> None:
    """The target link left in its walk subgraph's adjacency."""
    import s3grl_tpu_torch.sampling.random_walk as rw

    real = rw.assemble_local_structure

    def planted(*args, **kwargs):
        return real(*args, **{**kwargs, "remove_target_link": False})
    mp.setattr(rw, "assemble_local_structure", planted)


SCALED = ("bf16_storage", "walks_from_the_next_seed", "one_step_short", "link_left_in",
          "union_for_intersection")
