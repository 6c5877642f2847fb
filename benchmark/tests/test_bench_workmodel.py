"""The frozen work model on a hand-built graph whose counts are known."""
import numpy as np
import pytest

from benchmark import workmodel
from benchmark.graphs import to_undirected
from benchmark.reference import RefGraph

# A path 0-1-2-3-4 with a chord 1-3 and a pendant 5 on 4:
#   0 - 1 - 2 - 3 - 4 - 5, and 1 - 3.
EDGES = to_undirected(np.array([[0, 1, 2, 3, 4, 1], [1, 2, 3, 4, 5, 3]], np.int32))
X = np.eye(6, dtype=np.float32)


def graph():
    return RefGraph(6, EDGES, X, "cpu")


def test_members_entries_and_degrees():
    # Link (1, 3), an edge: 2 hops reach {0, 2, 4} then {5}; all 6 members.
    # Entries among them: 12 directed minus the link's 2 = 10.
    # Link (0, 2), no edge: hop 1 {1, 3}, hop 2 {4}: 5 members, entries
    # among {0..4}: edges 01 12 23 34 13 = 10 directed.
    w = workmodel.link_work(graph(), np.array([[1, 3], [0, 2]]), num_hops=2, max_nodes=99)
    assert w["members"].tolist() == [6, 5]
    assert w["entries"].tolist() == [10, 10]
    deg = np.bincount(EDGES[0], minlength=6)
    assert w["member_degree"].tolist() == [int(deg.sum()), int(deg[:5].sum())]


def test_the_cap_keeps_the_closest_hops_first():
    # Link (0, 2) capped at 4 members: 0, 2, then hop 1's 1 and 3.
    # Entries among {0, 1, 2, 3}: 01 12 23 13 = 8 directed.
    w = workmodel.link_work(graph(), np.array([[0, 2]]), num_hops=2, max_nodes=4)
    assert w["members"].tolist() == [4]
    assert w["entries"].tolist() == [8]


def test_bytes_and_flops():
    w = {"members": np.array([6, 5]), "entries": np.array([10, 10]),
         "member_degree": np.array([12, 10])}
    F, K = 6, 3
    n_bytes, flops = workmodel.pos_work(w, features=F, sign_k=K)
    assert n_bytes == 4 * 20 + 4 * F * 11 + 4 * (K + 1) * 2 * (F + 1) * 2
    assert flops == K * (2 * 2 * 20 + 2 * 2 * (F + 1) * 11)
    assert workmodel.local_table_work(w) == (4.0 * 11 + 4 * 22 + 4 * 20, 0.0)
    peaks = workmodel.PEAKS["NVIDIA H100 80GB HBM3"]
    assert workmodel.bound_s(3.35e12, 0.0, peaks) == pytest.approx(1.0)
    assert workmodel.bound_s(0.0, 67e12, peaks) == pytest.approx(1.0)


def test_signnet_flops():
    fwd = workmodel.signnet_flops(rows=32, d_in=4104, hidden=256, train=False)
    assert fwd == 2 * 32 * 2 * 4104 * 256 + 2 * 32 * 256 * 256 + 2 * 32 * 256
    train = workmodel.signnet_flops(rows=32, d_in=4104, hidden=256, train=True)
    assert train == 2 * fwd + 2 * 32 * 256 * 256 + 2 * 32 * 256


def test_batching_changes_nothing():
    links = np.array([[1, 3], [0, 2], [5, 0], [2, 4]])
    a = workmodel.link_work(graph(), links, num_hops=2, max_nodes=5)
    b = workmodel.link_work(graph(), links, num_hops=2, max_nodes=5, batch=1)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_an_impossible_share_fails_the_run():
    from benchmark.cellbase import TraceContext
    from benchmark.trace import Profile, roofline_percent

    peaks = workmodel.PEAKS["NVIDIA H100 80GB HBM3"]
    prof = Profile(wall_s=1.0, busy_s=1.0,
                   device_s={"void (anonymous namespace)::pos_xpass_kernel<2>(int)": 1.0})
    ctx = TraceContext(profile=prof, peaks=peaks, work={"pos": (3.35e12 * 0.5, 0.0)})
    assert roofline_percent(ctx, "pos", "pos_") == pytest.approx(50.0)
    ctx.work["pos"] = (3.35e12 * 1.2, 0.0)
    with pytest.raises(ValueError):
        roofline_percent(ctx, "pos", "pos_")
    assert roofline_percent(ctx, "local_table", "local_table") is None
