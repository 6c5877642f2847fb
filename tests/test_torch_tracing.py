"""The port's spans and counters (``s3grl_tpu_torch/profiling.py``) on the
CPU: no span without a profiler, the spans of ``precompute_pos`` and
``fit_signnet`` nested as ``PERF.md`` lists them on each route, the
counters equal to what the plan and the loop do, the same bits with and
without a profiler, and the spans in ``torch_trace``'s Chrome trace."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import s3grl_tpu_torch.data.graph as tgraph
import s3grl_tpu_torch.operators.pos as tpos
import s3grl_tpu_torch.sampling.extraction as text
from s3grl_tpu_torch import native, profiling
from s3grl_tpu_torch.train.loop import fit_signnet
from tests.torch_port_helpers import one_torch_thread, random_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

POS_KW = dict(num_hops=2, sign_k=2, buckets=(16, 32, 64), batch_size=8, max_subgraph_nodes=64,
              seed=3, device="cpu")
ROUTES = {  # route -> (S3GRL_TPU_HOST_EXTRACT, whole-split host table)
    "host-whole": ("1", True), "host-batch": ("1", False), "device": ("0", True)}


def _graph(seed=5, n=90, e=300, n_links=48):
    rng = np.random.default_rng(seed)
    ei = random_edges(rng, n, e)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    dg = text.DeviceGraph.from_graph(tgraph.Graph(edge_index=ei, num_nodes=n, x=x),
                                     device="cpu")
    links = rng.integers(0, n, (n_links, 2)).astype(np.int32)
    links = links[links[:, 0] != links[:, 1]]
    y = (np.arange(len(links)) % 2).astype(np.float32)
    return dg, links, y


def _route(monkeypatch, route, table="global"):
    host, whole = ROUTES[route]
    monkeypatch.setenv("S3GRL_TPU_HOST_EXTRACT", host)
    monkeypatch.setenv("S3GRL_TPU_LOCAL_TAB", "1" if table == "local" else "0")
    if not whole:
        monkeypatch.setattr(tpos, "KHOP_TABLE_ENTRIES", 0)


def _spans(prof):
    """The program's spans of a session: the main thread's user annotations."""
    return [e for e in prof.events()
            if getattr(e, "is_user_annotation", False) and e.name.startswith(("pos.", "fit."))]


def _ancestors(e):
    out = []
    p = e.cpu_parent
    while p is not None:
        out.append(p.name)
        p = p.cpu_parent
    return out


def test_without_a_profiler_a_span_is_the_shared_null_context():
    a, b = profiling.span("pos.precompute"), profiling.span("fit.step")
    assert a is b is profiling._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with a:  # made before the session: records nothing inside it
            torch.ones(4).sum()
    assert not _spans(prof)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.span("pos.plan") is not profiling._NULL_SPAN
        with profiling.span("pos.plan"):
            torch.ones(4).sum()
    assert [e.name for e in _spans(prof)] == ["pos.plan"]


def test_counters_are_a_copy_and_count_once_per_call():
    before = profiling.counters()
    profiling.count("pos.batches")
    profiling.count("pos.links", 7)
    got = profiling.counters()
    got["pos.links"] = -1
    after = profiling.counters()
    assert after["pos.batches"] - before.get("pos.batches", 0) == 1
    assert after["pos.links"] - before.get("pos.links", 0) == 7


@pytest.mark.parametrize("table", ["global", "local"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_precompute_pos_spans_nest_as_listed(monkeypatch, route, table):
    dg, links, y = _graph()
    _route(monkeypatch, route, table)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tpos.precompute_pos(dg, links, y, **POS_KW)
    spans = _spans(prof)
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    nodes = "host" if route.startswith("host") else "device"
    bfs = f"pos.{nodes}_bfs"
    batches = [k for k in by if k.startswith("pos.batch/")]
    assert batches and all(k.split("/")[1:3] == [nodes, table] for k in batches), sorted(by)
    assert {int(k.split("/")[3]) for k in batches} <= {16, 32, 64}
    assert len(by["pos.precompute"]) == 1 and not _ancestors(by["pos.precompute"][0])
    assert [_ancestors(e) for e in by["pos.plan"]] == [["pos.precompute"]]
    assert any(_ancestors(e)[:2] == ["pos.plan", "pos.precompute"] for e in by[bfs])
    for k in batches:
        assert all(_ancestors(e) == ["pos.precompute"] for e in by[k])
    n_batches = sum(len(by[k]) for k in batches)
    for name in ("pos.inputs", "pos.kernel", "pos.store"):
        assert len(by[name]) == n_batches
        assert all(_ancestors(e)[0].startswith("pos.batch/") for e in by[name])
    in_batches = [e for e in by[bfs] if _ancestors(e)[0].startswith("pos.batch/")]
    assert len(in_batches) == (0 if route == "host-whole" else n_batches)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_counters_equal_the_plan(monkeypatch, route):
    dg, links, y = _graph(seed=9)
    _route(monkeypatch, route)
    plan = tpos.pos_plan(dg, links, **{k: v for k, v in POS_KW.items() if k != "device"})
    sizes = tpos.subgraph_sizes(dg, links, **{k: v for k, v in POS_KW.items()
                                              if k not in ("device", "sign_k")})
    before = profiling.counters()
    tpos.precompute_pos(dg, links, y, **POS_KW)
    after = profiling.counters()
    got = {k: after[k] - before.get(k, 0) for k in after
           if k.startswith("pos.") and after[k] != before.get(k, 0)}
    nodes = "host_bfs" if route.startswith("host") else "device_bfs"
    used = sum(int(np.minimum(sizes[idx], b).sum()) for b, idx in plan.batches)
    # By id a batch's kernel inputs are its row ids [B, S], selected rows
    # [B, 2] and links [B, 2], int32.
    built = sum(4 * len(idx) * (b + 4) for b, idx in plan.batches)
    # The whole-split table at the cap serves every host batch.
    table = {"pos.links.host_table": len(links)} if route == "host-whole" else {}
    assert got == {
        "pos.batches": len(plan.batches), "pos.links": len(links),
        f"pos.links.{nodes}": len(links), "pos.links.global_table": len(links),
        "pos.slots_used": used, "pos.slots": sum(b * len(idx) for b, idx in plan.batches),
        "pos.inputs.by_id": len(plan.batches), "pos.inputs.bytes": built,
        "pos.store.f32": 1, **table}
    assert 0 < used < got["pos.slots"]


@pytest.mark.parametrize("width", [50, 0], ids=["partial-table", "no-table"])
def test_host_table_counts_the_links_it_served(monkeypatch, width):
    """``pos.links.host_table``: with the host table at a width W below the
    cap (every size here is 38-79, cap 64), the links of the batches whose
    bucket is at most W or whose sizes all lie below it; with no table
    (``KHOP_TABLE_ENTRIES`` 0), none."""
    dg, links, y = _graph(seed=9)
    _route(monkeypatch, "host-whole")
    monkeypatch.setattr(tpos, "KHOP_TABLE_ENTRIES", width * len(links))
    kw = {k: v for k, v in POS_KW.items() if k != "device"}
    sizes = native.bfs_sizes(*dg.host_csr(), links, kw["num_hops"])
    plan = tpos.pos_plan(dg, links, **kw)
    served = sum(len(idx) for b, idx in plan.batches
                 if width and (b <= width or (sizes[idx] < width).all()))
    before = profiling.counters()
    tpos.precompute_pos(dg, links, y, **POS_KW)
    after = profiling.counters()
    got = {k: after.get(k, 0) - before.get(k, 0)
           for k in ("pos.links.host_table", "pos.links.host_bfs")}
    assert got == {"pos.links.host_table": served, "pos.links.host_bfs": len(links)}
    assert (0 < served < len(links)) if width else served == 0


def test_walk_batches_count_slots_summed_on_the_card():
    """Walk batches count no slot from host sizes, which the plan does not
    have: their filled slots are the walks' members summed on the card
    (``pos.walks.members``, each below the bucket), and their slots the
    bucket a link; the membership masks count B·N a batch."""
    dg, links, y = _graph(seed=2)
    plan = tpos.pos_plan(dg, links, rw_m=2, rw_M=4,
                         **{k: v for k, v in POS_KW.items() if k != "device"})
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tpos.precompute_pos(dg, links, y, rw_m=2, rw_M=4, **POS_KW)
    after = profiling.counters()
    got = {k: after[k] - before.get(k, 0) for k in after if k.startswith("pos.")}
    assert got["pos.links"] == got["pos.links.walks"] == got["pos.links.local_table"] \
        == len(links)
    assert got["pos.slots"] == sum(b * len(idx) for b, idx in plan.batches)
    assert 2 * len(links) < got["pos.slots_used"] == got["pos.walks.members"] < got["pos.slots"]
    assert got["pos.walks.mask_entries"] == len(links) * dg.num_nodes
    assert got.get("pos.ccn.rows", 0) == got.get("pos.ccn.slots", 0) == 0
    assert {e.name.split("/")[1] for e in _spans(prof) if e.name.startswith("pos.batch/")} \
        == {"walks"}


def _datasets():
    dg, links, y = _graph(seed=4, n=70, n_links=60)
    ds = tpos.precompute_pos(dg, links, y, **POS_KW)
    return ds, ds, ds


FIT_KW = dict(sign_k=2, hidden_channels=8, batch_size=16, lr=1e-2, epochs=2, dropout=0.5,
              eval_steps=1, seed=6, device="cpu")


def test_fit_signnet_spans_and_counters():
    ds = _datasets()
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fit_signnet(*ds, **FIT_KW)
    after = profiling.counters()
    steps = -(-len(ds[0].y) // FIT_KW["batch_size"]) * FIT_KW["epochs"]
    names = [e.name for e in _spans(prof)]
    assert after["fit.steps"] - before.get("fit.steps", 0) == names.count("fit.step") == steps
    assert after["fit.evals"] - before.get("fit.evals", 0) == names.count("fit.eval") == 2
    assert names.count("fit.setup") == 1 and names.count("fit.auc") == 2
    assert names.count("fit.epoch") == names.count("fit.epoch_read") == FIT_KW["epochs"]
    for e in _spans(prof):
        want = {"fit.setup": [], "fit.epoch": [], "fit.step": ["fit.epoch"],
                "fit.epoch_read": ["fit.epoch"], "fit.eval": ["fit.epoch"],
                "fit.auc": ["fit.eval", "fit.epoch"]}[e.name]
        assert _ancestors(e) == want, (e.name, _ancestors(e))


def test_outputs_are_the_same_bits_under_a_profiler(monkeypatch):
    dg, links, y = _graph(seed=8)
    _route(monkeypatch, "device")
    want = tpos.precompute_pos(dg, links, y, **POS_KW)
    fit_want = fit_signnet(want, want, want, **FIT_KW)
    with profile(activities=[ProfilerActivity.CPU]):
        got = tpos.precompute_pos(dg, links, y, **POS_KW)
        fit_got = fit_signnet(got, got, got, **FIT_KW)
    assert torch.equal(got.xs, want.xs) and torch.equal(got.row_mask, want.row_mask)
    xs = torch.randn(5, *want.xs.shape[1:], generator=torch.Generator().manual_seed(0))
    flat = xs.permute(0, 2, 1, 3).reshape(5, xs.shape[2], -1)
    mask = torch.ones(5, xs.shape[2], dtype=torch.bool)
    with torch.no_grad():
        logits = [f.model.eval()(flat, mask) for f in (fit_want, fit_got)]
    assert torch.equal(logits[0], logits[1])
    assert fit_got.results_per_epoch[-1][0] == fit_want.results_per_epoch[-1][0]


def test_torch_trace_writes_the_spans(tmp_path, monkeypatch):
    dg, links, y = _graph(seed=1)
    _route(monkeypatch, "device")
    with profiling.torch_trace(str(tmp_path)):
        tpos.precompute_pos(dg, links, y, **POS_KW)
    with open(os.path.join(tmp_path, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"pos.precompute", "pos.plan", "pos.device_bfs", "pos.inputs", "pos.kernel",
            "pos.store"} <= names
    assert any(n and n.startswith("pos.batch/device/global/") for n in names)


def _span_report():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "span_report.py")
    spec = importlib.util.spec_from_file_location("span_report", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, start, end, thread=1, annotation=False, device=None):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, thread=thread, is_user_annotation=annotation,
                           device_type=device or DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def test_span_table_self_time_launches_and_syncs():
    """Nested spans with a gap between them, a launch and a wait inside a
    nested span, a launch from another thread (as the autograd engine's)
    while it is open, a synchronous copy in the gap, and what is not
    counted: an asynchronous copy, a launch outside every span, torch's own
    annotation, the span of a thread with fewer of them and the device's
    copy of an annotation."""
    from torch.autograd import DeviceType

    rep = _span_report()
    events = [
        _event("ProfilerStep#1", 0, 200, annotation=True),
        _event("pos.precompute", 0, 100, annotation=True),
        _event("pos.plan", 5, 20, annotation=True),
        _event("aten::empty", 6, 8),
        _event("cudaMemcpy", 25, 26),
        _event("cudaMemcpyAsync", 27, 28),
        _event("pos.batch/host/global/64", 30, 90, annotation=True),
        _event("pos.kernel", 40, 60, annotation=True),
        _event("cudaLaunchKernel", 45, 46),
        _event("cudaStreamSynchronize", 50, 58),
        _event("cudaLaunchKernel", 55, 56, thread=3),
        _event("Optimizer.step#Adam.step", 62, 64, annotation=True),
        _event("cudaLaunchKernel", 150, 151),
        _event("pos.precompute", 0, 100, thread=2, annotation=True),
        _event("pos.kernel", 44, 70, annotation=True, device=DeviceType.CUDA),
    ]
    got = rep.span_table(events)
    assert set(got) == {"pos.precompute", "pos.plan", "pos.batch/host/global/64", "pos.kernel"}
    want = {"pos.precompute": (100, 25, 2, 2), "pos.plan": (15, 15, 0, 0),
            "pos.batch/host/global/64": (60, 40, 2, 1), "pos.kernel": (20, 20, 2, 1)}
    for name, (total, own, launches, syncs) in want.items():
        row = got[name]
        assert row["n"] == 1 and (row["launches"], row["syncs"]) == (launches, syncs), name
        assert row["total_s"] == pytest.approx(total * 1e-6)
        assert row["self_s"] == pytest.approx(own * 1e-6)
        assert row["median_ms"] == pytest.approx(total * 1e-3)
    r = rep.readings(got, {"pos.slots": 64, "pos.slots_used": 48}, 200e-6, "prep")
    assert r == pytest.approx({"prep.syncs_per_batch": 2.0, "prep.slot_fill": 75.0})
    device = [_event(f"kernel{i}", a, b, thread=9, device=DeviceType.CUDA)
              for i, (a, b) in enumerate([(10, 12), (30, 32), (44, 46), (95, 97), (150, 160)])]
    idle = rep.idle_by_span(events + device)
    assert idle == pytest.approx({"pos.batch/host/global/64": 61e-6, rep.OUTSIDE: 53e-6,
                                  "pos.precompute": 18e-6})


def test_span_readings_leave_out_what_is_missing():
    rep = _span_report()
    assert rep.readings({}, {}, 1.0, "prep") == {}
    table = {"fit.step": {"n": 4, "total_s": 0.02, "self_s": 0.02, "launches": 600, "syncs": 0,
                          "median_ms": 5.0},
             "fit.eval": {"n": 1, "total_s": 0.1, "self_s": 0.1, "launches": 9, "syncs": 3,
                          "median_ms": 100.0},
             "pos.device_bfs": {"n": 2, "total_s": 0.3, "self_s": 0.25, "launches": 0,
                                "syncs": 2, "median_ms": 150.0}}
    assert rep.readings(table, {"fit.steps": 4}, 1.0, "score") == pytest.approx(
        {"fit.step_launches": 150.0, "fit.step_host_ms": 5.0, "fit.eval_share": 10.0,
         "score.bfs_share": 25.0})


@pytest.mark.parametrize("cell", ["usair_pos.prep", "usair_pos.fit"])
def test_span_report_reads_a_traced_benchmark_run(tmp_path, cell):
    """The benchmark's traced run at its tiny CPU size, read by span: the
    program's spans and counters of the profiled slice, and the readings."""
    from benchmark.tests.tiny import make_tiny

    rep = _span_report()
    root, bench = make_tiny(str(tmp_path))
    result, events, delta = rep.traced_run(cell, 2**33 + 7, root=root, bench_dir=bench,
                                           device="cpu")
    assert result["correct"], result["checks"]
    table = rep.span_table(events)
    got = rep.readings(table, delta, result["device"]["window_s"], cell.split(".")[1])
    assert set(rep.idle_by_span(events)) <= set(table) | {rep.OUTSIDE}
    if cell.endswith(".prep"):
        assert delta["pos.links"] > 0 and delta["pos.batches"] == table["pos.store"]["n"]
        assert delta["pos.batches"] == sum(r["n"] for k, r in table.items()
                                           if k.startswith("pos.batch/"))
        assert set(got) == {"prep.bfs_share", "prep.syncs_per_batch", "prep.slot_fill"}
        assert 0 < got["prep.bfs_share"] < 100 and 0 < got["prep.slot_fill"] <= 100
        assert got["prep.syncs_per_batch"] == 0  # no card: no runtime calls
    else:
        assert delta["fit.steps"] == table["fit.step"]["n"] > 0
        assert delta["fit.evals"] == table["fit.eval"]["n"] == 1
        assert {"fit.step_launches", "fit.step_host_ms", "fit.eval_share"} <= set(got)
        assert got["fit.step_launches"] == 0 and 0 < got["fit.eval_share"] < 100


@pytest.mark.parametrize("counters,want", [
    ({"fit.steps": 228, "fit.graph_steps": 225, "fit.captures": 1}, 100.0 * 225 / 228),
    ({"fit.steps": 4 * 1140, "fit.graph_steps": 4 * 1137, "fit.evals": 20},
     100.0 * 1137 / 1140),
    ({"fit.steps": 10, "fit.graph_steps": 0}, 0.0),
    ({"fit.steps": 228, "fit.evals": 1}, None),
    ({}, None),
    ({"fit.steps": 0, "fit.graph_steps": 0}, None),
    (None, None),
])
def test_graph_step_share_reads_the_programs_counters(monkeypatch, counters, want):
    """``fit.graph_step_share``: 100 x replayed steps / all steps of the
    program's counters; None where the program keeps no ``fit.graph_steps``
    (a commit before the graphed step, or no counters at all)."""
    from benchmark import spec
    from benchmark.cellbase import TraceContext

    if counters is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    got = spec.reader("fit.graph_step_share")(TraceContext())
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("counters,want", [
    ({"pos.links.host_bfs": 17_952, "pos.links.host_table": 17_952}, 100.0),
    ({"pos.links.host_bfs": 40, "pos.links.host_table": 8}, 20.0),
    ({"pos.links.host_bfs": 40, "pos.links.host_table": 0}, 0.0),
    ({"pos.links.host_bfs": 40}, None),
    ({"pos.links.device_bfs": 526, "pos.links": 526}, None),
    ({"pos.links.host_bfs": 0, "pos.links.host_table": 0}, None),
    ({}, None),
    (None, None),
])
def test_host_table_share_reads_the_programs_counters(monkeypatch, counters, want):
    """``prep.host_table_share``: 100 x the host links the plan's table
    served / every host link; None where no link took the host route or the
    program keeps no ``pos.links.host_table`` (a commit before it, or no
    counters at all)."""
    from benchmark import spec
    from benchmark.cellbase import TraceContext

    if counters is None:
        monkeypatch.delattr(profiling, "counters")
    else:
        monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    got = spec.reader("prep.host_table_share")(TraceContext())
    assert got == (None if want is None else pytest.approx(want))
