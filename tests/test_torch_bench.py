"""Port, ``bench_torch.py`` on the CPU at its toy scale.

Its two JSON lines carry bench.py's keys, the last one enriched; its links
and AUC are those of the JAX package's pipeline (bench.py:439-502 with
``precompute_pos(use_pallas=False)`` and ``fit_signnet``) on the same graph
and seed; a missing dataset and a missing card raise.
"""
import json

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

import bench_torch
import s3grl_tpu.data.graph as jgraph
from s3grl_tpu.data.features import init_features as j_init_features
from s3grl_tpu.data.split import do_edge_split as j_do_edge_split
from s3grl_tpu.operators.pos import precompute_pos as j_precompute_pos
from s3grl_tpu.runner import build_split_links as j_build_split_links
from s3grl_tpu.sampling.extraction import DeviceGraph as JDeviceGraph
from s3grl_tpu.train.loop import fit_signnet as j_fit_signnet
from s3grl_tpu.utils.seeding import seed_everything as j_seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_torch_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)

TOY = ["--device", "cpu", "--scale", "toy", "--epochs", "1"]
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail", "device", "graph"}
DETAIL_KEYS = {"precompute_links_per_sec", "train_links_per_sec",
               "reference_scipy_links_per_sec", "test_auc_at_5_epochs", "total_links"}
SECTIONS = {"kernel_efficiency", "blogcatalog_precompute", "arxiv_precompute"}
# The two packages draw SIGNNet's weights, dropout and batch order from
# different generators, so their AUCs after one epoch agree only this far
# (chip_smoke.AUC_SLACK, in percent: 0.03).
AUC_SLACK = 0.03


@pytest.fixture(scope="module")
def toy_run():
    """(the toy run's JSON lines, its ``run_workload`` result): one run of
    ``main`` for the module, its workload recorded on the way."""
    from contextlib import redirect_stdout
    from io import StringIO

    real, seen = bench_torch.run_workload, []

    def record(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    out = StringIO()
    bench_torch.run_workload = record
    try:
        with redirect_stdout(out):
            rc = bench_torch.main(TOY)
    finally:
        bench_torch.run_workload = real
    assert rc == 0 and len(seen) == 1
    return [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")], seen[0]


def test_prints_the_headline_then_the_enriched_line(toy_run):
    first, last = toy_run[0]
    assert set(first) == HEADLINE_KEYS and set(last) == HEADLINE_KEYS
    assert DETAIL_KEYS <= set(first["detail"]) and not SECTIONS & set(first["detail"])
    assert SECTIONS <= set(last["detail"])
    assert {k: v for k, v in last["detail"].items() if k not in SECTIONS} == first["detail"]
    assert (first["metric"], first["value"]) == (last["metric"], last["value"])
    assert first["metric"] == "edges_per_sec_precompute_plus_train"
    assert first["unit"] == "links/s" and first["value"] > 0 and first["vs_baseline"] > 0
    assert first["device"] == {"name": "cpu", "power_limit": None}
    assert first["graph"].startswith("usair_like_edges(1, n=40)")
    assert last["detail"]["kernel_efficiency"] == {"skipped": "not on cuda"}
    for key in ("blogcatalog_precompute", "arxiv_precompute"):
        sec = last["detail"][key]
        assert sec["links_per_sec"] > 0 and sec["sop_links_per_sec"] > 0, sec
        assert sec["n_links"] == bench_torch.SCALES["toy"]["links"]


def test_links_datasets_and_auc_match_the_jax_pipeline(toy_run):
    """bench.py:439-502 with the JAX package on the toy graph, one epoch:
    the same links, each split's dataset within the operator bar of
    tests/test_pos_pallas.py, and the best test AUC within AUC_SLACK."""
    detail, run = toy_run[0][-1]["detail"], toy_run[1]
    cfg = bench_torch.CONFIG
    n = bench_torch.SCALES["toy"]["nodes"]
    rng, _ = j_seed_everything(cfg["seed"])
    g = jgraph.Graph(num_nodes=n, edge_index=usair_like_edges(cfg["seed"], n=n))
    graph, edge_split = j_do_edge_split(g, val_ratio=0.05, test_ratio=0.1, rng=rng)
    graph = j_init_features(graph, cfg["init_features"])
    splits = {s: j_build_split_links(s, edge_split, 100.0, rng)
              for s in ("train", "valid", "test")}
    assert detail["total_links"] == sum(len(lk) for lk, _ in splits.values())
    dg = JDeviceGraph.from_graph(graph)
    kw = dict(num_hops=cfg["num_hops"], sign_k=cfg["sign_k"],
              buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096), batch_size=512,
              max_subgraph_nodes=4096, seed=cfg["seed"], use_pallas=False)
    ds = {s: j_precompute_pos(dg, lk, y, **kw) for s, (lk, y) in splits.items()}
    for s, want in ds.items():
        got = run["datasets"][s]
        np.testing.assert_array_equal(np.asarray(want.row_mask), got.row_mask.numpy())
        np.testing.assert_allclose(np.asarray(want.xs), got.xs.numpy(), rtol=2e-3, atol=2e-4)
        np.testing.assert_array_equal(np.asarray(want.y), np.asarray(got.y))
    fit = j_fit_signnet(ds["train"], ds["valid"], ds["test"], sign_k=cfg["sign_k"],
                        hidden_channels=cfg["hidden_channels"], batch_size=cfg["batch_size"],
                        lr=cfg["lr"], epochs=1, dropout=0.5, seed=cfg["seed"])
    jax_auc = max(r["AUC"][1] for r, _ in fit.results_per_epoch)
    print(f"toy AUC: port {detail['test_auc_at_5_epochs']}, JAX {jax_auc}")
    assert detail["test_auc_at_5_epochs"] >= jax_auc - AUC_SLACK, (detail, jax_auc)


def test_a_missing_dataset_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        bench_torch.main(TOY + ["--dataset", "USAir", "--data_root", str(tmp_path)])


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main([])


def test_a_failing_section_exits_1_after_both_lines(monkeypatch, capsys):
    def fail(*a, **kw):
        raise ValueError("boom")

    run = dict(total_links=10, n_train=4, t_precompute=1.0, t_train=1.0, ref_rate=2.0,
               launches=0, best_auc=0.5)
    monkeypatch.setattr(bench_torch, "run_workload", lambda *a, **kw: dict(run))
    monkeypatch.setattr(bench_torch, "large_graph_precompute_rate", fail)
    assert bench_torch.main(TOY) == 1
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 2 and lines[0]["value"] == 7.0
    for key in ("blogcatalog_precompute", "arxiv_precompute"):
        assert lines[1]["detail"][key] == {"failed": "ValueError: boom"}
