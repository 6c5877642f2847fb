"""Port parity, the tooling around a run: checkpoints (``train/checkpoint.py``
and ``fit_signnet``'s four flags), profiling, the suite manager, tuning,
the calc_ratio analyzer and the OGB loader, with the runner's profile,
checkpoint and OGB routes.

The checkpoint flows are tests/test_checkpoint_modes.py's, with an exact
``only_test`` score; the profile schema tests/test_sidecars.py:130's; the
manager, tuning and calc_ratio flows tests/test_sidecars.py's with the
runner stubbed, and the copied logic gives the JAX package's own results
on the same stubs; SEAL subgraph counts are bit-exact with the JAX
package's; the OGB loader reads what the JAX package reads from the same
directory (tests/test_ogb.py:100-166) and OGB Hits@K and MRR runs finish
(tests/test_ogb.py:251-277) on the synthetic graph.
"""
import gzip
import json
import os

import numpy as np
import pytest
import torch

import s3grl_tpu.manager as jmgr
import s3grl_tpu.tuning as jtune
from s3grl_tpu.analysis import subgraph_counts as j_subgraph_counts
from s3grl_tpu.data.graph import Graph as JGraph
from s3grl_tpu.data.ogb import load_ogb_dataset as j_load_ogb
from s3grl_tpu.sampling.extraction import DeviceGraph as JDeviceGraph
import s3grl_tpu_torch.manager as tmgr
import s3grl_tpu_torch.runner as trunner
import s3grl_tpu_torch.tuning as ttune
from s3grl_tpu_torch.analysis import calc_ratio_helper, subgraph_counts
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.data.ogb import load_ogb_dataset
from s3grl_tpu_torch.data.split import OgbEdgeSplit, do_edge_split, get_pos_neg_edges
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.profiling import (
    count_parameters,
    device_memory_stats,
    model_size_mb,
    parse_profiling_data,
    profile_helper,
    torch_trace,
)
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.train.checkpoint import checkpoint_paths, saved_epochs
from s3grl_tpu_torch.train.loop import fit_signnet
from s3grl_tpu_torch.utils.seeding import seed_everything
from tests.torch_port_helpers import one_torch_thread, usair_like_edges

one_thread = pytest.fixture(autouse=True, scope="module")(one_torch_thread)


def _toy_ds(rng, n=64, k=2, r=2, f=6):
    xs = rng.normal(size=(n, k + 1, r, f)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.float32)
    xs[y > 0.5] += 0.8  # learnable: shift the positives
    return OperatorDataset(xs=torch.as_tensor(xs), row_mask=torch.ones((n, r), dtype=torch.bool),
                           y=y)


def _synthetic_split(seed=1):
    g = Graph(num_nodes=332, edge_index=usair_like_edges(seed))
    rng, _ = seed_everything(seed)
    return do_edge_split(g, rng=rng)


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_resume_only_test_and_multi(tmp_path):
    """tests/test_checkpoint_modes.py's flows: resume trains the one epoch
    left; only_test scores the restored final checkpoint and reproduces the
    final score exactly; test_multiple_models scores every checkpoint."""
    rng = np.random.default_rng(0)
    tr, va, te = _toy_ds(rng), _toy_ds(rng, 32), _toy_ds(rng, 32)
    kw = dict(sign_k=2, hidden_channels=16, batch_size=16, lr=1e-2, dropout=0.0, seed=1,
              res_dir=str(tmp_path), device="cpu")

    fit = fit_signnet(tr, va, te, epochs=3, checkpoint_training=True, **kw)
    assert len(fit.results_per_epoch) == 3
    assert saved_epochs(str(tmp_path), 1) == [1, 2, 3]
    for e in (1, 2, 3):
        assert all(os.path.exists(p) for p in checkpoint_paths(str(tmp_path), 1, e))
    assert checkpoint_paths(str(tmp_path), 1, 3)[0].endswith("run1_model_checkpoint3.pth")

    fit2 = fit_signnet(tr, va, te, epochs=3, continue_from=2, **kw)
    assert len(fit2.train_times) == 1 and len(fit2.results_per_epoch) == 1
    # The shuffle starts again from the seed on resume, as in the JAX package.
    assert np.isfinite(fit2.results_per_epoch[0][0]["AUC"][1])

    fit3 = fit_signnet(tr, va, te, epochs=3, continue_from=3, only_test=True, **kw)
    assert fit3.train_times == [] and len(fit3.results_per_epoch) == 1
    assert fit3.results_per_epoch[0][0]["AUC"] == fit.results_per_epoch[-1][0]["AUC"]

    fit4 = fit_signnet(tr, va, te, epochs=3, test_multiple_models=True, **kw)
    assert len(fit4.results_per_epoch) == 3
    for got, want in zip(fit4.results_per_epoch, fit.results_per_epoch):
        assert got[0]["AUC"] == want[0]["AUC"]


def test_checkpoint_holds_batch_norm_buffers_and_optimizer(tmp_path):
    rng = np.random.default_rng(1)
    tr, va, te = _toy_ds(rng), _toy_ds(rng, 16), _toy_ds(rng, 16)
    fit = fit_signnet(tr, va, te, sign_k=2, hidden_channels=8, batch_size=16, epochs=1,
                      seed=1, checkpoint_training=True, res_dir=str(tmp_path), device="cpu")
    model_path, opt_path = checkpoint_paths(str(tmp_path), 1, 1)
    state = torch.load(model_path, weights_only=True)
    assert any(k.endswith("running_mean") for k in state)
    for k, v in fit.model.state_dict().items():
        assert torch.equal(state[k], v), k
    opt_state = torch.load(opt_path, weights_only=True)
    assert opt_state["state"] and "exp_avg" in next(iter(opt_state["state"].values()))


def test_runner_checkpoint_resume(tmp_path):
    """tests/test_models_extra.py:165-181 through the port's runner."""
    graph, split = _synthetic_split()
    base = dict(dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
                init_features="degree", use_feature=True, sign_k=2, node_label="zo",
                hidden_channels=16, batch_size=32, lr=1e-3, seed=1, num_hops=1,
                train_percent=15.0, val_percent=40.0, test_percent=40.0,
                max_subgraph_nodes=128, subgraph_buckets=(64, 128), delete_dataset=True,
                res_dir=str(tmp_path), checkpoint_training=True, results_dir=str(tmp_path))
    trunner.run_sgrl_learning(RunConfig(**base, epochs=2), graph, split, device="cpu")
    assert os.path.exists(tmp_path / "run1_model_checkpoint2.pth")
    _, best, tt, _, _ = trunner.run_sgrl_learning(
        RunConfig(**base, epochs=3, continue_from=2), graph, split, device="cpu")
    assert len(tt) == 1 and best > 50.0


def test_runner_names_the_checkpoint_pattern_when_none_is_found(tmp_path):
    graph, split = _synthetic_split()
    cfg = RunConfig(dataset="USAir", sign_type="PoS", optimize_sign=True,
                    init_features="degree", sign_k=1, num_hops=1,
                    hidden_channels=8, epochs=1, train_percent=5.0, val_percent=20.0,
                    test_percent=20.0, max_subgraph_nodes=128, delete_dataset=True,
                    test_multiple_models=True, res_dir=str(tmp_path / "empty"),
                    results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match=r"run1_model_checkpoint\*\.pth"):
        trunner.run_sgrl_learning(cfg, graph, split, device="cpu")


# ------------------------------------------------------------------ profiling
def test_profile_helper_schema(tmp_path):
    """tests/test_sidecars.py:130: the JAX package's keys, a parameter count
    over a state dict, and the collation across seeds."""
    from s3grl_tpu.profiling import profile_helper as j_profile_helper

    params = {"w": np.zeros((4, 4), np.float32)}
    stats = profile_helper([0.1, 0.2], [0.05], 1.5, params, dataset_num_links=10,
                           stats_suffix="SIGN_USAir_x_seed_1", out_dir=str(tmp_path))
    assert stats["num_parameters"] == 16
    want = j_profile_helper([0.1, 0.2], [0.05], 1.5, params, dataset_num_links=10,
                            stats_suffix="jax", out_dir=str(tmp_path / "jax"))
    assert set(stats) == set(want)
    assert set(stats["device_memory"]) == set(want["device_memory"])
    for k in ("train_time_per_epoch_s", "inference_time_per_epoch_s", "total_prep_time_s",
              "model_size_mb", "num_parameters", "dataset_num_links"):
        assert stats[k] == want[k], k
    profile_helper([0.3], [0.07], 1.0, params, dataset_num_links=10,
                   stats_suffix="SIGN_USAir_x_seed_2", out_dir=str(tmp_path))
    combined = parse_profiling_data(str(tmp_path))
    assert combined["SIGN_USAir_x"]["runs"] == 2
    assert combined["SIGN_USAir_x"]["total_prep_time_s"] == pytest.approx(1.25)
    assert os.path.exists(tmp_path / "collated_csv.csv")


def test_device_memory_stats_off_the_card_are_zeros():
    assert device_memory_stats("cpu") == {"max_allocated_mb": 0.0, "allocated_mb": 0.0,
                                          "reserved_mb": 0.0, "total_mb": 0.0}


def test_parameter_count_and_size_of_a_module():
    m = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    assert count_parameters(m) == 4 * 3 + 3 + 3 + 3
    # parameters and buffers (running mean, var, and the batch counter)
    n_bytes = sum(t.numel() * t.element_size() for t in m.state_dict().values())
    assert model_size_mb(m) == pytest.approx(n_bytes / 2**20)


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with torch_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    with torch_trace(""):  # no directory: no trace
        pass


def test_runner_profile_route_writes_stats(tmp_path):
    graph, split = _synthetic_split()
    cfg = RunConfig(dataset="USAir", sign_type="PoS", optimize_sign=True,
                    init_features="degree", sign_k=1, num_hops=1,
                    hidden_channels=8, epochs=2, train_percent=5.0, val_percent=20.0,
                    test_percent=20.0, max_subgraph_nodes=128, delete_dataset=True,
                    profile=True, save_appendix="_p", results_dir=str(tmp_path))
    _, _, _, _, n_params = trunner.run_sgrl_learning(cfg, graph, split, device="cpu")
    with open(tmp_path / "stats" / "stats_SIGN_USAir__p_seed_1.json") as f:
        stats = json.load(f)
    assert stats["num_parameters"] == n_params
    assert stats["device_memory"]["max_allocated_mb"] == 0.0  # the CPU has no card stats
    assert stats["train_time_per_epoch_s"]["mean"] > 0


# -------------------------------------------------------------------- manager
SUITE = {
    "datasets": {
        "Fake_PoS": {
            "ds_params": {"runs": 3, "seeds": [1, 2, 3], "dataset": "USAir"},
            "hyperparams_per_run": {"model": "SIGN", "sign_type": "PoS",
                                    "optimize_sign": True},
        },
        "Fake_AA": {
            "ds_params": {"runs": 2, "seeds": [4, 5], "dataset": "USAir"},
            "hyperparams_per_run": {"model": "SIGN", "use_heuristic": "AA", "epochs": 1},
        },
    }
}


def _stub(cfg, device=None):
    return 1.0 + cfg.seed, 0.90 + 0.01 * cfg.seed, [0.1, 0.2 * cfg.seed], [0.05], 123


def _write_suite(tmp_path):
    path = tmp_path / "suite.json"
    path.write_text(json.dumps(SUITE))
    return str(path)


def test_manager_results_match_the_jax_managers(tmp_path, monkeypatch):
    """The results JSON of both managers on the same suite and the same
    stubbed runs is the same, but for the measured runtimes."""
    suite = _write_suite(tmp_path)
    monkeypatch.setattr(tmgr, "run_sgrl_learning", _stub)
    monkeypatch.setattr(jmgr, "run_sgrl_learning", lambda cfg: _stub(cfg))
    got = tmgr.sgrl_master_controller(suite, str(tmp_path / "t.json"))
    want = jmgr.sgrl_master_controller(suite, str(tmp_path / "j.json"))
    assert set(got) == set(want) == {"Fake_PoS", "Fake_AA"}
    for ident in got:
        g, w = got[ident], want[ident]
        for d in (g, w):
            d["results"].pop("Average Runtime")
            d["raw"].pop("total_run_times")
        assert g == w, ident
    with open(tmp_path / "t.json") as f:
        assert json.load(f)["Fake_PoS"]["n_runs"] == 3


def test_manager_only_and_max_seeds(tmp_path, monkeypatch):
    suite = _write_suite(tmp_path)
    monkeypatch.setattr(tmgr, "run_sgrl_learning", _stub)
    out = tmgr.sgrl_master_controller(suite, str(tmp_path / "o.json"), only="Fake_AA",
                                      max_seeds=1)
    assert set(out) == {"Fake_AA"} and out["Fake_AA"]["n_runs"] == 1
    assert out["Fake_AA"]["results"]["Average Test AUC"].endswith("0.00")


def test_manager_flushes_after_each_run(tmp_path, monkeypatch):
    suite = _write_suite(tmp_path)
    out_path = str(tmp_path / "out.json")
    seen = []

    def stub(cfg, device=None):
        if os.path.exists(out_path):
            with open(out_path) as f:
                seen.append(json.load(f).get("Fake_PoS", {}).get("n_runs", 0))
        else:
            seen.append(0)
        return _stub(cfg)

    monkeypatch.setattr(tmgr, "run_sgrl_learning", stub)
    tmgr.sgrl_master_controller(suite, out_path, only="Fake_PoS")
    assert seen == [0, 1, 2]


def test_manager_seed_granular_resume(tmp_path, monkeypatch):
    suite = _write_suite(tmp_path)
    out_path = str(tmp_path / "out.json")
    calls = []

    def dies(cfg, device=None):
        calls.append(cfg.seed)
        if len(calls) == 2:
            raise KeyboardInterrupt
        return _stub(cfg)

    monkeypatch.setattr(tmgr, "run_sgrl_learning", dies)
    with pytest.raises(KeyboardInterrupt):
        tmgr.sgrl_master_controller(suite, out_path, only="Fake_PoS")
    with open(out_path) as f:
        assert json.load(f)["Fake_PoS"]["n_runs"] == 1

    def lives(cfg, device=None):
        calls.append(cfg.seed)
        return _stub(cfg)

    monkeypatch.setattr(tmgr, "run_sgrl_learning", lives)
    res = tmgr.sgrl_master_controller(suite, out_path, only="Fake_PoS", skip_existing=True)
    assert calls == [1, 2, 2, 3]
    assert res["Fake_PoS"]["n_runs"] == 3
    assert res["Fake_PoS"]["results"]["Average Test AUC"].startswith("0.92")
    assert res["Fake_PoS"]["raw"]["cold_indices"] == [0, 1]


# --------------------------------------------------------------------- tuning
def test_search_space_and_draws_match_jax():
    assert ttune.DEFAULT_SEARCH_SPACE == jtune.DEFAULT_SEARCH_SPACE
    got = ttune.sample_configs(6, np.random.default_rng(3))
    want = jtune.sample_configs(6, np.random.default_rng(3))
    assert got == want


def test_tuning_matches_jax_on_a_stub(tmp_path):
    """The same trials, rungs, promotions and best trial as the JAX harness
    for the same scoring function."""
    base = RunConfig(seed=2)

    def score(cfg):
        return 50.0 + cfg.hidden_channels / 100.0 + cfg.epochs + 0.1 * cfg.sign_k

    got = ttune.ray_tune_helper(base, num_samples=6, max_epochs=8, grace_period=2,
                                results_json=str(tmp_path / "t.json"), run_fn=score)
    want = jtune.ray_tune_helper(base, num_samples=6, max_epochs=8, grace_period=2,
                                 results_json=str(tmp_path / "j.json"), run_fn=score)
    assert got == want
    with open(tmp_path / "t.json") as f:
        assert json.load(f)["best_score"] == got["best_score"]


def test_tuning_default_runner_resumes_promoted_trials(tmp_path, monkeypatch):
    """With the runner itself, each trial checkpoints into its own directory
    and a promoted trial continues from its previous rung's epoch."""
    seen = []

    def run(cfg, graph=None, edge_split=None, *, device="cuda"):
        seen.append((cfg.res_dir, cfg.epochs, cfg.continue_from, cfg.checkpoint_training,
                     device))
        return 0.0, float(cfg.hidden_channels), [], [], 1

    monkeypatch.setattr(trunner, "run_sgrl_learning", run)
    out = ttune.ray_tune_helper(RunConfig(seed=1), num_samples=4, max_epochs=4,
                                grace_period=2, results_json=str(tmp_path / "r.json"),
                                device="cpu")
    first = {d: e for d, e, c, _, _ in seen if c is None}
    resumed = [(d, e, c) for d, e, c, _, _ in seen if c is not None]
    assert len(first) == 4 and all(e == 2 for e in first.values())
    assert resumed and all(e == 4 and c == 2 and d in first for d, e, c in resumed)
    assert all(ck and dev == torch.device("cpu") for _, _, _, ck, dev in seen)
    assert out["best_score"] == max(c["hidden_channels"] for c in (
        t["config"] for t in out["trials"]))


def test_tuning_scores_a_failed_trial_minus_infinity(tmp_path):
    def boom(cfg):
        raise ValueError("no")

    out = ttune.ray_tune_helper(RunConfig(), num_samples=2, max_epochs=2, grace_period=2,
                                results_json=str(tmp_path / "f.json"), run_fn=boom)
    assert all(t["scores"] == [float("-inf")] for t in out["trials"])


# ----------------------------------------------------------------- calc_ratio
@pytest.fixture(scope="module")
def ratio_graph():
    graph, split = _synthetic_split()
    rng = np.random.default_rng(1)
    pos, neg = get_pos_neg_edges("train", split, percent=5, rng=rng)
    return graph, pos, neg


def test_seal_subgraph_counts_bit_exact_with_jax(ratio_graph):
    graph, pos, neg = ratio_graph
    links = np.concatenate([pos, neg])
    dg = DeviceGraph.from_graph(graph, device="cpu")
    jdg = JDeviceGraph.from_graph(JGraph(num_nodes=graph.num_nodes,
                                         edge_index=graph.edge_index))
    for hops in (1, 2):
        got = subgraph_counts(dg, links, num_hops=hops, max_nodes=256, batch_size=64)
        want = j_subgraph_counts(jdg, links, num_hops=hops, max_nodes=256, batch_size=64)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_scaled_subgraph_counts(ratio_graph):
    """ScaLed's counts: at most the 2M(m + 1) walk nodes, each edge counted
    in both directions, and the target link left out."""
    graph, pos, _ = ratio_graph
    dg = DeviceGraph.from_graph(graph, device="cpu")
    nodes, edges = subgraph_counts(dg, pos, num_hops=1, max_nodes=64, rw_m=2, rw_M=5)
    assert (nodes >= 2).all() and (nodes <= 2 * 5 * 3).all()
    assert (edges % 2 == 0).all()
    seal_nodes, _ = subgraph_counts(dg, pos, num_hops=2, max_nodes=1024)
    assert nodes.mean() < seal_nodes.mean()


def test_calc_ratio_emits_stats(tmp_path, ratio_graph):
    """tests/test_sidecars.py:110-128's flow: the scratch file accumulates
    and the final seed writes the stats JSON and removes it."""
    graph, pos, neg = ratio_graph
    dg = DeviceGraph.from_graph(graph, device="cpu")
    out = None
    for seed in (1, 2):
        out = calc_ratio_helper(pos, neg, dg, num_hops=1, max_nodes=256, rw_m=2, rw_M=5,
                                dataset_name="USAir", seed=seed, final_seed=2,
                                out_dir=str(tmp_path), scratch_dir=str(tmp_path))
        assert (out is None) == (seed == 1)
    assert set(out["train"]) == {"SEAL average no of nodes", "SWEAL average no of nodes",
                                 "SEAL average no of edges", "SWEAL average no of edges"}
    assert os.path.exists(tmp_path / "preprocessing_stats_USAir_train.json")
    assert not os.path.exists(tmp_path / "saved_calc_ratioUSAir.npz")


# ------------------------------------------------------------------------ OGB
def _write_ogb_dir(root, name="ogbl_toy", with_feats=True, n=30, source_target=False,
                   weights=False):
    """tests/test_ogb.py:100-139's synthetic OGB directory (plus weights)."""
    rng = np.random.default_rng(0)
    base = os.path.join(root, name)
    raw = os.path.join(base, "raw")
    os.makedirs(raw)
    edges = rng.integers(0, n, size=(80, 2))
    edges = edges[edges[:, 0] != edges[:, 1]]
    with gzip.open(os.path.join(raw, "edge.csv.gz"), "wt") as f:
        for u, v in edges:
            f.write(f"{u},{v}\n")
    with gzip.open(os.path.join(raw, "num-node-list.csv.gz"), "wt") as f:
        f.write(f"{n}\n")
    if with_feats:
        x = rng.random((n, 5)).astype(np.float32)
        with gzip.open(os.path.join(raw, "node-feat.csv.gz"), "wt") as f:
            for row in x:
                f.write(",".join(f"{v:.6f}" for v in row) + "\n")
    if weights:
        with gzip.open(os.path.join(raw, "edge_weight.csv.gz"), "wt") as f:
            for w in rng.random(len(edges)):
                f.write(f"{w:.6f}\n")
    sp = os.path.join(base, "split", "time")
    os.makedirs(sp)
    gen = torch.Generator().manual_seed(0)
    for split in ("train", "valid", "test"):
        if source_target:
            d = {"source_node": torch.arange(8), "target_node": torch.arange(8) + 12}
            if split != "train":
                d["target_node_neg"] = torch.randint(0, n, (8, 3), generator=gen)
        else:
            d = {"edge": torch.as_tensor(edges[:20].copy())}
            if split != "train":
                d["edge_neg"] = torch.randint(0, n, (10, 2), generator=gen)
        torch.save(d, os.path.join(sp, f"{split}.pt"))
    return base


def test_ogb_loader_roundtrip(tmp_path):
    """tests/test_ogb.py:141-158."""
    _write_ogb_dir(str(tmp_path))
    g, split = load_ogb_dataset("ogbl-toy", str(tmp_path))
    assert g.num_nodes == 30 and g.x.shape == (30, 5)
    s = g.x.sum(axis=1)
    np.testing.assert_allclose(s[s > 0], 1.0, rtol=1e-5)  # NormalizeFeatures
    pairs = {(int(a), int(b)) for a, b in g.edge_index.T}
    assert all((b, a) in pairs for a, b in pairs)
    assert isinstance(split, OgbEdgeSplit)
    assert split.split_edge["valid"]["edge"].shape == (20, 2)
    pos, _ = split.pos_neg("valid", rng=np.random.default_rng(0))
    assert pos.shape == (20, 2)


@pytest.mark.parametrize("layout", ["edge", "source_target", "weighted"])
def test_ogb_loader_matches_jax(tmp_path, layout):
    _write_ogb_dir(str(tmp_path), source_target=layout == "source_target",
                   weights=layout == "weighted")
    g, split = load_ogb_dataset("ogbl-toy", str(tmp_path))
    jg, jsplit = j_load_ogb("ogbl-toy", str(tmp_path))
    np.testing.assert_array_equal(g.edge_index, jg.edge_index)
    np.testing.assert_array_equal(g.x, jg.x)
    if layout == "weighted":
        np.testing.assert_array_equal(g.edge_weight, jg.edge_weight)
    else:
        assert g.edge_weight is None and jg.edge_weight is None
    for s in ("train", "valid", "test"):
        assert set(split.split_edge[s]) == set(jsplit.split_edge[s])
        for k, v in split.split_edge[s].items():
            np.testing.assert_array_equal(v, jsplit.split_edge[s][k])


def test_ogb_loader_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError, match="Pre-download"):
        load_ogb_dataset("ogbl-absent", str(tmp_path))


OGB_BASE = dict(
    model="SIGN", sign_type="PoS", optimize_sign=True, init_features="degree",
    use_feature=True, sign_k=2, node_label="zo", hidden_channels=32, batch_size=32,
    lr=1e-3, epochs=2, num_hops=1, seed=1, extract_batch_size=64, max_subgraph_nodes=256,
    subgraph_buckets=(64, 256), delete_dataset=True, train_percent=20.0,
    val_percent=100.0, test_percent=100.0,
)


def _ogb_splits(source_target=False):
    """tests/test_ogb.py:224-248's OGB splits, of the synthetic graph."""
    graph, es = _synthetic_split()
    if not source_target:
        split_edge = {"train": {"edge": es.train_pos}, "valid": {"edge": es.valid_pos},
                      "test": {"edge": es.test_pos}}
    else:
        rng2 = np.random.default_rng(3)
        split_edge = {"train": {"source_node": es.train_pos[:, 0],
                                "target_node": es.train_pos[:, 1]}}
        for split, pos in (("valid", es.valid_pos), ("test", es.test_pos)):
            split_edge[split] = {
                "source_node": pos[:, 0], "target_node": pos[:, 1],
                "target_node_neg": rng2.integers(0, graph.num_nodes, size=(len(pos), 5)),
            }
    return graph, OgbEdgeSplit(split_edge, graph.num_nodes, graph.edge_index)


def test_ogb_e2e_hits(tmp_path):
    """Hits@K, the metric ogbl-collab takes (sgrl_link_pred.py:1012-1014)."""
    graph, split = _ogb_splits()
    cfg = RunConfig(**OGB_BASE, dataset="ogbl-collab", results_dir=str(tmp_path))
    _, best, tt, _, n_params = trunner.run_sgrl_learning(cfg, graph, split, device="cpu")
    assert 0.0 <= best <= 100.0 and n_params > 0 and len(tt) == 2


def test_ogb_e2e_mrr(tmp_path):
    """MRR, ogbl-citation2's metric (sgrl_link_pred.py:1008-1009): above
    the 1/(5+1) of a random ranking after training."""
    graph, split = _ogb_splits(source_target=True)
    cfg = RunConfig(**OGB_BASE, dataset="ogbl-citation2", results_dir=str(tmp_path))
    _, best, _, _, _ = trunner.run_sgrl_learning(cfg, graph, split, device="cpu")
    assert best > 100.0 / 6.0


def test_runner_reads_an_ogb_directory(tmp_path):
    """The runner's OGB route: no graph passed in, the dataset read from
    ``data_root``, Hits@K scored."""
    _write_ogb_dir(str(tmp_path), name="ogbl_collab", n=60)
    cfg = RunConfig(**{**OGB_BASE, "num_hops": 1, "epochs": 1}, dataset="ogbl-collab",
                    data_root=str(tmp_path), results_dir=str(tmp_path / "res"))
    _, best, tt, _, _ = trunner.run_sgrl_learning(cfg, device="cpu")
    assert 0.0 <= best <= 100.0 and len(tt) == 1
