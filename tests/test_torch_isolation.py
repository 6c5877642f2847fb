"""Port isolation: no JAX inside the port, and no quiet fallback to the CPU."""
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one test process)
import numpy as np
import pytest
import torch

import s3grl_tpu_torch
from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm, csr_matrix
from tests.torch_port_helpers import random_edges

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = os.path.join(ROOT, "s3grl_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module."""
    mods = _port_modules()
    assert "s3grl_tpu_torch.runner" in mods and "s3grl_tpu_torch.ops.pos_kernel" in mods
    assert "s3grl_tpu_torch.operators.sop" in mods and "s3grl_tpu_torch.ops.spmm_kernel" in mods
    for m in ("sampling.labeling", "operators.fullrow", "models.gnn", "train.gnn_loop",
              "runner_utils", "models.n2v", "sampling.random_walk", "heuristics",
              "models.gae", "models.svgae", "models.gic", "models.init_representation",
              "models.baselines", "models.walkpool", "train.walkpool_loop",
              "train.checkpoint", "profiling", "manager", "tuning", "analysis", "data.ogb",
              "ops.segment", "ops.local_table", "native", "sampling.prng", "parallel", "parallel.mesh",
              "parallel.dist", "parallel.scaling"):
        assert f"s3grl_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 's3grl_tpu' or m.startswith('s3grl_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_port_does_not_import_sklearn():
    """sklearn is absent where the port runs on the card: the logistic
    regression of models/baselines.py is the port's own."""
    import re

    for dirpath, _, files in os.walk(os.path.join(ROOT, "s3grl_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    found = re.search(r"^\s*(import|from)\s+sklearn\b", fh.read(), re.M)
                assert found is None, os.path.join(dirpath, f)


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    suite = str(tmp_path / "suite.json")
    with open(suite, "w") as f:
        f.write('{"datasets": {"X": {"ds_params": {"runs": 1, "seeds": [1], '
                '"dataset": "USAir"}, "hyperparams_per_run": {"sign_type": "PoS", '
                '"optimize_sign": true, "init_features": "degree"}}}}')
    results = str(tmp_path / "tune.json")
    from s3grl_tpu_torch.operators.common import OperatorDataset
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.operators.sop import precompute_sop
    from s3grl_tpu_torch.operators.fullrow import precompute_pos_fullrow, precompute_sop_fullrow
    from s3grl_tpu_torch.runner import main, run_sgrl_learning
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.heuristics import heuristic_scores
    from s3grl_tpu_torch.models.gae import run_gae
    from s3grl_tpu_torch.models.gic import run_gic
    from s3grl_tpu_torch.models.n2v import node2vec_pretrain
    from s3grl_tpu_torch.models.svgae import run_svgae
    from s3grl_tpu_torch.train.gnn_loop import run_gnn_learning
    from s3grl_tpu_torch.train.loop import fit_signnet
    from s3grl_tpu_torch.train.walkpool_loop import run_walkpool_learning
    from s3grl_tpu_torch.models.baselines import run_n2v, train_gnn, train_mf
    from s3grl_tpu_torch.manager import main as manager_main
    from s3grl_tpu_torch.tuning import ray_tune_helper
    from s3grl_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from s3grl_tpu_torch.parallel.scaling import main as scaling_main, measure

    rng = np.random.default_rng(0)
    g = Graph(num_nodes=40, edge_index=random_edges(rng, n=40, e=80),
              x=np.ones((40, 2), np.float32))
    dg = DeviceGraph.from_graph(g, device="cpu")
    ds = OperatorDataset(torch.zeros((4, 2, 2, 3)), torch.ones((4, 2), dtype=torch.bool),
                         np.array([0, 1, 0, 1], np.float32))
    calls = [
        lambda: run_sgrl_learning(RunConfig(sign_type="PoS", optimize_sign=True,
                                            init_features="degree"), g),
        lambda: DeviceGraph.from_graph(g),
        lambda: precompute_pos(dg, np.zeros((2, 2), np.int32), np.zeros(2),
                               num_hops=1, sign_k=1),
        lambda: precompute_sop(dg, np.zeros((2, 2), np.int32), np.zeros(2), sign_k=1),
        lambda: csr_matrix(np.zeros(1), np.zeros(1), np.ones(1), 4, 4),
        lambda: run_sgrl_learning(RunConfig(sign_type="SoP", optimize_sign=True,
                                            pool_operatorwise=True,
                                            init_features="degree"), g),
        lambda: fit_signnet(ds, ds, ds, sign_k=1, epochs=1),
        lambda: main(["--sign_type", "PoS", "--optimize_sign", "--init_features", "degree"]),
        lambda: precompute_pos_fullrow(dg, np.zeros((2, 2), np.int32), np.zeros(2),
                                       num_hops=1, sign_k=1),
        lambda: precompute_sop_fullrow(dg, np.zeros((2, 2), np.int32), np.zeros(2), sign_k=1),
        lambda: run_gnn_learning(g, None, RunConfig(model="DGCNN"), None),
        lambda: run_sgrl_learning(RunConfig(model="GCN", node_label="de"), g),
        lambda: main(["--model", "DGCNN", "--node_label", "drnl"]),
        lambda: main(["--sign_type", "PoS", "--optimize_sign", "false", "--node_label",
                      "drnl", "--init_features", "degree"]),
        lambda: node2vec_pretrain(g),
        lambda: init_features(g, "n2v"),
        lambda: heuristic_scores(g, np.zeros((2, 2), np.int32), "CN"),
        lambda: run_gae(g, g.edge_index, ()),
        lambda: run_svgae(g, g.edge_index, ()),
        lambda: run_gic(g, g.edge_index, ()),
        lambda: main(["--use_heuristic", "PPR"]),
        lambda: main(["--init_representation", "GAE", "--init_features", "degree"]),
        lambda: main(["--m", "3", "--M", "20", "--num_hops", "0", "--init_features", "degree",
                      "--sign_type", "PoS", "--optimize_sign"]),
        lambda: run_walkpool_learning(g, None, RunConfig(model="WalkPool"), None),
        lambda: main(["--model", "WalkPool", "--node_label", "drnl"]),
        lambda: main(["--dataset", "ogbl-collab", "--sign_type", "PoS", "--optimize_sign",
                      "--init_features", "degree"]),
        lambda: main(["--profile", "--sign_type", "PoS", "--optimize_sign",
                      "--init_features", "degree"]),
        lambda: fit_signnet(ds, ds, ds, sign_k=1, epochs=1, only_test=True, continue_from=1),
        lambda: train_mf(g, None),
        lambda: train_gnn(g, None),
        lambda: run_n2v(g, None),
        lambda: manager_main(["--config", suite]),
        lambda: ray_tune_helper(RunConfig(sign_type="PoS", optimize_sign=True,
                                          init_features="degree"), num_samples=1,
                                max_epochs=1, grace_period=1, results_json=results),
        lambda: init_distributed(0, 1, init_method=f"file://{tmp_path / 'store'}"),
        lambda: make_mesh(),
        lambda: measure(1),
        lambda: scaling_main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_wrapper_cpu_route_and_launch_count():
    assert pos_power_rows.launches == 0
    sel = torch.zeros((1, 2), dtype=torch.int32)
    nbr = torch.zeros((1, 4, 3), dtype=torch.int32)
    out = pos_power_rows(sel, nbr, torch.ones((1, 4, 3)), torch.ones((1, 4, 5)), sign_k=2)
    assert out.shape == (1, 3, 2, 5)
    assert pos_power_rows.launches == 0
    assert s3grl_tpu_torch.RunConfig is RunConfig


def test_bsr_wrapper_cpu_route_leaves_the_launch_count():
    assert bsr_spmm.launches == 0
    adj = csr_matrix(np.array([0, 1]), np.array([1, 0]), np.ones(2), 3, 3, device="cpu")
    y = bsr_spmm(adj, torch.ones((3, 4)))
    assert y.shape == (3, 4) and y.sum() == 8
    assert bsr_spmm.launches == 0
