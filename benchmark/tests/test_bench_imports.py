"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference, the work model and the generators
load nothing of the program either; and the run refuses to measure without
a card or without the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.run import FORBIDDEN, forbidden_modules
from benchmark.tests.tiny import BENCH, ROOT, make_tiny

PROGRAM = "s3grl_tpu_torch"
YARDSTICK = ("reference.py", "workmodel.py", "graphs.py", "trace.py")


def test_whole_top_level_names():
    assert forbidden_modules(["s3grl_tpu_torch", "s3grl_tpu_torch.ops.pos_kernel", "numpy",
                              "jaxtyping"]) == []
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen", "s3grl_tpu",
                              "s3grl_tpu.ops"]) == ["flax.linen", "jax", "jaxlib.xla_client",
                                                    "s3grl_tpu", "s3grl_tpu.ops"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(BENCH):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", sorted(_sources()))
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(name):
    assert PROGRAM not in set(_imports(os.path.join(BENCH, name)))


def test_a_whole_run_loads_no_jax(tmp_path):
    root, bench = make_tiny(str(tmp_path))
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        f"res, _ = run_cell('usair_pos.prep', 11, 0.2, False, root={root!r}, "
        f"bench_dir={bench!r}, device='cpu')\n"
        "print(json.dumps({'loaded': forbidden_modules(sys.modules), 'ok': res['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"loaded": [], "ok": True}


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "usair_pos.fit",
                           "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
