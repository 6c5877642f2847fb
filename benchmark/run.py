"""The port's benchmark: one run of one cell on one CUDA card.

    python3 benchmark/run.py --workload usair_pos.fit --seed 7 --seconds 30 --trace 0

Run from the root of a checkout of the repository. The cell's pieces are
found by name (``benchmark/spec.py``). A run makes its inputs and weights
from ``--seed``, sets up and warms the program on the cell's own shapes
(``setup_s``), then:

- ``--trace 0``: measures for ``--seconds`` seconds and reports the cell's
  end-to-end metrics;
- ``--trace 1``: times a short slice of the same traffic, profiles it once
  with ``torch.profiler``, early in this fresh process, and reports the
  cell's per-layer metrics, each read by its reader, with the device's busy
  time and the slice's length and the ``breakdown``.

Then it frees the program's state and compares what the timed path produced
with the plain reference (``benchmark/reference.py``). Every number compared
is printed beside its limit as the last lines of standard error and under
``checks`` as the last key of the result, the last line of standard output.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 1. So it does when a module of JAX or of the JAX
package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "s3grl_tpu")


def forbidden_modules(modules) -> list:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``s3grl_tpu_torch`` is not ``s3grl_tpu``)."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def fixed_caches(root: str) -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the kernels themselves build into ``build/kernels`` and
    ``build/native``), so that only a checkout's first run builds."""
    cache = os.path.join(root, "build", "benchmark_cache")
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def card_line() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"smi": f"unavailable: {e}"}
    name, limit = (p.strip() for p in out.split(",", 1))
    return {"smi_name": name, "power_limit": limit}


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *, root: str = ROOT,
             bench_dir: str | None = None, device: str = "cuda", control: bool = False):
    """One run; returns (result dict, checks). ``device="cpu"`` is for the
    harness's own tests: the measurement path never takes it."""
    import torch

    from benchmark import spec, trace, workmodel
    from benchmark.cellbase import sync

    cell = spec.load_cell(workload, root, **({"bench_dir": bench_dir} if bench_dir else {}))
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"benchmark: {workload} needs {cell.chips} CUDA card(s); "
                             f"cuda available {torch.cuda.is_available()}, "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                             "card(s)")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    config = cell.config
    prec = config["precision"]
    if prec["dtype"] != "float32" or prec["tf32"]:
        raise ValueError(f"unsupported precision {prec}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"setup imports and card {time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    run = spec.kind_module(cell.kind).Run(config, cell.traffic, cell.limits, seed, dev)
    run.setup()
    sync(dev)
    setup_s = time.perf_counter() - T_START
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips}
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not traced:
        got = run.window(seconds)
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                result["metrics"]["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in got:
                result["metrics"][m["name"]] = {"value": got[m["name"]], "unit": m["unit"]}
    else:
        peaks = workmodel.PEAKS.get(device_info["kind"])
        ctx = run.trace(peaks)
        for m in cell.per_layer:
            value = spec.reader(m["name"], **({"bench_dir": bench_dir} if bench_dir else {}))(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx.profile is not None:
            device_info["busy_s"] = ctx.profile.busy_s
            device_info["window_s"] = ctx.profile.wall_s
            result["breakdown"] = trace.breakdown(ctx.profile)
        got = {"attempted": ctx.counts.get("links", ctx.counts.get("requests", 1))}
    sync(dev)
    if dev.type == "cuda":
        device_info["memory_peak_bytes"] = int(max(torch.cuda.max_memory_allocated(d)
                                                   for d in range(cell.chips)))
        device_info.update(card_line())
    else:
        device_info["memory_peak_bytes"] = 0
    run.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = run.check(control=control)
    result["attempted"] = int(got["attempted"])
    result["failed"] = int(getattr(run, "failed", 0))
    result["correct"] = bool(all(c.ok for c in checks if not c.name.startswith("control_")))
    result["device"] = device_info
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        raise SystemExit("--seed must be a whole number >= 0")
    fixed_caches(ROOT)
    os.environ.setdefault("USE_FLAX", "0")
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}: no result", file=sys.stderr)
        return 1
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # Run as a script, the first entry of sys.path is this folder, whose
    # module names (trace, spec) would hide the standard library's.
    sys.path[0] = ROOT
    sys.exit(main())
