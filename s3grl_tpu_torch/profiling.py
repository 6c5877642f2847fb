"""Profiling and run-stats collection on the GPU.

Port of ``s3grl_tpu/profiling.py`` (reference profiler_utils.py: per-epoch
CUDA stats gathered into ``stats/stats_{suffix}.json``, and
parsers/parse_profiling_data.py, their collation across seeds). The memory
stats come from ``torch.cuda.memory_stats``, as in the reference; the
trace is a ``torch.profiler`` trace. The JSON keeps the JAX package's
field names, so the same parsing reads both.

The program's spans and counters live here too. :func:`span` names a piece
of the hot path on the profiler's own timeline (``record_function``), so a
trace shows which piece the host was in while the card sat idle; it records
only while a profiler session records and costs one check otherwise.
:func:`count` adds to a named counter that is always kept; :func:`counters`
gives a copy to take differences of. ``PERF.md`` lists every span and counter
and the benchmark metric that reads it; :func:`torch_trace` writes the spans
and the card's kernels into one Chrome trace.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager, nullcontext
from typing import Optional

import numpy as np
import torch

_MB = 1.0 / (1024 * 1024)

_NULL_SPAN = nullcontext()
_recording = torch._C._autograd._profiler_enabled
_COUNTERS: dict = {}


def span(name: str):
    """A context that marks ``name`` on the profiler's timeline: a
    ``record_function`` while a ``torch.profiler`` (or autograd profiler)
    session records, else one shared null context, so a span site costs a
    check of the profiler's state and nothing more. There is no switch:
    tracing is on exactly when a profiler records. ``name`` is a stable
    string drawn from a small set (a bucket or a route at most), so a trace
    keeps few distinct names.

    Keep spans outside any CUDA-graph capture: a captured region replays
    without the host, so a span inside one would mark nothing on replay. A
    captured training step keeps ``fit.step`` around the replay, not inside
    the capture."""
    if _recording():
        return torch.autograd.profiler.record_function(name)
    return _NULL_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``. Called once per call, plan, batch
    or step, never per element, and only with numbers already on the host:
    a counter never waits for the card or copies from it."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of every counter of this process; a reader takes the
    difference of two copies."""
    return dict(_COUNTERS)


def device_memory_stats(device=None) -> dict:
    """The card's memory stats in MiB: peak and current allocation, the
    caching allocator's reservation, and the card's total. Zeros where
    ``device`` is not a CUDA device (the same keys)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"max_allocated_mb": 0.0, "allocated_mb": 0.0,
                "reserved_mb": 0.0, "total_mb": 0.0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "max_allocated_mb": stats.get("allocated_bytes.all.peak", 0) * _MB,
        "allocated_mb": stats.get("allocated_bytes.all.current", 0) * _MB,
        "reserved_mb": stats.get("reserved_bytes.all.current", 0) * _MB,
        "total_mb": torch.cuda.get_device_properties(dev).total_memory * _MB,
    }


def _tensors(params):
    """The tensors of a module (parameters and buffers) or a state dict."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    return [torch.as_tensor(v) for v in params.values()]


def _parameters(params):
    """The trainable tensors of a module, or every tensor of a state dict."""
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    return _tensors(params)


def count_parameters(params) -> int:
    """Number of parameters of a module, or of the entries of a state dict."""
    return int(sum(p.numel() for p in _parameters(params)))


def model_size_mb(params) -> float:
    """MiB of a module's parameters and buffers, or of a state dict."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(params)) * _MB)


@contextmanager
def torch_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the CPU and the card, written to
    ``log_dir`` as a Chrome trace when the block ends; nothing when
    ``log_dir`` is empty. The program's spans (:func:`span`) and the card's
    kernels lie on its one timeline."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_helper(
    epoch_times,
    inference_times,
    total_prep_time: float,
    params,
    dataset_num_links: int,
    stats_suffix: str,
    out_dir: str = "stats",
    device=None,
) -> dict:
    """Aggregate run stats into ``{out_dir}/stats_{suffix}.json``.

    The schema of profiler_utils.py:10-66 as the JAX package writes it: mean
    and std of the train and inference times per epoch, prep time, memory
    stats, model size, parameter count, dataset size. ``params`` is the
    model or its state dict.
    """
    epoch_times = np.asarray(epoch_times, dtype=np.float64)
    inference_times = np.asarray(inference_times, dtype=np.float64)

    def ms(arr):
        if arr.size == 0:
            return {"mean": 0.0, "std": 0.0}
        return {"mean": float(arr.mean()), "std": float(arr.std()) if arr.size > 1 else 0.0}

    stats = {
        "train_time_per_epoch_s": ms(epoch_times),
        "inference_time_per_epoch_s": ms(inference_times),
        "total_prep_time_s": float(total_prep_time),
        "device_memory": device_memory_stats(device),
        "model_size_mb": model_size_mb(params),
        "num_parameters": count_parameters(params),
        "dataset_num_links": int(dataset_num_links),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"stats_{stats_suffix}.json"), "w") as f:
        json.dump(stats, f, indent=2)
    return stats


def parse_profiling_data(stats_dir: str = "stats") -> dict:
    """Collate the stats files of ``stats_dir`` across runs and seeds
    (parsers/parse_profiling_data.py): files are grouped by their name up
    to ``_seed_``, numeric fields averaged; writes
    ``combined_profiling_results.json`` and ``collated_csv.csv``."""
    import csv
    import re
    from collections import defaultdict

    groups = defaultdict(list)
    for fname in sorted(os.listdir(stats_dir)):
        if not (fname.startswith("stats_") and fname.endswith(".json")):
            continue
        m = re.match(r"stats_(.+)_seed_\d+.*\.json", fname)
        key = m.group(1) if m else fname[len("stats_") : -len(".json")]
        with open(os.path.join(stats_dir, fname)) as f:
            groups[key].append(json.load(f))

    combined = {}
    for key, runs in groups.items():
        combined[key] = {
            "runs": len(runs),
            "train_time_per_epoch_s": float(
                np.mean([r["train_time_per_epoch_s"]["mean"] for r in runs])),
            "inference_time_per_epoch_s": float(
                np.mean([r["inference_time_per_epoch_s"]["mean"] for r in runs])),
            "total_prep_time_s": float(np.mean([r["total_prep_time_s"] for r in runs])),
            "max_allocated_mb": float(
                np.mean([r["device_memory"]["max_allocated_mb"] for r in runs])),
            "num_parameters": float(np.mean([r["num_parameters"] for r in runs])),
        }

    with open(os.path.join(stats_dir, "combined_profiling_results.json"), "w") as f:
        json.dump(combined, f, indent=2)
    cols = ["key", "runs", "train_time_per_epoch_s", "inference_time_per_epoch_s",
            "total_prep_time_s", "max_allocated_mb", "num_parameters"]
    with open(os.path.join(stats_dir, "collated_csv.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(cols)
        for key, row in combined.items():
            writer.writerow([key] + [row[c] for c in cols[1:]])
    return combined
