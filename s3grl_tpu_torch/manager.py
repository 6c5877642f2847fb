"""Experiment-suite manager on the GPU.

Port of ``s3grl_tpu/manager.py``, the equivalent of the reference's
``sgrl_master_controller`` (sgrl_run_manager.py:105-181): it reads the same
suite JSON (``{"datasets": {id: {ds_params: {runs, seeds, dataset},
hyperparams_per_run: {...}}}}``), runs every (run, seed) through
``runner.run_sgrl_learning``, and writes the same results JSON: mean ± std
of runtime, best test AUC, prep time, train and inference time per epoch
and parameter count per experiment, flushed after every run, with
seed-granular resume and the ``--only`` / ``--max_seeds`` filters.

Left out: the JAX package's chip lock, its retries on the TPU backend's
transient errors and its heartbeat thread (JAX manager.py:48-114). They
serve the shared remote TPU only; a run on the card that fails raises.

    python -m s3grl_tpu_torch.manager --config suite.json --results_json out.json \
        [--only ID,ID] [--max_seeds N] [--skip_existing] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from s3grl_tpu_torch.config import ExperimentSuite
from s3grl_tpu_torch.runner import run_sgrl_learning
from s3grl_tpu_torch.utils.seeding import seed_everything


def _mean_std(arr) -> str:
    arr = np.asarray(arr, dtype=np.float64)
    if arr.size == 0:
        return "0.00 ± 0.00"
    std = arr.std() if arr.size > 1 else 0.0
    return f"{arr.mean():.2f} ± {std:.2f}"


def sgrl_master_controller(
    config_path: str,
    results_json: str,
    only: str | None = None,
    max_seeds: int | None = None,
    skip_existing: bool = False,
    device="cuda",
) -> dict:
    """Run a suite JSON on ``device``; returns the results dict it wrote.

    ``only`` is a comma-separated identifier filter and ``max_seeds`` cuts
    each experiment's seed list. ``skip_existing`` resumes a partly written
    ``results_json``: an experiment with all its runs is skipped, one with
    some goes on at its next seed from the per-run series it flushed.
    "Average Dataset Prep Time (warm)" leaves out the first run this
    process made of each experiment, and the first run after a resume.
    """
    suite = ExperimentSuite.load(config_path)
    exp_results: dict = {}
    if skip_existing and os.path.exists(results_json):
        with open(results_json) as f:
            exp_results = json.load(f)
    wanted = set(only.split(",")) if only else None
    process_virgin = True

    by_identifier: dict = {}
    for identifier, dataset, seed, cfg in suite.runs():
        if wanted is not None and identifier not in wanted:
            continue
        runs = by_identifier.setdefault(identifier, [])
        if max_seeds is not None and len(runs) >= max_seeds:
            continue
        runs.append((dataset, seed, cfg))

    for identifier, runs in by_identifier.items():
        done = 0
        if skip_existing and identifier in exp_results:
            done = exp_results[identifier].get("n_runs", 0)
            if done >= len(runs):
                print(f"skip {identifier} (already {done} runs)")
                continue
        best_test_scores, prep_times, total_run_times = [], [], []
        all_train_times, all_inference_times, total_params_arr = [], [], []
        cold_indices: list[int] = []
        ds_config = suite.experiments[identifier]
        if done:
            raw = exp_results[identifier].get("raw")
            if raw:
                best_test_scores = list(raw["best_test_scores"])[:done]
                prep_times = list(raw["prep_times"])[:done]
                total_run_times = list(raw["total_run_times"])[:done]
                all_train_times = list(raw["train_times"])
                all_inference_times = list(raw["inference_times"])
                total_params_arr = list(raw["total_params"])[:done]
                cold_indices = [i for i in raw.get("cold_indices", [0]) if i < done]
                print(f"resume {identifier} at run {done + 1}")
            else:  # an entry without the raw series: start it again
                done = 0

        for run_no, (dataset, seed, cfg) in enumerate(runs, start=1):
            if run_no <= done:
                continue
            print(f"Run {run_no} of {dataset} with id {identifier}")
            if process_virgin:
                cold_indices.append(run_no - 1)
                process_virgin = False
            start = time.perf_counter()
            seed_everything(cfg.seed)
            (
                total_prep_time,
                best_test_score,
                train_times,
                inference_times,
                total_params,
            ) = run_sgrl_learning(cfg, device=device)
            total_run_times.append(time.perf_counter() - start)
            prep_times.append(total_prep_time)
            best_test_scores.append(best_test_score)
            all_train_times.extend(train_times)
            all_inference_times.extend(inference_times)
            total_params_arr.append(total_params)

            exp_results[identifier] = {
                "results": {
                    "Average Runtime": _mean_std(total_run_times),
                    "Average Test AUC": _mean_std(best_test_scores),
                    "Average Dataset Prep Time": _mean_std(prep_times),
                    "Average Dataset Prep Time (warm)": _mean_std(
                        [t for i, t in enumerate(prep_times)
                         if i != 0 and i not in cold_indices]
                        or prep_times
                    ),
                    "Average Train time per epoch": _mean_std(all_train_times),
                    "Average Inf time per epoch": _mean_std(all_inference_times),
                    "Total Model Parameters": _mean_std(total_params_arr),
                },
                "config_dump": ds_config,
                "n_runs": run_no,
                "raw": {
                    "best_test_scores": best_test_scores,
                    "prep_times": prep_times,
                    "total_run_times": total_run_times,
                    "train_times": all_train_times,
                    "inference_times": all_inference_times,
                    "total_params": total_params_arr,
                    "cold_indices": cold_indices,
                },
            }
            tmp = results_json + ".tmp"
            with open(tmp, "w") as f:
                json.dump(exp_results, f)
            os.replace(tmp, results_json)
    return exp_results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run an experiment suite (torch)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--results_json", type=str, default="result.json")
    parser.add_argument("--only", type=str, default=None)
    parser.add_argument("--max_seeds", type=int, default=None)
    parser.add_argument("--skip_existing", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    sgrl_master_controller(
        args.config, args.results_json, only=args.only, max_seeds=args.max_seeds,
        skip_existing=args.skip_existing, device=args.device,
    )


if __name__ == "__main__":
    main()
