"""Hyperparameter tuning harness.

Port of ``s3grl_tpu/tuning.py`` (reference ray_tuning.py: Ray Tune ASHA
over {hidden_channels, batch_size, num_hops, lr, dropout, sign_k, n2v_dim,
k_heuristic}, ray_tuning.py:26-35, 113-123, with a 30-minute TimeStopper,
tuning_utils.py:5-14, and a best-trial JSON, ray_tuning.py:145-152). Ray is
not a dependency, so the scheduler is written out: asynchronous successive
halving on the best test score, the same search space, the configurations
drawn from ``np.random.default_rng(seed)`` as the JAX package draws them.
With the default runner a promoted trial resumes from its previous rung's
checkpoint (``continue_from``) instead of training from epoch 0.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.utils.device import resolve_device

# ray_tuning.py:26-35 search space
DEFAULT_SEARCH_SPACE: Dict[str, list] = {
    "hidden_channels": [32, 64, 128, 256],
    "batch_size": [32, 64, 128],
    "num_hops": [1, 2, 3],
    "lr": [1e-4, 1e-3, 1e-2],
    "dropout": [0.0, 0.25, 0.5],
    "sign_k": [1, 2, 3],
    "n2v_dim": [16, 32, 64, 128],
    "k_heuristic": [0, 1],
}


@dataclass
class Trial:
    config: Dict[str, Any]
    scores: List[float] = field(default_factory=list)  # score per rung


def sample_configs(
    n: int, rng: np.random.Generator, space: Optional[Dict[str, list]] = None
) -> List[Dict[str, Any]]:
    """``n`` configurations, one value of each key drawn uniformly."""
    space = space or DEFAULT_SEARCH_SPACE
    return [{k: vs[rng.integers(0, len(vs))] for k, vs in space.items()} for _ in range(n)]


def rung_epochs(max_epochs: int, grace_period: int, reduction_factor: int) -> List[int]:
    """The epochs of each rung: grace_period times powers of the reduction
    factor below ``max_epochs``, then ``max_epochs``."""
    rungs = []
    e = grace_period
    while e < max_epochs:
        rungs.append(e)
        e *= reduction_factor
    rungs.append(max_epochs)
    return rungs


def ray_tune_helper(
    base_config: RunConfig,
    *,
    num_samples: int = 16,
    max_epochs: int = 50,
    grace_period: int = 5,
    reduction_factor: int = 2,
    time_budget_s: float = 30 * 60,  # tuning_utils.py TimeStopper: 30 min
    search_space: Optional[Dict[str, list]] = None,
    results_json: str = "tuning_result.json",
    run_fn: Optional[Callable[[RunConfig], float]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Successive-halving tuning; returns ``{best_config, best_score,
    trials}`` and writes it to ``results_json``.

    ``run_fn(cfg)`` gives a trial's score; by default the best test score
    of ``runner.run_sgrl_learning`` on ``device``, which checkpoints each
    trial into its own directory so that the next rung resumes it. A trial
    that raises scores -inf.
    """
    from s3grl_tpu_torch.runner import run_sgrl_learning

    rng = np.random.default_rng(base_config.seed)
    trials = [Trial(c) for c in sample_configs(num_samples, rng, search_space)]
    start = time.time()
    survivors = list(range(len(trials)))
    default_run = run_fn is None
    if default_run:
        dev = resolve_device(device)  # a missing card fails the tuning, not each trial

        def run_fn(cfg):
            return run_sgrl_learning(cfg, device=dev)[1]

    ckpt_root = tempfile.mkdtemp(prefix="s3grl_tune_")
    prev_rung_epochs = [0] * len(trials)

    for epochs in rung_epochs(max_epochs, grace_period, reduction_factor):
        if time.time() - start > time_budget_s:
            break
        scores = []
        for t_idx in survivors:
            if time.time() - start > time_budget_s:
                break
            trial = trials[t_idx]
            cfg = base_config.replace(**trial.config, epochs=int(epochs))
            if default_run:
                resume = prev_rung_epochs[t_idx]
                cfg = cfg.replace(
                    checkpoint_training=True, log_steps=1,
                    res_dir=os.path.join(ckpt_root, f"trial{t_idx}"),
                    continue_from=resume or None,
                )
            try:
                score = float(run_fn(cfg))
                prev_rung_epochs[t_idx] = int(epochs)
            except Exception as exc:  # noqa: BLE001 - a failed trial scores -inf
                print(f"trial {t_idx} failed: {type(exc).__name__}: {exc}")
                score = float("-inf")
            trial.scores.append(score)
            scores.append((score, t_idx))
        if not scores:
            break
        # keep the top 1/reduction_factor for the next rung
        scores.sort(reverse=True)
        keep = max(1, len(scores) // reduction_factor)
        survivors = [t for _, t in scores[:keep]]

    def best_of(t: Trial) -> float:
        return max(t.scores) if t.scores else float("-inf")

    best = max(trials, key=best_of)
    result = {
        "best_config": best.config,
        "best_score": best_of(best) if best.scores else None,
        "trials": [{"config": t.config, "scores": t.scores} for t in trials],
    }
    with open(results_json, "w") as f:
        json.dump(result, f, indent=2)
    return result
