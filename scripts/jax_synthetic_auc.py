#!/usr/bin/env python3
"""The JAX package's best test AUC on the synthetic USAir-shaped graph.

    JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
        [--sign_type PoS|SoP|hybrid]

Runs ``s3grl_tpu.runner.run_sgrl_learning`` with ``chip_smoke.py``'s config
(the bench.py USAir PoS run: sign_k 3, 2 hops, degree features, hidden 256,
batch 32, lr 1e-4) on ``tests/torch_port_helpers.usair_like_edges(seed)``,
split as ``chip_smoke.py`` splits it. ``--sign_type`` SoP and hybrid also set
``pool_operatorwise``, which the config requires for both.
``chip_smoke.py`` holds the printed AUC of each sign type in
``JAX_REFERENCE_AUC`` and fails when the torch port falls more than 3
points below it.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--sign_type", choices=("PoS", "SoP", "hybrid"), default="PoS")
    args = ap.parse_args(argv)

    from s3grl_tpu.config import RunConfig
    from s3grl_tpu.data.graph import Graph
    from s3grl_tpu.data.split import do_edge_split
    from s3grl_tpu.runner import run_sgrl_learning
    from s3grl_tpu.utils.seeding import seed_everything
    from tests.torch_port_helpers import usair_like_edges

    with tempfile.TemporaryDirectory() as results_dir:
        cfg = RunConfig(
            dataset="USAir", model="SIGN", sign_type=args.sign_type, optimize_sign=True,
            pool_operatorwise=args.sign_type != "PoS",
            init_features="degree", use_feature=True, sign_k=3, node_label="zo",
            hidden_channels=256, batch_size=32, lr=1e-4, num_hops=2,
            seed=args.seed, epochs=args.epochs, delete_dataset=True,
            results_dir=results_dir,
        )
        g = Graph(num_nodes=332, edge_index=usair_like_edges(args.seed))
        rng, _ = seed_everything(cfg.seed)
        graph, split = do_edge_split(
            g, val_ratio=cfg.split_val_ratio, test_ratio=cfg.split_test_ratio, rng=rng
        )
        prep, best, _, _, _ = run_sgrl_learning(cfg, graph, split)
    print(f"{args.sign_type} seed {args.seed} epochs {args.epochs}: best test AUC {best!r} "
          f"(prep {prep:.1f} s on {os.environ.get('JAX_PLATFORMS', 'default')})")


if __name__ == "__main__":
    main()
