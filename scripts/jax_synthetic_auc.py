#!/usr/bin/env python3
"""The JAX package's best test AUC on the synthetic USAir-shaped graph.

    JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
        [--sign_type PoS|SoP|hybrid] [--model SIGN|DGCNN|GCN] \
        [--node_label drnl|de|...] [--optimize_sign true|false]

Runs ``s3grl_tpu.runner.run_sgrl_learning`` with one of ``chip_smoke.py``'s
configs on ``tests/torch_port_helpers.usair_like_edges(seed)``, split as
``chip_smoke.py`` splits it:

- ``--model SIGN`` (default) with ``--optimize_sign true``: the bench.py
  USAir run (``chip_smoke.BENCH``: sign_k 3, 2 hops, degree features,
  hidden 256, batch 32, lr 1e-4); ``--sign_type`` SoP and hybrid also set
  ``pool_operatorwise``, which the config requires for both;
- ``--model SIGN --optimize_sign false``: the full-row PoS path
  (``chip_smoke.LABEL_PATHS["fullrow"]``), ``--node_label`` drnl by default;
- ``--model DGCNN`` / ``--model GCN``: Table 2's USAir_SEAL and
  USAir_GCN_DE (``LABEL_PATHS["SEAL"]``, ``["GCN-DE"]``), with their labels
  (drnl, de) unless ``--node_label`` says otherwise.

``chip_smoke.py`` holds the printed AUC of each path in
``JAX_REFERENCE_AUC`` and fails when the torch port falls further below it
than the path's slack.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def config_fields(model: str, sign_type: str, node_label: str, optimize_sign: bool) -> dict:
    """RunConfig fields of the chip_smoke.py path these flags name."""
    from chip_smoke import BENCH, LABEL_PATHS

    if model == "SIGN" and optimize_sign:
        fields = {**BENCH, "sign_type": sign_type, "pool_operatorwise": sign_type != "PoS"}
    elif model == "SIGN":
        fields = {**BENCH, **LABEL_PATHS["fullrow"]}
    else:
        fields = {**BENCH, **LABEL_PATHS["SEAL" if model == "DGCNN" else "GCN-DE"]}
    if node_label:
        fields["node_label"] = node_label
    return fields


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--sign_type", choices=("PoS", "SoP", "hybrid"), default="PoS")
    ap.add_argument("--model", choices=("SIGN", "DGCNN", "GCN"), default="SIGN")
    ap.add_argument("--node_label", default="",
                    help="overrides the path's label (drnl, de, de+, hop, zo, degree)")
    ap.add_argument("--optimize_sign", choices=("true", "false"), default="true")
    args = ap.parse_args(argv)

    from s3grl_tpu.config import RunConfig
    from s3grl_tpu.data.graph import Graph
    from s3grl_tpu.data.split import do_edge_split
    from s3grl_tpu.runner import run_sgrl_learning
    from s3grl_tpu.utils.seeding import seed_everything
    from tests.torch_port_helpers import usair_like_edges

    optimize = args.optimize_sign == "true"
    fields = config_fields(args.model, args.sign_type, args.node_label, optimize)
    if args.model == "SIGN" and not optimize:
        # The JAX full-row flow gathers [B, S, D, Z+F] per batch; 16 links a
        # batch keep that small on a CPU. Batching changes no output.
        fields["extract_batch_size"] = 16
    with tempfile.TemporaryDirectory() as results_dir:
        cfg = RunConfig(**fields, seed=args.seed, epochs=args.epochs,
                        delete_dataset=True, results_dir=results_dir)
        g = Graph(num_nodes=332, edge_index=usair_like_edges(args.seed))
        rng, _ = seed_everything(cfg.seed)
        graph, split = do_edge_split(
            g, val_ratio=cfg.split_val_ratio, test_ratio=cfg.split_test_ratio, rng=rng
        )
        prep, best, _, _, _ = run_sgrl_learning(cfg, graph, split)
    what = (args.sign_type if args.model == "SIGN" and optimize
            else f"{args.model} {cfg.node_label}" + ("" if optimize else " full-row"))
    print(f"{what} seed {args.seed} epochs {args.epochs}: best test AUC {best!r} "
          f"(prep {prep:.1f} s on {os.environ.get('JAX_PLATFORMS', 'default')})")


if __name__ == "__main__":
    main()
