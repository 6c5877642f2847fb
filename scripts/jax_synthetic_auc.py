#!/usr/bin/env python3
"""The JAX package's best test AUC on the synthetic USAir-shaped graph.

    JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
        [--sign_type PoS|SoP|hybrid] [--model SIGN|DGCNN|GCN] \
        [--node_label drnl|de|...] [--optimize_sign true|false] \
        [--init_features n2v --n2v_dim 16] [--m 3 --M 20 --num_hops 0] \
        [--k_heuristic 1] [--init_representation GAE|GIC|SVGAE] \
        [--use_heuristic CN|AA|PPR] [--ratio_per_hop 0.5] \
        [--max_nodes_per_hop 10] \
        [--pairwise --loss_fn auc_loss|weighted_auc_loss|hinge_auc_loss] \
        [--use_valedges_as_input]
    JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
        --model WalkPool
    JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 \
        --baseline mf|gnn-GCN|gnn-SAGE|gnn-GIN|n2v

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
  (drnl, de) unless ``--node_label`` says otherwise;
- ``--init_features``/``--n2v_dim``, ``--m``/``--M``/``--num_hops``/
  ``--k_heuristic``, ``--init_representation`` and ``--use_heuristic`` set
  those fields over the bench run, for ``chip_smoke.INIT_PATHS``: node2vec
  features, ScaLed walks (``--k_heuristic 1`` adds PoS+'s intersection CCN
  rows pooled by mean, as configs/paper/scaled.json does), GAE/GIC/SVGAE
  init representations and the CN/AA/PPR heuristics (whose AUC is the raw
  one in [0, 1]). Every config that sets them pools operator-wise, so these
  flags also set ``pool_operatorwise``;
- ``--ratio_per_hop``/``--max_nodes_per_hop``: per-hop sampling over the
  path the other flags name (``chip_smoke.SAMPLED_PATHS``), with no other
  field changed;
- ``--pairwise --loss_fn ...``: pairwise training with that PLNLP loss and
  one negative a positive (``chip_smoke.PAIRWISE_PATHS``), and
  ``--use_valedges_as_input``: the validation positives joined to the
  observed graph (``chip_smoke.VALEDGES``), each over the path the other
  flags name, with no other field changed;
- ``--model WalkPool``: ``chip_smoke.WALKPOOL``, configs/paper/walkpool.json's
  USAir_WalkPool at its widths, cut to 10 % of the train links (about 15
  minutes on a CPU at 5 epochs);
- ``--baseline``: ``models/baselines.py``'s ``train_mf``, ``train_gnn``
  (with the named layer) or ``run_n2v`` on the split, with
  ``chip_smoke.BASELINES``' arguments and the seed; ``--epochs`` is unused.

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


def config_fields(model: str, sign_type: str, node_label: str, optimize_sign: bool,
                  extra: dict | None = None) -> dict:
    """RunConfig fields of the chip_smoke.py path these flags name; ``extra``
    holds the fields of the init, walk and heuristic flags that were given."""
    from chip_smoke import BENCH, LABEL_PATHS, WALKPOOL

    if model == "WalkPool":
        fields = {**BENCH, **WALKPOOL}
    elif model == "SIGN" and optimize_sign:
        fields = {**BENCH, "sign_type": sign_type, "pool_operatorwise": sign_type != "PoS"}
    elif model == "SIGN":
        fields = {**BENCH, **LABEL_PATHS["fullrow"]}
    else:
        fields = {**BENCH, **LABEL_PATHS["SEAL" if model == "DGCNN" else "GCN-DE"]}
    if node_label:
        fields["node_label"] = node_label
    if extra:
        fields.update(extra, pool_operatorwise=True)
        if extra.get("k_heuristic"):
            fields.update(k_node_set_strategy="intersection", k_pool_strategy="mean")
    return fields


def baseline_auc(baseline: str, seed: int) -> None:
    """Print the best test AUC of one of ``chip_smoke.BASELINES`` on the
    synthetic graph, split as ``chip_smoke.py`` splits it."""
    import time

    from chip_smoke import BASELINES
    from s3grl_tpu.config import RunConfig
    from s3grl_tpu.data.graph import Graph
    from s3grl_tpu.data.split import do_edge_split
    from s3grl_tpu.models.baselines import run_n2v, train_gnn, train_mf
    from s3grl_tpu.utils.seeding import seed_everything
    from tests.torch_port_helpers import usair_like_edges

    name = {"mf": "MF", "n2v": "n2v"}.get(baseline) or "GNN-" + baseline.split("-", 1)[1]
    _, kwargs = BASELINES[name]
    cfg = RunConfig(seed=seed)
    g = Graph(num_nodes=332, edge_index=usair_like_edges(seed))
    rng, _ = seed_everything(seed)
    graph, split = do_edge_split(
        g, val_ratio=cfg.split_val_ratio, test_ratio=cfg.split_test_ratio, rng=rng
    )
    t0 = time.perf_counter()
    if baseline == "mf":
        best, _ = train_mf(graph, split, seed=seed, **kwargs)
    elif baseline == "n2v":
        best = run_n2v(graph, split, seed=seed, **kwargs)
    else:
        best, _ = train_gnn(graph, split, seed=seed, **kwargs)
    print(f"baseline {name} seed {seed}: best test AUC {best!r} "
          f"({time.perf_counter() - t0:.1f} s on {os.environ.get('JAX_PLATFORMS', 'default')})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--sign_type", choices=("PoS", "SoP", "hybrid"), default="PoS")
    ap.add_argument("--model", choices=("SIGN", "DGCNN", "GCN", "WalkPool"), default="SIGN")
    ap.add_argument("--baseline", choices=("mf", "gnn-GCN", "gnn-SAGE", "gnn-GIN", "n2v"))
    ap.add_argument("--node_label", default="",
                    help="overrides the path's label (drnl, de, de+, hop, zo, degree)")
    ap.add_argument("--optimize_sign", choices=("true", "false"), default="true")
    ap.add_argument("--init_features", choices=("degree", "n2v"))
    ap.add_argument("--n2v_dim", type=int)
    ap.add_argument("--m", type=int, help="ScaLed walk length")
    ap.add_argument("--M", type=int, help="ScaLed walks from each endpoint")
    ap.add_argument("--num_hops", type=int)
    ap.add_argument("--k_heuristic", type=int)
    ap.add_argument("--init_representation", choices=("GAE", "VGAE", "ARGVA", "SVGAE", "GIC"))
    ap.add_argument("--use_heuristic", choices=("CN", "AA", "PPR"))
    ap.add_argument("--ratio_per_hop", type=float)
    ap.add_argument("--max_nodes_per_hop", type=int)
    ap.add_argument("--pairwise", action="store_true")
    ap.add_argument("--loss_fn", choices=("auc_loss", "weighted_auc_loss", "hinge_auc_loss"),
                    default="auc_loss", help="the pairwise loss (with --pairwise)")
    ap.add_argument("--use_valedges_as_input", action="store_true")
    args = ap.parse_args(argv)
    extra = {k: getattr(args, k) for k in (
        "init_features", "n2v_dim", "m", "M", "num_hops", "k_heuristic",
        "init_representation", "use_heuristic") if getattr(args, k) is not None}

    from s3grl_tpu.config import RunConfig
    from s3grl_tpu.data.graph import Graph
    from s3grl_tpu.data.split import do_edge_split
    from s3grl_tpu.runner import run_sgrl_learning
    from s3grl_tpu.utils.seeding import seed_everything
    from tests.torch_port_helpers import usair_like_edges

    if args.baseline:
        return baseline_auc(args.baseline, args.seed)
    optimize = args.optimize_sign == "true"
    fields = config_fields(args.model, args.sign_type, args.node_label, optimize, extra)
    overrides = {k: getattr(args, k) for k in ("ratio_per_hop", "max_nodes_per_hop")
                if getattr(args, k) is not None}
    if args.pairwise:
        overrides.update(pairwise=True, loss_fn=args.loss_fn, neg_ratio=1)
    if args.use_valedges_as_input:
        overrides["use_valedges_as_input"] = True
    fields.update(overrides)
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
            else "WalkPool" if args.model == "WalkPool" else f"{args.model} {cfg.node_label}" + ("" if optimize else " full-row"))
    if extra or overrides:
        what += " " + " ".join(f"{k}={v}" for k, v in {**extra, **overrides}.items())
    print(f"{what} seed {args.seed} epochs {args.epochs}: best test AUC {best!r} "
          f"(prep {prep:.1f} s on {os.environ.get('JAX_PLATFORMS', 'default')})")


if __name__ == "__main__":
    main()
