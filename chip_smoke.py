#!/usr/bin/env python3
"""Drive the torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises, prints its traceback and exits
non-zero without the final line:

1. environment: torch and CUDA versions, the card, ``nvidia-smi``'s name
   and power limit;
2. build: every ``s3grl_tpu_torch/csrc/*.cu`` through nvcc, with each
   kernel's registers, shared memory and spills from ``-Xptxas -v``;
3. kernels: each kernel of the paths against its plain torch version on
   the card, at the main path's shapes and on the main path's data, with
   its device time (``s3grl_tpu_torch/utils/timing.graph_ms``: 20 calls
   replayed from one CUDA graph, timed by events), its time a call on the
   stream (``call_ms``: events around 20 eager calls), the host's time to
   enqueue a call, the SM clock during the readings, the plain version's
   time and the least time the card could take (``ops/*_kernel.work`` over
   ``utils/device.PEAK_RATES``); for ``pos_power_rows`` also its selector phase
   against its plain version and alone (and at K = 0: the table pass), and
   the resolved neighbor entries; ``bsr_spmm`` on the SoP chain, on SoP's
   first batch of one-hot endpoint columns (C = 2B = 8,192) and on a
   Cora-shaped random graph, with the edge-list route's time and one
   ``torch.sparse.mm`` as a yardstick; ``pos_power_rows`` on the hub
   graph's first global batch (B = 32) on the global table, on the local
   tables the card builds for the same links, and on the local route's own
   first batch (B = 64), whose outputs must equal the global row's bit for
   bit, and equal to the same call with the table's weights spelled out
   (``w = loc >= 0``); then ``local_table`` (slots only, no weight array)
   against its plain version, bit for bit, on the main path's S = 256 batch
   and the local route's first hub batch, with its device time and its
   bound, and its time at each of ``ROWS_PER_BLOCK_SWEEP`` rows a block
   (``phase_local_table``);
4. end to end: ``run_sgrl_learning`` on a synthetic USAir-shaped graph
   with the bench.py config (USAir, sign_k 3, 2 hops, degree features,
   hidden 256, batch 32, lr 1e-4), 5 epochs, seed 1, once per sign type
   (PoS; SoP and hybrid with ``pool_operatorwise``); each kernel's launch
   count in each run, and its best test AUC against the JAX package's on
   the same graph and config;
5. the paths of structural labels, which launch no kernel of ours, on the
   same graph, EPOCHS epochs each: SEAL (DGCNN, DRNL) and GCN-DE (GCN, DE)
   at Table 2's USAir widths, and the full-row PoS flow with DRNL labels
   (``LABEL_PATHS``); each one's prep, train rate, peak memory and best
   test AUC against the JAX package's;
6. the paths of feature inits, ScaLed walks and heuristics on the same
   graph (``INIT_PATHS``): n2v-initialized PoS, ScaLed PoS and PoS+ (whose
   subgraphs go through ``pos_power_rows`` in its local-slot mode, which
   phase 3 also holds against its plain version on the ScaLed paths' own
   first batch), GAE-, GIC- and SVGAE-initialized PoS, and CN, AA, PPR;
   each one's prep, train rate, peak memory, kernel launches and best test
   AUC against the JAX package's;
7. repeat: each path of ``REPEAT_PATHS`` (SoP, hybrid, SEAL, PoS-n2v,
   PoS-sampled, pairwise with ``auc_loss``) twice at ``REPEAT_EPOCHS`` epochs; the two best test AUCs,
   printed, must be equal to the last bit;
8. WalkPool: configs/paper/walkpool.json's USAir_WalkPool at its widths
   (S = 512 on this graph), cut in links and epochs only (``WALKPOOL``);
   prep, train rate, peak memory and best test AUC against the JAX
   package's;
9. baselines: MF, the GCN/SAGE/GIN link predictors and node2vec with a
   logistic regression (``BASELINES``), each over seeds 1-3 on the seed's
   own graph; the mean best test AUC against the JAX package's mean;
10. tooling: the checkpoint flags on the PoS path (save, resume,
    ``only_test``, ``test_multiple_models``, each score equal to the saving
    run's), the ``profile`` route's stats JSON with the card's memory, and
    an OGB run (a synthetic ogbl-collab directory, PoS, Hits@50);
11. large graphs (``phase_large_graphs``): the BFS crossover, the sizing
    pass and node sets by the device BFS and by the native host core on
    random graphs of 500 to 200,000 nodes (average degree 20, 2,048 links,
    2 hops), which must agree, and ``precompute_pos`` by both routes on
    each and on the main path's train split, bit for bit (the auto route
    too at 50,000 nodes); then 256 links of a BlogCatalog-sized power-law
    graph (hub degree 3,377: a global table 3,392 wide) by both routes,
    bit for bit; phase 3 also holds ``pos_power_rows`` on that graph's
    first S = 1,024 batch against its plain version; then the local-table
    routes (``S3GRL_TPU_LOCAL_TAB=1``, its tables built on the card, on the
    host's and on the device BFS's node sets) against the global routes,
    bit for bit, with each route's prep timed twice (six times on the
    Cora-shaped graph), on the hub graph, a narrow-local graph (50,004
    nodes, a global table 3,008 wide, 1 hop), an arxiv-shaped graph (a
    global table 512 wide) and a Cora-shaped graph (a global table 192
    wide, with the auto route); and the threshold's
    sweep: one batch's operators by each route at S/D_tab 0.17 to 1 on
    three of those graphs (``threshold_rows``);
12. sampled paths (``SAMPLED_PATHS``): the bench config with
    ``ratio_per_hop`` 0.5 and SEAL with ``max_nodes_per_hop`` 10, each
    one's prep, train rate, peak memory and best test AUC against the JAX
    package's (the first also in the repeat phase);
13. pairwise and validation edges: the bench config with pairwise training
    and one negative a positive, once with each PLNLP loss
    (``PAIRWISE_PATHS``), whose train loss must fall and whose best test
    AUC must be within slack of the JAX package's; then one run with
    ``use_valedges_as_input`` (``VALEDGES``), whose observed graph and
    datasets must equal those of a run on the graph with the valid edges
    joined by hand, and whose AUC is held against the JAX package's;
14. multi-device (``phase_multi_device``): ``s3grl_tpu_torch/parallel`` at
    world size 1 over NCCL in this process (the sharded PoS, the
    row-partitioned chain and the sharded SoP of the main path's train split
    bit for bit against one process, one epoch of data-parallel training,
    ``scaling.measure(1)`` at the JAX harness's defaults), ``bsr_spmm``
    alone on rank 0's 166-row shard of a 2-way partition against its plain
    version, then the same checks in two ranks spawned on the one card over
    gloo (NCCL takes one rank a card);
15. device times: each kernel that phase 3 timed, and ``torch.sparse.mm``,
    by ``torch.profiler`` (``phase_device_times``: per-launch means over the
    device events kept), held against the graph replay at ``TIMER_ROWS``;
    then one profiled 1-epoch run of each path of
    ``IDLE_PATHS`` (one of each kind: a label path, a ScaLed path, an init
    path, a heuristic, WalkPool) for its device idle share. It comes last:
    a profiler session leaves every later launch in the process slower.

Every kernel count is set to 0 just before each path and read just after;
the kernels line gives each kernel's launches on every path.

Imports nothing of JAX or the JAX package. Exits 2 when CUDA is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 1
EPOCHS = 5
# The JAX package's best test AUC (in percent) on
# tests/torch_port_helpers.usair_like_edges(SEED)
# with this script's config and EPOCHS epochs, by sign type, on the CPU, from
#   JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
#       --sign_type {PoS,SoP,hybrid}
#   JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed 1 --epochs 5 \
#       --model DGCNN | --model GCN | --optimize_sign false
# for the label paths (SEAL, GCN-DE, fullrow).
# The paths of INIT_PATHS, from the same script with their fields as flags:
#   ... --init_features n2v --n2v_dim 16                     (PoS-n2v)
#   ... --m 3 --M 20 --num_hops 0 [--k_heuristic 1]           (ScaLed[-Plus])
#   ... --num_hops 3 --init_representation GAE|GIC|SVGAE      (*-init)
#   ... --use_heuristic CN|AA|PPR                             (a raw AUC in [0, 1])
#   ... --model WalkPool                                      (WALKPOOL's cut)
#   ... --ratio_per_hop 0.5                                   (PoS-sampled)
#   ... --epochs 2 --model DGCNN --max_nodes_per_hop 10       (SEAL-sampled)
#   ... --pairwise --loss_fn auc_loss|weighted_auc_loss|hinge_auc_loss
#                                                             (PAIRWISE_PATHS)
#   ... --use_valedges_as_input                               (valedges)
JAX_REFERENCE_AUC = {
    "PoS": 77.23776146708104,
    "SoP": 76.65145804403888,
    "hybrid": 78.48971764861469,
    "SEAL": 92.41111772355573,
    "GCN-DE": 89.12032445061607,
    "fullrow": 68.40512637949449,
    "PoS-n2v": 82.57620842425445,
    "ScaLed": 76.51920915162336,
    "ScaLed-Plus": 90.90127620181181,
    "GAE-init": 83.39835570543764,
    "GIC-init": 81.03110053119971,
    "SVGAE-init": 83.62538297075095,
    "CN": 0.8980581454296986,
    "AA": 0.917410566686504,
    "PPR": 0.799466596133924,
    "WalkPool": 92.15323238334545,
    "PoS-sampled": 75.6309374242324,
    "SEAL-sampled": 85.48788820560294,
    "pairwise-auc_loss": 47.210650444135865,
    "pairwise-weighted_auc_loss": 47.210650444135865,
    "pairwise-hinge_auc_loss": 45.610438845908,
    "valedges": 77.07685864797548,
}
AUC_SLACK = 3.0  # the port may fall at most 0.03 below it
# A label path's slack is the larger of AUC_SLACK and the spread (max - min)
# of the JAX package's own AUC over seeds 1-3 of the same script: SEAL
# 92.4111 / 91.6434 / 89.9533, GCN-DE 89.1203 / 86.6713 / 83.3392, fullrow
# 68.4051 / 57.9614 / 59.4375. The same for INIT_PATHS' PoS paths: PoS-n2v
# 82.5762 / 76.5569 / 80.5878, ScaLed 76.5192 / 72.8513 / 68.9143,
# ScaLed-Plus 90.9013 / 88.6409 / 87.5229, GAE-init 83.3984 / 79.5200 /
# 78.2579, GIC-init 81.0311 / 79.9655 / 77.0941, SVGAE-init 83.6254 /
# 80.3695 / 83.1055. WalkPool (--model WalkPool, WALKPOOL's cut): 92.1532 /
# 92.1696 / 91.6215. PoS-sampled 75.6309 / 74.2838 / 69.3969, SEAL-sampled
# 85.4879 / 81.6731 / 81.5945. Pairwise (near chance on this graph: the
# reference's two forward passes a step each normalize their own batch)
# auc_loss and weighted_auc_loss (the same function at one negative a
# positive) 47.2107 / 54.5179 / 46.4233, hinge_auc_loss 45.6104 / 54.6139 /
# 46.1765; valedges 77.0769 / 73.8667 / 71.2158.
JAX_AUC_RANGE = {"SEAL": 2.4578466955183416, "GCN-DE": 5.781168192427586,
                 "PoS-sampled": 6.234046866105061, "SEAL-sampled": 3.89342580714019,
                 "WalkPool": 0.54808280199144,
                 "fullrow": 10.44373237128417, "PoS-n2v": 6.019303891107455,
                 "ScaLed": 7.6048934908669565, "ScaLed-Plus": 3.3783484351946385,
                 "GAE-init": 5.140429248978563, "GIC-init": 3.937031180164695,
                 "SVGAE-init": 3.2559183886913843,
                 "pairwise-auc_loss": 8.09459341427199,
                 "pairwise-weighted_auc_loss": 8.09459341427199,
                 "pairwise-hinge_auc_loss": 9.003501236195241,
                 "valedges": 5.8610319382191705}
# A heuristic is deterministic: its raw AUC must equal the JAX package's
# within this.
HEURISTIC_AUC_TOL = 0.005
TOL = dict(rtol=2e-3, atol=2e-4)
BSR_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas_spmm.py's bar
# The end-to-end paths, each with the kernels it must launch.
PATHS = {"PoS": ("pos_power_rows",), "SoP": ("bsr_spmm",),
         "hybrid": ("pos_power_rows", "bsr_spmm")}


# bench.py:432-437's run.
BENCH = dict(
    dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
    init_features="degree", use_feature=True, sign_k=3, node_label="zo",
    hidden_channels=256, batch_size=32, lr=1e-4, num_hops=2,
)
# The paths of structural labels, which launch no kernel of ours: RunConfig
# fields over BENCH. SEAL and GCN-DE are configs/paper/table_2.json's
# USAir_SEAL and USAir_GCN_DE (hyperparams_per_run: no node features,
# hidden 32, 3 layers, 2 hops, sortpool_k 0.6, batch 32, lr 1e-4). fullrow
# is the PoS run with optimize_sign off and DRNL labels at 1 hop; its
# dataset is links x (K+1) x S x (Z+F) x 4 bytes (4.2 MB a link at S = 256,
# F = 1,025), so its percents are cut to about 610 links, under 2 GB.
TABLE_2 = dict(
    model="DGCNN", node_label="drnl", init_features="", use_feature=False,
    hidden_channels=32, num_layers=3, num_hops=2, sortpool_k=0.6,
    batch_size=32, lr=1e-4, dropout=0.5,
)
LABEL_PATHS = {
    "SEAL": TABLE_2,
    "GCN-DE": {**TABLE_2, "model": "GCN", "node_label": "de"},
    "fullrow": dict(optimize_sign=False, node_label="drnl", num_hops=1,
                    train_percent=4.0, val_percent=50.0, test_percent=50.0),
}
# The paths of feature inits, ScaLed walks and heuristics: RunConfig fields
# over BENCH, each from a named config, cut to EPOCHS epochs; degree features
# stand in for Cora's attributes. PoS-n2v is configs/paper/auc_s3grl.json's
# USAir_PoS (node2vec features of dimension 16, trained for EPOCHS epochs as
# the runner does); ScaLed and ScaLed-Plus are configs/paper/scaled.json's
# Cora_PoS_ScaLed and Cora_PoS_Plus_ScaLed (M = 20 walks of length m = 3 from
# each endpoint, no BFS); GAE-init and GIC-init are configs/paper/initrep.json's
# Cora_PoS_GAE and Cora_PoS_GIC (3 hops; GAE trains EPOCHS epochs, GIC its own
# 50), SVGAE-init the same config with the JAX package's 2,000 SVGAE epochs.
# CN, AA and PPR score the split with the heuristic alone (a raw AUC in [0, 1]).
INIT_PATHS = {
    "PoS-n2v": dict(init_features="n2v", n2v_dim=16, pool_operatorwise=True),
    "ScaLed": dict(m=3, M=20, num_hops=0, pool_operatorwise=True),
    "ScaLed-Plus": dict(m=3, M=20, num_hops=0, pool_operatorwise=True, k_heuristic=1,
                        k_node_set_strategy="intersection", k_pool_strategy="mean"),
    "GAE-init": dict(init_representation="GAE", num_hops=3, pool_operatorwise=True),
    "GIC-init": dict(init_representation="GIC", num_hops=3, pool_operatorwise=True),
    "SVGAE-init": dict(init_representation="SVGAE", num_hops=3, pool_operatorwise=True),
    "CN": dict(use_heuristic="CN"),
    "AA": dict(use_heuristic="AA"),
    "PPR": dict(use_heuristic="PPR"),
}
# configs/paper/walkpool.json's USAir_WalkPool at its widths (hidden 32,
# 2 heads, walk length 7, 2 hops, DRNL, no node features, batch 32, lr 5e-5;
# S = 512 on this graph), cut in links and epochs only: 10 % of the train
# links, every valid and test link, EPOCHS epochs. The JAX package takes
# about 15 minutes on a CPU for that cut.
WALKPOOL = dict(
    model="WalkPool", node_label="drnl", init_features="", use_feature=False,
    hidden_channels=32, num_hops=2, batch_size=32, lr=5e-5, dropout=0.5,
    train_percent=10.0, val_percent=100.0, test_percent=100.0,
)
# The non-subgraph baselines at tests/test_models_extra.py:79-96's settings
# (hidden 32, lr 0.01; MF 10 epochs, GNN 15 epochs), node2vec + logistic
# regression with n2v_dim 32 and 10 node2vec epochs: keyword arguments of
# models/baselines.py's train_mf, train_gnn and run_n2v.
BASELINES = {
    "MF": ("mf", dict(hidden_channels=32, epochs=10, lr=0.01)),
    "GNN-GCN": ("gnn", dict(layer="GCN", hidden_channels=32, epochs=15, lr=0.01)),
    "GNN-SAGE": ("gnn", dict(layer="SAGE", hidden_channels=32, epochs=15, lr=0.01)),
    "GNN-GIN": ("gnn", dict(layer="GIN", hidden_channels=32, epochs=15, lr=0.01)),
    "n2v": ("n2v", dict(hidden_channels=32, epochs=10, lr=0.01)),
}
SCALED_PATHS = ("ScaLed", "ScaLed-Plus")
# The paths whose seeded runs did not repeat on the card before they added
# in a fixed order (ROADMAP §3 item 1): RunConfig fields over BENCH, run
# twice at REPEAT_EPOCHS epochs.
# The sampled paths (per-hop sampling, drawn from jax.random's uniforms as the
# JAX package draws them): RunConfig fields over BENCH and their epochs. The
# bench config with ratio_per_hop 0.5, and SEAL (Table 2's USAir widths) with
# max_nodes_per_hop 10 on the dynamic route (the static cache needs no
# sampling).
SAMPLED_PATHS = {"PoS-sampled": (dict(ratio_per_hop=0.5), EPOCHS),
                 "SEAL-sampled": ({**TABLE_2, "max_nodes_per_hop": 10}, 2)}
# Pairwise training (the reference's train_pairwise with the PLNLP losses)
# and the validation edges joined to the observed graph: RunConfig fields
# over BENCH, EPOCHS epochs each.
PAIRWISE_PATHS = {f"pairwise-{f}": dict(pairwise=True, neg_ratio=1, loss_fn=f)
                  for f in ("auc_loss", "weighted_auc_loss", "hinge_auc_loss")}
VALEDGES = dict(use_valedges_as_input=True)
REPEAT_PATHS = {"SoP": dict(sign_type="SoP", pool_operatorwise=True),
                "hybrid": dict(sign_type="hybrid", pool_operatorwise=True),
                "SEAL": TABLE_2, "PoS-n2v": INIT_PATHS["PoS-n2v"],
                "PoS-sampled": SAMPLED_PATHS["PoS-sampled"][0],
                "pairwise-auc_loss": PAIRWISE_PATHS["pairwise-auc_loss"]}
REPEAT_EPOCHS = 2
BASELINE_SEEDS = (1, 2, 3)
# The JAX package's best test AUC of each of BASELINES over seeds 1-3, each
# on usair_like_edges(seed) split by that seed, from
#   JAX_PLATFORMS=cpu python scripts/jax_synthetic_auc.py --seed S \
#       --baseline mf|gnn-GCN|gnn-SAGE|gnn-GIN|n2v
# The port is held by its mean over the same seeds: the two packages draw
# weights, dropout and negatives from different generators.
JAX_BASELINE_AUC = {
    "MF": (54.16914633339945, 53.86714996942964, 48.491134596908026),
    "GNN-GCN": (73.514955145584, 72.8273211634204, 68.25923661455148),
    "GNN-SAGE": (66.10460887390069, 59.920080356363, 58.8391999301249),
    "GNN-GIN": (67.99356388723578, 67.37269630535417, 64.76984889510001),
    "n2v": (55.16431924882629, 57.476635514018696, 58.177570093457945),
}
JAX_AUC_RANGE.update({k: max(v) - min(v) for k, v in JAX_BASELINE_AUC.items()})
# The paths profiled for their idle share, one of each kind; every path of
# LABEL_PATHS and INIT_PATHS read 0.90-0.98 when all were profiled, and
# the profiler's own cost grows with the device events (0.5 ms each).
IDLE_PATHS = ("SEAL", "ScaLed", "GAE-init", "PPR", "WalkPool")


def bench_config(seed: int, epochs: int, results_dir: str):
    from s3grl_tpu_torch.config import RunConfig

    # BENCH, plus a fresh dataset every run and a local results dir.
    return RunConfig(**BENCH, seed=seed, epochs=epochs, delete_dataset=True,
                     results_dir=results_dir)


def split_graph(cfg):
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.utils.seeding import seed_everything
    from torch_port_helpers import usair_like_edges

    g = Graph(num_nodes=332, edge_index=usair_like_edges(cfg.seed))
    rng, _ = seed_everything(cfg.seed)
    return do_edge_split(
        g, val_ratio=cfg.split_val_ratio, test_ratio=cfg.split_test_ratio, rng=rng
    )


def device_time(prof) -> tuple[float, dict[str, float], int]:
    """(busy microseconds, device microseconds by event name, number of
    device events) of a ``torch.profiler`` trace. Annotations on the device
    timeline (``Optimizer.step#...``) span other kernels and are left out."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, by_name, len(spans)


def fmt_device(by_name: dict[str, float]) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))


def phase_environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(smi)
    return smi


def phase_build() -> None:
    from s3grl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel(s) in {time.perf_counter() - t0:.2f} s")
    for k in built.values():
        usage = [ln.strip() for ln in k.log.splitlines()
                 if re.search(r"registers|spill|smem", ln)]
        print(f"  {k.name}: nvcc {k.seconds:.2f} s; " + " | ".join(usage))


def by_id_kwargs(dg, links, nodes, mask, sign_k, max_ccn=0, strategy=""):
    """The kwargs of ``pos_power_rows`` as the global route calls it on one
    batch (``operators/pos.pos_operators_global``): the graph's table,
    degrees and features read by node id, with the batch's selected rows,
    row ids and links (``by_id_kernel_inputs``)."""
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs

    sel, row_ids, lk, _ = by_id_kernel_inputs(dg, links, nodes, mask, max_ccn=max_ccn,
                                              strategy=strategy)
    return dict(sel_idx=sel, nbr=dg.nbr, w=dg.degrees(), subg_x=dg.x_with_indicator(),
                sign_k=sign_k, row_ids=row_ids, links=lk)


def gathered_kwargs(kw):
    """A by-id call's kwargs as the gathered per-batch [B, S, *] arrays it
    stands for (``pos_kernel.gather_by_id``: those of
    ``operators/pos.global_kernel_inputs``, the global route's inputs before
    it read by id)."""
    from s3grl_tpu_torch.ops.pos_kernel import gather_by_id

    nbr, w, x = gather_by_id(kw["nbr"], kw["w"], kw["subg_x"], kw["row_ids"], kw["links"])
    return dict(sel_idx=kw["sel_idx"], nbr=nbr, w=w, subg_x=x, sign_k=kw["sign_k"],
                row_ids=kw["row_ids"])


def kernel_cases(cfg, graph, split):
    """Kernel inputs at the main path's shapes, from the main path's data:
    (label, kwargs of pos_power_rows, node mask [B, S] of the member slots).
    The global cases ("global", "hub global", "blog global") read the graph
    by id, as the global route does (:func:`by_id_kwargs`)."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import batch_cap
    from s3grl_tpu_torch.sampling.extraction import (
        DeviceGraph, extract_node_sets, extract_subgraphs,
    )

    g = init_features(graph, cfg.init_features)
    dg = DeviceGraph.from_graph(g, device="cuda")
    F, D = int(dg.x.shape[1]), int(dg.nbr.shape[1])
    links_all = np.concatenate([split.train_pos, split.train_neg]).astype(np.int32)

    def links_for(B):
        reps = -(-B // len(links_all))
        return torch.as_tensor(np.tile(links_all, (reps, 1))[:B], device="cuda")

    cases = []
    for S, ccn, strategy in ((64, 0, ""), (128, 0, ""), (256, 0, ""), (512, 0, ""),
                             (256, 32, "union")):
        B = batch_cap(S, F, D, ccn, cfg.extract_batch_size)
        lb = links_for(B)
        nodes, mask, _, _ = extract_node_sets(dg, lb, num_hops=cfg.num_hops, max_nodes=S)
        kw = by_id_kwargs(dg, lb, nodes, mask, cfg.sign_k, ccn, strategy)
        cases.append((f"global S={S} R={kw['sel_idx'].shape[1]} B={B}", kw, mask))
    S = 128
    B = batch_cap(S, F, D, 0, cfg.extract_batch_size)
    sub = extract_subgraphs(dg, links_for(B), num_hops=cfg.num_hops, max_nodes=S)
    x = torch.cat([torch.zeros((B, S, 1), device="cuda"),
                   dg.x[sub.nodes.long()] * sub.node_mask[:, :, None]], dim=-1)
    x[:, :2, 0] = 1.0
    sel = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda").expand(B, 2).contiguous()
    cases.append((f"local S={S} R=2 B={B}",
                  dict(sel_idx=sel, nbr=sub.nbr_local.contiguous(), w=sub.nbr_w.contiguous(),
                       subg_x=x.contiguous(), sign_k=cfg.sign_k, row_ids=None),
                  sub.node_mask))
    cases += scaled_kernel_cases(cfg, dg, split)
    cases += hub_kernel_cases()
    cases.append(blog_kernel_case())
    return cases, D, F


def scaled_kernel_cases(cfg, dg, split):
    """``pos_power_rows`` in local-slot mode on each ScaLed path's first
    train batch, planned by ``scaled_batch_plan`` as ``precompute_pos``
    plans it: the same links, seeds, bucket, batch size and CCN width."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.operators.pos import (
        local_kernel_inputs, padded_ccn_width, scaled_batch_plan,
    )
    from s3grl_tpu_torch.sampling.random_walk import extract_rw_subgraphs

    cases = []
    for name in SCALED_PATHS:
        c = dataclasses.replace(cfg, **INIT_PATHS[name])
        links = split_links(c, split)["train"].astype(np.int32)
        ccn = (padded_ccn_width(dg, links, c.k_node_set_strategy, c.max_ccn_nodes)
               if c.k_heuristic else 0)
        S, B, seeds = scaled_batch_plan(
            dg, len(links), rw_m=c.m, rw_M=c.M, seed=c.seed, eff_ccn=ccn,
            buckets=c.subgraph_buckets, max_subgraph_nodes=c.max_subgraph_nodes,
            batch_size=c.extract_batch_size,
        )
        B = min(B, len(links))
        sub = extract_rw_subgraphs(dg, torch.as_tensor(links[:B], device="cuda"),
                                   torch.as_tensor(seeds[:B], device="cuda"),
                                   rw_m=c.m, rw_M=c.M, max_nodes=S)
        sel, nbr, w, x, _ = local_kernel_inputs(sub, dg.x, max_ccn=ccn,
                                                strategy=c.k_node_set_strategy)
        cases.append((f"{name} local S={S} R={sel.shape[1]} B={B}",
                      dict(sel_idx=sel, nbr=nbr, w=w, subg_x=x, sign_k=c.sign_k,
                           row_ids=None), sub.node_mask))
    return cases


def card_rates():
    """The card's peak rates (``utils.device.PEAK_RATES``), None for a card
    not listed there: its bounds and shares are then printed as unknown."""
    import torch

    from s3grl_tpu_torch.utils.device import peak_rates

    return peak_rates(torch.cuda.get_device_name(0))


def f4(x) -> str:
    return "unknown" if x is None else f"{x:.4f}"


def ratio(a, b):
    return None if a is None or b is None else a / b


def bound_of(kw, node_mask) -> tuple:
    """(bound_ms, bound_by, bytes, flops, resolved entries per subgraph,
    bound_ms over every padded slot, bound_ms over the member rows' live
    entries) of one ``pos_power_rows`` call: ``pos_kernel.work`` (its
    docstring says what it counts) over the card's peak rates. A by-id call
    reads no padding: its padded bound is that of the gathered arrays it
    stands for (:func:`gathered_kwargs`)."""
    from s3grl_tpu_torch.ops.pos_kernel import resolved_entries, work
    from s3grl_tpu_torch.utils.device import bound_ms

    rates = card_rates()
    gathered = gathered_kwargs(kw) if kw["nbr"].dim() == 2 else kw
    counts = {c: work(**kw, node_mask=node_mask, count=c) for c in ("members", "live")}
    counts["padded"] = work(**gathered, node_mask=node_mask, count="padded")
    per_subgraph = resolved_entries(gathered["nbr"], gathered["w"],
                                    gathered["row_ids"]).cpu().numpy()
    return (*bound_ms(counts["members"], rates), counts["members"].n_bytes,
            counts["members"].flops, per_subgraph, bound_ms(counts["padded"], rates)[0],
            bound_ms(counts["live"], rates)[0])


def phase_kernels(cfg, graph, split, power_limit: str):
    import torch

    from s3grl_tpu_torch.ops import pos_kernel
    from s3grl_tpu_torch.ops.pos_kernel import (
        pos_power_rows, pos_power_rows_reference, pos_selector_rows,
        pos_selector_rows_reference,
    )
    from s3grl_tpu_torch.utils import timing

    cases, D, F = kernel_cases(cfg, graph, split)
    print(f"kernel phase: D={D} F={F + 1} (features + indicator) K={cfg.sign_k}; "
          f"card {power_limit}")
    rows, hub_out = {}, {}
    for label, kw, node_mask in cases:
        got = pos_power_rows(**kw)
        if label.startswith("hub "):
            hub_out[label] = got
        want = pos_power_rows_reference(**kw)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        max_abs = float(diff.max())
        big = want.abs() > TOL["atol"]
        max_rel = float((diff[big] / want.abs()[big]).max()) if bool(big.any()) else 0.0
        ok = bool((diff <= TOL["atol"] + TOL["rtol"] * want.abs()).all())
        if not ok:
            raise AssertionError(
                f"pos_power_rows disagrees with its plain version at {label}: "
                f"max abs err {max_abs} (tolerance rtol {TOL['rtol']}, atol {TOL['atol']})"
            )
        spelled_kw = None
        by_id = kw["nbr"].dim() == 2
        if kw["w"] is None:  # a card-built local table: no weight array
            spelled_kw = {**kw, "w": (kw["nbr"] >= 0).float()}
            if not torch.equal(got, pos_power_rows(**spelled_kw)):
                raise AssertionError(f"pos_power_rows with w=None differs from w = loc >= 0 "
                                     f"at {label}")
        # Phase 1 alone: the selector rows H against their plain version.
        sel_kw = {k: kw[k] for k in ("sel_idx", "nbr", "w", "sign_k", "row_ids", "links")
                  if k in kw}
        h_err = float((pos_selector_rows(**sel_kw)
                       - pos_selector_rows_reference(**sel_kw)).abs().max())
        if h_err > TOL["atol"]:
            raise AssertionError(f"pos_selector_rows disagrees with its plain version at "
                                 f"{label}: max abs err {h_err} (atol {TOL['atol']})")
        fn = lambda: pos_power_rows(**kw)  # noqa: E731
        with timing.ClockSampler() as clocks:
            ms, device_ms = timing.call_ms(fn), timing.graph_ms(fn)
        host_ms = timing.host_ms(fn)
        B, S = kw["row_ids"].shape if by_id else kw["nbr"].shape[:2]
        Dk = kw["nbr"].shape[-1]
        lib = pos_kernel._lib()
        # The selector phase alone, and at K = 0: its one pass over the table
        # (with the hash build and the scaling) without the K steps.
        phase1_ms, table_ms = (timing.graph_ms(lambda: pos_kernel._selector_rows_cuda(
            lib, kw["sel_idx"], kw["nbr"], kw["w"], kw["row_ids"], k, B, S, Dk,
            kw["sel_idx"].shape[1], links=kw.get("links")))
            for k in (kw["sign_k"], 0))
        gathered = ""
        gathered_ms = gathered_bound = None
        if by_id:  # the same call on the gathered arrays: the same bits, and its time
            gkw = gathered_kwargs(kw)
            if not torch.equal(got, pos_power_rows(**gkw)):
                raise AssertionError(f"pos_power_rows by id differs from the call on the "
                                     f"gathered arrays at {label}")
            gathered_ms = timing.graph_ms(lambda: pos_power_rows(**gkw))
            gathered_bound = bound_of(gkw, node_mask)[0]
            gathered = (f"; on the gathered [B, S, *] arrays (the same bits) {gathered_ms:.4f} ms, "
                        f"bound {f4(gathered_bound)} ms")
            del gkw
        plain_ms = timing.call_ms(lambda: pos_power_rows_reference(**kw), reps=3)
        bound_ms, by, n_bytes, flops, nnz, padded_ms, degree_ms = bound_of(kw, node_mask)
        spelled = ""
        if spelled_kw is not None:  # the same call reading a weight array
            spelled_ms = timing.graph_ms(lambda: pos_power_rows(**spelled_kw))
            spelled = (f"; with w = loc >= 0 spelled out (the same bits) {spelled_ms:.4f} ms, "
                       f"bound {f4(bound_of(spelled_kw, node_mask)[0])} ms")
            del spelled_kw
        members = int(node_mask.sum())
        cap = lib.s3grl_pos_list_cap(S, Dk)
        rows[label] = dict(max_abs_err=max_abs, ms=ms, device_ms=device_ms, host_ms=host_ms,
                           plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by, phase1_ms=phase1_ms,
                           resolved_entries=int(nnz.sum()), member_rows=members,
                           padded_bound_ms=padded_ms, degree_bound_ms=degree_ms,
                           gathered_device_ms=gathered_ms, gathered_bound_ms=gathered_bound)
        print(f"  {label}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(selector rows {h_err:.3e}) kernel {device_ms:.4f} ms device by graph "
              f"replay, {ms:.4f} ms a call on the stream, {host_ms:.4f} ms of host a call "
              f"(SM clock MHz min/median/max {clocks.summary().get('sm_mhz')}) (selector "
              f"phase {phase1_ms:.4f} ms, of it the table pass {table_ms:.4f} ms) plain "
              f"{plain_ms:.4f} ms bound "
              f"{f4(bound_ms)} ms ({by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP over "
              f"{members} member rows of {B * S}; {f4(padded_ms)} ms over every padded slot, "
              f"{f4(degree_ms)} ms over the member rows' live entries) share of bound "
              f"{f4(ratio(bound_ms, device_ms))}; resolved entries {int(nnz.sum())} "
              f"(per subgraph mean {nnz.mean():.1f}, max {int(nnz.max())}; "
              f"{int((nnz > cap).sum())} of {B} over the {cap}-entry shared-memory list)"
              f"{spelled}{gathered}")
    want = next(v for k, v in hub_out.items() if k.startswith("hub global"))
    for label, got in hub_out.items():
        if label.startswith("hub local") and not torch.equal(got[:len(want)], want):
            raise AssertionError(f"pos_power_rows on the local tables at {label} differs from "
                                 f"the global-table call")
    print("  each hub local row equal to the hub global row bit for bit (on the links both "
          "batches hold)")
    return rows


def local_table_batches(cfg, graph, split) -> dict:
    """{label: (DeviceGraph, links [B, 2], nodes [B, S] int32, node mask)}:
    the main path's S = 256 batch as :func:`kernel_cases` builds it, and
    the local route's first batch of the hub graph (:func:`hub_batch`)."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import batch_cap
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph, extract_node_sets

    dg = DeviceGraph.from_graph(init_features(graph, cfg.init_features), device="cuda")
    S = 256
    B = batch_cap(S, int(dg.x.shape[1]), int(dg.nbr.shape[1]), 0, cfg.extract_batch_size)
    links_all = np.concatenate([split.train_pos, split.train_neg]).astype(np.int32)
    lb = torch.as_tensor(np.tile(links_all, (-(-B // len(links_all)), 1))[:B], device="cuda")
    nodes, mask, _, _ = extract_node_sets(dg, lb, num_hops=cfg.num_hops, max_nodes=S)
    hub = hub_batch(local=True)
    return {f"main path S={S} B={B}": (dg, lb, nodes, mask),
            f"hub S={LARGE_S} B={len(hub[1])}": hub}


# Rows of one subgraph a block of ``local_table`` builds, swept in
# ``phase_local_table`` (each block hashes its subgraph's members once); the
# wrapper takes ``ops/local_table.rows_per_block``'s.
ROWS_PER_BLOCK_SWEEP = (8, 16, 32, 64, 128, 256)


def phase_local_table(cfg, graph, split, power_limit: str) -> dict:
    """``local_table`` against ``local_table_reference`` on the card, equal
    bit for bit (integer output), on :func:`local_table_batches`, at the
    route's width (``operators/pos.local_table_width``); its device time by
    graph replay of its one launch, its time a call on the stream
    (``call_ms``), the plain version's time and the bound of
    ``local_table.work`` (the member rows' live entries; over whole rows of
    the global table beside it); then, at each of ROWS_PER_BLOCK_SWEEP, the
    table (equal bit for bit again) and its device time."""
    import torch

    from s3grl_tpu_torch.operators.pos import local_table_width
    from s3grl_tpu_torch.ops import local_table as lt
    from s3grl_tpu_torch.utils import timing
    from s3grl_tpu_torch.utils.device import bound_ms

    rates = card_rates()
    print(f"local_table phase: card {power_limit}")
    rows = {}
    for label, (dg, links, nodes, mask) in local_table_batches(cfg, graph, split).items():
        nodes = nodes.to(torch.int32).contiguous()
        l32 = links.to(torch.int32).contiguous()
        D, W = int(dg.nbr.shape[1]), local_table_width(dg, int(nodes.shape[1]))
        args = (dg.nbr, dg.degrees(), nodes, mask, l32)
        got = lt.local_table(*args, W)
        want = lt.local_table_reference(*args, W)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"local_table differs from its plain version at {label}")
        mdeg = (got >= 0).sum(dim=2).amax(dim=1).cpu().numpy()
        device_ms = timing.graph_ms(lambda: lt.local_table(*args, W))
        ms = timing.call_ms(lambda: lt.local_table(*args, W))
        plain_ms = timing.call_ms(lambda: lt.local_table_reference(*args, W), reps=3)
        live = lt.work(dg.nbr, dg.degrees(), nodes, mask, W, count="live")
        padded = lt.work(dg.nbr, dg.degrees(), nodes, mask, W, count="padded")
        b_ms, by = bound_ms(live, rates)
        p_ms = bound_ms(padded, rates)[0]
        sweep = {}
        rule = lt.rows_per_block
        kept = rule(int(nodes.shape[1]), W)
        try:
            for r in ROWS_PER_BLOCK_SWEEP:
                lt.rows_per_block = lambda S, width, r=r: r
                if not torch.equal(lt.local_table(*args, W), want):
                    raise AssertionError(f"local_table at {r} rows a block differs from its "
                                         f"plain version at {label}")
                sweep[r] = timing.graph_ms(lambda: lt.local_table(*args, W))
        finally:
            lt.rows_per_block = rule
        rows[label] = dict(max_abs_err=0.0, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=by, padded_bound_ms=p_ms, width=W,
                           n_bytes=live.n_bytes, mdeg_max=int(mdeg.max()),
                           mdeg_mean=float(mdeg.mean()), rows_per_block=kept,
                           rows_per_block_ms=sweep)
        print(f"  {label} D_tab={D}: equal bit for bit; width {W} (mdeg mean "
              f"{mdeg.mean():.1f}, max {int(mdeg.max())}); kernel {device_ms:.4f} ms device "
              f"by graph replay, {ms:.4f} ms a call on the stream; plain {plain_ms:.4f} ms; "
              f"bound {f4(b_ms)} ms ({by}: {live.n_bytes / 1e6:.1f} MB; "
              f"{f4(p_ms)} ms reading whole global rows) share of bound "
              f"{f4(ratio(b_ms, device_ms))}; {kept} rows a block; device ms by rows a "
              f"block (equal bit for bit at each): "
              + ", ".join(f"{r} {t:.4f} ({f4(ratio(b_ms, t))})" for r, t in sweep.items()))
    return rows


def bsr_inputs(src, dst, n, w=None, rows=None):
    """M on the card, ``M[dst, src] = w``, as the kernel reads it
    (``csr_matrix``): by default the sym-normalized adjacency of (src, dst),
    n x n; with ``w`` and ``rows`` a [rows, n] row shard, as the
    row-partitioned chain builds it. That, its edge list (src, dst, w) and
    one torch CSR tensor of it."""
    import torch

    from s3grl_tpu_torch.ops.spmm import normalized_adjacency_weights
    from s3grl_tpu_torch.ops.spmm_kernel import csr_matrix

    if w is None:
        w = normalized_adjacency_weights(
            torch.as_tensor(src, dtype=torch.int64), torch.as_tensor(dst, dtype=torch.int64), n
        ).numpy()
    rows = n if rows is None else rows
    adj = csr_matrix(src, dst, w, rows, n, device="cuda")
    s_t = torch.as_tensor(src, dtype=torch.int64, device="cuda")
    d_t = torch.as_tensor(dst, dtype=torch.int64, device="cuda")
    w_t = torch.as_tensor(w, device="cuda")
    with warnings.catch_warnings():  # torch's notes on sparse invariants and beta CSR
        warnings.simplefilter("ignore", UserWarning)
        m_csr = torch.sparse_coo_tensor(torch.stack([d_t, s_t]), w_t, (rows, n))
        m_csr = m_csr.coalesce().to_sparse_csr()
    return adj, (s_t, d_t, w_t), m_csr


def bsr_case(label, src, dst, n, x, power_k=0, w=None, rows=None):
    """``bsr_spmm`` on M = the sym-normalized adjacency of (src, dst) and X
    (or, with ``w`` and ``rows``, a [rows, n] row shard): checked against
    its plain version (the dense blocks of ``blockify`` through
    ``bsr_spmm_reference``, or a shard's ``csr_spmm_reference``; and, with
    ``power_k``, the K-step chain against the plain chain), timed beside
    the plain version, the edge-list route (a square M only) and one
    ``torch.sparse.mm`` of M in CSR form."""
    import torch

    from s3grl_tpu_torch.ops.spmm import edge_list, spmm
    from s3grl_tpu_torch.ops.spmm_kernel import (
        blockify,
        bsr_spmm,
        bsr_spmm_reference,
        csr_spmm_reference,
        power_chain_of,
    )
    from s3grl_tpu_torch.ops.spmm_kernel import work as spmm_work
    from s3grl_tpu_torch.utils import timing
    from s3grl_tpu_torch.utils.device import Work
    from s3grl_tpu_torch.utils.device import bound_ms as bound_ms_for

    blocked = rows is None
    adj, (s_t, d_t, w_t), m_csr = bsr_inputs(src, dst, n, w, rows)
    rows = adj.num_nodes
    if blocked:
        blocks = blockify(src, dst, w_t.cpu().numpy(), n, device="cuda")
        plain = lambda y: bsr_spmm_reference(blocks, y)  # noqa: E731
    else:
        plain = lambda y: csr_spmm_reference(adj, y)  # noqa: E731
    c = int(x.shape[1])

    def check(got, want, what):
        diff = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= BSR_TOL["atol"] + BSR_TOL["rtol"] * want.abs()).all())
        if not ok:
            raise AssertionError(
                f"bsr_spmm disagrees with its plain version at {label} ({what}): max abs "
                f"err {diff} (tolerance rtol {BSR_TOL['rtol']}, atol {BSR_TOL['atol']})"
            )
        return diff

    max_abs = check(bsr_spmm(adj, x), plain(x), "one product")
    if power_k:
        chain_err = check(power_chain_of(lambda y: bsr_spmm(adj, y), x, power_k),
                          power_chain_of(plain, x, power_k), f"K={power_k} chain")
        max_abs = max(max_abs, chain_err)
    torch.cuda.synchronize()

    ms = timing.call_ms(lambda: bsr_spmm(adj, x))
    device_ms = timing.graph_ms(lambda: bsr_spmm(adj, x))
    host_ms = timing.host_ms(lambda: bsr_spmm(adj, x))
    plain_ms = timing.call_ms(lambda: plain(x), reps=3)
    edge_ms = None
    if rows == n:
        edges = edge_list(s_t, d_t, w_t, n)
        edge_ms = timing.call_ms(lambda: spmm(edges, x))
    library_ms = timing.call_ms(lambda: torch.sparse.mm(m_csr, x))

    # The bound is what the function Y = M X needs (spmm_kernel.work). The
    # dense-block layout's own figure (every block whole, 2*NB*128^2*C FLOP,
    # the JAX cost estimate's) is printed beside it (a blocked M only: a
    # shard has no blocks).
    nnz = int(adj.csr_vals.numel())
    need = spmm_work(adj, x)
    n_bytes, flops = need.n_bytes, need.flops
    bound_ms, by = bound_ms_for(need, card_rates())
    dense_ms, dense_note, nb = None, "", "n/a (CSR alone)"
    if blocked:
        nb, bs = blocks.num_blocks, int(blocks.blocks.shape[1])
        dense_bytes = 4 * (nb * bs * bs + (n + rows) * c + nb + blocks.num_row_blocks + 1)
        dense_flops = 2.0 * nb * bs * bs * c
        dense_ms, dense_by = bound_ms_for(Work(dense_bytes, dense_flops), card_rates())
        dense_note = (f"; dense-block layout's bound {f4(dense_ms)} ms ({dense_by}: "
                      f"{dense_bytes / 1e6:.2f} MB, {dense_flops / 1e9:.3f} GFLOP)")
    edge = "n/a (a row shard)" if edge_ms is None else f"{edge_ms:.4f} ms"
    shape = f"N={n} C={c}" if rows == n else f"rows={rows} N_pad={n} C={c}"
    print(f"  bsr_spmm {label}: {shape} NB={nb} nnz={nnz} max_abs_err {max_abs:.3e} "
          f"kernel {device_ms:.4f} ms device by graph replay, {ms:.4f} ms a call on the "
          f"stream, {host_ms:.4f} ms of host a call; plain {plain_ms:.4f} ms edge-list {edge} "
          f"torch.sparse.mm (CSR) {library_ms:.4f} ms bound {f4(bound_ms)} ms "
          f"({by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP, 2*nnz*C) "
          f"share of bound {f4(ratio(bound_ms, device_ms))}{dense_note}")
    return dict(max_abs_err=max_abs, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                edge_list_ms=edge_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                bound_ms_dense_blocks=dense_ms, shape=f"{label} {shape} NB={nb} nnz={nnz}")


def sop_batch_columns(cfg, graph, split):
    """X of SoP's per-batch propagation on the main path: the one-hot
    endpoint columns [N, 2B] of the first batch of train links (positives
    then negatives, B as ``precompute_sop`` picks it), as ``_sop_batch``
    builds them before its first ``bsr_spmm``."""
    import torch

    from s3grl_tpu_torch.operators.sop import sop_batch_size
    from s3grl_tpu_torch.runner import build_split_links

    links, _ = build_split_links("train", split, cfg.train_percent, np.random.default_rng(SEED))
    B = min(len(links), sop_batch_size(graph.num_nodes, int(graph.edge_index.shape[1])))
    ends = torch.as_tensor(links[:B].astype(np.int64).reshape(-1), device="cuda")
    R = torch.zeros((graph.num_nodes, 2 * B), dtype=torch.float32, device="cuda")
    R[ends, torch.arange(2 * B, device="cuda")] = 1.0
    return R


def bsr_shapes(cfg, graph, split):
    """(label, src, dst, n, x, power_k) of ``bsr_spmm``'s three shapes: the
    main path's two (the SoP chain of the split graph with its degree
    features: one product and the K-step chain; SoP's per-batch
    propagation of the first batch's one-hot endpoint columns) and a
    Cora-shaped random graph with random X, where the kernel is forced (the
    selector takes the edge list there)."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from torch_port_helpers import cora_like_edges

    g = init_features(graph, cfg.init_features)
    x = torch.as_tensor(g.x, dtype=torch.float32, device="cuda")
    ei = cora_like_edges(SEED)
    rng = np.random.default_rng(SEED)
    xc = torch.as_tensor(rng.normal(size=(2708, 1433)).astype(np.float32), device="cuda")
    return [("main path (SoP chain)", g.edge_index[0], g.edge_index[1], g.num_nodes, x,
             cfg.sign_k),
            ("main path (SoP batch, one-hot endpoint columns)", g.edge_index[0],
             g.edge_index[1], g.num_nodes, sop_batch_columns(cfg, graph, split), 0),
            ("Cora-shaped random graph (forced)", ei[0], ei[1], 2708, xc, 0)]


def phase_bsr_kernel(cfg, graph, split, power_limit: str):
    """``bsr_spmm`` at each of :func:`bsr_shapes`; returns their rows."""
    from s3grl_tpu_torch.ops.spmm_kernel import should_use_bsr

    print(f"bsr_spmm kernel phase: card {power_limit}")
    shapes = bsr_shapes(cfg, graph, split)
    (_, src, dst, n, x, _), cora = shapes[0], shapes[-1]
    if not should_use_bsr(src, dst, n, x.shape[1]):
        raise AssertionError("the selector does not pick bsr_spmm on the main path")
    pick = should_use_bsr(*cora[1:4], cora[4].shape[1])
    print(f"  selector on the Cora shape: {'bsr' if pick else 'edge list'}")
    return [bsr_case(*shape[:5], power_k=shape[5]) for shape in shapes]


# The main path's global S = 256 row and the hub row, where the sum of the
# profiler's kept device events over the calls made once read short of the
# CUDA events (PERF.md §6). There the profiler's per-launch means must agree
# with the graph replay's time within TIMER_AGREE.
TIMER_ROWS = ("global S=256 R=2 ", "hub ")
TIMER_AGREE = 0.10
PROFILER_REPS = 20
# Profiler sessions a row may take until one keeps events of every kernel.
PROFILER_SESSIONS = 3


def fmt_profile(prof: dict) -> str:
    return (f"{prof['events']} device events kept, lag {f4(prof['lag_ms'])} ms, tail "
            f"{f4(prof['tail_ms'])} ms, mean gap {f4(prof['gap_ms'])} ms; ms a launch: "
            f"{fmt_device(prof['by_name'])}")


def profiled_pos(kw) -> tuple[dict, float]:
    """``timing.profile_kernels`` of ``pos_power_rows(**kw)`` and its time a
    call: each kernel's per-launch mean times its launches a call. A call
    launches the selector and the X pass once each, or, where the selector
    is split over row blocks (``pos_selector_rows.split_launches`` counts
    it), a table pass, a degree pass, one step kernel a step and the X pass:
    ``prof["kernels"]`` kernels, ``prof["launched"]`` launches in all. Late
    in a long process a session can miss every launch of its window
    (``PERF.md`` §6): a session that kept no event of one of the kernels is
    taken again, up to PROFILER_SESSIONS in all (``prof["sessions"]``)."""
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows, pos_selector_rows
    from s3grl_tpu_torch.utils import timing

    k = kw["sign_k"]
    for sessions in range(1, PROFILER_SESSIONS + 1):
        split_before = pos_selector_rows.split_launches
        prof = timing.profile_kernels(lambda: pos_power_rows(**kw), PROFILER_REPS)
        split = pos_selector_rows.split_launches > split_before
        kernels, per_call = (3 + (k > 0), 3 + k) if split else (2, 2)
        if len(prof["launches"]) == kernels:
            break
    prof.update(sessions=sessions, kernels=kernels, launched=per_call * PROFILER_REPS)
    return prof, sum(v * (k if name == "pos_selector_step_kernel" else 1)
                     for name, v in prof["by_name"].items() if name.startswith("pos_"))


def phase_device_times(cfg, graph, split, rows, bsr_rows, power_limit: str) -> None:
    """Each kernel's device time per call by ``torch.profiler``
    (``timing.profile_kernels``: the mean of each kernel's kept device
    events), on the kernel phases' inputs built again, beside the graph
    replay's ``device_ms`` and the kept events' sum over the calls made
    (which reads short where the session missed events); at TIMER_ROWS the
    means must agree with ``device_ms`` within TIMER_AGREE. Adds ``profiler_ms`` (and, for ``bsr_spmm``,
    ``library_device_ms``) to the rows."""
    import torch

    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm
    from s3grl_tpu_torch.utils import timing

    print(f"device time phase (torch.profiler, {PROFILER_REPS} calls): card {power_limit}")
    cases, _, _ = kernel_cases(cfg, graph, split)
    for label, kw, _ in cases:
        r = rows[label]
        prof, r["profiler_ms"] = profiled_pos(kw)
        agree = r["profiler_ms"] / r["device_ms"] - 1
        print(f"  pos_power_rows {label}: {fmt_profile(prof)} (of {prof['launched']} "
              f"launched; session {prof['sessions']}); its {prof['kernels']} kernels "
              f"{r['profiler_ms']:.4f} ms against {r['device_ms']:.4f} ms by graph replay "
              f"({agree:+.3%}); the kept events' sum "
              f"over the calls {prof['kept_sum_ms']:.4f} ms; share of bound "
              f"{f4(ratio(r['bound_ms'], r['device_ms']))}")
        if label.startswith(TIMER_ROWS) and (len(prof["launches"]) != prof["kernels"]
                                             or abs(agree) > TIMER_AGREE):
            raise AssertionError(
                f"{label}: the profiler reads {r['profiler_ms']:.4f} ms over "
                f"{prof['launches']} kept events against the graph replay's "
                f"{r['device_ms']:.4f} ms (bar {TIMER_AGREE:.0%})")
    del cases
    for (label, src, dst, n, x, _), r in zip(bsr_shapes(cfg, graph, split), bsr_rows):
        adj, _, m_csr = bsr_inputs(src, dst, n)
        prof = timing.profile_kernels(lambda: bsr_spmm(adj, x), PROFILER_REPS)
        lib = timing.profile_kernels(lambda: torch.sparse.mm(m_csr, x), PROFILER_REPS)
        r["profiler_ms"] = sum(v for k, v in prof["by_name"].items() if k.startswith("csr_spmm"))
        r["library_device_ms"] = sum(lib["by_name"].values())
        print(f"  bsr_spmm {label}: {fmt_profile(prof)}; kernel {r['profiler_ms']:.4f} ms "
              f"against {r['device_ms']:.4f} ms by graph replay (share of bound "
              f"{f4(ratio(r['bound_ms'], r['device_ms']))}); torch.sparse.mm "
              f"{r['library_device_ms']:.4f} ms ({fmt_profile(lib)})")


def phase_end_to_end(cfg, graph, split):
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph, pick_bucket

    dg = DeviceGraph.from_graph(init_features(graph, cfg.init_features), device="cuda")
    n_links = {s: len(getattr(split, f"{s}_pos")) + len(getattr(split, f"{s}_neg"))
               for s in ("train", "valid", "test")}
    links = np.concatenate([np.concatenate([getattr(split, f"{s}_pos"),
                                            getattr(split, f"{s}_neg")])
                            for s in ("train", "valid", "test")]).astype(np.int32)
    sizes = measure_subgraph_sizes(dg, links, num_hops=cfg.num_hops)
    buckets = [b for b in cfg.subgraph_buckets if b <= cfg.max_subgraph_nodes]
    hist = {}
    for s in sizes:
        b = pick_bucket(int(s), buckets)
        hist[b] = hist.get(b, 0) + 1
    deg = graph.degrees
    print(f"graph: N={graph.num_nodes} E={graph.num_edges // 2} (observed, undirected) "
          f"max degree {int(deg.max())} D={int(dg.nbr.shape[1])} links {n_links} "
          f"bucket histogram {dict(sorted(hist.items()))}")
    del dg

    launches = {}
    for sign_type, kernels in PATHS.items():
        launches[sign_type] = run_path(cfg, graph, split, n_links, sign_type, kernels)
    return launches, hist


def run_path(cfg, graph, split, n_links, sign_type, kernels):
    """One 5-epoch run of ``sign_type``, with every kernel's count set to 0
    just before it and read just after; returns the counts."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = kernel_wrappers()
    cfg = dataclasses.replace(cfg, sign_type=sign_type,
                              pool_operatorwise=sign_type != "PoS")
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    prep, best, train_times, _, n_params = run_sgrl_learning(cfg, graph, split, device="cuda")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    total = sum(n_links.values())
    train_s = sum(train_times)
    print(f"e2e {sign_type}: prep {prep:.3f} s, precompute {total / prep:.1f} links/s "
          f"({total} links), train {cfg.epochs * n_links['train'] / train_s:.1f} links/s "
          f"({cfg.epochs} epochs x {n_links['train']} links in {train_s:.3f} s), "
          f"precompute+train {(total + cfg.epochs * n_links['train']) / (prep + train_s):.1f} "
          f"links/s, best test AUC {best:.4f}, params {n_params}, launches {launches}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    for name in kernels:
        if launches[name] == 0:
            raise AssertionError(f"the {sign_type} path never launched {name}")
    if launches["local_table"]:
        raise AssertionError(f"the {sign_type} path took the local-table route")
    if "bsr_spmm" in kernels:
        print(f"  bsr_spmm launches {launches['bsr_spmm']} (K = {cfg.sign_k} for each "
              f"split's chain and K for each batch of links of a split)")
    if not np.isfinite(best):
        raise AssertionError(f"{sign_type} best test AUC is not finite: {best}")
    ref = JAX_REFERENCE_AUC[sign_type]
    if best < ref - AUC_SLACK:
        raise AssertionError(
            f"{sign_type} best test AUC {best:.4f} is more than {AUC_SLACK / 100} below "
            f"the JAX package's {ref:.4f} on the same graph and config"
        )
    print(f"AUC check {sign_type}: {best:.4f} vs JAX {ref:.4f} (slack {AUC_SLACK})")
    return launches


def split_links(cfg, split) -> dict:
    """Each split's links at ``cfg``'s percents, drawn as the runner draws
    them."""
    from s3grl_tpu_torch.runner import build_split_links
    from s3grl_tpu_torch.utils.seeding import seed_everything

    rng, _ = seed_everything(cfg.seed)
    return {s: build_split_links(s, split, getattr(cfg, f"{p}_percent"), rng)[0]
            for s, p in (("train", "train"), ("valid", "val"), ("test", "test"))}


def fullrow_bytes(cfg, graph, links: dict) -> int:
    """The full-row datasets' bytes: per split, links x (K+1) x S x (Z+F) x 4,
    S the largest size bucket of the split's subgraphs."""
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph, pick_bucket

    dg = DeviceGraph.from_graph(init_features(graph, cfg.init_features), device="cuda")
    width = int(dg.x.shape[1]) + (2 if cfg.node_label in ("de", "de+") else 1)
    total = 0
    for lk in links.values():
        sizes = measure_subgraph_sizes(dg, lk.astype(np.int32), num_hops=cfg.num_hops)
        s_max = pick_bucket(int(sizes.max()), [b for b in cfg.subgraph_buckets
                                               if b <= cfg.max_subgraph_nodes])
        total += len(lk) * (cfg.sign_k + 1) * s_max * width * 4
    return total


def phase_label_paths(cfg, graph, split) -> dict:
    """One EPOCHS-epoch run of each label path, with every kernel's count set
    to 0 just before it and read just after; returns each path's numbers."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = kernel_wrappers()
    rows = {}
    for name, fields in LABEL_PATHS.items():
        c = dataclasses.replace(cfg, **fields)
        links = split_links(c, split)
        n = {s: len(lk) for s, lk in links.items()}
        extra = ""
        if not c.optimize_sign:
            extra = f", datasets {fullrow_bytes(c, graph, links) / 1e9:.3f} GB"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        prep, best, train_times, _, n_params = run_sgrl_learning(c, graph, split, device="cuda")
        launches = {k: fn.launches for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        train_s = sum(train_times)
        rate = c.epochs * n["train"] / train_s
        print(f"e2e {name}: model {c.model}, node_label {c.node_label}, links {n}{extra}; "
              f"prep {prep:.3f} s, train {rate:.1f} links/s ({c.epochs} epochs x "
              f"{n['train']} links in {train_s:.3f} s), best test AUC {best:.4f}, params "
              f"{n_params}, launches {launches}, max_memory_allocated {peak:.1f} MiB")
        if not np.isfinite(best):
            raise AssertionError(f"{name} best test AUC is not finite: {best}")
        ref, slack = JAX_REFERENCE_AUC[name], max(AUC_SLACK, JAX_AUC_RANGE[name])
        if best < ref - slack:
            raise AssertionError(
                f"{name} best test AUC {best:.4f} is more than {slack / 100} below the JAX "
                f"package's {ref:.4f} on the same graph and config"
            )
        print(f"AUC check {name}: {best:.4f} vs JAX {ref:.4f} (slack {slack})")
        rows[name] = dict(prep_s=prep, train_links_per_s=rate, peak_mib=peak, auc=best)
    return rows


def phase_init_paths(cfg, graph, split) -> dict:
    """One EPOCHS-epoch run of each path of INIT_PATHS, with every kernel's
    count set to 0 just before it and read just after; returns each path's
    numbers and counts."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = kernel_wrappers()
    rows = {}
    for name, fields in INIT_PATHS.items():
        c = dataclasses.replace(cfg, **fields)
        n = {s: len(lk) for s, lk in split_links(c, split).items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        pos_power_rows.local_launches = 0
        t0 = time.perf_counter()
        prep, best, train_times, _, n_params = run_sgrl_learning(c, graph, split, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        local = pos_power_rows.local_launches
        peak = torch.cuda.max_memory_allocated() / 2**20
        train_s = sum(train_times)
        rate = c.epochs * n["train"] / train_s if train_s else None
        trained = (f"train {rate:.1f} links/s ({c.epochs} epochs x {n['train']} links in "
                   f"{train_s:.3f} s)" if rate else "no training")
        print(f"e2e {name}: links {n}; prep {prep:.3f} s, {trained}, wall {wall:.3f} s, "
              f"best test AUC {best:.4f}, params {n_params}, launches {launches} (local-slot "
              f"pos_power_rows {local}), max_memory_allocated {peak:.1f} MiB")
        if not np.isfinite(best):
            raise AssertionError(f"{name} best test AUC is not finite: {best}")
        ref = JAX_REFERENCE_AUC[name]
        if c.use_heuristic:
            if abs(best - ref) > HEURISTIC_AUC_TOL:
                raise AssertionError(f"{name} AUC {best:.6f} differs from the JAX package's "
                                     f"{ref:.6f} by more than {HEURISTIC_AUC_TOL}")
            print(f"AUC check {name}: {best:.6f} vs JAX {ref:.6f} (tolerance "
                  f"{HEURISTIC_AUC_TOL})")
        else:
            if launches["pos_power_rows"] == 0:
                raise AssertionError(f"the {name} path never launched pos_power_rows")
            if name in SCALED_PATHS and not 0 < local == launches["pos_power_rows"]:
                raise AssertionError(f"the {name} path launched pos_power_rows "
                                     f"{launches['pos_power_rows']} times, {local} in "
                                     f"local-slot mode")
            slack = max(AUC_SLACK, JAX_AUC_RANGE[name])
            if best < ref - slack:
                raise AssertionError(
                    f"{name} best test AUC {best:.4f} is more than {slack / 100} below the "
                    f"JAX package's {ref:.4f} on the same graph and config"
                )
            print(f"AUC check {name}: {best:.4f} vs JAX {ref:.4f} (slack {slack})")
        rows[name] = dict(prep_s=prep, train_links_per_s=rate, peak_mib=peak, auc=best,
                          wall_s=wall, launches=launches, local_launches=local)
    return rows


WRAPPERS = ("pos_power_rows", "bsr_spmm", "local_table")


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name (WRAPPERS)."""
    from s3grl_tpu_torch.ops.local_table import local_table
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm

    return {"pos_power_rows": pos_power_rows, "bsr_spmm": bsr_spmm, "local_table": local_table}


def kernel_counts() -> dict:
    """Each kernel wrapper's launch count."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def zero_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def phase_repeat(cfg, graph, split) -> dict:
    """Each path of REPEAT_PATHS twice, REPEAT_EPOCHS epochs, seed 1, each
    run in a results dir of its own (so node2vec trains anew): the two best
    test AUCs must be equal. Returns each path's launches (both runs)."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    rows = {}
    for name, fields in REPEAT_PATHS.items():
        zero_counts()
        best = []
        for i in range(2):
            c = dataclasses.replace(cfg, **fields, epochs=REPEAT_EPOCHS, results_dir=os.path.join(
                cfg.results_dir, "repeat", f"{name}-{i}"))
            best.append(run_sgrl_learning(c, graph, split, device="cuda")[1])
        torch.cuda.synchronize()
        rows[name] = kernel_counts()
        print(f"repeat {name} ({REPEAT_EPOCHS} epochs, seed {cfg.seed}): best test AUC "
              f"{best[0]!r} / {best[1]!r}, launches {rows[name]}")
        if not np.isfinite(best[0]) or best[0] != best[1]:
            raise AssertionError(f"two seeded {name} runs gave {best[0]!r} and {best[1]!r}")
    return rows


def phase_walkpool(cfg, graph, split) -> dict:
    """configs/paper/walkpool.json's USAir_WalkPool at its widths, cut as
    WALKPOOL says, EPOCHS epochs: prep, train rate, peak memory and the best
    test AUC against the JAX package's on the same cut."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    c = dataclasses.replace(cfg, **WALKPOOL)
    n = {s: len(lk) for s, lk in split_links(c, split).items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    prep, best, train_times, inf_times, n_params = run_sgrl_learning(c, graph, split,
                                                                     device="cuda")
    peak = torch.cuda.max_memory_allocated() / 2**20
    train_s = sum(train_times)
    rate = c.epochs * n["train"] / train_s
    steps = -(-n["train"] // c.batch_size)
    print(f"e2e WalkPool: hidden {c.hidden_channels}, 2 heads, walk length 7, {c.num_hops} "
          f"hops, {c.node_label}, links {n}; prep {prep:.3f} s, train {rate:.1f} links/s "
          f"({c.epochs} epochs x {steps} steps in {train_s:.3f} s, "
          f"{1e3 * train_s / (c.epochs * steps):.2f} ms a step), inference "
          f"{sum(inf_times):.3f} s, best test AUC {best:.4f}, params {n_params}, launches "
          f"{kernel_counts()}, max_memory_allocated {peak:.1f} MiB")
    check_auc("WalkPool", best)
    return dict(prep_s=prep, train_links_per_s=rate, peak_mib=peak, auc=best)


def check_auc(name: str, best: float, ref: float | None = None) -> None:
    """Fail where ``best`` is not finite or is more than the path's slack
    (the larger of AUC_SLACK and the JAX spread over seeds 1-3) below the
    JAX package's AUC."""
    if not np.isfinite(best):
        raise AssertionError(f"{name} best test AUC is not finite: {best}")
    ref = JAX_REFERENCE_AUC[name] if ref is None else ref
    slack = max(AUC_SLACK, JAX_AUC_RANGE.get(name, 0.0))
    if best < ref - slack:
        raise AssertionError(f"{name} best test AUC {best:.4f} is more than {slack / 100} below "
                             f"the JAX package's {ref:.4f} on the same graph and config")
    print(f"AUC check {name}: {best:.4f} vs JAX {ref:.4f} (slack {slack})")


def phase_baselines() -> dict:
    """Each of BASELINES over seeds 1-3, each seed on its own synthetic
    graph and split (as scripts/jax_synthetic_auc.py --baseline makes them):
    the mean best test AUC against the JAX package's mean."""
    import torch

    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.models import baselines

    fns = {"mf": baselines.train_mf, "gnn": baselines.train_gnn, "n2v": baselines.run_n2v}
    rows = {}
    for name, (kind, kwargs) in BASELINES.items():
        aucs, secs = [], []
        zero_counts()
        for seed in BASELINE_SEEDS:
            graph, split = split_graph(RunConfig(seed=seed))
            t0 = time.perf_counter()
            out = fns[kind](graph, split, seed=seed, device="cuda", **kwargs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            aucs.append(out if kind == "n2v" else out[0])
        print(f"baseline {name} {kwargs}: best test AUC {aucs} (mean {np.mean(aucs):.4f}), "
              f"wall {[round(t, 3) for t in secs]} s, launches {kernel_counts()}")
        check_auc(name, float(np.mean(aucs)), ref=float(np.mean(JAX_BASELINE_AUC[name])))
        rows[name] = dict(aucs=aucs, wall_s=secs)
    return rows


class StopBeforeTraining(Exception):
    pass


class FitRecorder:
    """Wraps the runner's ``fit_signnet`` to keep the last run's per-epoch
    results (the runner returns only the best one), its train loss each
    epoch and the datasets and keywords it was given; with ``stop`` it raises
    :class:`StopBeforeTraining` instead of training."""

    def __init__(self, stop: bool = False):
        from s3grl_tpu_torch import runner

        self.runner, self.real, self.last = runner, runner.fit_signnet, None
        self.stop, self.losses, self.datasets, self.kwargs = stop, [], None, None

    def __enter__(self):
        def fit(*a, **kw):
            self.datasets, self.kwargs = a[:3], dict(kw)
            if self.stop:
                raise StopBeforeTraining
            hook = kw.get("logger_hook")

            def record(epoch, loss, results):
                self.losses.append(loss)
                if hook is not None:
                    hook(epoch, loss, results)

            kw["logger_hook"] = record
            self.last = self.real(*a, **kw)
            return self.last

        self.runner.fit_signnet = fit
        return self

    def __exit__(self, *exc):
        self.runner.fit_signnet = self.real


def phase_checkpoints(cfg, graph, split) -> dict:
    """The checkpoint flags on the PoS path at 2 epochs: save every epoch;
    resume from epoch 2 for a third; only_test scores epoch 2's checkpoint
    as the saving run scored it; test_multiple_models gives one row per
    file, each equal to the epoch's own."""
    import dataclasses

    from s3grl_tpu_torch.runner import run_sgrl_learning
    from s3grl_tpu_torch.train.checkpoint import saved_epochs

    res_dir = os.path.join(cfg.results_dir, "checkpoints")
    base = dataclasses.replace(cfg, res_dir=res_dir, epochs=2)
    zero_counts()
    rows = {}
    with FitRecorder() as rec:
        for label, fields in (("save", dict(checkpoint_training=True)),
                              ("resume", dict(checkpoint_training=True, continue_from=2,
                                              epochs=3)),
                              ("only_test", dict(only_test=True, continue_from=2)),
                              ("test_multiple_models", dict(test_multiple_models=True))):
            run_sgrl_learning(dataclasses.replace(base, **fields), graph, split, device="cuda")
            fit = rec.last
            rows[label] = ([r["AUC"][1] for r, _ in fit.results_per_epoch], len(fit.train_times))
            print(f"checkpoint {label}: test AUC by scored epoch {rows[label][0]}, "
                  f"{rows[label][1]} epoch(s) trained, files {saved_epochs(res_dir, 1)}")
    (saved, _), (resumed, n_resumed) = rows["save"], rows["resume"]
    if n_resumed != 1 or saved_epochs(res_dir, 1) != [1, 2, 3]:
        raise AssertionError("the resumed run did not train the one epoch left")
    if rows["only_test"][0] != [saved[1]]:
        raise AssertionError(f"only_test gave {rows['only_test'][0]}, epoch 2 scored {saved[1]}")
    if rows["test_multiple_models"][0] != saved + resumed:
        raise AssertionError(f"test_multiple_models gave {rows['test_multiple_models'][0]}, "
                             f"the epochs scored {saved + resumed}")
    counts = kernel_counts()
    print(f"checkpoint route: launches {counts}")
    return counts


def phase_profile(cfg, graph, split) -> dict:
    """The runner's profile route on the PoS path, 1 epoch: the stats JSON
    it writes, with the card's memory."""
    import dataclasses

    from s3grl_tpu_torch.runner import run_sgrl_learning

    c = dataclasses.replace(cfg, profile=True, epochs=1, save_appendix="_smoke")
    zero_counts()
    run_sgrl_learning(c, graph, split, device="cuda")
    path = os.path.join(c.results_dir, "stats", f"stats_SIGN_USAir__smoke_seed_{c.seed}.json")
    with open(path) as f:
        stats = json.load(f)
    mem = stats["device_memory"]
    print(f"profile: {os.path.relpath(path, c.results_dir)}: {json.dumps(stats)}")
    if not mem["max_allocated_mb"] > 0 or not stats["num_parameters"] > 0:
        raise AssertionError(f"the profile stats hold no card memory: {mem}")
    return kernel_counts()


def write_ogb_dir(root: str, graph, split) -> None:
    """The synthetic graph's split as a downloaded ogbl-collab directory:
    the observed edges in raw/edge.csv.gz, the split dicts of tensors in
    split/time/*.pt (valid and test with their negatives)."""
    import gzip

    import torch

    raw = os.path.join(root, "ogbl_collab", "raw")
    sp = os.path.join(root, "ogbl_collab", "split", "time")
    os.makedirs(raw)
    os.makedirs(sp)
    ei = graph.edge_index
    with gzip.open(os.path.join(raw, "edge.csv.gz"), "wt") as f:
        f.write("".join(f"{u},{v}\n" for u, v in ei.T if u < v))
    with gzip.open(os.path.join(raw, "num-node-list.csv.gz"), "wt") as f:
        f.write(f"{graph.num_nodes}\n")
    for s in ("train", "valid", "test"):
        d = {"edge": torch.as_tensor(getattr(split, f"{s}_pos").astype(np.int64))}
        if s != "train":
            d["edge_neg"] = torch.as_tensor(getattr(split, f"{s}_neg").astype(np.int64))
        torch.save(d, os.path.join(sp, f"{s}.pt"))


def phase_ogb(cfg, graph, split) -> dict:
    """The runner's OGB route: a synthetic ogbl-collab directory written
    under the results dir, read by the runner, PoS, scored by Hits@50."""
    import dataclasses

    from s3grl_tpu_torch.runner import run_sgrl_learning

    root = os.path.join(cfg.results_dir, "ogb")
    write_ogb_dir(root, graph, split)
    c = dataclasses.replace(cfg, dataset="ogbl-collab", data_root=root, epochs=2)
    zero_counts()
    prep, best, _, _, _ = run_sgrl_learning(c, device="cuda")
    counts = kernel_counts()
    print(f"ogb: ogbl-collab layout, PoS, 2 epochs: prep {prep:.3f} s, best test Hits@50 "
          f"{best:.4f}, launches {counts}")
    if not 0.0 <= best <= 100.0 or counts["pos_power_rows"] == 0:
        raise AssertionError(f"the OGB run gave Hits@50 {best} with launches {counts}")
    return counts


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# The large-graph phase: synthetic random graphs of average degree 20
# (tests/torch_port_helpers.random_edges with 10 pairs a node), LARGE_LINKS
# random links, 2 hops, the default largest bucket; L·E from 2e7 to 8e9.
LARGE_NODES = (500, 1_000, 2_000, 10_000, 50_000, 200_000)
LARGE_LINKS = 2_048
LARGE_HOPS = 2
LARGE_S = 1_024
LARGE_PREP_NODES = 50_000  # the graph the auto route runs on too
LARGE_FEATURES = 128
# The hub-dense shape: tests/torch_port_helpers.blogcatalog_like_edges (10,312
# nodes, 333,983 edges, hub degree 3,377: a global table 3,392 wide), 2 hops,
# S = 1,024, 128 feature columns; HUB_LINKS observed edges through
# precompute_pos, the first batch of which the kernel cases take.
HUB_LINKS = 256
HUB_FEATURES = 128
# BlogCatalog's batch on the benchmark's blogcatalog_pos.prep cell: 8 links
# at S = 4,096 with 1,025 feature columns (+ the indicator: 1,026).
BLOG_B = 8
BLOG_S = 4_096
BLOG_FEATURES = 1_025
# The narrow-local graph: LARGE_PREP_NODES nodes of average degree 20 and
# NARROW_HUBS hubs, NARROW_LINKS random links, 1 hop: subgraphs of ~40 nodes
# whose local degrees stay small beside a global table 3,008 wide.
NARROW_HUBS = 4
NARROW_HUB_DEGREE = 3_000
NARROW_LINKS = 2_048
NARROW_HOPS = 1
# Observed links of the Cora-shaped graph (cora_graph) through precompute_pos.
CORA_LINKS = 8_192


def sync_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0


def large_graph(n: int):
    """(Graph, DeviceGraph on the card, links [LARGE_LINKS, 2]) of the random
    graph of ``n`` nodes, average degree 20 and LARGE_FEATURES features."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import random_edges

    rng = np.random.default_rng(n)
    ei = random_edges(rng, n=n, e=10 * n)
    x = rng.normal(size=(n, LARGE_FEATURES)).astype(np.float32)
    g = Graph(num_nodes=n, edge_index=ei, x=x)
    links = rng.integers(0, n, (LARGE_LINKS, 2)).astype(np.int32)
    return g, DeviceGraph.from_graph(g, device="cuda"), links


def device_node_sets(dg, links):
    """The device route's sizing pass (512 links a batch, as
    measure_subgraph_sizes) and its node sets at LARGE_S (256 links a batch):
    (sizes, nodes, mask, sizing s, node-set s)."""
    import torch

    from s3grl_tpu_torch.operators.pos import measure_subgraph_sizes
    from s3grl_tpu_torch.sampling.extraction import extract_node_sets

    t0 = time.perf_counter()
    sizes = measure_subgraph_sizes(dg, links, num_hops=LARGE_HOPS)
    sizing_s = sync_s(t0)
    t0 = time.perf_counter()
    parts = []
    for a in range(0, len(links), 256):
        lb = torch.as_tensor(links[a : a + 256], device="cuda")
        nodes, mask, _, _ = extract_node_sets(dg, lb, num_hops=LARGE_HOPS, max_nodes=LARGE_S)
        parts.append((nodes, mask))
    nodes = torch.cat([p[0] for p in parts]).cpu().numpy()
    mask = torch.cat([p[1] for p in parts]).cpu().numpy()
    return sizes, nodes, mask, sizing_s, sync_s(t0)


# precompute_pos' routes: the auto choice; the host or the device BFS on the
# global table; the host or the device BFS's node sets on the local tables
# the card builds.
ROUTES = {"auto": {},
          "host": dict(S3GRL_TPU_HOST_EXTRACT="1", S3GRL_TPU_LOCAL_TAB="0"),
          "device": dict(S3GRL_TPU_HOST_EXTRACT="0", S3GRL_TPU_LOCAL_TAB="0"),
          "local": dict(S3GRL_TPU_HOST_EXTRACT="1", S3GRL_TPU_LOCAL_TAB="1"),
          "device-local": dict(S3GRL_TPU_HOST_EXTRACT="0", S3GRL_TPU_LOCAL_TAB="1")}
# Each route on the local tables beside the same BFS on the global table.
LOCAL_PAIRS = (("local", "host"), ("device-local", "device"))


def prep_both_ways(dg, links, label: str, routes=("host", "device"), hops: int = LARGE_HOPS,
                   rounds: int = 0) -> dict:
    """``precompute_pos`` (``hops`` hops, K = 3) of ``links`` by each of
    ``routes`` (ROUTES), which must give the same datasets bit for bit, each
    route's counts set to 0 just before it and read just after: {route:
    (prep s, launches)}. The local routes must launch ``local_table`` and the
    global ones must not. With ``rounds``, the graph's host CSR and degrees
    are built first, and the routes run once untimed, then ``rounds`` timed
    passes, in order and in reverse order by turns (prep s is then the
    tuple of readings)."""
    import torch

    from s3grl_tpu_torch.operators.pos import precompute_pos

    y = np.ones(len(links), np.float32)
    out, rows = {}, {}

    def run(route):
        zero_counts()
        t0 = time.perf_counter()
        with env(**ROUTES[route]):
            out[route] = precompute_pos(dg, links, y, num_hops=hops, sign_k=3, device="cuda")
        return sync_s(t0), kernel_counts()

    if rounds:
        dg.host_csr()
        dg.degrees()
        for route in routes:
            run(route)
        times = {route: [] for route in routes}
        for route in [r for i in range(rounds) for r in routes[:: 1 - 2 * (i % 2)]]:
            t, counts = run(route)
            times[route].append(t)
            rows[route] = (tuple(times[route]), counts)
    else:
        rows = {route: run(route) for route in routes}
    first = out[routes[0]]
    for route in routes[1:]:
        if not (torch.equal(out[route].xs, first.xs)
                and torch.equal(out[route].row_mask, first.row_mask)):
            raise AssertionError(f"{label}: the {routes[0]} and {route} routes' datasets differ")
    for route, (_, counts) in rows.items():
        took = counts["local_table"] > 0
        if route != "auto" and took != route.endswith("local"):
            raise AssertionError(f"{label}: the {route} route launched local_table "
                                 f"{counts['local_table']} times")
        if route.endswith("local") and counts["pos_power_rows"] == 0:
            raise AssertionError(f"{label}: the {route} route never launched pos_power_rows")

    def fmt(t):
        return " / ".join(f"{x:.4f}" for x in t) if isinstance(t, tuple) else f"{t:.4f}"

    print(f"  precompute_pos {label}: " + ", ".join(
        f"{r} prep {fmt(t)} s (launches pos_power_rows {c['pos_power_rows']}, local_table "
        f"{c['local_table']})" for r, (t, c) in rows.items()) + "; datasets equal bit for bit")
    return rows


def local_widths(dg, links, hops: int) -> dict:
    """{bucket: (batches, links, the tables' width, each batch's largest
    local degree)} of the local route's plan for ``links``, each batch's
    table built on the card from the host BFS's node sets."""
    import torch

    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.operators.pos import local_table_width, pos_plan
    from s3grl_tpu_torch.ops.local_table import local_table

    with env(**ROUTES["local"]):
        plan = pos_plan(dg, links, num_hops=hops, sign_k=3)
    out = {}
    for bucket, idx in plan.batches:
        nd, _ = native.khop_nodes(*dg.host_csr(), links[idx], hops, bucket)
        width = local_table_width(dg, bucket)
        loc = local_table(dg.nbr, dg.degrees(),
                          torch.as_tensor(np.where(nd >= 0, nd, 0), device="cuda"),
                          torch.as_tensor(nd >= 0, device="cuda"),
                          torch.as_tensor(links[idx], device="cuda"), width)
        mdeg = (loc >= 0).sum(dim=2).max()
        n_b, n_l, _, degs = out.get(bucket, (0, 0, width, []))
        out[bucket] = (n_b + 1, n_l + len(idx), width, degs + [int(mdeg.max())])
    return out


def local_route_rows(dg, links, label: str, routes, hops: int = LARGE_HOPS,
                     rounds: int = 2) -> dict:
    """The local route against the global routes on one graph
    (:func:`prep_both_ways`, ``rounds`` timed passes), with the plan's
    buckets, each bucket's S over the global table's width D_tab, and the
    local tables' widths: the readings the ``auto`` threshold stands on."""
    D = int(dg.nbr.shape[1])
    widths = local_widths(dg, links, hops)
    print(f"  {label}: D_tab {D}, {len(links)} links, {hops} hop(s); buckets (batches, "
          f"links, S/D_tab, table width, batches' largest local degree): " + "; ".join(
              f"{b}: ({nb}, {nl}, {b / D:.3f}, {w}, {min(ds)}-{max(ds)})"
              for b, (nb, nl, w, ds) in sorted(widths.items())))
    prep = prep_both_ways(dg, links, label, routes, hops=hops, rounds=rounds)
    return dict(d_tab=D, links=len(links), hops=hops,
                buckets={str(b): dict(batches=nb, links=nl, s_over_d=b / D, width=w,
                                      max_local_degree=ds)
                         for b, (nb, nl, w, ds) in widths.items()},
                prep_s={r: list(t) for r, (t, _) in prep.items()},
                launches={r: c for r, (_, c) in prep.items()})


def phase_large_graphs(cfg, graph, split, power_limit: str) -> dict:
    """(a) the BFS crossover: on each of LARGE_NODES, the sizing pass and
    the node sets by the device BFS and by the host core (``native.bfs_sizes``,
    one whole-split ``khop_nodes`` pass), which must agree, and
    ``precompute_pos`` with 128 features by each route, bit for bit; the
    same for the main path's train split; (b) ``precompute_pos`` on the
    LARGE_PREP_NODES graph by the auto route too; (c) the hub graph, whose
    kernel case phase_kernels runs, through ``precompute_pos`` by both
    routes, bit for bit. Returns the crossover rows and each route's kernel
    launches."""
    import torch

    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import HOST_EXTRACT_MIN_LE, LOCAL_TAB_MAX_S_OVER_D
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph

    print(f"large graphs: random graphs of average degree 20, {LARGE_LINKS} links, "
          f"{LARGE_HOPS} hops, S = {LARGE_S}, {LARGE_FEATURES} features; host core on "
          f"{os.cpu_count()} cores; card {power_limit}")
    rows, launches = [], {}
    for n in LARGE_NODES:
        g, dg, links = large_graph(n)
        E = int(dg.edge_src.shape[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        d_sizes, d_nodes, d_mask, d_size_s, d_nodes_s = device_node_sets(dg, links)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        t0 = time.perf_counter()
        row_ptr, col_idx = native.build_csr(*dg.host_edges()[:2], None, n)[:2]
        csr_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_sizes = native.bfs_sizes(row_ptr, col_idx, links, LARGE_HOPS)
        h_size_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_nodes, kh_sizes = native.khop_nodes(row_ptr, col_idx, links, LARGE_HOPS, LARGE_S)
        torch.as_tensor(h_nodes, device="cuda")  # the route ships them to the card
        h_nodes_s = sync_s(t0)
        if not np.array_equal(h_sizes, d_sizes):
            raise AssertionError(f"N={n}: host and device subgraph sizes differ")
        if not np.array_equal(np.minimum(kh_sizes, LARGE_S), np.minimum(d_sizes, LARGE_S)):
            raise AssertionError(f"N={n}: khop_nodes' sizes differ from the device BFS")
        if not (np.array_equal(h_nodes >= 0, d_mask)
                and np.array_equal(np.where(d_mask, d_nodes, -1), h_nodes)):
            raise AssertionError(f"N={n}: host and device node sets differ")
        dev_s, host_s = d_size_s + d_nodes_s, csr_s + h_nodes_s
        print(f"  N={n} E={E} L*E={LARGE_LINKS * E:.3e} mean size {d_sizes.mean():.1f} "
              f"(over {LARGE_S}: {int((d_sizes > LARGE_S).sum())}): device BFS sizing "
              f"{d_size_s:.4f} s + node sets {d_nodes_s:.4f} s = {dev_s:.4f} s, peak "
              f"{peak:.1f} MiB over the graph; host csr {csr_s:.4f} s, bfs_sizes "
              f"{h_size_s:.4f} s, khop_nodes (sizes + node sets, to the card) "
              f"{h_nodes_s:.4f} s, route {host_s:.4f} s; equal")
        routes = ("host", "device", "auto") if n == LARGE_PREP_NODES else ("host", "device")
        prep = prep_both_ways(dg, links, f"N={n}", routes)
        if n == LARGE_PREP_NODES:
            launches.update({f"large-graph {r}": c for r, (_, c) in prep.items() if r != "host"})
        rows.append(dict(nodes=n, edges=E, le=LARGE_LINKS * E, device_s=dev_s, host_s=host_s,
                         device_peak_mib=peak, prep_host_s=prep["host"][0],
                         prep_device_s=prep["device"][0]))
        del dg, g
        torch.cuda.empty_cache()
    # The main path's train split (bench config, degree features).
    links = split_links(cfg, split)["train"].astype(np.int32)
    dg = DeviceGraph.from_graph(init_features(graph, cfg.init_features), device="cuda")
    E = int(dg.edge_src.shape[0])
    prep = prep_both_ways(dg, links, f"main path train split (N={graph.num_nodes}, "
                          f"E={E}, {len(links)} links, L*E={len(links) * E:.3e})")
    rows.append(dict(nodes=graph.num_nodes, edges=E, le=len(links) * E, main_path=True,
                     prep_host_s=prep["host"][0], prep_device_s=prep["device"][0]))
    for key in ("host_s", "prep_host_s"):
        other = key.replace("host", "device")
        won = [r["le"] for r in rows if key in r and r[key] < r[other]]
        measured = sorted(r["le"] for r in rows if key in r)
        print(f"  crossover ({'BFS stage' if key == 'host_s' else 'precompute_pos'}): "
              f"the host route was faster at L*E {[f'{x:.1e}' for x in sorted(won)]} of "
              f"{[f'{x:.1e}' for x in measured]}; the default threshold is "
              f"{HOST_EXTRACT_MIN_LE:.0e}")

    # The local-table routes against the global routes on the same BFS: the
    # hub graph, the narrow-local graph, the arxiv-shaped graph, and the
    # Cora-shaped graph, where auto takes local tables in its small buckets
    # only; then the threshold's sweep (SWEEP).
    local, sweep = {}, {}
    both = ("host", "device", "local", "device-local")
    for name, make, hops, routes, rounds in (
            ("hub", hub_graph, LARGE_HOPS, both, 2),
            ("narrow-local", narrow_graph, NARROW_HOPS, both, 2),
            ("arxiv-shaped", arxiv_graph, LARGE_HOPS, ("host", "local"), 2),
            ("cora-shaped", cora_graph, LARGE_HOPS, ("device", "device-local", "auto"), 6)):
        g, dg, links = make()
        local[name] = local_route_rows(dg, links, f"{name} graph (N={g.num_nodes})", routes,
                                       hops=hops, rounds=rounds)
        for route in routes:
            key = f"{name} {'global' if route == 'host' else route}"
            launches[key] = local[name]["launches"][route]
        if name in SWEEP:
            sweep[name] = threshold_rows(dg, links, name, SWEEP[name])
        del dg, g
        torch.cuda.empty_cache()
    for name, r in local.items():
        t = {route: statistics.median(v) for route, v in r["prep_s"].items()}
        ratios = sorted(round(b["s_over_d"], 3) for b in r["buckets"].values())
        for lr, gr in LOCAL_PAIRS + (("auto", "device"),):
            if lr in t and gr in t:
                print(f"  {lr} route, {name}: prep {t[lr]:.4f} s against the {gr} route's "
                      f"{t[gr]:.4f} s (medians), {t[gr] / t[lr]:.3f}x; buckets' S/D_tab "
                      f"{ratios}; auto threshold S/D_tab <= {LOCAL_TAB_MAX_S_OVER_D}")
    return dict(crossover=rows, launches=launches, local_route=local, threshold_sweep=sweep)


# The auto threshold's sweep: buckets S of S/D_tab 0.17 to 1 against the
# global table's width, on the hub graph (D_tab 3,392), the arxiv-shaped
# graph (D_tab 512) and the Cora-shaped graph (D_tab 192), 2 hops.
SWEEP = {"hub": (1024, 2048, 3072), "arxiv-shaped": (128, 256, 512),
         "cora-shaped": (32, 64, 128)}


def threshold_rows(dg, links, name: str, sizes, hops: int = LARGE_HOPS) -> dict:
    """One batch's PoS operators by the global route (``pos_operators_global``:
    ``pos_power_rows`` reading the graph by id) and by the local route
    (``local_table_kernel_inputs``, then ``pos_power_rows``), each at its
    own batch cap, on the host BFS's node sets of ``links`` at each S of
    ``sizes`` (the largest subgraphs first), equal bit for bit on the links
    both batches hold: {S/D_tab: each route's B, ms a call on the stream
    (CUDA events) and ms a link}. What the local route saves a link in one
    bucket, leaving out the BFS the two routes share."""
    import torch

    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.operators.pos import (
        batch_cap, local_table_kernel_inputs, local_table_width, pos_operators_global,
    )
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.utils import timing

    D, F = int(dg.nbr.shape[1]), int(dg.x.shape[1])

    def global_ops(lb, nodes, mask):
        return pos_operators_global(dg, lb, nodes, mask, sign_k=3)[0]

    def local_ops(lb, nodes, mask):
        sel, loc, w, x, rm = local_table_kernel_inputs(dg, lb, nodes, mask)
        return pos_power_rows(sel, loc, w, x, sign_k=3) * rm[:, None, :, None]

    out = {}
    for S in sizes:
        nd, size = native.khop_nodes(*dg.host_csr(), links, hops, S)
        order = np.argsort(-np.minimum(size, S), kind="stable")
        row, got = dict(S=S), {}
        for route, fn, width in (("global", global_ops, D),
                                 ("local", local_ops, local_table_width(dg, S))):
            B = batch_cap(S, F, width, 0, 256)
            idx = order[:B]
            args = (torch.as_tensor(links[idx], device="cuda"),
                    torch.as_tensor(np.where(nd[idx] >= 0, nd[idx], 0), device="cuda"),
                    torch.as_tensor(nd[idx] >= 0, device="cuda"))
            got[route] = fn(*args)
            ms = timing.call_ms(lambda: fn(*args), reps=10)
            row[route] = dict(B=B, ms=ms, ms_a_link=ms / B)
        n = min(row["global"]["B"], row["local"]["B"])
        if not torch.equal(got["global"][:n], got["local"][:n]):
            raise AssertionError(f"{name} S={S}: the local and global routes' operators differ")
        del got
        g_, l_ = row["global"], row["local"]
        out[f"{S / D:.3f}"] = row
        print(f"  threshold sweep, {name} S={S} (S/D_tab {S / D:.3f}): global B={g_['B']} "
              f"{g_['ms']:.4f} ms a call, {g_['ms_a_link']:.5f} ms a link; local B={l_['B']} "
              f"{l_['ms']:.4f} ms, {l_['ms_a_link']:.5f} ms a link; global/local "
              f"{g_['ms_a_link'] / l_['ms_a_link']:.3f}x; equal bit for bit")
    return out


def hub_graph():
    """(Graph, DeviceGraph on the card, HUB_LINKS observed links) of the
    BlogCatalog-sized power-law graph with HUB_FEATURES normal features."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import blogcatalog_like_edges

    ei = blogcatalog_like_edges(SEED)
    n = int(ei.max()) + 1
    rng = np.random.default_rng(SEED)
    g = Graph(num_nodes=n, edge_index=ei,
              x=rng.normal(size=(n, HUB_FEATURES)).astype(np.float32))
    links = ei[:, rng.choice(ei.shape[1], HUB_LINKS, replace=False)].T.astype(np.int32)
    return g, DeviceGraph.from_graph(g, device="cuda"), links


def narrow_graph():
    """(Graph, DeviceGraph on the card, NARROW_LINKS random links) of the
    narrow-local graph: LARGE_PREP_NODES nodes of average degree 20
    (:func:`large_graph`'s) and NARROW_HUBS hubs of degree NARROW_HUB_DEGREE
    each (a global table 3,008 wide), LARGE_FEATURES normal features."""
    from s3grl_tpu_torch.data.graph import Graph, to_undirected
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import random_edges

    n = LARGE_PREP_NODES
    rng = np.random.default_rng(n + 4)
    ei = random_edges(rng, n=n, e=10 * n)
    hubs = [np.stack([np.full(NARROW_HUB_DEGREE, n + h),
                      rng.choice(n, NARROW_HUB_DEGREE, replace=False)])
            for h in range(NARROW_HUBS)]
    ei = to_undirected(np.concatenate([ei, *hubs], axis=1).astype(np.int32))
    n_all = n + NARROW_HUBS
    g = Graph(num_nodes=n_all, edge_index=ei,
              x=rng.normal(size=(n_all, LARGE_FEATURES)).astype(np.float32))
    links = rng.integers(0, n, (NARROW_LINKS, 2)).astype(np.int32)
    return g, DeviceGraph.from_graph(g, device="cuda"), links


def cora_graph():
    """(Graph, DeviceGraph on the card, CORA_LINKS observed links) of a
    power-law graph of Planetoid Cora's size (2,708 nodes, 5,278 edges;
    ``blogcatalog_like_edges`` at exponent 0.6: max degree 173, a global
    table 192 wide, as Cora's) with HUB_FEATURES normal features."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import blogcatalog_like_edges

    n = 2_708
    ei = blogcatalog_like_edges(SEED, n=n, n_undirected=5_278, exponent=0.6)
    rng = np.random.default_rng(SEED)
    g = Graph(num_nodes=n, edge_index=ei,
              x=rng.normal(size=(n, HUB_FEATURES)).astype(np.float32))
    links = ei[:, rng.choice(ei.shape[1], CORA_LINKS, replace=False)].T.astype(np.int32)
    return g, DeviceGraph.from_graph(g, device="cuda"), links


def arxiv_graph():
    """(Graph, DeviceGraph on the card, HUB_LINKS observed links) of an
    arxiv-shaped Chung-Lu graph (18,772 nodes, 198,110 edges, max degree
    505: a global table 512 wide) with HUB_FEATURES normal features."""
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from torch_port_helpers import blogcatalog_like_edges

    ei = blogcatalog_like_edges(SEED, n=18_772, n_undirected=198_110, exponent=0.375)
    n = int(ei.max()) + 1
    rng = np.random.default_rng(SEED)
    g = Graph(num_nodes=n, edge_index=ei,
              x=rng.normal(size=(n, HUB_FEATURES)).astype(np.float32))
    links = ei[:, rng.choice(ei.shape[1], HUB_LINKS, replace=False)].T.astype(np.int32)
    return g, DeviceGraph.from_graph(g, device="cuda"), links


def hub_batch(local: bool = False):
    """The first batch that ``precompute_pos``' host route runs in the hub
    graph's S = 1,024 bucket on the global table (B = 32), or with
    ``local`` on the local tables (B = 64: batch_cap at their width,
    ``local_table_width``): its links in the order of the route's clamped
    sizes, as (DeviceGraph, links [B, 2], nodes [B, S], node mask [B, S]) on
    the card. The global batch is the local one's first 32 links."""
    import inspect

    import torch

    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.operators.pos import (
        _size_buckets, batch_cap, local_table_width, precompute_pos,
    )
    from s3grl_tpu_torch.sampling.extraction import pick_bucket

    _, dg, links = hub_graph()
    width = local_table_width(dg, LARGE_S) if local else int(dg.nbr.shape[1])
    B = batch_cap(LARGE_S, HUB_FEATURES, width, 0, 256)
    buckets = _size_buckets(inspect.signature(precompute_pos).parameters["buckets"].default,
                            LARGE_S)
    nd, sizes = native.khop_nodes(*dg.host_csr(), links, LARGE_HOPS, LARGE_S)
    sizes = np.minimum(sizes, LARGE_S)
    order = np.argsort(sizes, kind="stable")
    in_top = np.array([pick_bucket(int(s), buckets) == LARGE_S for s in sizes[order]])
    order = order[in_top][:B]
    nodes = torch.as_tensor(np.where(nd[order] >= 0, nd[order], 0), device="cuda")
    mask = torch.as_tensor(nd[order] >= 0, device="cuda")
    return dg, torch.as_tensor(links[order], device="cuda"), nodes, mask


def hub_kernel_cases():
    """``pos_power_rows`` on the hub graph's first batches (:func:`hub_batch`):
    the global route's (B = 32) reading the global table by id; the
    same 32 links on the local tables the card builds for them
    (``local_table_kernel_inputs``), the before-and-after pair; and the local
    route's own first batch (B = 64), as (label, kwargs, node mask)."""
    from s3grl_tpu_torch.operators.pos import batch_cap, local_table_kernel_inputs

    dg, links, nodes, mask = hub_batch(local=True)
    D = int(dg.nbr.shape[1])
    B = batch_cap(LARGE_S, HUB_FEATURES, D, 0, 256)
    cases = [(f"hub global S={LARGE_S} D={D} R=2 B={B}",
              by_id_kwargs(dg, links[:B], nodes[:B], mask[:B], 3), mask[:B])]
    for b in (B, len(links)):
        lsel, loc, lw, lx, _ = local_table_kernel_inputs(dg, links[:b], nodes[:b], mask[:b])
        cases.append((f"hub local S={LARGE_S} D={loc.shape[2]} R=2 B={b}",
                      dict(sel_idx=lsel, nbr=loc, w=lw, subg_x=lx, sign_k=3, row_ids=None),
                      mask[:b]))
    return cases


def blog_kernel_case():
    """``pos_power_rows`` at BlogCatalog's batch on the benchmark's
    ``blogcatalog_pos.prep`` cell, by id: BLOG_B observed links of the hub
    graph (BlogCatalog's size and skew) with their 2-hop sets at BLOG_S and
    BLOG_FEATURES seeded normal feature columns (the cell's one-hot degree
    width), which takes the split selector (B below the card's SMs), as
    (label, kwargs, node mask)."""
    import torch

    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph

    g, _, links = hub_graph()
    x = np.random.default_rng(SEED + 1).normal(size=(g.num_nodes, BLOG_FEATURES))
    dg = DeviceGraph.from_graph(Graph(num_nodes=g.num_nodes, edge_index=g.edge_index,
                                      x=x.astype(np.float32)), device="cuda")
    lk = np.ascontiguousarray(links[:BLOG_B])
    nd, _ = native.khop_nodes(*dg.host_csr(), lk, LARGE_HOPS, BLOG_S)
    nodes = torch.as_tensor(np.where(nd >= 0, nd, 0), device="cuda")
    mask = torch.as_tensor(nd >= 0, device="cuda")
    kw = by_id_kwargs(dg, torch.as_tensor(lk, device="cuda"), nodes, mask, 3)
    return f"blog global S={BLOG_S} D={int(dg.nbr.shape[1])} R=2 B={BLOG_B}", kw, mask


def phase_sampled_paths(cfg, graph, split) -> dict:
    """Each of SAMPLED_PATHS once: prep, train rate, peak memory and best
    test AUC against the JAX package's on the same graph and config."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    rows = {}
    for name, (fields, epochs) in SAMPLED_PATHS.items():
        c = dataclasses.replace(cfg, **fields, epochs=epochs)
        n = {s: len(lk) for s, lk in split_links(c, split).items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        prep, best, train_times, _, n_params = run_sgrl_learning(c, graph, split, device="cuda")
        peak = torch.cuda.max_memory_allocated() / 2**20
        rate = epochs * n["train"] / sum(train_times)
        rows[name] = kernel_counts()
        print(f"e2e {name}: model {c.model}, ratio_per_hop {c.ratio_per_hop}, "
              f"max_nodes_per_hop {c.max_nodes_per_hop}, links {n}; prep {prep:.3f} s, train "
              f"{rate:.1f} links/s ({epochs} epochs), best test AUC {best:.4f}, params "
              f"{n_params}, launches {rows[name]}, max_memory_allocated {peak:.1f} MiB")
        if c.model == "SIGN" and rows[name]["pos_power_rows"] == 0:
            raise AssertionError(f"the {name} path never launched pos_power_rows")
        check_auc(name, best)
    return rows


def phase_pairwise(cfg, graph, split) -> dict:
    """Each of PAIRWISE_PATHS once, EPOCHS epochs, with every kernel's count
    set to 0 just before it and read just after: its train loss each epoch
    (falling from the first epoch to the last), prep, train rate and best
    test AUC against the JAX package's on the same graph and config; then
    one epoch of it on the card against the CPU
    (:func:`pairwise_card_against_cpu`). The AUC, near chance on this graph
    in both packages, shows only that the path runs; the CPU comparison and
    tests/test_torch_pairwise.py (the JAX package's step within 1e-5) hold
    its numbers."""
    import dataclasses

    import torch

    from s3grl_tpu_torch.runner import run_sgrl_learning

    rows = {}
    for name, fields in PAIRWISE_PATHS.items():
        c = dataclasses.replace(cfg, **fields)
        zero_counts()
        with FitRecorder() as rec:
            prep, best, train_times, _, _ = run_sgrl_learning(c, graph, split, device="cuda")
        torch.cuda.synchronize()
        counts = kernel_counts()
        print(f"e2e {name}: prep {prep:.3f} s, train {sum(train_times):.3f} s ({c.epochs} epochs "
              f"of batches of {c.batch_size} positives and {c.batch_size * c.neg_ratio} "
              f"negatives), train loss by epoch {[round(x, 6) for x in rec.losses]}, best test "
              f"AUC {best:.4f}, launches {counts}")
        if (len(rec.losses) != c.epochs or not np.isfinite(rec.losses).all()
                or not rec.losses[-1] < rec.losses[0]):
            raise AssertionError(f"{name}: the train loss did not fall: {rec.losses}")
        if counts["pos_power_rows"] == 0:
            raise AssertionError(f"the {name} path never launched pos_power_rows")
        check_auc(name, best)
        pairwise_card_against_cpu(name, rec)
        rows[name] = counts
    return rows


# One pairwise epoch on the card and on the CPU may part by at most this in
# their train loss, relative (float32 sums in another order, over one epoch
# of Adam steps).
PAIRWISE_CPU_RTOL = 1e-4


def pairwise_card_against_cpu(name: str, rec) -> float:
    """One epoch of the recorded run's own ``fit_signnet`` call, dropout
    0, on the card and on the CPU from the same datasets (the weights come
    from a CPU generator, the permutations from numpy, so both start alike):
    their train losses must agree within PAIRWISE_CPU_RTOL. Returns the
    relative difference."""
    kw = {**rec.kwargs, "epochs": 1, "dropout": 0.0}
    losses = {}
    for dev in ("cuda", "cpu"):
        got = []
        rec.real(*rec.datasets, **{**kw, "device": dev,
                                   "logger_hook": lambda e, loss, r: got.append(loss)})
        losses[dev] = got[0]
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"  {name}: one epoch at dropout 0, train loss on the card {losses['cuda']!r}, on "
          f"the CPU {losses['cpu']!r}: relative difference {rel:.3e} "
          f"(bar {PAIRWISE_CPU_RTOL})")
    if not rel <= PAIRWISE_CPU_RTOL:
        raise AssertionError(f"{name}: one epoch's loss on the card and on the CPU differ by "
                             f"{rel:.3e}, relative")
    return rel


def phase_valedges(cfg, graph, split) -> dict:
    """The bench config with ``use_valedges_as_input``, EPOCHS epochs: its
    observed graph (the one ``precompute_split`` is given) holds the valid
    edges both ways, and its datasets equal bit for bit those of a run on
    the graph built by hand (the split graph's degree features, the valid
    edges joined; stopped before its training); its best test AUC against
    the JAX package's."""
    import dataclasses

    import torch

    from s3grl_tpu_torch import runner
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.data.graph import to_undirected

    seen = []
    real = runner.precompute_split

    def precompute(dg, *a, **kw):
        seen.append(dg.host_edges()[:2])
        return real(dg, *a, **kw)

    # By hand: the features of the split's graph (the runner joins the valid
    # edges after the feature init), then the valid edges both ways.
    hand = init_features(graph, cfg.init_features).with_edges(np.concatenate(
        [graph.edge_index, to_undirected(split.valid_pos.T.astype(np.int32))], axis=1), None)
    c = dataclasses.replace(cfg, **VALEDGES)
    runner.precompute_split = precompute
    try:
        zero_counts()
        with FitRecorder() as rec:
            prep, best, _, _, _ = runner.run_sgrl_learning(c, graph, split, device="cuda")
        counts = kernel_counts()
        with FitRecorder(stop=True) as by_hand:
            try:
                runner.run_sgrl_learning(
                    dataclasses.replace(c, use_valedges_as_input=False, init_features=""),
                    hand, split, device="cuda")
            except StopBeforeTraining:
                pass
    finally:
        runner.precompute_split = real
    (src, dst), (h_src, h_dst) = seen[0], seen[3]
    added = len(src) - graph.edge_index.shape[1]
    print(f"e2e valedges: observed edges {graph.edge_index.shape[1]} + {added} "
          f"(valid {len(split.valid_pos)} both ways); prep {prep:.3f} s, best test AUC "
          f"{best:.4f}, launches {counts}")
    if not (np.array_equal(src, h_src) and np.array_equal(dst, h_dst)
            and added == 2 * len(split.valid_pos)):
        raise AssertionError("the observed graph is not the split's graph with the valid edges")
    for a, b in zip(rec.datasets, by_hand.datasets):
        if not (torch.equal(a.xs, b.xs) and torch.equal(a.row_mask, b.row_mask)):
            raise AssertionError("the valedges datasets differ from the hand-built graph's")
    print("  datasets equal to the hand-built graph's bit for bit")
    check_auc("valedges", best)
    return counts


def multi_device_checks(mesh, cfg, graph, split) -> dict:
    """On one rank of ``mesh`` (every rank runs it): the main path's train
    split through ``precompute_pos_sharded``, the row-partitioned chain and
    ``precompute_sop_sharded``, each gathered and held bit for bit against
    its single-process counterpart (which this rank computes first), then
    one epoch of data-parallel SIGNNet training. Returns each piece's
    seconds and kernel launches (counts set to 0 just before each and read
    just after) and the training rate."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.operators.sop import host_normalized_edges, precompute_sop
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm, csr_matrix, power_chain_of
    from s3grl_tpu_torch.parallel import dist as pdist
    from s3grl_tpu_torch.parallel.scaling import _train_rate
    from s3grl_tpu_torch.runner import build_split_links
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.utils.seeding import seed_everything

    dg = DeviceGraph.from_graph(init_features(graph, cfg.init_features), device="cuda")
    rng, _ = seed_everything(cfg.seed)
    links, y = build_split_links("train", split, cfg.train_percent, rng)
    links, L, K, N = links.astype(np.int32), len(links), cfg.sign_k, graph.num_nodes
    kw = dict(num_hops=cfg.num_hops, sign_k=K, buckets=tuple(cfg.subgraph_buckets),
              batch_size=cfg.extract_batch_size, max_subgraph_nodes=cfg.max_subgraph_nodes,
              seed=cfg.seed)
    one_pos = precompute_pos(dg, links, y, device="cuda", **kw)
    one_sop = precompute_sop(dg, links, y, sign_k=K, device="cuda")
    src, dst, w = host_normalized_edges(dg)
    adj = csr_matrix(src, dst, w, N, N, device="cuda")
    one_chain = power_chain_of(lambda v: bsr_spmm(adj, v), dg.x, K)
    out = {}

    def timed_piece(name, fn):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = dict(s=time.perf_counter() - t0, launches=kernel_counts())
        return result

    pos = timed_piece("PoS sharded", lambda: pdist.precompute_pos_sharded(mesh, dg, links, y,
                                                                        **kw))
    full = pdist.gather_dataset(mesh, pos, L)
    if not (torch.equal(full.xs, one_pos.xs) and torch.equal(full.row_mask, one_pos.row_mask)):
        raise AssertionError("precompute_pos_sharded differs from precompute_pos")
    chain = timed_piece("SoP chain", lambda: pdist.dist_power_chain(mesh, src, dst, w, dg.x, K))
    if not torch.equal(pdist.gather_rows(mesh, chain, N), one_chain):
        raise AssertionError("dist_power_chain differs from one process's chain")
    sop = timed_piece("SoP sharded", lambda: pdist.precompute_sop_sharded(mesh, dg, links, y,
                                                                        sign_k=K))
    if not torch.equal(pdist.gather_dataset(mesh, sop, L).xs, one_sop.xs):
        raise AssertionError("precompute_sop_sharded differs from precompute_sop")
    rate, _ = timed_piece("train", lambda: _train_rate(
        mesh, pos, epochs=1, hidden=cfg.hidden_channels, seed=cfg.seed))
    out["train"]["links_per_s"] = rate
    for name in ("PoS sharded", "SoP sharded"):
        kernel = "pos_power_rows" if name.startswith("PoS") else "bsr_spmm"
        if out[name]["launches"][kernel] == 0:
            raise AssertionError(f"{name} never launched {kernel}")
    out["links"] = L
    return out


def multi_device_rank(rank, world, init_method, cfg, graph, split) -> dict:
    """A spawned rank of the two-rank check: gloo on the one card."""
    import torch.distributed as dist

    from s3grl_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(rank, world, "cuda", init_method=init_method, backend="gloo")
    out = multi_device_checks(make_mesh(), cfg, graph, split)
    out["backend"] = dist.get_backend()
    return out


def shard_bsr_case(cfg, graph) -> dict:
    """``bsr_spmm`` alone (no collective) on rank 0's shard of a 2-way row
    partition of the main path's chain: [166, 332] times the degree
    features [332, 1,025]; its row as ``bsr_case`` gives it, with its device
    time and ``torch.sparse.mm``'s."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.parallel.dist import partition_edges_by_owner
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.operators.sop import host_normalized_edges
    from s3grl_tpu_torch.utils import timing

    g = init_features(graph, cfg.init_features)
    src, dst, w = host_normalized_edges(DeviceGraph.from_graph(g, device="cuda"))
    src_p, dstl_p, w_p, rows = partition_edges_by_owner(src, dst, w, g.num_nodes, 2)
    keep = w_p[0] != 0
    n_pad = 2 * rows
    x = torch.zeros((n_pad, g.x.shape[1]), dtype=torch.float32, device="cuda")
    x[: g.num_nodes] = torch.as_tensor(g.x, dtype=torch.float32)
    args = (src_p[0][keep], dstl_p[0][keep], n_pad, x)
    row = bsr_case("2-way row shard (rank 0) of the SoP chain", *args, w=w_p[0][keep],
                   rows=rows)
    _, _, m_csr = bsr_inputs(*args[:3], w=w_p[0][keep], rows=rows)
    lib = timing.profile_kernels(lambda: torch.sparse.mm(m_csr, x))
    row["library_device_ms"] = sum(lib["by_name"].values())
    print(f"  bsr_spmm row shard: torch.sparse.mm {row['library_device_ms']:.4f} ms device "
          f"({fmt_profile(lib)})")
    return row


def phase_multi_device(cfg, graph, split, power_limit: str) -> dict:
    """``s3grl_tpu_torch/parallel`` on the card. World size 1 over NCCL, in
    this process (the collectives present, trivial): the main path's
    sharded PoS, chain and SoP bit for bit against one process, one epoch
    of data-parallel training, ``scaling.measure(1)`` at the JAX harness's
    defaults; then ``bsr_spmm`` on a 2-way row shard. Then the same checks
    in two spawned ranks on the one card over gloo, which takes the card's
    tensors (NCCL refuses two ranks on one device). Returns each piece's
    launches and rows."""
    import tempfile

    import torch.distributed as dist

    from s3grl_tpu_torch.parallel import scaling
    from s3grl_tpu_torch.parallel.mesh import init_distributed, make_mesh, run_ranks

    print(f"multi-device phase: card {power_limit}")
    store = tempfile.mkdtemp(prefix="s3grl_rendezvous_")
    init_distributed(0, 1, "cuda", init_method=f"file://{os.path.join(store, 'store')}")
    print(f"  world 1: backend {dist.get_backend()}")
    one = multi_device_checks(make_mesh(), cfg, graph, split)
    t0 = time.perf_counter()
    row = scaling.measure(1)
    print(f"  world 1 ({one['links']} train links): " + "; ".join(
        f"{k} {v['s']:.3f} s, launches {v['launches']}" for k, v in one.items()
        if isinstance(v, dict)) + f"; train 1 epoch {one['train']['links_per_s']:.1f} links/s; "
        "sharded PoS, chain and SoP equal to one process bit for bit")
    print(f"  scaling.measure(1) ({time.perf_counter() - t0:.1f} s): {json.dumps(row)}")
    dist.destroy_process_group()
    shutil.rmtree(store, ignore_errors=True)
    shard = shard_bsr_case(cfg, graph)
    launches = {f"multi-device {k} (world 1)": v["launches"] for k, v in one.items()
                if isinstance(v, dict)}
    t0 = time.perf_counter()
    two = run_ranks(multi_device_rank, 2, cfg, graph, split, timeout_s=300)
    for r, res in enumerate(two):
        print(f"  2 ranks on one card, rank {r} ({res['backend']}): " + "; ".join(
            f"{k} {v['s']:.3f} s, launches {v['launches']}" for k, v in res.items()
            if isinstance(v, dict)) + f"; train 1 epoch {res['train']['links_per_s']:.1f} "
            "links/s (both ranks share the card)")
        launches.update({f"multi-device {k} (rank {r} of 2, gloo)": v["launches"]
                         for k, v in res.items() if isinstance(v, dict)})
    print(f"  2 ranks on one card: equal to one process bit for bit "
          f"({time.perf_counter() - t0:.1f} s with the ranks' start)")
    return dict(launches=launches, world1=one, scaling=row, shard=shard, two=two)


def phase_idle(cfg, graph, split, power_limit: str) -> None:
    """The device's idle share of each path of IDLE_PATHS: one 1-epoch run
    under ``torch.profiler`` (prep and eval included), 1 - busy / wall."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from s3grl_tpu_torch.runner import run_sgrl_learning

    print(f"idle share (torch.profiler, 1 epoch each): card {power_limit}")
    paths = {**LABEL_PATHS, **INIT_PATHS, "WalkPool": WALKPOOL}
    for name in IDLE_PATHS:
        c = dataclasses.replace(cfg, **paths[name], epochs=1)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_sgrl_learning(c, graph, split, device="cuda")
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, by_name, n_events = device_time(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"  {name}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
              f"over {n_events} device events, idle share {1 - busy / wall_us:.3f}; top: "
              + "; ".join(f"{k[:50]} {v / 1e3:.1f} ms" for k, v in top))


def main(argv=None) -> int:
    import torch

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    # The synthetic graphs come from the tests' helpers, imported by module
    # name: a machine may hold a foreign ``tests`` package on its path.
    sys.path[:0] = [here, os.path.join(here, "tests")]
    import s3grl_tpu_torch  # noqa: F401  (fails where the package is absent)

    results_dir = os.path.join(here, "build", "chip_smoke_results")
    shutil.rmtree(results_dir, ignore_errors=True)
    cfg = bench_config(SEED, EPOCHS, results_dir)
    t0 = time.perf_counter()
    marks = []

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        marks.append(f"{name} {time.perf_counter() - t:.1f}")
        return out

    power_limit = timed("environment", phase_environment)
    timed("build", phase_build)
    graph, split = split_graph(cfg)
    rows = timed("kernels", phase_kernels, cfg, graph, split, power_limit)
    lt_rows = timed("local_table", phase_local_table, cfg, graph, split, power_limit)
    bsr_rows = timed("bsr_spmm", phase_bsr_kernel, cfg, graph, split, power_limit)
    launches, hist = timed("e2e", phase_end_to_end, cfg, graph, split)
    timed("label paths", phase_label_paths, cfg, graph, split)
    init_rows = timed("init paths", phase_init_paths, cfg, graph, split)
    repeat = timed("repeat", phase_repeat, cfg, graph, split)
    timed("WalkPool", phase_walkpool, cfg, graph, split)
    timed("baselines", phase_baselines)
    tooling = {"checkpoints": timed("checkpoints", phase_checkpoints, cfg, graph, split),
               "profile": timed("profile", phase_profile, cfg, graph, split),
               "OGB": timed("OGB", phase_ogb, cfg, graph, split)}
    large = timed("large graphs", phase_large_graphs, cfg, graph, split, power_limit)
    sampled = timed("sampled paths", phase_sampled_paths, cfg, graph, split)
    pairwise = timed("pairwise", phase_pairwise, cfg, graph, split)
    valedges = timed("valedges", phase_valedges, cfg, graph, split)
    multi = timed("multi-device", phase_multi_device, cfg, graph, split, power_limit)
    timed("device times", phase_device_times, cfg, graph, split, rows, bsr_rows, power_limit)
    timed("idle", phase_idle, cfg, graph, split, power_limit)
    bsr_main, bsr_batch = bsr_rows[0], bsr_rows[1]

    # pos_power_rows reports the global-id shape of the bucket that took
    # the most links on the PoS path; bsr_spmm the SoP chain's one product.
    # "launches" is each kernel's count on its own path (PoS, SoP).
    main_s = max(hist, key=hist.get)
    label = next((k for k in rows if k.startswith(f"global S={main_s} R=2 ")),
                 next(k for k in rows if k.startswith("global S=512 ")))
    r = rows[label]
    by_path = {name: {**{t: launches[t][name] for t in launches},
                      **{t: r["launches"][name] for t, r in init_rows.items()},
                      **{f"repeat {t} (2 runs)": r[name] for t, r in repeat.items()},
                      **{t: r[name] for t, r in tooling.items()},
                      **{t: r[name] for t, r in large["launches"].items()},
                      **{t: r[name] for t, r in sampled.items()},
                      **{t: r[name] for t, r in pairwise.items()},
                      "valedges": valedges[name],
                      **{t: r[name] for t, r in multi["launches"].items()}}
               for name in WRAPPERS}
    local = {k: v for k, v in rows.items() if k.split()[0] in SCALED_PATHS}
    hub_label = next(k for k in lt_rows if k.startswith("hub "))
    hub_lt = lt_rows[hub_label]
    print("multi-device: " + json.dumps({
        "world1": multi["world1"], "scaling_measure_1": multi["scaling"],
        "two_ranks_one_card_gloo": multi["two"]}))
    print(f"total {time.perf_counter() - t0:.1f} s (by phase, s: {'; '.join(marks)})")
    print(power_limit)
    print(json.dumps({"kernels": [{
        "name": "pos_power_rows", "route": "cuda",
        "source": "s3grl_tpu_torch/csrc/pos_power_rows.cu",
        "replaces": "s3grl_tpu/ops/pos_pallas.py:173",
        "launches": launches["PoS"]["pos_power_rows"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "shape": label,
        "device_ms": r["device_ms"], "profiler_ms": r["profiler_ms"],
        "selector_phase_ms": r["phase1_ms"],
        "resolved_entries": r["resolved_entries"], "member_rows": r["member_rows"],
        "padded_bound_ms": r["padded_bound_ms"],
        "gathered_device_ms": r["gathered_device_ms"],
        "blogcatalog_batch": [{
            "shape": k, "max_abs_err": v["max_abs_err"], "device_ms": v["device_ms"],
            "profiler_ms": v["profiler_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "gathered_device_ms": v["gathered_device_ms"],
            "gathered_bound_ms": v["gathered_bound_ms"]}
            for k, v in rows.items() if k.startswith("blog ")],
        "launches_by_path": by_path["pos_power_rows"],
        "local_slot": [{
            "shape": k, "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "device_ms": v["device_ms"], "profiler_ms": v["profiler_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "member_rows": v["member_rows"],
            "padded_bound_ms": v["padded_bound_ms"],
            "launches": init_rows[k.split()[0]]["local_launches"]} for k, v in local.items()],
        "hub": [{
            "shape": k, "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "device_ms": v["device_ms"], "profiler_ms": v["profiler_ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "member_rows": v["member_rows"],
            "resolved_entries": v["resolved_entries"], "padded_bound_ms": v["padded_bound_ms"],
            "degree_bound_ms": v["degree_bound_ms"],
            "launches": large["launches"][" ".join(k.split()[:2])]["pos_power_rows"]}
            for k, v in rows.items() if k.startswith("hub ")],
        "bfs_crossover": large["crossover"],
        "local_table_route": large["local_route"],
        "multi_device_launches": multi["world1"]["PoS sharded"]["launches"]["pos_power_rows"],
    }, {
        "name": "bsr_spmm", "route": "cuda",
        "source": "s3grl_tpu_torch/csrc/bsr_spmm.cu",
        "replaces": "s3grl_tpu/ops/spmm_pallas.py:206",
        "launches": launches["SoP"]["bsr_spmm"], "max_abs_err": bsr_main["max_abs_err"],
        "ms": bsr_main["ms"], "plain_ms": bsr_main["plain_ms"],
        "bound_ms": bsr_main["bound_ms"], "bound_by": bsr_main["bound_by"],
        "library_ms": bsr_main["library_ms"], "shape": bsr_main["shape"],
        "launches_by_path": by_path["bsr_spmm"],
        "edge_list_ms": bsr_main["edge_list_ms"],
        "bound_ms_dense_blocks": bsr_main["bound_ms_dense_blocks"],
        "device_ms": bsr_main["device_ms"], "profiler_ms": bsr_main["profiler_ms"],
        "library_device_ms": bsr_main["library_device_ms"],
        "sop_batch": {k: bsr_batch[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "profiler_ms", "plain_ms", "bound_ms",
            "bound_by",
            "library_ms", "library_device_ms", "edge_list_ms")},
        "row_shard": {k: multi["shard"][k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms")},
        "multi_device_launches": multi["world1"]["SoP sharded"]["launches"]["bsr_spmm"],
    }, {
        "name": "local_table", "route": "cuda",
        "source": "s3grl_tpu_torch/csrc/local_table.cu", "replaces": None,
        "note": "no TPU counterpart: the card's build of the table that the JAX package "
                "builds on the host (s3grl_tpu/native/graphcore.cpp gc_khop_local_tab)",
        "launches": large["launches"]["hub local"]["local_table"],
        "max_abs_err": hub_lt["max_abs_err"], "ms": hub_lt["ms"],
        "plain_ms": hub_lt["plain_ms"], "bound_ms": hub_lt["bound_ms"],
        "bound_by": hub_lt["bound_by"], "library_ms": None, "shape": hub_label,
        "device_ms": hub_lt["device_ms"], "launches_by_path": by_path["local_table"],
        "shapes": lt_rows,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
