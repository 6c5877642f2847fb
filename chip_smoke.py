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
   its time by CUDA events, the plain version's time and the least time
   the card could take; for ``pos_power_rows`` also its selector phase
   against its plain version and alone (and at K = 0: the table pass), and
   the resolved neighbor entries; ``bsr_spmm`` on the SoP chain, on SoP's
   first batch of one-hot endpoint columns (C = 2B = 8,192) and on a
   Cora-shaped random graph, with the edge-list route's time and one
   ``torch.sparse.mm`` as a yardstick;
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
7. repeat: each path of ``REPEAT_PATHS`` (SoP, hybrid, SEAL, PoS-n2v)
   twice at ``REPEAT_EPOCHS`` epochs; the two best test AUCs, printed, must
   be equal to the last bit;
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
11. device times: each kernel that phase 3 timed, and ``torch.sparse.mm``,
    by ``torch.profiler``, on inputs built again; then one profiled
    1-epoch run of each path of ``IDLE_PATHS`` (one of each kind: a label
    path, a ScaLed path, an init path, a heuristic, WalkPool) for its
    device idle share. It comes last, so that no profiler session has run
    in the process while the paths are timed.

Every kernel count is set to 0 just before each path and read just after;
the kernels line gives each kernel's launches on every path.

Imports nothing of JAX or the JAX package. Exits 2 when CUDA is missing.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
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
# 92.1696 / 91.6215.
JAX_AUC_RANGE = {"SEAL": 2.4578466955183416, "GCN-DE": 5.781168192427586,
                 "WalkPool": 0.54808280199144,
                 "fullrow": 10.44373237128417, "PoS-n2v": 6.019303891107455,
                 "ScaLed": 7.6048934908669565, "ScaLed-Plus": 3.3783484351946385,
                 "GAE-init": 5.140429248978563, "GIC-init": 3.937031180164695,
                 "SVGAE-init": 3.2559183886913843}
# A heuristic is deterministic: its raw AUC must equal the JAX package's
# within this.
HEURISTIC_AUC_TOL = 0.005
TOL = dict(rtol=2e-3, atol=2e-4)
BSR_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_pallas_spmm.py's bar
# The end-to-end paths, each with the kernels it must launch.
PATHS = {"PoS": ("pos_power_rows",), "SoP": ("bsr_spmm",),
         "hybrid": ("pos_power_rows", "bsr_spmm")}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores, the same sheet


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
REPEAT_PATHS = {"SoP": dict(sign_type="SoP", pool_operatorwise=True),
                "hybrid": dict(sign_type="hybrid", pool_operatorwise=True),
                "SEAL": TABLE_2, "PoS-n2v": INIT_PATHS["PoS-n2v"]}
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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after two warm calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(fn, reps: int) -> dict[str, float]:
    """Device milliseconds per call of each kernel (by short name) that
    ``fn`` launches, from ``torch.profiler`` over ``reps`` calls after a
    warm one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name)
            name = re.split(r"[<(]", name)[0][:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return by_name


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


def kernel_cases(cfg, graph, split):
    """Kernel inputs at the main path's shapes, from the main path's data:
    (label, kwargs of pos_power_rows, node mask [B, S] of the member slots)."""
    import torch

    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.operators.pos import batch_cap, global_kernel_inputs
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
        sel, nbr, w, x, row_ids, _ = global_kernel_inputs(
            dg, lb, nodes, mask, max_ccn=ccn, strategy=strategy
        )
        label = f"global S={S} R={sel.shape[1]} B={B}"
        cases.append((label, dict(sel_idx=sel, nbr=nbr, w=w, subg_x=x,
                                  sign_k=cfg.sign_k, row_ids=row_ids), mask))
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


def bound_ms_of(n_bytes: float, flops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over its f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bound_of(kw, node_mask) -> tuple[float, str, float, float, np.ndarray, float]:
    """(bound_ms, bound_by, bytes, flops, resolved entries per subgraph,
    bound_ms over every padded slot) for one call. The bound counts what
    this data needs: the member slots' rows (``node_mask``) of the table,
    its weights, X and the row ids, each read once, the output written once;
    one multiply-add per resolved neighbor entry and selected row per step,
    and one per (k >= 1, row, member node, feature) for the output. A padded
    slot adds nothing to the output."""
    from s3grl_tpu_torch.ops.pos_kernel import _resolve_slots

    sel, nbr, w, x, K = kw["sel_idx"], kw["nbr"], kw["w"], kw["subg_x"], kw["sign_k"]
    B, S, D = nbr.shape
    F, R = x.shape[2], sel.shape[1]
    ids = kw["row_ids"] is not None

    def bytes_flops(rows, entries):
        return (4 * (2 * rows * D + rows * F + B * (K + 1) * R * F + B * R + (rows if ids else 0)),
                2.0 * (K * R * entries + K * R * rows * F))

    _, found = _resolve_slots(nbr, kw["row_ids"], S)
    per_subgraph = (found & (w.reshape(B, -1) != 0)).sum(dim=1).cpu().numpy()
    entries = int(per_subgraph.sum())
    n_bytes, flops = bytes_flops(int(node_mask.sum()), entries)
    padded_ms, _ = bound_ms_of(*bytes_flops(B * S, entries))
    return (*bound_ms_of(n_bytes, flops), n_bytes, flops, per_subgraph, padded_ms)


def phase_kernels(cfg, graph, split, power_limit: str):
    import torch

    from s3grl_tpu_torch.ops import pos_kernel
    from s3grl_tpu_torch.ops.pos_kernel import (
        pos_power_rows, pos_power_rows_reference, pos_selector_rows,
        pos_selector_rows_reference,
    )

    cases, D, F = kernel_cases(cfg, graph, split)
    print(f"kernel phase: D={D} F={F + 1} (features + indicator) K={cfg.sign_k}; "
          f"card {power_limit}")
    rows = {}
    for label, kw, node_mask in cases:
        got = pos_power_rows(**kw)
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
        # Phase 1 alone: the selector rows H against their plain version.
        sel_kw = {k: kw[k] for k in ("sel_idx", "nbr", "w", "sign_k", "row_ids")}
        h_err = float((pos_selector_rows(**sel_kw)
                       - pos_selector_rows_reference(**sel_kw)).abs().max())
        if h_err > TOL["atol"]:
            raise AssertionError(f"pos_selector_rows disagrees with its plain version at "
                                 f"{label}: max abs err {h_err} (atol {TOL['atol']})")
        ms = cuda_ms(lambda: pos_power_rows(**kw), reps=20)
        B, S, Dk = kw["nbr"].shape
        lib = pos_kernel._lib()
        # The selector phase alone, and at K = 0: its one pass over the table
        # (with the hash build and the scaling) without the K steps.
        phase1_ms, table_ms = (cuda_ms(lambda: pos_kernel._selector_rows_cuda(
            lib, kw["sel_idx"], kw["nbr"], kw["w"], kw["row_ids"], k, B, S, Dk,
            kw["sel_idx"].shape[1]), reps=20) for k in (kw["sign_k"], 0))
        plain_ms = cuda_ms(lambda: pos_power_rows_reference(**kw), reps=3)
        bound_ms, by, n_bytes, flops, nnz, padded_ms = bound_of(kw, node_mask)
        members = int(node_mask.sum())
        cap = lib.s3grl_pos_list_cap(S, Dk)
        rows[label] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=by, phase1_ms=phase1_ms,
                           resolved_entries=int(nnz.sum()), member_rows=members,
                           padded_bound_ms=padded_ms)
        print(f"  {label}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
              f"(selector rows {h_err:.3e}) kernel {ms:.4f} ms (selector phase "
              f"{phase1_ms:.4f} ms, of it the table pass {table_ms:.4f} ms) "
              f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
              f"({by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP over {members} "
              f"member rows of {B * S}; {padded_ms:.4f} ms over every padded slot) "
              f"share of bound {bound_ms / ms:.3f}; resolved entries {int(nnz.sum())} "
              f"(per subgraph mean {nnz.mean():.1f}, max {int(nnz.max())}; "
              f"{int((nnz > cap).sum())} of {B} over the {cap}-entry shared-memory list)")
    return rows


def bsr_inputs(src, dst, n):
    """M = the sym-normalized adjacency of (src, dst) on the card: its
    ``blockify`` layout, its edge list (src, dst, w) and one torch CSR
    tensor of it."""
    import torch

    from s3grl_tpu_torch.ops.spmm import normalized_adjacency_weights
    from s3grl_tpu_torch.ops.spmm_kernel import blockify

    w = normalized_adjacency_weights(
        torch.as_tensor(src, dtype=torch.int64), torch.as_tensor(dst, dtype=torch.int64), n
    ).numpy()
    adj = blockify(src, dst, w, n, device="cuda")
    s_t = torch.as_tensor(src, dtype=torch.int64, device="cuda")
    d_t = torch.as_tensor(dst, dtype=torch.int64, device="cuda")
    w_t = torch.as_tensor(w, device="cuda")
    with warnings.catch_warnings():  # torch's notes on sparse invariants and beta CSR
        warnings.simplefilter("ignore", UserWarning)
        m_csr = torch.sparse_coo_tensor(torch.stack([d_t, s_t]), w_t, (n, n))
        m_csr = m_csr.coalesce().to_sparse_csr()
    return adj, (s_t, d_t, w_t), m_csr


def bsr_case(label, src, dst, n, x, power_k=0):
    """``bsr_spmm`` on M = the sym-normalized adjacency of (src, dst) and X:
    checked against its plain version (and, with ``power_k``, the K-step
    chain against the plain chain), timed beside the plain version, the
    edge-list route and one ``torch.sparse.mm`` of M in CSR form."""
    import torch

    from s3grl_tpu_torch.ops.spmm import edge_list, spmm
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm, bsr_spmm_reference, power_chain

    adj, (s_t, d_t, w_t), m_csr = bsr_inputs(src, dst, n)
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

    max_abs = check(bsr_spmm(adj, x), bsr_spmm_reference(adj, x), "one product")
    if power_k:
        want = [x]
        for _ in range(power_k):
            want.append(bsr_spmm_reference(adj, want[-1]))
        chain_err = check(power_chain(adj, x, power_k), torch.stack(want[1:]),
                          f"K={power_k} chain")
        max_abs = max(max_abs, chain_err)
    torch.cuda.synchronize()

    ms = cuda_ms(lambda: bsr_spmm(adj, x), reps=20)
    plain_ms = cuda_ms(lambda: bsr_spmm_reference(adj, x), reps=3)
    edges = edge_list(s_t, d_t, w_t, n)
    edge_ms = cuda_ms(lambda: spmm(edges, x), reps=20)
    library_ms = cuda_ms(lambda: torch.sparse.mm(m_csr, x), reps=20)

    # The bound is the least the function Y = M X needs: the nonzeros (value
    # and column id, CSR row pointers), X read and Y written once, and one
    # multiply-add per nonzero and column. The dense-block layout's own
    # figure (every block whole, 2*NB*128^2*C FLOP, the JAX cost estimate's)
    # is printed beside it.
    nb, bs = adj.num_blocks, int(adj.blocks.shape[1])
    nnz = int(adj.csr_vals.numel())
    n_bytes = 8 * nnz + 4 * (n + 1) + 8 * n * c
    flops = 2.0 * nnz * c
    bound_ms, by = bound_ms_of(n_bytes, flops)
    dense_bytes = 4 * (nb * bs * bs + 2 * n * c + nb + adj.num_row_blocks + 1)
    dense_flops = 2.0 * nb * bs * bs * c
    dense_ms, dense_by = bound_ms_of(dense_bytes, dense_flops)
    print(f"  bsr_spmm {label}: N={n} C={c} NB={nb} nnz={nnz} max_abs_err {max_abs:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms edge-list {edge_ms:.4f} ms "
          f"torch.sparse.mm (CSR) {library_ms:.4f} ms bound {bound_ms:.4f} ms "
          f"({by}: {n_bytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP, 2*nnz*C) "
          f"share of bound {bound_ms / ms:.4f}; dense-block layout's bound {dense_ms:.4f} ms "
          f"({dense_by}: {dense_bytes / 1e6:.2f} MB, {dense_flops / 1e9:.3f} GFLOP)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, edge_list_ms=edge_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                bound_ms_dense_blocks=dense_ms, shape=f"{label} N={n} C={c} NB={nb} nnz={nnz}")


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


def phase_device_times(cfg, graph, split, rows, bsr_rows, power_limit: str) -> None:
    """Each kernel's device time per call by ``torch.profiler``, on the
    kernel phases' inputs built again; adds ``device_ms`` (and, for
    ``bsr_spmm``, ``library_device_ms``) to their rows."""
    import torch

    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm

    print(f"device time phase (torch.profiler): card {power_limit}")
    cases, _, _ = kernel_cases(cfg, graph, split)
    for label, kw, _ in cases:
        dev = device_ms_by_kernel(lambda: pos_power_rows(**kw), reps=5)
        r = rows[label]
        r["device_ms"] = sum(v for k, v in dev.items() if k.startswith("pos_"))
        print(f"  pos_power_rows {label}: {fmt_device(dev)}; the two kernels "
              f"{r['device_ms']:.4f} ms, share of bound {r['bound_ms'] / r['device_ms']:.3f}")
    del cases
    for (label, src, dst, n, x, _), r in zip(bsr_shapes(cfg, graph, split), bsr_rows):
        adj, _, m_csr = bsr_inputs(src, dst, n)
        dev = device_ms_by_kernel(lambda: bsr_spmm(adj, x), reps=20)
        lib_dev = device_ms_by_kernel(lambda: torch.sparse.mm(m_csr, x), reps=20)
        r["device_ms"] = sum(v for k, v in dev.items() if k.startswith("csr_spmm"))
        r["library_device_ms"] = sum(lib_dev.values())
        print(f"  bsr_spmm {label}: kernel {r['device_ms']:.4f} ms (share of bound "
              f"{r['bound_ms'] / r['device_ms']:.3f}); torch.sparse.mm "
              f"{r['library_device_ms']:.4f} ms ({fmt_device(lib_dev)})")


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

    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm
    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = {"pos_power_rows": pos_power_rows, "bsr_spmm": bsr_spmm}
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

    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm
    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = {"pos_power_rows": pos_power_rows, "bsr_spmm": bsr_spmm}
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
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm
    from s3grl_tpu_torch.runner import run_sgrl_learning

    wrappers = {"pos_power_rows": pos_power_rows, "bsr_spmm": bsr_spmm}
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


WRAPPERS = ("pos_power_rows", "bsr_spmm")


def kernel_counts() -> dict:
    """Each kernel wrapper's launch count."""
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm

    return {"pos_power_rows": pos_power_rows.launches, "bsr_spmm": bsr_spmm.launches}


def zero_counts() -> None:
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.ops.spmm_kernel import bsr_spmm

    pos_power_rows.launches = bsr_spmm.launches = 0


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


class FitRecorder:
    """Wraps the runner's ``fit_signnet`` to keep the last run's per-epoch
    results (the runner returns only the best one)."""

    def __init__(self):
        from s3grl_tpu_torch import runner

        self.runner, self.real, self.last = runner, runner.fit_signnet, None

    def __enter__(self):
        def fit(*a, **kw):
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
                      **{t: r[name] for t, r in tooling.items()}}
               for name in WRAPPERS}
    local = {k: v for k, v in rows.items() if k.split()[0] in SCALED_PATHS}
    print(f"total {time.perf_counter() - t0:.1f} s (by phase, s: {'; '.join(marks)})")
    print(power_limit)
    print(json.dumps({"kernels": [{
        "name": "pos_power_rows", "route": "cuda",
        "source": "s3grl_tpu_torch/csrc/pos_power_rows.cu",
        "replaces": "s3grl_tpu/ops/pos_pallas.py:173",
        "launches": launches["PoS"]["pos_power_rows"], "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None, "shape": label,
        "device_ms": r["device_ms"], "selector_phase_ms": r["phase1_ms"],
        "resolved_entries": r["resolved_entries"], "member_rows": r["member_rows"],
        "padded_bound_ms": r["padded_bound_ms"],
        "launches_by_path": by_path["pos_power_rows"],
        "local_slot": [{
            "shape": k, "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "device_ms": v["device_ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "member_rows": v["member_rows"],
            "padded_bound_ms": v["padded_bound_ms"],
            "launches": init_rows[k.split()[0]]["local_launches"]} for k, v in local.items()],
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
        "device_ms": bsr_main["device_ms"], "library_device_ms": bsr_main["library_device_ms"],
        "sop_batch": {k: bsr_batch[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "edge_list_ms")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
