"""End-to-end run orchestration on the GPU.

Port of ``s3grl_tpu/runner.py``: the SIGN path (PoS, SoP and hybrid
operators, optimized or full-row), the SEAL GNN baselines (DGCNN, GCN,
SAGE, GIN, through ``train/gnn_loop.run_gnn_learning``) and WalkPool
(``train/walkpool_loop.run_walkpool_learning``), the equivalent of
the reference's ``run_sgrl_learning`` (sgrl_link_pred.py:791-1466): dataset
load -> seeded edge split -> feature init -> operator precompute -> SIGNNet
training -> highest-valid test metric.

Returns the reference's result tuple shape:
(total_prep_time, best_test_score, train_times, inference_times, total_params).

Run from the command line with
``python -m s3grl_tpu_torch.runner --dataset USAir --sign_type PoS
--optimize_sign --init_features degree --epochs 5 [--device cuda]``; SoP and
hybrid also take ``--pool_operatorwise``; ``--optimize_sign false
--node_label drnl`` runs the full-row flow; ``--model DGCNN --node_label
drnl --hidden_channels 32 --num_hops 2`` a SEAL baseline; ``--init_features
n2v --n2v_dim 16`` trains node2vec features; ``--m 3 --M 20 --num_hops 0``
extracts ScaLed's random-walk subgraphs (PoS, PoS+, hybrid);
``--init_representation GAE|VGAE|ARGVA|SVGAE|GIC`` pretrains the features;
``--use_heuristic CN|AA|PPR`` scores the split with a heuristic alone;
``--model WalkPool --node_label drnl --hidden_channels 32 --lr 5e-5`` runs
WalkPool; ``--dataset ogbl-*`` reads a downloaded OGB directory under
``--data_root``; ``--profile`` writes the run's stats JSON under
``{results_dir}/stats``; ``--checkpoint_training``, ``--continue_from N``,
``--only_test`` and ``--test_multiple_models`` save, resume and score
checkpoints in the run's results dir.
"""
from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.features import init_features
from s3grl_tpu_torch.data.graph import Graph, to_undirected
from s3grl_tpu_torch.data.io import dataset_source_paths, load_dataset
from s3grl_tpu_torch.data.ogb import load_ogb_dataset
from s3grl_tpu_torch.data.split import EdgeSplit, do_edge_split, get_pos_neg_edges
from s3grl_tpu_torch.heuristics import run_heuristic
from s3grl_tpu_torch.models.init_representation import pretrain_representation
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.operators.fullrow import precompute_pos_fullrow, precompute_sop_fullrow
from s3grl_tpu_torch.operators.pos import precompute_pos
from s3grl_tpu_torch.operators.sop import precompute_sop
from s3grl_tpu_torch.profiling import profile_helper
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.train.gnn_loop import run_gnn_learning
from s3grl_tpu_torch.train.logger import Logger
from s3grl_tpu_torch.train.loop import fit_signnet
from s3grl_tpu_torch.train.metrics import eval_metric_for_dataset, make_eval_fn
from s3grl_tpu_torch.train.walkpool_loop import run_walkpool_learning
from s3grl_tpu_torch.utils.device import resolve_device
from s3grl_tpu_torch.utils.seeding import seed_everything


def _dataset_cache_path(cfg: RunConfig, split: str, graph: Graph, links) -> str:
    """Cache file for one split's precomputed operator dataset, under
    ``{results_dir}/dataset_cache``.

    Fingerprint = every config field that changes the precompute output,
    the dataset's source files, and a hash of the observed graph and the
    split's links (so a graph passed in by the caller never reuses another
    graph's cache). ``delete_dataset=True`` disables reuse.
    """
    keys = (
        "dataset", "seed", "split_val_ratio", "split_test_ratio", "neg_ratio",
        "train_percent", "val_percent", "test_percent", "num_hops",
        "ratio_per_hop", "max_nodes_per_hop", "node_label", "use_feature",
        "use_edge_weight", "init_features", "n2v_dim", "init_representation",
        "sign_k", "sign_type", "optimize_sign", "k_heuristic",
        "k_node_set_strategy", "max_ccn_nodes", "m", "M", "dataset_split_num",
        "max_subgraph_nodes", "data_appendix",
    )
    src_sig = ""
    for p in dataset_source_paths(cfg.dataset, cfg.data_root):
        st = os.stat(p)
        src_sig += f"{p}:{st.st_size}:{int(st.st_mtime)};"
    h = hashlib.sha256()
    h.update(
        (
            repr([(k, getattr(cfg, k)) for k in keys])
            + repr(tuple(cfg.subgraph_buckets))
            + repr(cfg.data_root)
            + src_sig
        ).encode()
    )
    h.update(np.ascontiguousarray(graph.edge_index).tobytes())
    if graph.x is not None:
        h.update(np.ascontiguousarray(graph.x).tobytes())
    h.update(np.ascontiguousarray(links).tobytes())
    root = os.path.join(cfg.results_dir, "dataset_cache")
    return os.path.join(root, f"{cfg.dataset}_{split}_{h.hexdigest()[:16]}.npz")


def build_split_links(
    split: str, edge_split: EdgeSplit, percent: float, rng, neg_ratio: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """(links [L, 2], y [L]) for one split: positives then negatives
    (SEALDataset.process ordering, sgrl_link_pred.py:193-204)."""
    pos, neg = get_pos_neg_edges(
        split, edge_split, percent=percent, rng=rng, neg_ratio=neg_ratio
    )
    links = np.concatenate([pos, neg], axis=0)
    y = np.concatenate([np.ones(len(pos)), np.zeros(len(neg))])
    return links, y


def precompute_split(
    dg: DeviceGraph,
    links: np.ndarray,
    y: np.ndarray,
    cfg: RunConfig,
    *,
    device="cuda",
) -> OperatorDataset:
    """Dispatch the operator flow for one split (utils.py:446-496 routing)."""
    if cfg.sign_type not in ("PoS", "SoP", "hybrid"):
        raise NotImplementedError(f"sign_type {cfg.sign_type!r}")
    if cfg.sign_type == "SoP":
        if not cfg.optimize_sign:
            return precompute_sop_fullrow(
                dg, links, y, sign_k=cfg.sign_k, num_hops=cfg.num_hops,
                node_label=cfg.node_label, device=device,
            )
        return precompute_sop(dg, links, y, sign_k=cfg.sign_k, device=device)
    kw = dict(
        num_hops=cfg.num_hops,
        sign_k=cfg.sign_k,
        ratio_per_hop=cfg.ratio_per_hop,
        max_nodes_per_hop=cfg.max_nodes_per_hop,
        buckets=tuple(cfg.subgraph_buckets),
        batch_size=cfg.extract_batch_size,
        max_subgraph_nodes=cfg.max_subgraph_nodes,
        device=device,
    )
    if cfg.sign_type == "PoS" and not cfg.optimize_sign:
        # The whole subgraph is kept and node_label is live as the first
        # feature column (utils.py:497-531, 308-312).
        if cfg.m or cfg.M:
            raise NotImplementedError(
                "ScaLed rw sampling with optimize_sign=False is not "
                "supported; use the optimized flow for ScaLed"
            )
        return precompute_pos_fullrow(
            dg, links, y, node_label=cfg.node_label,
            max_label_dist=cfg.max_label_dist, seed=cfg.seed, **kw,
        )
    kw.update(seed=cfg.seed, rw_m=cfg.m, rw_M=cfg.M)
    if cfg.sign_type == "hybrid":
        pos_ds = precompute_pos(dg, links, y, **kw)
        if cfg.sign_k == 1:
            return pos_ds
        return pos_ds.hybrid_with(
            precompute_sop(dg, links, y, sign_k=cfg.sign_k, device=device)
        )
    if cfg.k_heuristic:
        kw.update(
            k_heuristic=cfg.k_heuristic,
            k_node_set_strategy=cfg.k_node_set_strategy,
            max_ccn=cfg.max_ccn_nodes,
        )
    return precompute_pos(dg, links, y, **kw)


def run_sgrl_learning(
    cfg: RunConfig,
    graph: Optional[Graph] = None,
    edge_split: Optional[EdgeSplit] = None,
    *,
    device="cuda",
):
    """One seeded end-to-end run. Returns the reference's tuple
    (prep_time, best_test, train_times, inference_times, total_params)."""
    dev = resolve_device(device)
    cfg.validate()
    rng, _ = seed_everything(cfg.seed)

    # Per-run results dir + command/log files (reference protocol:
    # sgrl_link_pred.py:791-823).
    save_appendix = cfg.save_appendix
    if save_appendix == "":
        save_appendix = "_" + time.strftime("%Y%m%d%H%M%S") + f"_seed{cfg.seed}"
        if cfg.m and cfg.M:
            save_appendix += f"_m{cfg.m}_M{cfg.M}_dropedge{cfg.dropedge}_seed{cfg.seed}"
    res_dir = cfg.res_dir or os.path.join(
        cfg.results_dir, f"{cfg.dataset}{save_appendix}"
    )
    log_file = os.path.join(res_dir, "log.txt")
    try:
        os.makedirs(res_dir, exist_ok=True)
        cmd_input = "python " + " ".join(sys.argv) + "\n"
        with open(os.path.join(res_dir, "cmd_input.txt"), "a") as f:
            f.write(cmd_input)
        with open(log_file, "a") as f:
            f.write("\n" + cmd_input)
    except OSError:  # read-only results root: keep running, drop file logs
        log_file = None

    if graph is None and cfg.dataset.startswith("ogbl"):
        # OGB: a pre-made split, the observed graph its raw edges
        # (reference sgrl_link_pred.py:826-828).
        graph, edge_split = load_ogb_dataset(cfg.dataset, cfg.data_root)
    elif graph is None:
        full = load_dataset(cfg.dataset, cfg.data_root)
        graph, edge_split = do_edge_split(
            full,
            val_ratio=cfg.split_val_ratio,
            test_ratio=cfg.split_test_ratio,
            neg_ratio=cfg.neg_ratio,
            rng=rng,
        )

    t_prep0 = time.perf_counter()
    graph = init_features(
        graph, cfg.init_features, n2v_dim=cfg.n2v_dim, seed=cfg.seed,
        epochs=cfg.epochs, cache_key=cfg.dataset,
        cache_root=os.path.join(cfg.results_dir, "emb_cache"), device=dev,
    )
    if cfg.init_representation:
        graph = pretrain_representation(graph, edge_split, cfg, device=dev)
    if cfg.use_valedges_as_input:
        # Validation positives join the observed graph (reference
        # sgrl_link_pred.py:1018-1028), after feature init.
        val_ei = to_undirected(edge_split.valid_pos.T.astype(np.int32))
        new_ei = np.concatenate([graph.edge_index, val_ei], axis=1)
        new_w = None
        if graph.edge_weight is not None:
            new_w = np.concatenate(
                [graph.edge_weight, np.ones(val_ei.shape[1], dtype=np.float32)]
            )
        graph = graph.with_edges(new_ei, new_w)

    if cfg.use_heuristic:
        return run_heuristic(graph, edge_split, cfg, device=dev)
    if cfg.model == "WalkPool":
        return run_walkpool_learning(graph, edge_split, cfg, rng, device=dev)
    if cfg.model != "SIGN":  # the SEAL GNN baselines (DGCNN, GCN, SAGE, GIN)
        return run_gnn_learning(graph, edge_split, cfg, rng, device=dev)

    dg = DeviceGraph.from_graph(graph, device=dev)
    datasets = {}
    for split, percent in (
        ("train", cfg.train_percent),
        ("valid", cfg.val_percent),
        ("test", cfg.test_percent),
    ):
        links, y = build_split_links(
            split, edge_split, percent, rng, neg_ratio=cfg.neg_ratio
        )
        cache_path = (
            None if cfg.delete_dataset else _dataset_cache_path(cfg, split, graph, links)
        )
        if cache_path and os.path.exists(cache_path):
            # Processed-artifact reload (reference sgrl_link_pred.py:84-94).
            datasets[split] = OperatorDataset.load(cache_path)
            continue
        datasets[split] = precompute_split(dg, links, y, cfg, device=dev)
        if cache_path:
            datasets[split].save(cache_path)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # bill all device work to prep
    total_prep_time = time.perf_counter() - t_prep0

    num_layers = cfg.sign_k
    if cfg.sign_type == "hybrid":
        num_layers = cfg.sign_k * 2 - 1
    eval_metric = (
        cfg.eval_metric
        if cfg.eval_metric not in ("auc", "")
        else eval_metric_for_dataset(cfg.dataset)
    )
    eval_fn = make_eval_fn(eval_metric)

    def _log_hook(epoch: int, loss: float, results: dict) -> None:
        # Per-epoch log lines (reference sgrl_link_pred.py:1419-1428 format).
        if log_file is None or epoch % cfg.log_steps != 0:
            return
        with open(log_file, "a") as f:
            for key, (valid_res, test_res) in results.items():
                print(key, file=f)
                print(
                    f"Run: {1:02d}, Epoch: {epoch:02d}, "
                    f"Loss: {loss:.4f}, Valid: {100 * valid_res:.2f}%, "
                    f"Test: {100 * test_res:.2f}%",
                    file=f,
                )

    seed_everything(cfg.seed)  # reset rng for model weights (reference :1280)
    fit = fit_signnet(
        datasets["train"],
        datasets["valid"],
        datasets["test"],
        sign_k=num_layers,
        hidden_channels=cfg.hidden_channels,
        num_layers=num_layers,
        batch_size=cfg.batch_size,
        lr=cfg.lr,
        epochs=cfg.epochs,
        dropout=cfg.dropout,
        k_heuristic=cfg.k_heuristic,
        k_pool_strategy=cfg.k_pool_strategy,
        pool_operatorwise=cfg.pool_operatorwise,
        last_only=cfg.sign_k == -1,
        seed=cfg.seed,
        eval_steps=cfg.eval_steps,
        eval_fn=eval_fn,
        loss_fn=cfg.loss_fn,
        neg_ratio=cfg.neg_ratio,
        pairwise=cfg.pairwise,
        checkpoint_training=cfg.checkpoint_training,
        continue_from=cfg.continue_from,
        only_test=cfg.only_test,
        test_multiple_models=cfg.test_multiple_models,
        res_dir=res_dir,
        log_steps=cfg.log_steps,
        logger_hook=_log_hook,
        device=dev,
    )

    if cfg.profile:
        # Per-run stats JSON (reference: profile_helper, profiler_utils.py:
        # 10-66; written at sgrl_link_pred.py:1430-1435).
        profile_helper(
            fit.train_times, fit.inference_times, total_prep_time, fit.model,
            dataset_num_links=datasets["train"].num_links,
            stats_suffix=f"{cfg.model}_{cfg.dataset}_{cfg.save_appendix}_seed_{cfg.seed}",
            out_dir=os.path.join(cfg.results_dir, "stats"), device=dev,
        )

    logger = {}
    for results, _tinf in fit.results_per_epoch:
        for key, result in results.items():
            logger.setdefault(key, Logger(cfg.runs)).add_result(0, result)

    best_scores = []
    for key in logger:
        logger[key].add_info(cfg.epochs, cfg.runs)
        best_scores.append(logger[key].print_statistics())
        if log_file is not None:
            with open(log_file, "a") as f:
                print(key, file=f)
                logger[key].print_statistics(0, f=f)
    if not best_scores:
        raise RuntimeError(
            "no evaluation results produced: epochs < eval_steps, or, for "
            "test_multiple_models, no run1_model_checkpoint*.pth files in "
            f"{res_dir!r}"
        )

    return (
        total_prep_time,
        best_scores[0],
        fit.train_times,
        fit.inference_times,
        fit.num_params,
    )


def _build_arg_parser() -> "argparse.ArgumentParser":
    """CLI mirroring the reference argparse surface (sgrl_link_pred.py:
    1478-1580). Field names and defaults come from RunConfig; ``--device``
    picks the device (default cuda)."""
    import argparse
    import dataclasses

    def str2bool(v: str) -> bool:
        if isinstance(v, bool):
            return v
        if v.lower() in ("true", "1", "yes", "y", "t"):
            return True
        if v.lower() in ("false", "0", "no", "n", "f"):
            return False
        raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")

    parser = argparse.ArgumentParser(description="S3GRL link prediction (torch)")
    for f in dataclasses.fields(RunConfig):
        name = f"--{f.name}"
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(
                name, type=str2bool, nargs="?", const=True, default=f.default
            )
        elif f.name in ("max_nodes_per_hop", "continue_from", "use_heuristic"):
            parser.add_argument(
                name,
                type=lambda v: None if v == "None" else (int(v) if v.isdigit() else v),
                default=f.default,
            )
        elif f.name == "subgraph_buckets":
            parser.add_argument(
                name,
                type=lambda v: tuple(int(x) for x in v.split(",")),
                default=f.default,
            )
        elif isinstance(f.default, int):
            parser.add_argument(name, type=int, default=f.default)
        elif isinstance(f.default, float):
            parser.add_argument(name, type=float, default=f.default)
        else:
            parser.add_argument(name, type=str, default=f.default)
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    args = vars(_build_arg_parser().parse_args(argv))
    device = args.pop("device")
    cfg = RunConfig(**args)
    start = time.perf_counter()
    total_prep_time, best, _, _, _ = run_sgrl_learning(cfg, device=device)
    print(f"Best test score: {best}")
    print(f"Time taken for dataset prep: {total_prep_time:.2f} seconds")
    print(f"Time taken for run: {time.perf_counter() - start:.2f} seconds")


if __name__ == "__main__":
    main()
