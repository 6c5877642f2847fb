#!/usr/bin/env python3
"""Headline benchmark of the torch port: links/s through PoS precompute plus
SIGNNet training, on one CUDA card.

    python3 bench_torch.py                                     # on the card
    python3 bench_torch.py --device cpu --scale toy --epochs 1 # the CPU test's run

The counterpart of bench.py, which imports the JAX package throughout; this
file imports neither JAX nor that package.

Workload: bench.py:432-437's config (PoS, sign_k 3, 2 hops, degree
features, zo labels, hidden 256, batch 32, lr 1e-4, seed 1, 5 epochs)
through the port's ``do_edge_split``, ``build_split_links(..., 100.0, rng)``,
``precompute_pos`` and ``fit_signnet``. USAir's files are in neither the
repository nor the card's machine, so by default the graph is the synthetic
USAir-shaped one of ``chip_smoke.py`` (``usair_like_edges(1)``: 332 nodes,
2,138 edges); ``--dataset USAir`` loads the real files through
``s3grl_tpu_torch/data/io.py`` and raises where they are absent. The JSON
names the graph.

Protocol (bench.py:473-501): a warm precompute of the three splits, then a
timed one, ended by ``torch.cuda.synchronize()``; a warm 1-epoch fit, then
a timed ``--epochs`` fit; ``value = (total_links + epochs * n_train) /
(t_precompute + t_train)``. ``vs_baseline`` divides it by the rate of a
per-link scipy version of the reference's PoS precompute on the host
(bench.py's own baseline, copied here).

Output: the headline JSON line first, then the same line again, enriched
with three sections, each under a SIGALRM limit: ``kernel_efficiency`` (the
two kernels at bench.py's shapes against their plain versions, each read
three ways by ``s3grl_tpu_torch/utils/timing.py``, against the bound of the
bytes and FLOP the data needs over the card's peak rates), and
``blogcatalog_precompute`` and ``arxiv_precompute`` (PoS by the host route,
and SoP, on 4,096 train links of synthetic graphs of those datasets'
shapes). A section that fails or runs out its limit is recorded in the
second line and makes the run exit 1. ``kernel_efficiency`` is skipped
only with ``--device cpu``; without a card and without that flag the bench
raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py:432-437's run (RunConfig fields).
CONFIG = dict(
    dataset="USAir", model="SIGN", sign_type="PoS", optimize_sign=True,
    init_features="degree", use_feature=True, sign_k=3, node_label="zo",
    hidden_channels=256, batch_size=32, lr=1e-4, num_hops=2, seed=1,
)
EPOCHS = 5
TOL = dict(rtol=2e-3, atol=2e-4)  # pos_power_rows: tests/test_pos_pallas.py:37-39
BSR_TOL = dict(rtol=1e-4, atol=1e-4)  # bsr_spmm: tests/test_pallas_spmm.py's bar
# A share of the bound above this is an impossible reading, not a fast kernel.
SHARE_MAX = 1.05
# bench.py:167-177's pos_power_rows shapes (B, S, D, F, R, K), each built as
# bench.py:178-181 builds them: local slots, 10 % of the weights set,
# row_ids None, selected rows 0. The last is bench.py:192-198's table of
# power-law degrees, each row's live entries first; the port ignores the
# TPU kernel's staircase tile counts, so the row is named for its table.
POS_SHAPES = {
    "pos_power_rows": (64, 256, 128, 17, 2, 3),
    "pos_power_rows_large": (16, 1024, 3424, 40, 2, 3),
    "pos_power_rows_local_large": (16, 1024, 256, 40, 2, 3),
    "pos_power_rows_power_law_table": (16, 1024, 3424, 40, 2, 3),
}
SPMM_F = 256  # bench.py:274
TIMER_REPS = 20
# The large-graph sections' synthetic graphs (tests/torch_port_helpers.
# blogcatalog_like_edges, a Chung-Lu generator): BlogCatalog's 10,312 nodes
# and 333,983 edges (exponent 0.55: hub degree 3,377), and arxiv's (the
# reference's arxiv.mat, CA-AstroPh: 18,772 nodes, 198,110 edges, max
# degree 504; exponent 0.375 gives 505 at seed 1).
SCALES = {
    "full": dict(nodes=332, links=4096,
                 blogcatalog=dict(n=10_312, n_undirected=333_983, exponent=0.55),
                 arxiv=dict(n=18_772, n_undirected=198_110, exponent=0.375)),
    # The CPU test's run: every section's code at a size the CPU takes in seconds.
    "toy": dict(nodes=40, links=64,
                blogcatalog=dict(n=400, n_undirected=3_000, exponent=0.55),
                arxiv=dict(n=500, n_undirected=2_500, exponent=0.375)),
}
SECTION_LIMIT_S = 300


def reference_style_precompute_rate(graph, links, sign_k, num_hops, n_sample=300):
    """Time the reference's per-link scipy PoS algorithm on the host;
    return links/s (bench.py:33-78)."""
    import scipy.sparse as ssp

    A = graph.scipy_csr()
    x = graph.x
    sample = links[:n_sample]

    t0 = time.perf_counter()
    for src, dst in sample:
        src, dst = int(src), int(dst)
        # BFS fringe expansion (utils.py:52-74 semantics)
        nodes = [src, dst]
        visited = {src, dst}
        fringe = {src, dst}
        for _ in range(num_hops):
            nxt = set()
            for u in fringe:
                nxt.update(A.indices[A.indptr[u] : A.indptr[u + 1]].tolist())
            fringe = nxt - visited
            visited |= fringe
            if not fringe:
                break
            nodes += sorted(fringe)
        sub = A[nodes, :][:, nodes]
        sub = (sub != 0).astype(np.float32)
        sub[0, 1] = 0
        sub[1, 0] = 0
        deg = np.asarray(sub.sum(axis=1)).ravel()
        with np.errstate(divide="ignore"):
            dinv = 1.0 / np.sqrt(deg)
        dinv[~np.isfinite(dinv)] = 0
        D = ssp.diags(dinv)
        adj_n = D @ sub @ D
        subg_x = np.concatenate(
            [np.zeros((len(nodes), 1), np.float32), x[nodes]], axis=1
        )
        subg_x[0, 0] = 1.0
        subg_x[1, 0] = 1.0
        powers = [adj_n]
        for _ in range(sign_k - 1):
            powers.append(adj_n @ powers[-1])
        for p in powers:
            _ = p[[0, 1]] @ subg_x
    dt = time.perf_counter() - t0
    return len(sample) / dt


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(dev) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (p.strip() for p in smi.split(",", 1))
    return {"name": name, "power_limit": limit}


def headline_graph(dataset: str, data_root: str, scale: dict):
    """(Graph, its name in the JSON): the real dataset under ``data_root``,
    or the synthetic USAir-shaped graph."""
    from s3grl_tpu_torch.data.graph import Graph

    if dataset:
        from s3grl_tpu_torch.data.io import load_dataset

        return load_dataset(dataset, data_root), dataset
    from torch_port_helpers import usair_like_edges

    n = scale["nodes"]
    g = Graph(num_nodes=n, edge_index=usair_like_edges(CONFIG["seed"], n=n))
    return g, (f"usair_like_edges({CONFIG['seed']}, n={n}): synthetic USAir-shaped, "
               f"{n} nodes, {g.num_edges // 2} edges")


def run_workload(graph, *, epochs: int, dev) -> dict:
    """bench.py:439-502 on the port: the split, the three splits' links, the
    scipy baseline, the warm and timed precompute, the warm and timed fit.
    Returns the numbers of the headline and the timed run's datasets."""
    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.operators.pos import precompute_pos
    from s3grl_tpu_torch.ops.pos_kernel import pos_power_rows
    from s3grl_tpu_torch.runner import build_split_links
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.train.loop import fit_signnet
    from s3grl_tpu_torch.utils.seeding import seed_everything

    cfg = RunConfig(**CONFIG)
    rng, _ = seed_everything(cfg.seed)
    graph, edge_split = do_edge_split(
        graph, val_ratio=cfg.split_val_ratio, test_ratio=cfg.split_test_ratio, rng=rng,
    )
    graph = init_features(graph, cfg.init_features)
    splits = {s: build_split_links(s, edge_split, 100.0, rng)
              for s in ("train", "valid", "test")}
    total_links = sum(len(lk) for lk, _ in splits.values())
    ref_rate = reference_style_precompute_rate(
        graph, splits["train"][0], cfg.sign_k, cfg.num_hops
    )

    dg = DeviceGraph.from_graph(graph, device=dev)
    kw = dict(
        num_hops=cfg.num_hops, sign_k=cfg.sign_k, buckets=tuple(cfg.subgraph_buckets),
        batch_size=cfg.extract_batch_size, max_subgraph_nodes=cfg.max_subgraph_nodes,
        seed=cfg.seed, device=dev,
    )
    for lk, y in splits.values():  # warm
        precompute_pos(dg, lk, y, **kw)
    sync(dev)
    pos_power_rows.launches = 0
    t0 = time.perf_counter()
    ds = {s: precompute_pos(dg, lk, y, **kw) for s, (lk, y) in splits.items()}
    sync(dev)
    t_precompute = time.perf_counter() - t0
    launches = pos_power_rows.launches

    fit_kw = dict(sign_k=cfg.sign_k, hidden_channels=cfg.hidden_channels,
                  batch_size=cfg.batch_size, lr=cfg.lr, dropout=cfg.dropout,
                  seed=cfg.seed, device=dev)
    fit_signnet(ds["train"], ds["valid"], ds["test"], epochs=1, **fit_kw)
    sync(dev)
    t1 = time.perf_counter()
    fit = fit_signnet(ds["train"], ds["valid"], ds["test"], epochs=epochs, **fit_kw)
    sync(dev)
    t_train = time.perf_counter() - t1

    n_train = len(splits["train"][0])
    return dict(
        total_links=total_links, n_train=n_train, t_precompute=t_precompute,
        t_train=t_train, ref_rate=ref_rate, launches=launches, datasets=ds,
        best_auc=max(r["AUC"][1] for r, _ in fit.results_per_epoch),
    )


def pos_inputs(rng, shape, tag: str, dev):
    """pos_power_rows' inputs at one of POS_SHAPES, drawn from ``rng`` in
    bench.py:178-181's order (the power-law table's degrees after them, as
    bench.py:192-198 draws them)."""
    import torch

    B, S, D, F, R, K = shape
    nbr = rng.integers(0, S, (B, S, D)).astype(np.int32)
    w = (rng.random((B, S, D)) < 0.1).astype(np.float32)
    x = rng.normal(size=(B, S, F)).astype(np.float32)
    sel = np.zeros((B, R), dtype=np.int32)
    if tag == "pos_power_rows_power_law_table":
        deg = np.sort(np.minimum(D, ((rng.pareto(1.2, (B, S)) + 1) * 8).astype(np.int32)),
                      axis=1)[:, ::-1]
        w = (np.arange(D)[None, None, :] < deg[:, :, None]).astype(np.float32)
    kw = dict(sel_idx=sel, nbr=nbr, w=w, subg_x=x)
    kw = {k: torch.as_tensor(v, device=dev) for k, v in kw.items()}
    return dict(**kw, sign_k=K, row_ids=None)


def kernel_row(name: str, shape: dict, fn, plain, tol: dict, work, rates, prefix: str) -> dict:
    """One kernel_efficiency row: the kernel against its plain version on
    the same inputs, its three readings, its achieved rates and its share
    of the bound of ``work`` (None where the card's rates are unknown)."""
    import torch

    from s3grl_tpu_torch.utils import timing
    from s3grl_tpu_torch.utils.device import bound_ms

    got, want = fn(), plain()
    torch.cuda.synchronize()
    diff = (got - want).abs()
    within = bool((diff <= tol["atol"] + tol["rtol"] * want.abs()).all())
    max_abs = float(diff.max())
    del got, want, diff
    if not within:
        raise AssertionError(f"{name} {shape} disagrees with its plain version: max abs err "
                             f"{max_abs} (tolerance {tol})")
    device_ms = timing.graph_ms(fn, TIMER_REPS)
    # Each of the kernel's own launches runs once a call: the per-launch means add.
    prof = timing.profile_kernels(fn, TIMER_REPS)
    profiler_ms = sum(v for k, v in prof["by_name"].items() if k.startswith(prefix))
    call_ms = timing.call_ms(fn, TIMER_REPS)
    bound, by = bound_ms(work, rates)
    share = bound / device_ms if bound is not None else None
    if share is not None and share > SHARE_MAX:
        raise AssertionError(f"{name} {shape}: share of the bound {share:.3f} > {SHARE_MAX}: "
                             f"an impossible reading ({device_ms} ms against {bound} ms)")
    return dict(kernel=name, shape=shape, max_abs_err=max_abs, tol=tol, within_tol=within,
                device_ms=device_ms, profiler_ms=profiler_ms, call_ms=call_ms,
                achieved_gflops=work.flops / device_ms / 1e6,
                achieved_gbps=work.n_bytes / device_ms / 1e6,
                n_bytes=work.n_bytes, flops=work.flops, bound_ms=bound, bound_by=by,
                share=share)


def kernel_efficiency(dev) -> dict:
    """bench.py:147-308 on the card: ``pos_power_rows`` at POS_SHAPES and
    ``bsr_spmm`` with F = 256 on the sym-normalized BlogCatalog-sized
    graph; each row as :func:`kernel_row` gives it."""
    import torch

    from s3grl_tpu_torch.ops import pos_kernel, spmm_kernel
    from s3grl_tpu_torch.ops.spmm_kernel import blockify, bsr_spmm, bsr_spmm_reference
    from s3grl_tpu_torch.utils.device import peak_rates
    from torch_port_helpers import blogcatalog_like_edges

    name = torch.cuda.get_device_name(dev)
    rates = peak_rates(name)
    report = {"card": name, "rates": None if rates is None else vars(rates)}
    rng = np.random.default_rng(0)
    for tag, shape in POS_SHAPES.items():
        kw = pos_inputs(rng, shape, tag, dev)
        B, S, D, F, R, K = shape
        report[tag] = kernel_row(
            "pos_power_rows", dict(B=B, S=S, D=D, F=F, R=R, sign_k=K),
            lambda: pos_kernel.pos_power_rows(**kw),
            lambda: pos_kernel.pos_power_rows_reference(**kw), TOL,
            pos_kernel.work(**kw), rates, "pos_")
        del kw
        torch.cuda.empty_cache()

    ei = blogcatalog_like_edges(1)
    n = int(ei.max()) + 1
    src, dst = ei[0], ei[1]
    deg = np.zeros(n, np.float32)
    np.add.at(deg, dst, 1.0)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
    w_e = (dinv[src] * dinv[dst]).astype(np.float32)
    adj = blockify(src, dst, w_e, n, device=dev)
    x = torch.as_tensor(rng.normal(size=(n, SPMM_F)).astype(np.float32), device=dev)
    report["bsr_spmm"] = kernel_row(
        "bsr_spmm", dict(graph="blogcatalog_like_edges(1)", N=n, nnz=int(adj.csr_vals.numel()),
                         nnz_blocks=adj.num_blocks, F=SPMM_F),
        lambda: bsr_spmm(adj, x), lambda: bsr_spmm_reference(adj, x), BSR_TOL,
        spmm_kernel.work(adj, x), rates, "csr_spmm")
    return report


def large_graph_precompute_rate(label: str, params: dict, n_links: int, dev) -> dict:
    """bench.py:311-367 on a synthetic graph of the dataset's shape
    (:data:`SCALES`): PoS (the host BFS route where L·E reaches its
    threshold, the local-table route in the buckets where ``auto`` takes
    it) and SoP on ``n_links`` train links, each warm then timed."""
    from s3grl_tpu_torch.data.features import init_features
    from s3grl_tpu_torch.data.graph import Graph
    from s3grl_tpu_torch.data.split import do_edge_split
    from s3grl_tpu_torch.operators.pos import host_extract_route, precompute_pos
    from s3grl_tpu_torch.operators.sop import precompute_sop
    from s3grl_tpu_torch.ops.local_table import local_table
    from s3grl_tpu_torch.sampling.extraction import DeviceGraph
    from s3grl_tpu_torch.utils.seeding import seed_everything
    from torch_port_helpers import blogcatalog_like_edges

    ei = blogcatalog_like_edges(1, **params)
    rng, _ = seed_everything(1)
    graph, edge_split = do_edge_split(Graph(num_nodes=params["n"], edge_index=ei), rng=rng)
    graph = init_features(graph, "degree")
    dg = DeviceGraph.from_graph(graph, device=dev)
    links = np.concatenate([edge_split.train_pos[: n_links // 2],
                            edge_split.train_neg[: n_links // 2]]).astype(np.int32)
    y = np.concatenate([np.ones(n_links // 2), np.zeros(n_links // 2)]).astype(np.float32)
    kw = dict(num_hops=2, sign_k=3, batch_size=32, seed=1, device=dev)
    precompute_pos(dg, links, y, **kw)
    sync(dev)
    tables = local_table.launches
    t0 = time.perf_counter()
    precompute_pos(dg, links, y, **kw)
    sync(dev)
    pos_rate = len(links) / (time.perf_counter() - t0)
    tables = local_table.launches - tables

    warm = min(512, len(links))
    precompute_sop(dg, links[:warm], y[:warm], sign_k=3, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    precompute_sop(dg, links, y, sign_k=3, device=dev)
    sync(dev)
    sop_rate = len(links) / (time.perf_counter() - t0)
    host = host_extract_route(dg, len(links), scaled=False, ratio_per_hop=1.0,
                              max_nodes_per_hop=None)
    return {
        "links_per_sec": round(pos_rate, 2),
        "sop_links_per_sec": round(sop_rate, 2),
        "n_links": int(len(links)),
        "n_nodes": int(graph.num_nodes),
        "n_edges": int(graph.edge_index.shape[1]),
        "pos_route": "host BFS" if host else "device BFS",
        "local_table_launches": tables,
        "graph": f"{label}-shaped Chung-Lu: blogcatalog_like_edges(1, {params})",
    }


class SectionTimeout(Exception):
    pass


@contextlib.contextmanager
def section_alarm(seconds: int):
    """SIGALRM guard: a section that runs past ``seconds`` raises
    :class:`SectionTimeout`."""
    def _raise(signum, frame):
        raise SectionTimeout(f"section exceeded {seconds} s")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def main(argv=None) -> int:
    import torch

    from s3grl_tpu_torch.config import RunConfig
    from s3grl_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dataset", default="",
                    help="a dataset under --data_root (USAir); default: the "
                         "synthetic USAir-shaped graph")
    ap.add_argument("--data_root", default=RunConfig().data_root)
    ap.add_argument("--epochs", type=int, default=EPOCHS, help="timed epochs (the CPU test's)")
    ap.add_argument("--scale", choices=sorted(SCALES), default="full",
                    help="toy: every section at a size for the CPU test")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        # The synthetic graphs come from the tests' helpers, imported by
        # module name: a machine may hold a foreign ``tests`` package.
        sys.path.insert(0, tests)
    scale = SCALES[args.scale]

    graph, graph_name = headline_graph(args.dataset, args.data_root, scale)
    run = run_workload(graph, epochs=args.epochs, dev=dev)
    edges = run["total_links"] + args.epochs * run["n_train"]
    rate = edges / (run["t_precompute"] + run["t_train"])
    headline = {
        "metric": "edges_per_sec_precompute_plus_train",
        "value": round(rate, 2),
        "unit": "links/s",
        "vs_baseline": round(rate / run["ref_rate"], 3),
        "detail": {
            "precompute_links_per_sec": round(run["total_links"] / run["t_precompute"], 2),
            "train_links_per_sec": round(args.epochs * run["n_train"] / run["t_train"], 2),
            "reference_scipy_links_per_sec": round(run["ref_rate"], 2),
            "test_auc_at_5_epochs": round(run["best_auc"], 4),
            "total_links": run["total_links"],
            "epochs": args.epochs,
            "pos_power_rows_launches": run["launches"],
        },
        "device": device_line(dev),
        "graph": graph_name,
    }
    # Headline first: it stands even if a section below fails or hangs.
    print(json.dumps(headline), flush=True)
    del run

    sections = {
        "kernel_efficiency": (lambda: kernel_efficiency(dev)) if dev.type == "cuda" else None,
        "blogcatalog_precompute": lambda: large_graph_precompute_rate(
            "BlogCatalog", scale["blogcatalog"], scale["links"], dev),
        "arxiv_precompute": lambda: large_graph_precompute_rate(
            "arxiv", scale["arxiv"], scale["links"], dev),
    }
    failed = []
    for key, fn in sections.items():
        if fn is None:
            headline["detail"][key] = {"skipped": "not on cuda"}
            continue
        try:
            with section_alarm(SECTION_LIMIT_S):
                headline["detail"][key] = fn()
        except Exception as e:  # recorded and counted: the run then exits 1
            headline["detail"][key] = {"failed": f"{type(e).__name__}: {e}"}
            failed.append(key)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(headline), flush=True)
    if failed:
        print(f"bench_torch: section(s) failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
