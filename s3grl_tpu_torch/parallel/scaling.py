"""Weak-scaling harness: links/s through precompute and training against
the number of ranks.

Port of ``s3grl_tpu/parallel/scaling.py``. Weak scaling holds the load per
rank fixed, so ideal scaling runs n times the links in the same wall time;
efficiency = (rate_n / n) / rate_1.

    python -m s3grl_tpu_torch.parallel.scaling [--devices 1 2 4] [--device cpu]

spawns, for each count n, n ranks (NCCL, one card each; gloo with
``--device cpu``) that run :func:`measure` and prints one JSON line per
count, then, with more than one count, a summary of the efficiencies. On
the card a count above the number of cards is skipped (NCCL refuses two
ranks on one card).

A row's keys are the JAX harness's: PoS links/s (the rank-0 sizing pass and
the sharded extraction timed apart), SoP links/s, data-parallel SIGNNet
training at 32 and 128 links a rank, and two yardsticks: the least
data-parallel step with the same gradient all-reduce (:func:`dp_step_control`)
and a matmul chain with no communication (:func:`matmul_control`). With
``--census``, ``collective_census`` takes the place of the JAX ``hlo_evidence``:
the collectives in a ``torch.profiler`` trace of one step of each.
"""
from __future__ import annotations

import argparse
import json
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.parallel.dist import (
    precompute_pos_sharded,
    precompute_sop_sharded,
    shared_sizes,
)
from s3grl_tpu_torch.parallel.mesh import (
    all_reduce_gradients,
    data_group,
    data_parallel,
    init_distributed,
    make_mesh,
    mesh_device,
    run_ranks,
)
from s3grl_tpu_torch.sampling.extraction import DeviceGraph
from s3grl_tpu_torch.utils.device import resolve_device

# The kinds of collective the census counts, under the JAX census's keys.
_KINDS = {"all_reduce": "all-reduce", "allreduce": "all-reduce", "all_gather": "all-gather",
          "allgather": "all-gather", "reduce_scatter": "reduce-scatter",
          "all_to_all": "all-to-all", "alltoall": "all-to-all", "send": "collective-permute",
          "recv": "collective-permute", "broadcast": "broadcast"}


def _synthetic_graph(rng, n_nodes: int, avg_degree: int, f: int) -> Graph:
    e = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, e)
    dst = rng.integers(0, n_nodes, e)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return Graph(
        edge_index=np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int32),
        num_nodes=n_nodes,
        x=rng.normal(size=(n_nodes, f)).astype(np.float32),
    )


def _sync(mesh) -> None:
    """Wait for this rank's device, then for every rank."""
    dev = mesh_device(mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.all_reduce(torch.zeros(1, device=dev))


def _slowest(mesh, seconds: float) -> float:
    """The largest of every rank's ``seconds``."""
    t = torch.tensor([seconds], dtype=torch.float64, device=mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def train_step(mesh, model, opt, xb, mb, yb, generator=None) -> torch.Tensor:
    """One data-parallel SIGNNet step on this rank's share of the batch:
    masked BCE mean, backward (the BatchNorm statistics span ``data``,
    ``mesh.data_parallel``), the gradients averaged over ``data`` by one
    all-reduce, then Adam. With equal shares it computes what one process
    computes on the whole batch. Returns the detached loss of the share."""
    from s3grl_tpu_torch.train.loop import bce_with_logits

    opt.zero_grad(set_to_none=False)
    loss = bce_with_logits(model(xb, mb, generator=generator), yb).mean()
    loss.backward()
    all_reduce_gradients(mesh, [p for p in model.parameters()])
    opt.step()
    return loss.detach()


def collective_census(prof) -> dict:
    """The collectives in a ``torch.profiler`` trace (recorded with
    ``record_shapes=True``): how many of each kind (the process group's own
    ``gloo:``/``nccl:`` host ranges; the JAX census's keys, plus ``broadcast``
    and ``other``), and the all-reduces' float32 bytes, in all and one by
    one, in order."""
    from torch.autograd import DeviceType

    counts = {k: 0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                             "collective-permute", "all-to-all", "broadcast", "other")}
    sizes = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        m = re.fullmatch(r"(gloo|nccl):(\w+)", e.name)
        # NCCL marks some collectives on the device's timeline too: count
        # the host's range only.
        if m is None or e.device_type != DeviceType.CPU:
            continue
        kind = next((v for k, v in _KINDS.items() if k in m.group(2)), "other")
        counts[kind] += 1
        if kind == "all-reduce":
            shape = e.input_shapes[0] if e.input_shapes else []
            sizes.append(4 * int(np.prod(shape)) if shape else 0)
    counts["all_reduce_bytes"] = int(sum(sizes))
    counts["all_reduce_sizes"] = sizes
    return counts


def _profiled(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    return collective_census(prof)


def _train_rate(mesh, ds, epochs: int, hidden: int, seed: int,
                batch_per_device: int = 32, census: bool = False):
    """(links/s through data-parallel SIGNNet training on this rank's link
    shard ``ds``, parameter count[, census of one step]). The batch per
    rank is held constant and the shard is flattened onto the device
    before the clock starts; each epoch walks the shard in order."""
    from s3grl_tpu_torch.models.signnet import SIGNNet
    from s3grl_tpu_torch.train.loop import flat_operators, make_optimizer

    dev = mesh_device(mesh)
    n = mesh.size(0)
    xs = flat_operators(torch.as_tensor(ds.xs).to(dev))
    rm = torch.as_tensor(ds.row_mask).to(dev)
    y = torch.as_tensor(np.asarray(ds.y, dtype=np.float32), device=dev)
    steps = torch.tensor([len(y) // batch_per_device], device=dev)
    dist.all_reduce(steps, op=dist.ReduceOp.MIN, group=data_group(mesh))
    steps = int(steps)
    if steps < 1:
        raise ValueError(f"a rank holds fewer than {batch_per_device} links")
    model = SIGNNet(xs.shape[-1], hidden, int(ds.xs.shape[1]) - 1, dropout=0.5,
                    generator=torch.Generator().manual_seed(seed)).to(dev)
    data_parallel(mesh, model)
    opt = make_optimizer(model.parameters(), 1e-3)
    drop = torch.Generator(device=dev).manual_seed(seed + 1 + dist.get_rank())
    n_params = sum(p.numel() for p in model.parameters())
    b = batch_per_device

    def epoch():
        total = torch.zeros((), device=dev)
        for s in range(steps):
            sl = slice(s * b, (s + 1) * b)
            total = total + train_step(mesh, model, opt, xs[sl], rm[sl], y[sl], drop)
        return total

    epoch()  # warm-up
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(epochs):
        total = epoch()
    float(total)
    _sync(mesh)
    dt = _slowest(mesh, time.perf_counter() - t0)
    rate = epochs * steps * b * n / dt
    if not census:
        return rate, n_params
    return rate, n_params, _profiled(
        lambda: train_step(mesh, model, opt, xs[:b], rm[:b], y[:b], drop))


def dp_step_control(mesh, steps: int, batch_per_device: int = 32, n_params: int = 262144,
                    iters: int = 3, census: bool = False):
    """Links/s of the least data-parallel train step, ``steps`` to an
    epoch: forward and backward of ``tanh(x W).sum()``, the gradient summed
    over ``data`` by one all-reduce of W's bytes (W sized to about
    ``n_params``), the update. The real step's efficiency against this one
    separates the engine's overhead from the per-step all-reduce any
    data-parallel SGD pays. With ``census``, (rate, census of one step)."""
    dev = mesh_device(mesh)
    n, r = mesh.size(0), mesh.get_local_rank("data")
    B = batch_per_device * n
    k = 128 * max(1, round((n_params ** 0.5) / 128))
    rng = np.random.default_rng(0)
    x_all = torch.as_tensor(rng.random((steps, B, k), dtype=np.float32) * 0.1)
    x_all = x_all[:, r * batch_per_device : (r + 1) * batch_per_device].contiguous().to(dev)
    w0 = torch.as_tensor((rng.random((k, k), dtype=np.float32) - 0.5) / k, device=dev)
    group = data_group(mesh)

    def step(w, xb):
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.tanh(xb @ w).sum(), w)
        dist.all_reduce(g, group=group)
        return (w - 1e-6 * g).detach()

    def run(w):
        for s in range(steps):
            w = step(w, x_all[s])
        return w

    run(w0)
    _sync(mesh)
    t0 = time.perf_counter()
    w = w0
    for _ in range(iters):
        w = run(w)
    _sync(mesh)
    rate = iters * steps * B / _slowest(mesh, time.perf_counter() - t0)
    return (rate, _profiled(lambda: step(w0, x_all[0]))) if census else rate


def matmul_control(mesh, rows_per_device: int = 256, k: int = 1024, iters: int = 20,
                   census: bool = False):
    """Rows/s of a batch-sharded ``tanh(x W) W`` with no communication:
    the most any data-parallel program can reach here. With ``census``,
    (rate, census of one call)."""
    dev = mesh_device(mesh)
    n = mesh.size(0)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.random((rows_per_device, k), dtype=np.float32), device=dev)
    w = torch.as_tensor(rng.random((k, k), dtype=np.float32), device=dev)

    def f():
        return torch.tanh(x @ w) @ w

    f()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f()
    float(out[0, 0])
    _sync(mesh)
    rate = n * rows_per_device * iters / _slowest(mesh, time.perf_counter() - t0)
    return (rate, _profiled(f)) if census else rate


def measure(
    n_devices: int,
    links_per_device: int = 512,
    n_nodes: int = 4000,
    avg_degree: int = 12,
    f: int = 128,
    sign_k: int = 3,
    epochs: int = 3,
    seed: int = 0,
    hidden: int = 256,
    census: bool = False,
    device="cuda",
) -> dict:
    """One weak-scaling row, in a rank of an initialized process group of
    ``n_devices`` ranks (every rank calls it; every rank returns the row).
    The defaults are the JAX harness's: hidden 256, 128 features,
    ``sign_k`` 3, 512 links a rank, 32 links a rank a training step."""
    mesh = make_mesh(n_data=n_devices, device=device)
    dev = mesh_device(mesh)
    rng = np.random.default_rng(seed)
    g = _synthetic_graph(rng, n_nodes, avg_degree, f)
    dg = DeviceGraph.from_graph(g, device=dev)
    L = links_per_device * n_devices
    links = rng.integers(0, n_nodes, (L, 2)).astype(np.int32)
    y = rng.integers(0, 2, L).astype(np.float32)
    warm = 128 * n_devices

    kw = dict(num_hops=2, sign_k=sign_k, buckets=(64, 128, 256),
              batch_size=128 * n_devices, max_subgraph_nodes=256, seed=seed)
    precompute_pos_sharded(mesh, dg, links[:warm], y[:warm], **kw)  # warm-up
    # The sizing pass runs on rank 0 and does not scale with the ranks:
    # timed apart from the sharded extraction.
    _sync(mesh)
    t0 = time.perf_counter()
    sizes = shared_sizes(mesh, dg, links, **kw)
    _sync(mesh)
    t_sizes = _slowest(mesh, time.perf_counter() - t0)
    t0 = time.perf_counter()
    ds_pos = precompute_pos_sharded(mesh, dg, links, y, size_oracle=sizes, **kw)
    _sync(mesh)
    t_extract = _slowest(mesh, time.perf_counter() - t0)

    precompute_sop_sharded(mesh, dg, links[:warm], y[:warm], sign_k=sign_k)  # warm-up
    _sync(mesh)
    t0 = time.perf_counter()
    precompute_sop_sharded(mesh, dg, links, y, sign_k=sign_k)
    _sync(mesh)
    t_sop = _slowest(mesh, time.perf_counter() - t0)

    b32 = _train_rate(mesh, ds_pos, epochs=epochs, hidden=hidden, seed=seed, census=census)
    train_rate, n_params = b32[:2]
    train_rate_b128, _ = _train_rate(mesh, ds_pos, epochs=4 * epochs, hidden=hidden,
                                     seed=seed, batch_per_device=128)
    steps_b32 = max(L // (32 * n_devices), 1)
    mm = matmul_control(mesh, census=census)
    dp = dp_step_control(mesh, steps=steps_b32, n_params=int(n_params), census=census)
    row = {
        "devices": n_devices,
        "links": L,
        "pos_links_per_sec": L / (t_sizes + t_extract),
        "pos_sizing_secs": t_sizes,
        "pos_extract_secs": t_extract,
        "sop_links_per_sec": L / t_sop,
        "train_links_per_sec": train_rate,
        "train_b128_links_per_sec": train_rate_b128,
        "train_n_params": int(n_params),
        "matmul_control_rows_per_sec": mm[0] if census else mm,
        "dp_control_links_per_sec": dp[0] if census else dp,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dist.get_backend(),
    }
    if census:
        row["collective_census"] = {"train_b32": b32[2], "dp_control": dp[1],
                                    "matmul_control": mm[1]}
    return row


def summary(results: list) -> dict:
    """The JAX harness's summary of the first and last rows: per-rank
    efficiencies, the matmul yardstick's, and each against it."""
    base, r_n = results[0], results[-1]

    def eff(key):
        return (r_n[key] / r_n["devices"]) / max(base[key] / base["devices"], 1e-9)

    ctrl = eff("matmul_control_rows_per_sec")
    effs = {k: eff(k) for k in ("pos_links_per_sec", "sop_links_per_sec",
                                "train_links_per_sec", "train_b128_links_per_sec",
                                "dp_control_links_per_sec")}
    eff_ctrl = {k: v / max(ctrl, 1e-9) for k, v in effs.items()}
    return {
        "weak_scaling_efficiency": effs,
        "platform_control_efficiency": ctrl,
        "efficiency_vs_platform_control": eff_ctrl,
        "train_b32_vs_zero_comm_control": eff_ctrl["train_links_per_sec"],
        "train_b32_vs_matched_dp_control":
            effs["train_links_per_sec"] / max(effs["dp_control_links_per_sec"], 1e-9),
        "from": base["devices"],
        "to": r_n["devices"],
    }


def _measure_rank(rank: int, world: int, init_method: str, device: str, kwargs: dict):
    dev = init_distributed(rank, world, device, init_method=init_method)
    return measure(world, device=dev.type, **kwargs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--links_per_device", type=int, default=512)
    ap.add_argument("--nodes", type=int, default=4000)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--census", action="store_true",
                    help="count the collectives of one step at the largest count")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises where CUDA is asked for and missing
    avail = torch.cuda.device_count() if args.device == "cuda" else 8
    counts = args.devices or [d for d in (1, 2, 4, 8) if d <= avail]
    if args.device == "cuda":
        skipped = [d for d in counts if d > avail]
        if skipped:
            print(json.dumps({"skipped_device_counts": skipped, "available_devices": avail,
                              "why": "NCCL takes one rank a card"}))
        counts = [d for d in counts if d <= avail]
    results = []
    for n in counts:
        kwargs = dict(links_per_device=args.links_per_device, n_nodes=args.nodes,
                      census=args.census and n == max(counts))
        row = run_ranks(_measure_rank, n, args.device, kwargs)[0]
        results.append(row)
        print(json.dumps(row), flush=True)
    if len(results) > 1:
        print(json.dumps(summary(results)))


if __name__ == "__main__":
    main()
