"""Time the PoS selector phase of one batch on the card, one block a
subgraph against split over row blocks: the sweep that sets
``ops/pos_kernel.SPLIT_MIN_S``.

    python3 scripts/selector_split_sweep.py [--config blogcatalog_pos] [--seed 7]
        [--sizes 512 1024 2048 4096] [--batches 1 2 4 8 16 32 64] [--reps 20]
        [--out chiprun_out/selector_split_sweep.jsonl]

The graph and features are those a benchmark configuration's cell builds
(``--config``, its split at ``--seed``; at seed 7 ``blogcatalog_pos``'s
observed graph has a global table 2,880 wide, ``usair_pos``'s 96). A batch
is B observed edges with their 2-hop node sets capped at S by the host
core, read by id from the global table as the precompute does (B up to the
precompute's ``batch_cap`` at S). Each (S, B) prints one JSON line: P
(the rule's split without its threshold), each path's device ms a call
(CUDA events over ``--reps`` calls after a warm call) and whether the two
give h equal bit for bit. Then, at the largest S and B = 1 and 8: the
whole ``pos_power_rows`` call by each path, the split call's device time
by CUDA-graph replay (``utils/timing.graph_ms``), its bound
(``ops/pos_kernel.work`` over the card's peaks) and share, the same for the
call on ``global_kernel_inputs``' gathered [B, S, *] arrays (with the
gathers' own time a call beside it) and whether the two give the same bits,
and the split call's device ms by kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def batch(dg, edges, B, S, dev):
    """B edges at the cap S: (the by-id call's arguments, its keywords, the
    gathered inputs' maker, the member slots)."""
    from s3grl_tpu_torch import native
    from s3grl_tpu_torch.operators.pos import by_id_kernel_inputs, global_kernel_inputs

    links = np.ascontiguousarray(edges[:, :: edges.shape[1] // B][:, :B].T.astype(np.int32))
    nd, _ = native.khop_nodes(*dg.host_csr(), links, 2, S)
    nodes = torch.as_tensor(np.where(nd >= 0, nd, 0), device=dev)
    mask = torch.as_tensor(nd >= 0, device=dev)
    links = torch.as_tensor(links, device=dev)
    sel, row_ids, lk, _ = by_id_kernel_inputs(dg, links, nodes, mask)
    args = (sel, dg.nbr, dg.degrees(), dg.x_with_indicator())
    return (args, dict(row_ids=row_ids, links=lk),
            lambda: global_kernel_inputs(dg, links, nodes, mask)[:5], mask)


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def timed_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="blogcatalog_pos")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024, 2048, 4096])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 2, 4, 8, 16, 32, 64])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "selector_split_sweep.jsonl"))
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE]
    from benchmark.cellbase import make_inputs, program_graph
    from benchmark.trace import function_name
    from s3grl_tpu_torch.operators.pos import batch_cap
    from s3grl_tpu_torch.ops import pos_kernel as pk
    from s3grl_tpu_torch.utils.device import bound_ms, peak_rates
    from s3grl_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda")
    with open(os.path.join(HERE, "benchmark", "configs", f"{args.config}.json")) as f:
        inp = make_inputs(json.load(f), args.seed)
    dg = program_graph(inp, dev)
    edges = inp.split.observed
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = pk._lib()
    card = {"config": args.config, "card": torch.cuda.get_device_name(dev), "sms": sms}

    def split_rule(B, S):  # the rule's P without its threshold
        with patched(pk, "SPLIT_MIN_S", 0):
            return pk.selector_row_blocks(B, S, sms)

    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    for S in args.sizes:
        for B in args.batches:
            P = split_rule(B, S)
            if P == 1 or B > batch_cap(S, dg.x.shape[1], dg.nbr.shape[1], 0, 512):
                continue  # no split, or no batch of the precompute has this shape
            (sel, nbr, w, _), kw, _, _ = batch(dg, edges, B, S, dev)

            def run(p):
                return pk._selector_rows_cuda(lib, sel, nbr, w, kw["row_ids"], 3, B, S,
                                              nbr.shape[1], sel.shape[1], row_blocks=p,
                                              links=kw["links"])

            emit(dict(S=S, B=B, D=int(nbr.shape[1]), P=P,
                      one_block_ms=timed_ms(lambda: run(1), args.reps),
                      split_ms=timed_ms(lambda: run(P), args.reps),
                      equal=bool(torch.equal(run(1), run(P))), **card))

    from torch.profiler import ProfilerActivity, profile

    S = max(args.sizes)
    rates = peak_rates(card["card"])
    for B in (1, 8):
        by_id, kw, gather, mask = batch(dg, edges, B, S, dev)
        P = split_rule(B, S)
        row = dict(S=S, B=B, D=int(dg.nbr.shape[1]), P=P, **card)
        outs = []
        for name, p in (("one_block", 1), ("split", P)):
            with patched(pk, "selector_row_blocks", lambda B, S, sms, p=p: p):
                call = lambda: pk.pos_power_rows(*by_id, sign_k=3, **kw)  # noqa: E731
                row[f"{name}_pos_power_rows_ms"] = timed_ms(call, args.reps)
                outs.append(call())
        row["replay_ms"] = graph_ms(lambda: pk.pos_power_rows(*by_id, sign_k=3, **kw))
        work = pk.work(*by_id, sign_k=3, node_mask=mask, **kw)
        row["bound_ms"], row["bound_by"] = bound_ms(work, rates)
        row["share"] = row["bound_ms"] / row["replay_ms"]
        gsel, gnbr, gw, gx, gids = gather()
        outs.append(pk.pos_power_rows(gsel, gnbr, gw, gx, sign_k=3, row_ids=gids))
        row["equal"] = all(bool(torch.equal(outs[0], o)) for o in outs[1:])
        row["gathered_replay_ms"] = graph_ms(
            lambda: pk.pos_power_rows(gsel, gnbr, gw, gx, sign_k=3, row_ids=gids))
        row["gathers_ms"] = timed_ms(gather, args.reps)
        gwork = pk.work(gsel, gnbr, gw, gx, sign_k=3, row_ids=gids, node_mask=mask)
        row["gathered_bound_ms"], _ = bound_ms(gwork, rates)
        del gsel, gnbr, gw, gx, gids
        with patched(pk, "selector_row_blocks", lambda B, S, sms: P), \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                pk.pos_power_rows(*by_id, sign_k=3, **kw)
            torch.cuda.synchronize()
        row["split_device_ms_by_kernel"] = {
            function_name(e.key): e.device_time_total / 5e3
            for e in prof.key_averages() if e.device_time_total > 0}
        emit(row)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for row in lines:
            f.write(json.dumps(row) + "\n")
    return 0 if all(r["equal"] for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
