"""The rank side of ``tests/test_torch_distributed.py``: functions that
``parallel/mesh.run_ranks`` starts in spawned gloo processes on the CPU.

Importable by name in a fresh process and free of JAX: each function
joins the process group, runs the port's distributed code on the numpy
inputs it is given, and returns numpy results that the test holds to the
JAX package and to the port's single-process results. Several checks share
one spawn, since starting the ranks costs most of the time.
"""
import torch

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.parallel import dist as pdist
from s3grl_tpu_torch.parallel import mesh as pmesh
from s3grl_tpu_torch.sampling.extraction import DeviceGraph


def _np(t):
    return torch.as_tensor(t).detach().cpu().numpy().copy()  # no view of a live tensor


def _dg(graph):
    ei, x = graph
    return DeviceGraph.from_graph(Graph(num_nodes=len(x), edge_index=ei, x=x), device="cpu")


def chain(mesh, inputs, name="chain"):
    """The row-partitioned chain: this rank's shard and the gathered chain."""
    src, dst, w, x = inputs
    shard = pdist.dist_power_chain(mesh, src, dst, w, torch.as_tensor(x), 3)
    return {f"{name}_shard": _np(shard),
            name: _np(pdist.gather_rows(mesh, shard, len(x)))}


def pos(mesh, inputs):
    """Link-sharded PoS, gathered; then again with the owners' exchange cut
    to one row per peer a round."""
    graph, links, y, kw = inputs
    ds = pdist.precompute_pos_sharded(mesh, _dg(graph), links, y, **kw)
    full = pdist.gather_dataset(mesh, ds, len(links))
    out = {"pos_shard_links": len(ds.y), "pos_xs": _np(full.xs),
           "pos_mask": _np(full.row_mask), "pos_y": full.y}
    bytes_before, pdist.EXCHANGE_BYTES = pdist.EXCHANGE_BYTES, 1
    try:
        ds = pdist.precompute_pos_sharded(mesh, _dg(graph), links, y, **kw)
    finally:
        pdist.EXCHANGE_BYTES = bytes_before
    out["pos_rounds_xs"], out["pos_rounds_mask"] = _np(ds.xs), _np(ds.row_mask)
    return out


def sop(mesh, inputs):
    out = {}
    for name, (graph, links, y) in inputs.items():
        ds = pdist.precompute_sop_sharded(mesh, _dg(graph), links, y, sign_k=3)
        full = pdist.gather_dataset(mesh, ds, len(links))
        out[f"sop_{name}"] = {"shard_links": len(ds.y), "xs": _np(full.xs), "y": full.y}
    return out


def signnet(model_kw: dict, state: dict):
    from s3grl_tpu_torch.models.signnet import SIGNNet

    model = SIGNNet(**model_kw)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def dp_step(mesh, inputs):
    """One data-parallel SIGNNet step (``scaling.train_step``) on this
    rank's share of the batch, then one more under the profiler for the
    census."""
    from s3grl_tpu_torch.parallel.scaling import _profiled, train_step
    from s3grl_tpu_torch.train.loop import make_optimizer

    model_kw, state, xs, rm, y = inputs
    model = pmesh.data_parallel(mesh, signnet(model_kw, state))
    model.train()
    opt = make_optimizer(model.parameters(), 1e-3)
    xb, mb, yb = (torch.as_tensor(a) for a in pmesh.shard_batch(mesh, xs, rm, y))
    loss = train_step(mesh, model, opt, xb, mb, yb)
    out = {"dp_loss": float(loss),
           "dp_grads": {k: _np(p.grad) for k, p in model.named_parameters()},
           "dp_params": {k: _np(v) for k, v in model.state_dict().items()}}
    out["dp_census"] = _profiled(lambda: train_step(mesh, model, opt, xb, mb, yb))
    out["dp_n_params"] = sum(p.numel() for p in model.parameters())
    return out


def tensor_parallel(mesh, inputs):
    """SIGNNet's forward replicated, then tensor-parallel over ``model`` on
    this rank's share of the batch (eval mode), for each pooling."""
    out = {}
    for name, (model_kw, state, xs, rm) in inputs.items():
        model = signnet(model_kw, state).eval()
        with torch.no_grad():
            rep = model(torch.as_tensor(xs), torch.as_tensor(rm))
            pmesh.shard_signnet(mesh, model)
            xb, mb = pmesh.shard_batch(mesh, torch.as_tensor(xs), torch.as_tensor(rm))
            tp = model(xb, mb)
        out[f"tp_{name}"] = {
            "replicated": _np(rep), "out": _np(tp),
            "up_shape": tuple(model.operator_diff.lins[0].weight.shape),
            "down_shape": tuple(model.link_pred_mlp.lins[0].weight.shape),
            "coord": tuple(mesh.get_coordinate())}
    return out


def two_rank_checks(rank, world, init_method, inputs):
    pmesh.init_distributed(rank, world, "cpu", init_method=init_method)
    mesh = pmesh.make_mesh(device="cpu")
    out = {}
    out.update(chain(mesh, inputs["chain"]))
    out.update(chain(mesh, inputs["big_chain"], "big_chain"))
    out.update(pos(mesh, inputs["pos"]))
    out.update(sop(mesh, inputs["sop"]))
    out.update(dp_step(mesh, inputs["dp"]))
    return out


def four_rank_checks(rank, world, init_method, inputs):
    pmesh.init_distributed(rank, world, "cpu", init_method=init_method)
    out = chain(pmesh.make_mesh(device="cpu"), inputs["chain"])
    out.update(tensor_parallel(pmesh.make_mesh(n_data=2, n_model=2, device="cpu"),
                               inputs["tp"]))
    return out
