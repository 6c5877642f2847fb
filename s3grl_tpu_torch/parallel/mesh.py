"""Process groups, the ('data', 'model') device mesh and SIGNNet's
tensor-parallel and data-parallel forms over it.

Port of ``s3grl_tpu/parallel/mesh.py``. The JAX package places arrays with
``NamedSharding``s on one program's mesh; here every rank is a process of
its own (one per card, or per CPU rank under gloo), joined by a
``torch.distributed`` process group, and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over those processes with dims
``("data", "model")``; rank ``d * n_model + m`` sits at (d, m).

- ``data``: links are independent in precompute and training. A rank
  holds its contiguous share of a batch (:func:`shard_batch`) and the
  gradients are averaged over ``data`` by one all-reduce a step
  (:func:`all_reduce_gradients`); :func:`data_parallel` makes every
  ``MaskedBatchNorm`` sum its statistics over ``data``.
- ``model``: Megatron-style tensor parallelism of SIGNNet
  (:func:`shard_signnet`): ``operator_diff``'s Linear column-parallel,
  ``link_pred_mlp``'s first Linear row-parallel with an all-reduce over
  ``model`` before its activation.

A run starts its ranks with :func:`run_ranks` (``torch.multiprocessing``
with the ``spawn`` method) and each rank calls :func:`init_distributed`:
NCCL on the card unless the caller names another backend, gloo on the
CPU. There is no network: the ranks meet through a file store.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from s3grl_tpu_torch.utils.device import resolve_device

# Seconds a collective (and the rendezvous) may wait for its peers before
# it fails, and the default bound on a whole spawned run.
COLLECTIVE_TIMEOUT_S = 120
RUN_TIMEOUT_S = 900


def init_distributed(rank: int, world: int, device="cuda", *, init_method: str,
                     backend: Optional[str] = None,
                     timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Join this process to the default process group as ``rank`` of
    ``world`` and return its device: ``cuda:{rank % cards}`` for a bare
    ``"cuda"`` (raising without CUDA), or ``device`` as given.

    ``init_method`` is a ``file://`` store (:func:`run_ranks` makes one) or
    ``tcp://127.0.0.1:<port>``. The backend is NCCL on the card and gloo
    on the CPU unless ``backend`` names one; a failure raises, and no other
    backend is tried. Every collective fails after ``timeout_s`` seconds.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.device(device).index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _rank_entry(rank: int, fn: Callable, world: int, init_method: str, results, args):
    torch.set_num_threads(1)
    try:
        results.put((rank, fn(rank, world, init_method, *args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout_s: float = RUN_TIMEOUT_S) -> list:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes (one torch thread each) and return each rank's result, by
    rank. ``fn`` must be importable by name, calls :func:`init_distributed`
    itself and returns something picklable (numpy arrays, not tensors).

    A rank that raises makes this raise with its traceback, after the
    others are stopped; so does a run longer than ``timeout_s`` seconds.
    No process outlives the call.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    store_dir = tempfile.mkdtemp(prefix="s3grl_rendezvous_")
    init_method = "file://" + os.path.join(store_dir, "store")
    procs = mp.start_processes(_rank_entry, args=(fn, world, init_method, results, args),
                               nprocs=world, join=False, start_method="spawn")
    out: dict = {}

    def drain():  # results are read while the ranks run: a full pipe would block them
        while not results.empty():
            rank, value = results.get()
            out[rank] = value

    deadline = time.monotonic() + timeout_s
    try:
        while not procs.join(timeout=0.5):
            drain()
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
        drain()
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)
    missing = sorted(set(range(world)) - set(out))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [out[r] for r in range(world)]


def make_mesh(n_data: int = 0, n_model: int = 1, device="cuda"):
    """The ``("data", "model")`` DeviceMesh over the default process group,
    ``n_data`` x ``n_model`` ranks (``n_data`` 0: the world over
    ``n_model``). Raises without a process group, or when the mesh does not
    cover the world exactly: it never shrinks quietly. ``device`` is the
    mesh's device type (``"cuda"`` raises without CUDA)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev_type = resolve_device(device).type
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed in every rank first")
    world = dist.get_world_size()
    if n_data <= 0:
        n_data = world // n_model
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh does not cover the {world} ranks")
    return init_device_mesh(dev_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def data_group(mesh):
    """The process group of this rank's ``data`` dim."""
    return mesh.get_group("data")


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def share(n_items: int, n: int, r: int) -> tuple[int, int]:
    """[lo, hi) of rank r's contiguous share of ``n_items`` over n ranks:
    ⌈n_items/n⌉ each, the last ones shorter (JAX's ``P('data')`` layout)."""
    c = -(-n_items // n)
    return min(r * c, n_items), min((r + 1) * c, n_items)


def shard_batch(mesh, *arrays, axis: int = 0):
    """This rank's contiguous slice of each array along ``axis`` over
    ``data`` (:func:`share`). Returns one array, or a tuple of them."""
    n, r = mesh.size(0), mesh.get_local_rank("data")
    out = []
    for a in arrays:
        lo, hi = share(a.shape[axis], n, r)
        index = [slice(None)] * a.ndim
        index[axis] = slice(lo, hi)
        out.append(a[tuple(index)])
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh, module_or_tensors):
    """Broadcast a module's parameters and buffers (or a list of tensors)
    from rank 0 to every rank, in place; returns its argument. The tensors
    lie on the mesh's device."""
    tensors = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
               if isinstance(module_or_tensors, nn.Module) else list(module_or_tensors))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
    return module_or_tensors


def data_parallel(mesh, model: nn.Module) -> nn.Module:
    """Make ``model`` train data-parallel over ``data``: its weights are
    rank 0's (:func:`replicate`) and every ``MaskedBatchNorm`` sums its
    statistics over ``data``. The gradients are averaged by
    :func:`all_reduce_gradients` after each backward."""
    from s3grl_tpu_torch.models.mlp import MaskedBatchNorm

    replicate(mesh, model)
    for m in model.modules():
        if isinstance(m, MaskedBatchNorm):
            m.group = data_group(mesh)
    return model


def all_reduce_gradients(mesh, params: Sequence[torch.Tensor]) -> None:
    """Average the gradients of ``params`` over ``data``: one all-reduce of
    one flattened buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=data_group(mesh))
    flat /= mesh.size(0)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


class _SumOverModel(torch.autograd.Function):
    """All-reduce (sum) over ``model`` forward, identity backward: the
    partial products of a row-parallel Linear, whose output every model
    rank then holds whole (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class RowParallelLinear(nn.Module):
    """A Linear whose input features are split over ``model``: each rank
    multiplies its slice by its rows of the weight, the partial outputs are
    summed over ``model``, then the bias is added once."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, group):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        partial = torch.nn.functional.linear(x, self.weight)
        return _SumOverModel.apply(partial, self.group) + self.bias


def shard_signnet(mesh, model: nn.Module) -> nn.Module:
    """Tensor-parallel SIGNNet over ``model``, in place (JAX
    ``shard_signnet_params``): ``operator_diff``'s Linear keeps this rank's
    columns of the hidden layer (its weight rows and bias), its
    ``MaskedBatchNorm`` those channels (weight, bias, running statistics),
    so the [B, R, hidden / n_model] activations stay feature-sharded through
    the pooling. ``link_pred_mlp``'s first Linear becomes a
    :class:`RowParallelLinear` over this rank's slices of the pooled input,
    which is ``hidden``-wide blocks (center pooling, then the CCN pooling's
    one block, or k blocks under concat), each sharded the same way. The
    rest stays replicated. Returns ``model``."""
    n_model, j = mesh.size(1), mesh.get_local_rank("model")
    hidden = model.hidden_channels
    if hidden % n_model:
        raise ValueError(f"hidden {hidden} does not split over {n_model} model ranks")
    h = hidden // n_model
    cols = slice(j * h, (j + 1) * h)
    with torch.no_grad():
        up = model.operator_diff.lins[0]
        model.operator_diff.lins[0] = nn.Linear(up.in_features, h).to(up.weight.device)
        model.operator_diff.lins[0].weight.copy_(up.weight[cols])
        model.operator_diff.lins[0].bias.copy_(up.bias[cols])
        norm = model.operator_diff.norms[0]
        for name in ("weight", "bias", "running_mean", "running_var"):
            t = getattr(norm, name)
            t.data = t.data[cols].clone()
        down = model.link_pred_mlp.lins[0]
        blocks = down.in_features // hidden
        w = torch.cat([down.weight[:, b * hidden + j * h : b * hidden + (j + 1) * h]
                       for b in range(blocks)], dim=1)
        model.link_pred_mlp.lins[0] = RowParallelLinear(
            w.clone(), down.bias.clone(), mesh.get_group("model"))
    model.hidden_channels = h
    return model
