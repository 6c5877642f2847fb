"""MLP building blocks with PyG-MLP layer semantics.

The reference's SIGNNet is built from ``torch_geometric.nn.MLP`` with
``batch_norm=True, act_first=True`` (models.py:320-337). Per-layer order with
act_first: Linear -> activation -> BatchNorm -> Dropout; ``plain_last=True``
leaves the final Linear bare. ``nn.Linear``'s default init is
U(±1/sqrt(fan_in)) for weight and bias, as in the JAX package's ``Dense``.

Padded CCN rows must not enter BatchNorm statistics, so the norm layer is
mask-aware (statistics over valid rows only), as in the JAX package.
Under data parallelism each norm layer sums its statistics over the ranks
of its ``group``, so a step on n ranks normalizes over the global batch,
as the JAX package's sharded step does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as Fn


def _linear(in_features: int, out_features: int, generator) -> nn.Linear:
    """nn.Linear with its default init, drawn from ``generator``."""
    lin = nn.Linear(in_features, out_features)
    bound = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group, forward and backward: every
    rank's loss reads the sum, so each rank's gradient of it is the sum of
    the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the flattened valid rows.

    torch semantics: momentum 0.1 (new = (1-m)*old + m*batch), eps 1e-5,
    biased variance for normalization, unbiased variance in the running
    estimate. Statistics come from rows where ``mask`` is True; running
    statistics update only in training.
    """

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        # A torch.distributed group whose ranks each hold a share of the
        # batch (``parallel/mesh.data_parallel`` sets it): the statistics
        # then span the whole batch, as in one process.
        self.group = None

    def _group_stats(self, xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(n, mean, biased var) over every rank's valid rows: one
        all-reduce of [count, sum, sum of squares], differentiable (its
        backward all-reduces the gradients, since every rank's loss reads
        the statistics)."""
        C = xf.shape[1]
        m = (torch.ones(xf.shape[0], dtype=xf.dtype, device=xf.device) if mask is None
             else mask.reshape(-1).to(xf.dtype))
        xm = xf * m[:, None]
        stats = _SumOverGroup.apply(
            torch.cat([m.sum()[None], xm.sum(dim=0), (xm * xf).sum(dim=0)]), self.group)
        n = torch.clamp(stats[0], min=1.0)
        mean = stats[1 : 1 + C] / n
        return n, mean, torch.clamp(stats[1 + C :] / n - mean * mean, min=0.0)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        C = x.shape[-1]
        if self.training:
            xf = x.reshape(-1, C)
            if self.group is not None:
                n, mean, var = self._group_stats(xf, mask)
                bessel = n / torch.clamp(n - 1.0, min=1.0)
            elif mask is None:
                # n / max(n - 1, 1) from the shape, rounded to float32 on the
                # host as the tensor formula rounds it: no copy to the
                # device, so a CUDA graph can hold the step.
                n = xf.shape[0]
                mean = xf.mean(dim=0)
                var = ((xf - mean) ** 2).mean(dim=0)
                bessel = float(np.float32(n) / np.float32(max(n - 1, 1)))
            else:
                m = mask.reshape(-1).to(x.dtype)
                n = torch.clamp(m.sum(), min=1.0)
                mean = (xf * m[:, None]).sum(dim=0) / n
                var = (((xf - mean) ** 2) * m[:, None]).sum(dim=0) / n
                bessel = n / torch.clamp(n - 1.0, min=1.0)
            unbiased = var * bessel
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean.detach()
                )
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased.detach()
                )
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


_ACTS = {"relu": Fn.relu, "elu": Fn.elu, "tanh": torch.tanh}


class MLP(nn.Module):
    """PyG-style MLP (act_first, batch_norm, configurable plain_last).

    Layers are ``lins[i]`` and ``norms[i]``, in the order of the JAX
    package's ``Dense_i`` and ``MaskedBatchNorm_i``.
    """

    def __init__(
        self,
        in_channels: int,
        channel_list: Sequence[int],
        *,
        dropout: float = 0.0,
        act: str = "relu",
        act_first: bool = True,
        batch_norm: bool = True,
        plain_last: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.act = _ACTS[act]
        self.act_first = act_first
        self.batch_norm = batch_norm
        self.plain_last = plain_last
        dims = [in_channels, *channel_list]
        self.lins = nn.ModuleList(
            _linear(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )
        n_norm = len(channel_list) - (1 if plain_last else 0)
        self.norms = nn.ModuleList(
            MaskedBatchNorm(ch) for ch in channel_list[:n_norm]
        ) if batch_norm else nn.ModuleList()

    def forward(self, x, mask=None, generator: Optional[torch.Generator] = None):
        n_layers = len(self.lins)
        for i, lin in enumerate(self.lins):
            x = lin(x)
            if i == n_layers - 1 and self.plain_last:
                break
            if self.act_first:
                x = self.act(x)
                if self.batch_norm:
                    x = self.norms[i](x, mask)
            else:
                if self.batch_norm:
                    x = self.norms[i](x, mask)
                x = self.act(x)
            if self.training and self.dropout > 0:
                # The mask is drawn on x's device, from ``generator``, which
                # must live on that device too.
                keep = torch.empty_like(x).bernoulli_(
                    1.0 - self.dropout, generator=generator
                )
                x = x * keep / (1.0 - self.dropout)
        return x
