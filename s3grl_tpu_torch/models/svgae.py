"""S-VGAE init-representation: a hyperspherical (von Mises-Fisher) graph VAE.

Port of ``s3grl_tpu/models/svgae.py`` (reference:
Software/WalkPooling/software/svgae.py): GCN encoder (conv1 F->64, relu,
dropout 0.1; conv_mu 64->m; conv_var 64->1), latent z ~ vMF(mu/|mu|,
softplus(kappa)) on S^{m-1}, inner-product decoder, loss = recon +
KL(vMF || uniform on the sphere) / max_node_index (the reference divides by
``torch.max(edge_index)``, the largest index, a quirk kept here), Adam at
lr 1e-2 for 2,000 epochs, the best-validation z recorded every 10 epochs;
m = embedding_dim + 1.

The numerics are the JAX package's:
- ``log_iv``: Olver's uniform asymptotic expansion with the u1 term;
- ``bessel_ratio``: a 64-deep backward ratio recurrence, switching to the
  ratio of Olver asymptotics where kappa >= nu + 32;
- ``vmf_sample``: Wood's rejection over 16 fixed rounds (the last
  candidate where none is accepted), the mean-path reparameterization of
  omega (its gradient flows through E[omega] = bessel_ratio(m/2, kappa)), a
  uniform tangent and a Householder rotation onto mu.

The Beta(dim/2, dim/2) draw of Wood's proposal (``jax.random.beta`` in the
JAX package) is ``X / (X + Y)`` with X and Y each a sum of ``dim`` squared
standard normals from the run's generator: exact in law for the integer
``dim = m - 1``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s3grl_tpu_torch.data.graph import Graph
from s3grl_tpu_torch.models.gae import (
    _gcn_norm_edges,
    _glorot,
    _recon_loss,
    features_or_identity,
    link_scores,
)
from s3grl_tpu_torch.ops.spmm import EdgeList, spmm
from s3grl_tpu_torch.train.metrics import evaluate_auc

_RATIO_DEPTH = 64  # backward-recurrence depth for the Bessel ratio
_SAMPLE_ROUNDS = 16  # Wood rejection candidate rounds


def log_iv(nu: float, kappa: torch.Tensor) -> torch.Tensor:
    """log I_nu(kappa) by Olver's uniform asymptotic expansion (+u1 term)."""
    t = torch.sqrt(nu * nu + kappa * kappa)
    eta = t + nu * torch.log(kappa / (nu + t))
    p = nu / t
    u1 = (3.0 * p - 5.0 * p**3) / 24.0
    return eta - 0.5 * torch.log(2.0 * np.pi * t) + torch.log1p(u1 / nu)


def bessel_ratio(nu: float, kappa: torch.Tensor) -> torch.Tensor:
    """R = I_nu(kappa) / I_{nu-1}(kappa): r_k = I_{k+1}/I_k obeys
    r_k = 1 / (2(k+1)/kappa + r_{k+1}), seeded at index nu + 64 with its
    small-argument limit; where kappa >= nu + 32 the ratio of Olver
    asymptotics instead.

    Each step is one fused add and one reciprocal (the JAX package writes it
    ``kappa / (2(nu+j) + kappa r)``, the same value): on the card every op
    of the 64 steps, and of their backward, is a launch of its own."""
    inv_k = 1.0 / kappa
    r = kappa / (2.0 * (nu + _RATIO_DEPTH))
    for j in range(_RATIO_DEPTH - 1, -1, -1):
        r = torch.reciprocal(torch.add(r, inv_k, alpha=2.0 * (nu + j)))
    asym = torch.exp(log_iv(nu, kappa) - log_iv(nu - 1.0, kappa))
    return torch.where(kappa < nu + 0.5 * _RATIO_DEPTH, r, asym)


def vmf_kl(kappa: torch.Tensor, m: int) -> torch.Tensor:
    """KL(vMF(mu, kappa) || uniform on S^{m-1}), independent of mu:
    kappa I_{m/2}/I_{m/2-1} + log C_m(kappa) + log Area(S^{m-1}), with
    log C_m(k) = (m/2-1) log k - (m/2) log 2pi - log I_{m/2-1}(k)."""
    nu = m / 2.0 - 1.0
    kappa = torch.clamp(kappa, min=1e-8)
    ratio = bessel_ratio(nu + 1.0, kappa)
    log_c = nu * torch.log(kappa) - (nu + 1.0) * np.log(2.0 * np.pi) - log_iv(nu, kappa)
    log_area = (
        np.log(2.0) + (m / 2.0) * np.log(np.pi)
        - torch.lgamma(torch.tensor(m / 2.0, dtype=torch.float32, device=kappa.device))
    )
    return kappa * ratio + log_c + log_area


def beta_symmetric(dim: int, shape, generator: torch.Generator, device) -> torch.Tensor:
    """Beta(dim/2, dim/2) draws: X / (X + Y), X and Y chi-square with
    ``dim`` degrees of freedom, each a sum of squared standard normals."""
    g = torch.randn((2, *shape, dim), generator=generator, device=device)
    chi = (g * g).sum(dim=-1)
    return chi[0] / (chi[0] + chi[1])


def vmf_sample(mu: torch.Tensor, kappa: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One vMF(mu, kappa) draw per row; mu [N, m] unit rows, kappa [N, 1]."""
    N, m = mu.shape
    dev = mu.device
    kap = torch.clamp(kappa[:, 0], min=1e-8)

    # Wood (1994) envelope constants, per node.
    dim = m - 1.0
    sq = torch.sqrt(4.0 * kap**2 + dim**2)
    b = (-2.0 * kap + sq) / dim
    a = (dim + 2.0 * kap + sq) / 4.0
    d = 4.0 * a * b / (1.0 + b) - dim * np.log(dim)

    # Fixed-round rejection for omega = cos(angle to mu).
    eps = beta_symmetric(m - 1, (N, _SAMPLE_ROUNDS), generator, dev)
    u = torch.rand((N, _SAMPLE_ROUNDS), generator=generator, device=dev).clamp(min=1e-12)
    b_ = b[:, None]
    denom = 1.0 - (1.0 - b_) * eps
    omega_cand = (1.0 - (1.0 + b_) * eps) / denom
    t = 2.0 * (a * b)[:, None] / denom
    accept = dim * torch.log(t) - t + d[:, None] >= torch.log(u)
    # The first accepted column; the last candidate where none is.
    first = accept.to(torch.int32).argmax(dim=1)
    idx = torch.where(accept.any(dim=1), first, torch.full_like(first, _SAMPLE_ROUNDS - 1))
    omega = torch.gather(omega_cand, 1, idx[:, None].long())[:, 0]

    # Mean-path reparameterization (see the module docstring).
    mean_omega = bessel_ratio(m / 2.0, kap)
    omega = omega.detach() + mean_omega - mean_omega.detach()

    # Tangent direction uniform on S^{m-2}.
    v = torch.randn((N, m - 1), generator=generator, device=dev)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    z_e1 = torch.cat(
        [omega[:, None], torch.sqrt(torch.clamp(1.0 - omega**2, min=0.0))[:, None] * v], dim=1
    )

    # Householder reflection taking e1 to mu, row by row.
    e1 = torch.zeros((1, m), device=dev)
    e1[0, 0] = 1.0
    uvec = e1 - mu
    uvec = uvec / torch.clamp(torch.linalg.norm(uvec, dim=1, keepdim=True), min=1e-12)
    return z_e1 - 2.0 * uvec * torch.sum(uvec * z_e1, dim=1, keepdim=True)


class SVGAEEncoder(nn.Module):
    """GCN F->64, relu, dropout 0.1 in training; GCN heads for mu (64->m)
    and kappa (64->1). Parameters carry the JAX package's names ``w1``,
    ``w_mu``, ``w_kap``."""

    def __init__(self, in_channels: int, m: int, *, generator: torch.Generator, device="cpu"):
        super().__init__()
        self.w1 = nn.Parameter(_glorot((in_channels, 64), generator, device))
        self.w_mu = nn.Parameter(_glorot((64, m), generator, device))
        self.w_kap = nn.Parameter(_glorot((64, 1), generator, device))

    def forward(self, edges: EdgeList, x: torch.Tensor, generator: torch.Generator,
                dropout: bool = False):
        """(z, mu, kappa): mu normalized, kappa = softplus(.), z one vMF draw."""
        h = torch.relu(spmm(edges, x @ self.w1))
        if dropout:  # p = 0.1 (svgae.py:39, training only)
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 0.9
            h = torch.where(keep, h / 0.9, torch.zeros_like(h))
        mu = spmm(edges, h @ self.w_mu)
        mu = mu / torch.clamp(torch.linalg.norm(mu, dim=1, keepdim=True), min=1e-12)
        kappa = F.softplus(spmm(edges, h @ self.w_kap))
        return vmf_sample(mu, kappa, generator), mu, kappa


def run_svgae(
    graph: Graph,
    edge_index: np.ndarray,  # [2, E] observed (train-positive) edges
    test_and_val: Tuple[np.ndarray, ...],  # (test_pos, test_neg, val_pos, val_neg)
    *,
    embedding_dim: int = 64,
    lr: float = 1e-2,
    epochs: int = 2000,
    eval_every: int = 10,
    seed: int = 1,
    device="cuda",
) -> Tuple[float, np.ndarray]:
    """Train the vMF graph VAE on ``device``; returns (the test AUC x100 of
    the best-validation z, that z [N, embedding_dim + 1]), the CalSVGAE
    protocol (svgae.py:140-189). Evaluation samples z as the reference does."""
    from s3grl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    N = graph.num_nodes
    x = features_or_identity(graph, dev)
    m = embedding_dim + 1
    edges = _gcn_norm_edges(edge_index, N, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc = SVGAEEncoder(x.shape[1], m, generator=gen, device=dev)
    opt = torch.optim.Adam(enc.parameters(), lr=lr)
    pos_src = torch.as_tensor(np.asarray(edge_index[0], np.int64), device=dev)
    pos_dst = torch.as_tensor(np.asarray(edge_index[1], np.int64), device=dev)
    E = pos_src.shape[0]
    kl_scale = 1.0 / float(np.asarray(edge_index).max())

    def sample_z() -> np.ndarray:
        with torch.no_grad():
            return enc(edges, x, gen)[0].cpu().numpy()

    test_pos, test_neg, val_pos, val_neg = test_and_val
    best_val, record_z = -1.0, None
    for epoch in range(1, epochs + 1):
        neg_src = torch.randint(0, N, (E,), generator=gen, device=dev)
        neg_dst = torch.randint(0, N, (E,), generator=gen, device=dev)
        z, _, kappa = enc(edges, x, gen, dropout=True)
        loss = _recon_loss(z, pos_src, pos_dst, neg_src, neg_dst)
        loss = loss + kl_scale * vmf_kl(kappa[:, 0], m).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if epoch % eval_every == 0:
            zh = sample_z()
            r = evaluate_auc(*link_scores(zh, val_pos, val_neg),
                             *link_scores(zh, test_pos, test_neg))
            if r["AUC"][0] > best_val:
                best_val, record_z = r["AUC"][0], zh
    if record_z is None:  # epochs < eval_every
        record_z = sample_z()
    r = evaluate_auc(*link_scores(record_z, val_pos, val_neg),
                     *link_scores(record_z, test_pos, test_neg))
    return 100 * r["AUC"][1], record_z
