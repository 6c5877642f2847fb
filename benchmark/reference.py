"""The plain reference: S3GRL's PoS operators per link and its SIGNNet
scorer, forward and training, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
harness hands it the graph, features, links, seeds and weights that it hands
the program, and it works out everything else again.

PoS (tuned_SIGN.py:137-262 with utils.py:47-85's extraction; the frozen
per-link algorithm of ``bench_torch.py``, with the configuration's cap):
for a link (s, d), breadth-first hops from {s, d}; the members are s, d,
then the reached nodes by (hop, node id), the first ``max_nodes`` of them;
the binary adjacency among the members without the link itself; Â =
D^-1/2 A D^-1/2 over it; the rows of s and d of Â^k [1 | X] for k = 0..K,
where the column of ones marks s and d only.

``precision``: ``"float64"`` is the reference; ``"tf32"`` is the control,
the same arithmetic in float32 with every product's operands rounded to
TF32 (10 mantissa bits), as a float32 matmul with TF32 allowed computes it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

UNREACHED = 1 << 40


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, to nearest."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b for a [..., K] and b [K, N], operands rounded to TF32 forward
    and backward, as a float32 matmul with TF32 allowed runs both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        grad_a = g @ tf32(b).t()
        grad_b = tf32(a).reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return grad_a, grad_b


class Arith:
    """Products in the reference's precision or the control's."""

    def __init__(self, precision: str):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision must be float64 or tf32, got {precision!r}")
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.round = precision == "tf32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _TF32MatMul.apply(a, b) if self.round else a @ b


class RefGraph:
    """The observed graph and its features on ``device``."""

    def __init__(self, num_nodes: int, edge_index: np.ndarray, x: np.ndarray, device):
        self.n = int(num_nodes)
        self.src = torch.as_tensor(edge_index[0], dtype=torch.long, device=device)
        self.dst = torch.as_tensor(edge_index[1], dtype=torch.long, device=device)
        self.x = torch.as_tensor(x, dtype=torch.float32, device=device)
        self.device = torch.device(device)


def members(g: RefGraph, s: int, d: int, num_hops: int, max_nodes: int) -> torch.Tensor:
    """[S] long: s, d, then the nodes within ``num_hops`` hops of {s, d} by
    (hop, id), the first ``max_nodes``."""
    dist = torch.full((g.n,), UNREACHED, dtype=torch.long, device=g.device)
    dist[s] = 0
    dist[d] = 0
    for hop in range(1, num_hops + 1):
        front = dist == hop - 1
        hit = torch.zeros(g.n, dtype=torch.bool, device=g.device)
        hit[g.dst[front[g.src]]] = True
        dist = torch.where(hit & (dist == UNREACHED), hop, dist)
    reached = torch.nonzero(dist < UNREACHED).squeeze(1)
    key = dist[reached] * g.n + reached
    key = torch.where(reached == s, -2, torch.where(reached == d, -1, key))
    return reached[torch.argsort(key)][:max_nodes]


def pos_link(g: RefGraph, s: int, d: int, *, num_hops: int, sign_k: int, max_nodes: int,
             arith: Arith) -> torch.Tensor:
    """[K+1, 2, F+1]: the PoS rows of link (s, d)."""
    nodes = members(g, s, d, num_hops, max_nodes)
    S = int(nodes.numel())
    pos = torch.full((g.n,), -1, dtype=torch.long, device=g.device)
    pos[nodes] = torch.arange(S, device=g.device)
    ps, pd = pos[g.src], pos[g.dst]
    inside = (ps >= 0) & (pd >= 0)
    A = torch.zeros((S, S), dtype=arith.dtype, device=g.device)
    A[ps[inside], pd[inside]] = 1.0
    A[0, 1] = 0.0
    A[1, 0] = 0.0
    deg = A.sum(dim=1)
    dinv = torch.where(deg > 0, deg.clamp(min=1e-30).rsqrt(), torch.zeros_like(deg))
    A_hat = dinv[:, None] * A * dinv[None, :]
    ind = torch.zeros((S, 1), dtype=arith.dtype, device=g.device)
    ind[:2] = 1.0
    subg_x = torch.cat([ind, g.x[nodes].to(arith.dtype)], dim=1)
    h = torch.zeros((2, S), dtype=arith.dtype, device=g.device)
    h[0, 0] = 1.0
    h[1, 1] = 1.0
    out = [subg_x[:2]]
    for _ in range(sign_k):
        h = arith.mm(h, A_hat)
        out.append(arith.mm(h, subg_x))
    return torch.stack(out)


def pos_rows(g: RefGraph, links: np.ndarray, *, num_hops: int, sign_k: int, max_nodes: int,
             precision: str = "float64") -> torch.Tensor:
    """[L, K+1, 2, F+1] on ``g.device``: :func:`pos_link` of every link."""
    arith = Arith(precision)
    return torch.stack([
        pos_link(g, int(s), int(d), num_hops=num_hops, sign_k=sign_k, max_nodes=max_nodes,
                 arith=arith)
        for s, d in np.asarray(links)])


def flat(xs: torch.Tensor) -> torch.Tensor:
    """[B, O, R, F] -> [B, R, O*F]: the operators side by side per row."""
    B, O, R, F = xs.shape
    return xs.permute(0, 2, 1, 3).reshape(B, R, O * F)


# SIGNNet (models.py:301-383; PyG MLP with batch_norm, act_first): one
# Linear -> ELU -> BatchNorm -> Dropout layer per row; the product of the two
# target rows; Linear -> ReLU -> BatchNorm -> Dropout -> Linear to a logit.
TRAINED = ("w1", "b1", "g1", "be1", "w2", "b2", "g2", "be2", "w3", "b3")


def _batch_norm(p: dict, i: int, a: torch.Tensor, mask, train: bool,
                momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    C = a.shape[-1]
    if train:
        flat_a = a.reshape(-1, C)
        m = (torch.ones(flat_a.shape[0], dtype=a.dtype, device=a.device) if mask is None
             else mask.reshape(-1).to(a.dtype))
        n = m.sum().clamp(min=1.0)
        mean = (flat_a * m[:, None]).sum(0) / n
        var = (((flat_a - mean) ** 2) * m[:, None]).sum(0) / n
        with torch.no_grad():
            unbiased = var * (n / (n - 1.0).clamp(min=1.0))
            p[f"rm{i}"].mul_(1 - momentum).add_(momentum * mean.detach())
            p[f"rv{i}"].mul_(1 - momentum).add_(momentum * unbiased.detach())
    else:
        mean, var = p[f"rm{i}"], p[f"rv{i}"]
    return (a - mean) * torch.rsqrt(var + eps) * p[f"g{i}"] + p[f"be{i}"]


def signnet(p: dict, x: torch.Tensor, mask: torch.Tensor, arith: Arith, *, train: bool,
            keep=(None, None), dropout: float = 0.5) -> torch.Tensor:
    """Logits [B] of SIGNNet with parameters ``p`` on rows ``x`` [B, R, D]
    with row mask [B, R]. In training the batch statistics update the
    running ones and ``keep`` holds the two dropout masks."""
    a = torch.nn.functional.elu(arith.mm(x, p["w1"].t()) + p["b1"])
    h = _batch_norm(p, 1, a, mask, train)
    if train:
        h = h * keep[0].to(h.dtype) / (1.0 - dropout)
    pooled = h[:, 0] * h[:, 1]
    a = torch.relu(arith.mm(pooled, p["w2"].t()) + p["b2"])
    h = _batch_norm(p, 2, a, None, train)
    if train:
        h = h * keep[1].to(h.dtype) / (1.0 - dropout)
    return (arith.mm(h, p["w3"].t()) + p["b3"])[:, 0]


def bce_with_logits(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return z.clamp(min=0) - z * y + torch.log1p(torch.exp(-z.abs()))


def init_params(seed: int, d_in: int, hidden: int, device, dtype) -> dict:
    """nn.Linear's default init, U(+-1/sqrt(fan_in)) for weight then bias,
    layer by layer from a CPU generator seeded with ``seed``; BatchNorm at
    weight 1, bias 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    p = {}
    for i, (fan_in, fan_out) in ((1, (d_in, hidden)), (2, (hidden, hidden)), (3, (hidden, 1))):
        bound = 1.0 / math.sqrt(fan_in)
        p[f"w{i}"] = torch.empty(fan_out, fan_in).uniform_(-bound, bound, generator=gen)
        p[f"b{i}"] = torch.empty(fan_out).uniform_(-bound, bound, generator=gen)
    for i in (1, 2):
        p[f"g{i}"] = torch.ones(hidden)
        p[f"be{i}"] = torch.zeros(hidden)
        p[f"rm{i}"] = torch.zeros(hidden)
        p[f"rv{i}"] = torch.ones(hidden)
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def predict(p: dict, xs: torch.Tensor, mask: torch.Tensor, arith: Arith,
            chunk: int = 1024) -> torch.Tensor:
    """Eval-mode logits of every link of ``xs`` [L, O, R, F]."""
    with torch.no_grad():
        return torch.cat([signnet(p, flat(xs[i:i + chunk]).to(arith.dtype), mask[i:i + chunk],
                                  arith, train=False)
                          for i in range(0, xs.shape[0], chunk)])


def first_steps(p: dict, batches: list, gen: torch.Generator, *, lr: float,
                weight_decay: float, dropout: float, arith: Arith) -> dict:
    """S3GRL's ``train_bce`` steps (sgrl_link_pred.py:440-472), one per
    batch (xs [B, O, R, F], row mask [B, R], labels [B]), from parameters
    ``p``, which it trains in place: the dropout masks drawn in float32 from
    ``gen``, the first layer's then the second's; the mean BCE; Adam with
    the weight decay added to the gradients. Returns the logits of each
    step, the first gradient as Adam takes it (with the decay) and the
    parameters after the last step."""
    leaves = [p[k].requires_grad_(True) for k in TRAINED]
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    H = p["w1"].shape[0]
    out = {"logits": []}
    for s, (xs, mask, y) in enumerate(batches):
        B, _, R, _ = xs.shape
        keep = (torch.empty((B, R, H), device=xs.device).bernoulli_(1.0 - dropout, generator=gen),
                torch.empty((B, H), device=xs.device).bernoulli_(1.0 - dropout, generator=gen))
        opt.zero_grad(set_to_none=True)
        z = signnet(p, flat(xs).to(arith.dtype), mask, arith, train=True, keep=keep,
                    dropout=dropout)
        loss = bce_with_logits(z, y.to(arith.dtype)).mean()
        loss.backward()
        if s == 0:
            out["grad0"] = {k: (p[k].grad + weight_decay * p[k]).detach().clone()
                            for k in TRAINED}
        opt.step()
        out["logits"].append(z.detach())
    for v in leaves:
        v.requires_grad_(False)
    out["params"] = {k: p[k].detach().clone() for k in TRAINED}
    return out
