"""Training and evaluation of the SIGN scorer.

Port of ``s3grl_tpu/train/loop.py`` (reference ``train_bce``
sgrl_link_pred.py:440-472, ``test`` :538-587): the precomputed operator
datasets live on the device; each step gathers a shuffled batch, computes
the masked-mean BCE-with-logits and applies Adam with weight decay 1e-4
added to the gradients (torch Adam ``weight_decay``, sgrl_link_pred.py:1317).

The shuffle comes from ``np.random.default_rng(seed)``, so the port draws
the JAX package's batch order. The last batch is padded with index 0 and
loss weight 0; the padded rows still enter the BatchNorm statistics, as
there.

Spans (``profiling.span``): ``fit.setup`` (datasets to the device, the
model, the optimizer), ``fit.epoch`` (one epoch with its evaluation),
``fit.step`` (one optimizer step), ``fit.epoch_read`` (the epoch's one host
read of its loss), ``fit.eval`` (an evaluation) and ``fit.auc`` (its
metric on the host). Counters: ``fit.steps``, ``fit.evals``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from s3grl_tpu_torch.models.signnet import SIGNNet
from s3grl_tpu_torch.operators.common import OperatorDataset
from s3grl_tpu_torch.profiling import count, span
from s3grl_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, saved_epochs
from s3grl_tpu_torch.train.metrics import evaluate_auc
from s3grl_tpu_torch.utils.device import resolve_device


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogitsLoss (numerically stable torch formula)."""
    return (
        torch.clamp(logits, min=0.0)
        - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def make_optimizer(params, lr: float, weight_decay: float = 1e-4):
    """Adam with L2 added to the gradients before the moments."""
    return torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def flat_operators(xb: torch.Tensor) -> torch.Tensor:
    """[B, O, R, F] -> [B, R, O*F] feature-wise operator concat
    (sgrl_link_pred.py:449-459), in f32."""
    B, O, R, F = xb.shape
    return xb.permute(0, 2, 1, 3).reshape(B, R, O * F).float()


@dataclass
class FitResult:
    results_per_epoch: list  # [(results_dict, inference_time_s)]
    train_times: list
    inference_times: list
    num_params: int
    model: Optional[SIGNNet] = field(default=None, repr=False)


def fit_signnet(
    train_ds: OperatorDataset,
    val_ds: OperatorDataset,
    test_ds: OperatorDataset,
    *,
    sign_k: int,
    hidden_channels: int = 256,
    num_layers: Optional[int] = None,
    batch_size: int = 32,
    lr: float = 1e-4,
    epochs: int = 50,
    dropout: float = 0.5,
    k_heuristic: int = 0,
    k_pool_strategy: str = "",
    pool_operatorwise: bool = False,
    last_only: bool = False,
    seed: int = 1,
    eval_steps: int = 1,
    eval_fn: Callable = evaluate_auc,
    loss_fn: str = "",
    neg_ratio: int = 1,
    logger_hook: Optional[Callable] = None,
    pairwise: bool = False,
    checkpoint_training: bool = False,
    continue_from: Optional[int] = None,
    only_test: bool = False,
    test_multiple_models: bool = False,
    res_dir: str = "",
    run: int = 1,
    log_steps: int = 1,
    device="cuda",
) -> FitResult:
    """Train SIGNNet on precomputed operator datasets; returns FitResult.

    Checkpoints (``train/checkpoint.py``, in ``res_dir``): with
    ``checkpoint_training`` the model and optimizer are saved every
    ``log_steps`` epochs; ``continue_from`` restores epoch
    ``continue_from``'s and trains the rest of ``epochs``; ``only_test``
    scores the restored model once and trains nothing;
    ``test_multiple_models`` scores every saved checkpoint of ``run``, in
    epoch order, and trains nothing.
    """
    dev = resolve_device(device)
    if num_layers is None:
        num_layers = sign_k
    rng = np.random.default_rng(seed)
    # The init generator lives on the CPU, so a seeded run starts from the
    # same weights on every device; dropout masks are drawn on the device
    # that trains, from a generator there.
    init_gen = torch.Generator().manual_seed(seed)
    drop_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def to_dev(ds: OperatorDataset):
        # Datasets stay in their [L, O, R, F] layout (possibly bf16); each
        # batch is flattened to [B, R, O*F] f32 when it is drawn.
        xs = torch.as_tensor(ds.xs)
        n_ops = xs.shape[1]
        if last_only:
            if n_ops > 1:
                xs = xs[:, n_ops - 1 :]
        elif sign_k + 1 < n_ops:
            xs = xs[:, : sign_k + 1]
        return (
            xs.to(dev),
            torch.as_tensor(ds.row_mask).to(dev),
            torch.as_tensor(np.asarray(ds.y, dtype=np.float32)).to(dev),
        )

    with span("fit.setup"):
        x_tr, m_tr, y_tr = to_dev(train_ds)
        x_va, m_va, y_va = to_dev(val_ds)
        x_te, m_te, y_te = to_dev(test_ds)
        L = x_tr.shape[0]
        _, O, _, F = x_tr.shape

        model = SIGNNet(
            O * F, hidden_channels, num_layers, dropout=dropout,
            pool_operatorwise=pool_operatorwise, k_heuristic=k_heuristic,
            k_pool_strategy=k_pool_strategy, generator=init_gen,
        ).to(dev)
        opt = make_optimizer(model.parameters(), lr)
        n_params = sum(p.numel() for p in model.parameters())

        steps = (L + batch_size - 1) // batch_size
        L_pad = steps * batch_size
        w_full = torch.zeros(L_pad, dtype=torch.float32, device=dev)
        w_full[:L] = 1.0

    def step(loss_of) -> torch.Tensor:
        with span("fit.step"):
            opt.zero_grad(set_to_none=True)
            loss, weight = loss_of()
            loss.backward()
            opt.step()
            out = loss.detach() * weight
        count("fit.steps")
        return out

    def train_epoch(perm_pad: torch.Tensor) -> torch.Tensor:
        total = torch.zeros((), device=dev)
        for s in range(steps):
            idx = perm_pad[s * batch_size : (s + 1) * batch_size]
            wb = w_full[s * batch_size : (s + 1) * batch_size]

            def loss_of():
                out = model(flat_operators(x_tr[idx]), m_tr[idx], generator=drop_gen)
                losses = bce_with_logits(out, y_tr[idx])
                return (losses * wb).sum() / torch.clamp(wb.sum(), min=1.0), wb.sum()

            total = total + step(loss_of)
        return total

    # Pairwise training (reference train_pairwise, sgrl_link_pred.py:475-526,
    # PLNLP losses of custom_losses.py:5-16).
    y_np = np.asarray(train_ds.y)
    pos_idx_np = np.nonzero(y_np == 1)[0]
    neg_idx_np = np.nonzero(y_np == 0)[0]
    p_steps = max(len(pos_idx_np) // batch_size, 1) if pairwise else 0
    neg_bsz = batch_size * neg_ratio

    def train_epoch_pairwise(pos_perm: torch.Tensor, neg_perm: torch.Tensor):
        total = torch.zeros((), device=dev)
        for s in range(p_steps):
            pidx = pos_perm[s * batch_size : (s + 1) * batch_size]
            nidx = neg_perm[s * neg_bsz : (s + 1) * neg_bsz]

            def loss_of():
                pos_out = model(flat_operators(x_tr[pidx]), m_tr[pidx], generator=drop_gen)
                neg_out = model(flat_operators(x_tr[nidx]), m_tr[nidx], generator=drop_gen)
                pos_out = pos_out.reshape(-1, 1)
                if loss_fn == "weighted_auc_loss":
                    loss = (
                        float(neg_ratio) * (1 - (pos_out - neg_out.reshape(-1, 1))) ** 2
                    ).sum()
                elif loss_fn == "hinge_auc_loss":
                    neg_out = neg_out.reshape(-1, neg_ratio)
                    loss = (torch.clamp(1 - (pos_out - neg_out), min=0) ** 2).sum()
                else:  # auc_loss (default)
                    neg_out = neg_out.reshape(-1, neg_ratio)
                    loss = ((1 - (pos_out - neg_out)) ** 2).sum()
                return loss, 1.0

            total = total + step(loss_of)
        return total

    @torch.no_grad()
    def predict_all(x, m, bsz: int = 1024) -> np.ndarray:
        model.eval()
        outs = [
            model(flat_operators(x[s : s + bsz]), m[s : s + bsz])
            for s in range(0, x.shape[0], bsz)
        ]
        model.train()
        return torch.cat(outs).cpu().numpy()

    def evaluate():
        """(results, inference seconds) of the model on valid and test."""
        with span("fit.eval"):
            val_pred = predict_all(x_va, m_va)
            t1 = time.perf_counter()
            test_pred = predict_all(x_te, m_te)
            t_inf = time.perf_counter() - t1
            with span("fit.auc"):
                results = eval_fn(val_pred, np.asarray(val_ds.y), test_pred,
                                  np.asarray(test_ds.y))
        count("fit.evals")
        return results, t_inf

    # Checkpointed resume (reference: sgrl_link_pred.py:1328-1338).
    start_epoch = 1
    if continue_from is not None:
        load_checkpoint(res_dir, run, continue_from, model, opt, dev)
        start_epoch = continue_from + 1
        epochs = epochs - continue_from  # reference: sgrl_link_pred.py:1338
    if only_test or test_multiple_models:
        # Score the restored checkpoint, or every saved one, and train
        # nothing (reference: sgrl_link_pred.py:1340-1380).
        results_per_epoch = []
        for ckpt_epoch in saved_epochs(res_dir, run) if test_multiple_models else [None]:
            if ckpt_epoch is not None:
                load_checkpoint(res_dir, run, ckpt_epoch, model, opt, dev)
            results_per_epoch.append(evaluate())
        return FitResult(
            results_per_epoch=results_per_epoch,
            train_times=[],
            inference_times=[t for _, t in results_per_epoch],
            num_params=n_params,
            model=model,
        )

    results_per_epoch = []
    train_times, inference_times = [], []
    model.train()
    for epoch in range(start_epoch, start_epoch + epochs):
        with span("fit.epoch"):
            t0 = time.perf_counter()
            if pairwise:
                pperm = pos_idx_np[rng.permutation(len(pos_idx_np))]
                npad = p_steps * neg_bsz
                nperm = neg_idx_np[
                    rng.permutation(len(neg_idx_np))[:npad]
                    if len(neg_idx_np) >= npad
                    else rng.choice(len(neg_idx_np), npad)
                ]
                if len(pperm) < p_steps * batch_size:
                    pperm = np.concatenate([pperm, pperm[: p_steps * batch_size - len(pperm)]])
                loss_sum = train_epoch_pairwise(
                    torch.as_tensor(pperm, device=dev), torch.as_tensor(nperm, device=dev)
                )
            else:
                perm = rng.permutation(L)
                perm_pad = np.concatenate([perm, np.zeros(L_pad - L, dtype=perm.dtype)])
                loss_sum = train_epoch(torch.as_tensor(perm_pad, device=dev))
            with span("fit.epoch_read"):
                total = float(loss_sum)  # host read: the epoch's work has finished
            train_times.append(time.perf_counter() - t0)

            if checkpoint_training and epoch % log_steps == 0 and res_dir:
                save_checkpoint(res_dir, run, epoch, model, opt)

            if epoch % eval_steps == 0:
                results, t_inf = evaluate()
                inference_times.append(t_inf)
                results_per_epoch.append((results, t_inf))
                if logger_hook is not None:
                    logger_hook(epoch, total / L, results)

    return FitResult(
        results_per_epoch=results_per_epoch,
        train_times=train_times,
        inference_times=inference_times,
        num_params=n_params,
        model=model,
    )
