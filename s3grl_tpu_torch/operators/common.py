"""Shared container for precomputed diffusion-operator datasets."""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class OperatorDataset:
    """Precomputed SIGN-style per-link operator features.

    The fixed-shape analog of the reference's list of PyG ``Data`` objects
    with keys x, x1..xK (tuned_SIGN.py:173-185): every link stores R rows
    (2 targets + optional CCN rows) for each of the K+1 operators.

    xs:       [L, K+1, R, F'] float tensor (op 0 = raw trimmed x, ops 1..K = A^k X)
    row_mask: [L, R] bool tensor           (False on padded CCN slots)
    y:        [L] float numpy              labels

    ``xs`` and ``row_mask`` may also be numpy arrays (a dataset loaded from
    disk); ``fit_signnet`` moves them to its device.
    """

    xs: "torch.Tensor"
    row_mask: "torch.Tensor"
    y: "np.ndarray"

    @property
    def num_links(self) -> int:
        return int(self.xs.shape[0])

    @property
    def num_operators(self) -> int:
        return int(self.xs.shape[1])

    @property
    def num_rows(self) -> int:
        return int(self.xs.shape[2])

    @property
    def feature_dim(self) -> int:
        return int(self.xs.shape[3])

    def model_inputs(self, sign_k: int, last_only: bool = False) -> torch.Tensor:
        """Concatenate operators feature-wise for SIGNNet consumption.

        Mirrors the train-loop assembly (sgrl_link_pred.py:449-459):
        xs = [x, x1..xK] concat along features, or only x{K} if
        ``last_only`` (sign_k == -1 mode, tuned_SIGN.py:18-23).
        Returns [L, R, n_ops * F'].
        """
        xs = torch.as_tensor(self.xs)
        ops = xs[:, -1:] if last_only else xs[:, : sign_k + 1]
        L, O, R, F = ops.shape
        return ops.permute(0, 2, 1, 3).reshape(L, R, O * F)

    def concat(self, other: "OperatorDataset") -> "OperatorDataset":
        return OperatorDataset(
            xs=torch.cat([torch.as_tensor(self.xs), torch.as_tensor(other.xs)]),
            row_mask=torch.cat(
                [torch.as_tensor(self.row_mask), torch.as_tensor(other.row_mask)]
            ),
            y=np.concatenate([np.asarray(self.y), np.asarray(other.y)], axis=0),
        )

    def to_host(self) -> "OperatorDataset":
        """numpy copy (one bulk transfer per array). A bfloat16 ``xs`` is
        widened to float32, which numpy can hold; the values are unchanged."""
        xs = torch.as_tensor(self.xs)
        if xs.dtype == torch.bfloat16:
            xs = xs.float()
        return OperatorDataset(
            xs=xs.cpu().numpy(),
            row_mask=torch.as_tensor(self.row_mask).cpu().numpy(),
            y=np.asarray(self.y),
        )

    def save(self, path: str) -> None:
        """Persist as npz — the analog of the reference's processed
        ``SEAL_{split}_data.pt`` artifacts (sgrl_link_pred.py:87-94)."""
        host = self.to_host()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, xs=host.xs, row_mask=host.row_mask, y=host.y)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "OperatorDataset":
        with np.load(path) as z:
            return cls(xs=z["xs"], row_mask=z["row_mask"], y=z["y"])

    def hybrid_with(self, sop: "OperatorDataset") -> "OperatorDataset":
        """Hybrid PoS+SoP: append SoP operators x2..xK as x{K+1}..x{2K-1}
        (reference: utils.py:476-477, data[f'x{k}'] = sop x{k - K + 1}),
        zero-padding the feature width to the larger of the two. Requires
        equal R (vanilla PoS, R=2). The join is made on this (PoS) dataset's
        device, in the wider of the two dtypes (the PoS half may be bf16)."""
        if self.num_links != sop.num_links:
            raise ValueError(f"{self.num_links} PoS links, {sop.num_links} SoP links")
        if self.num_rows != sop.num_rows:
            raise ValueError("hybrid requires vanilla PoS (R=2)")
        a = torch.as_tensor(self.xs)
        b = torch.as_tensor(sop.xs)[:, 2:]
        dtype = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dtype), b.to(device=a.device, dtype=dtype)
        f = max(a.shape[-1], b.shape[-1])
        a = torch.nn.functional.pad(a, (0, f - a.shape[-1]))
        b = torch.nn.functional.pad(b, (0, f - b.shape[-1]))
        return OperatorDataset(
            xs=torch.cat([a, b], dim=1), row_mask=self.row_mask, y=self.y
        )
