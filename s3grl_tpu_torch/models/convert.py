"""Weights of the JAX package's SIGNNet and GNN baselines as a
``state_dict`` of the port's models.

The JAX package keeps flax variables: ``params`` and ``batch_stats``,
nested dicts keyed ``operator_diff`` / ``link_pred_mlp``, then ``Dense_i``
(an inner ``Dense_0`` holding ``kernel`` [in, out] and ``bias``) and
``MaskedBatchNorm_i`` (``scale``, ``bias``; batch stats ``mean``, ``var``).
Pass them in as nested dicts of numpy arrays; no JAX is needed here.
"""
from __future__ import annotations

import re

import numpy as np
import torch


def signnet_state_dict_from_flax(variables: dict) -> dict:
    """``{"params": ..., "batch_stats": ...}`` -> the port's state_dict."""
    out = {}
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for mlp_name, layers in params.items():
        for layer, leaves in layers.items():
            m = re.fullmatch(r"(Dense|MaskedBatchNorm)_(\d+)", layer)
            if m is None:
                raise KeyError(f"unexpected flax layer {mlp_name}/{layer}")
            i = int(m.group(2))
            if m.group(1) == "Dense":
                inner = leaves["Dense_0"]
                out[f"{mlp_name}.lins.{i}.weight"] = np.asarray(inner["kernel"]).T
                out[f"{mlp_name}.lins.{i}.bias"] = np.asarray(inner["bias"])
            else:
                pre = f"{mlp_name}.norms.{i}"
                out[f"{pre}.weight"] = np.asarray(leaves["scale"])
                out[f"{pre}.bias"] = np.asarray(leaves["bias"])
                bs = stats[mlp_name][layer]
                out[f"{pre}.running_mean"] = np.asarray(bs["mean"])
                out[f"{pre}.running_var"] = np.asarray(bs["var"])
    return {
        k: torch.tensor(np.asarray(v, dtype=np.float32))
        for k, v in out.items()
    }


def _dense(leaves: dict, prefix: str) -> dict:
    """One flax ``Dense`` (a wrapper holding ``Dense_0``, or a bare kernel)."""
    inner = leaves.get("Dense_0", leaves)
    out = {f"{prefix}.weight": np.asarray(inner["kernel"]).T}
    if "bias" in inner:
        out[f"{prefix}.bias"] = np.asarray(inner["bias"])
    return out


def gnn_state_dict_from_flax(variables: dict, model_name: str) -> dict:
    """The JAX package's GNN baseline variables (``params``, and
    ``batch_stats`` where the model has batch norms) -> the state_dict of
    ``models/gnn.py``'s model for ``model_name`` (DGCNN, GCN, SAGE, GIN).

    Flax names: ``ZEmbedding_0/embedding``; ``Batched{GCN,SAGE,GIN}Conv_i``
    (DGCNN's convs are GCN convs) holding ``Dense_j`` and, in GIN, a
    ``MaskedBatchNorm_0``; DGCNN's ``Conv_0``/``Conv_1`` with kernels
    [k, in, out] (torch: [out, in, k]); the score ``MLP_0``.
    """
    conv = {"DGCNN": "GCN", "GCN": "GCN", "SAGE": "SAGE", "GIN": "GIN"}[model_name]
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out = {"z_embedding.weight": np.asarray(params["ZEmbedding_0"]["embedding"])}
    for name, leaves in params.items():
        m = re.fullmatch(rf"Batched{conv}Conv_(\d+)", name)
        if m is None:
            if name not in ("ZEmbedding_0", "MLP_0", "Conv_0", "Conv_1"):
                raise KeyError(f"unexpected flax module {name} in {model_name}")
            continue
        pre = f"convs.{m.group(1)}"
        if conv == "GCN":
            out.update(_dense(leaves["Dense_0"], f"{pre}.lin"))
        elif conv == "SAGE":
            out.update(_dense(leaves["Dense_0"], f"{pre}.lin_l"))
            out.update(_dense(leaves["Dense_1"], f"{pre}.lin_r"))
        else:
            out.update(_dense(leaves["Dense_0"], f"{pre}.lin1"))
            out.update(_dense(leaves["Dense_1"], f"{pre}.lin2"))
            bn, bs = leaves["MaskedBatchNorm_0"], stats[name]["MaskedBatchNorm_0"]
            out[f"{pre}.norm.weight"] = np.asarray(bn["scale"])
            out[f"{pre}.norm.bias"] = np.asarray(bn["bias"])
            out[f"{pre}.norm.running_mean"] = np.asarray(bs["mean"])
            out[f"{pre}.norm.running_var"] = np.asarray(bs["var"])
    for i in (0, 1) if model_name == "DGCNN" else ():
        c = params[f"Conv_{i}"]
        out[f"conv{i + 1}.weight"] = np.asarray(c["kernel"]).transpose(2, 1, 0)
        out[f"conv{i + 1}.bias"] = np.asarray(c["bias"])
    mlp = signnet_state_dict_from_flax(
        {"params": {"mlp": params["MLP_0"]}, "batch_stats": {"mlp": stats["MLP_0"]}}
    )
    return {
        **{k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()},
        **mlp,
    }
