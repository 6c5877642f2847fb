"""Weights of the JAX package's SIGNNet, GNN baselines and init
representations (GAE/VGAE/ARGVA, SVGAE, GIC, node2vec) as a ``state_dict``
of the port's models.

The JAX package keeps flax variables: ``params`` and ``batch_stats``,
nested dicts keyed ``operator_diff`` / ``link_pred_mlp``, then ``Dense_i``
(an inner ``Dense_0`` holding ``kernel`` [in, out] and ``bias``) and
``MaskedBatchNorm_i`` (``scale``, ``bias``; batch stats ``mean``, ``var``).
Pass them in as nested dicts of numpy arrays; no JAX is needed here. The
init representations keep plain dicts of [in, out] arrays, whose names the
port's modules share.
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


def _tensors(params: dict, names) -> dict:
    return {k: torch.tensor(np.asarray(params[k], dtype=np.float32)) for k in names}


def gae_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's GAE ``{w1, w2}`` or VGAE/ARGVA ``{w1, w_mu, w_ls}``
    -> the state_dict of ``models/gae.GCNAutoEncoder`` (same names, same
    [in, out] layout)."""
    names = ("w1", "w_mu", "w_ls") if "w_mu" in params else ("w1", "w2")
    return _tensors(params, names)


def svgae_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's SVGAE ``{w1, w_mu, w_kap}`` -> the state_dict of
    ``models/svgae.SVGAEEncoder``."""
    return _tensors(params, ("w1", "w_mu", "w_kap"))


def gic_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's GIC ``{w_gcn, b_gcn, prelu_a, w_bil, b_bil}`` plus
    its fixed cluster init ``mu_init`` (one dict) -> the state_dict of
    ``models/gic.GICModel``."""
    return _tensors(params, ("w_gcn", "b_gcn", "prelu_a", "w_bil", "b_bil", "mu_init"))


def n2v_embedding_from_jax(emb) -> torch.Tensor:
    """A node2vec embedding [N, H] of the JAX package as the float32 leaf
    that ``models/n2v.skipgram_loss`` trains."""
    return torch.tensor(np.asarray(emb, dtype=np.float32)).requires_grad_()
