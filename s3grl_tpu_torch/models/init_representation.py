"""init_representation dispatch: pretrain node features with GAE / VGAE /
ARGVA / SVGAE / GIC.

Port of ``s3grl_tpu/models/init_representation.py`` (reference:
sgrl_link_pred.py:973-1003): the encoder's hidden width is half of
``hidden_channels`` and its output ``hidden_channels``; the embeddings
replace the node features, then NormalizeFeatures re-normalizes them.
"""
from __future__ import annotations

import os

import numpy as np

from s3grl_tpu_torch.config import RunConfig
from s3grl_tpu_torch.data.graph import Graph, normalize_features
from s3grl_tpu_torch.data.split import EdgeSplit


def pretrain_representation(
    graph: Graph, edge_split: EdgeSplit, cfg: RunConfig, *, device="cuda"
) -> Graph:
    """The graph with its features replaced by ``cfg.init_representation``'s
    embeddings, trained on ``device`` from the split's train edges. Every
    sum with a gradient adds in a fixed order (``ops/spmm.spmm``,
    ``ops/segment.gather_rows``), so the embeddings repeat on the card."""
    z = _pretrain(graph, edge_split, cfg, device)
    return graph.with_features(normalize_features(np.asarray(z, dtype=np.float32)))


def _pretrain(graph: Graph, edge_split: EdgeSplit, cfg: RunConfig, device) -> np.ndarray:
    """``cfg.init_representation``'s embeddings [N, D]."""
    sd = edge_split.as_dict()
    test_and_val = (
        sd["test"]["edge"].T,
        sd["test"]["edge_neg"].T,
        sd["valid"]["edge"].T,
        sd["valid"]["edge_neg"].T,
    )
    edge_index = sd["train"]["edge"].T  # [2, E]

    kind = cfg.init_representation
    if kind in ("GAE", "VGAE", "ARGVA"):
        from s3grl_tpu_torch.models.gae import run_gae

        _, z = run_gae(
            graph, edge_index, test_and_val, model=kind,
            embedding_dim=cfg.hidden_channels, hidden_channels=cfg.hidden_channels // 2,
            lr=cfg.lr, epochs=cfg.epochs, seed=cfg.seed, device=device,
        )
    elif kind == "SVGAE":
        from s3grl_tpu_torch.models.svgae import run_svgae

        # The reference's protocol: Z_DIM 64, lr 1e-2 and a fixed 2,000
        # pretraining epochs (WalkPooling/software/svgae.py:160), not
        # cfg.epochs. S3GRL_TPU_SVGAE_EPOCHS shortens it, the same variable
        # the JAX package reads.
        svgae_epochs = int(os.environ.get("S3GRL_TPU_SVGAE_EPOCHS", "2000"))
        _, z = run_svgae(
            graph, edge_index, test_and_val, embedding_dim=64, epochs=svgae_epochs,
            seed=cfg.seed, device=device,
        )
    elif kind == "GIC":
        from s3grl_tpu_torch.models.gic import run_gic

        _, z = run_gic(
            graph, edge_index, test_and_val, embedding_dim=cfg.hidden_channels,
            seed=cfg.seed, dataset=cfg.dataset, device=device,
        )
    else:
        raise NotImplementedError(f"init_representation: {kind} not supported.")
    return z
