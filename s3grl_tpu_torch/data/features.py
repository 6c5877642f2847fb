"""Feature initialization (init_features).

Reference: sgrl_link_pred.py:956-971 —
- ``degree``: PyG OneHotDegree(max_degree=1024) appended/assigned
- ``eye``:    identity features
- ``n2v``:    node2vec pretraining (``models/n2v.py``), with a disk cache
  keyed by (dataset, dim, seed, epochs, edge set, device type) like the
  reference's ``Emb/{ds}_{dim}_seed{seed}*.pt`` (n2v_prep.py:19-22)
followed by NormalizeFeatures re-normalization (:1000-1003).

The port's embeddings come from torch's generators, not the JAX package's,
so its cache lives under a root of its own (the caller's ``cache_root``,
the runner's results directory), never the JAX package's cache.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from s3grl_tpu_torch.data.graph import Graph, normalize_features


def one_hot_degree(g: Graph, max_degree: int = 1024) -> np.ndarray:
    """PyG OneHotDegree semantics: one-hot of (in-)degree, capped columns.

    OneHotDegree concatenates to existing x; for the S3GRL datasets using
    init_features='degree' x is None, so the one-hot IS the feature matrix.
    """
    deg = np.minimum(g.degrees, max_degree)
    out = np.zeros((g.num_nodes, max_degree + 1), dtype=np.float32)
    out[np.arange(g.num_nodes), deg] = 1.0
    if g.x is not None:
        return np.concatenate([g.x, out], axis=1)
    return out


def eye_features(g: Graph) -> np.ndarray:
    return np.eye(g.num_nodes, dtype=np.float32)


def n2v_cache_path(
    cache_root: str, cache_key: str, g: Graph, n2v_dim: int, seed: int, epochs: int,
    device_type: str,
) -> str:
    """``{cache_root}/{ds}_{dim}_seed{seed}_ep{epochs}_{edgehash}_{device}.npz``:
    the JAX package's key (a hash of the observed edge set, so another split
    of the same dataset never collides) plus the device type, whose
    generator draws other numbers."""
    h = hashlib.sha256(
        np.ascontiguousarray(g.edge_index).tobytes() + np.int64(g.num_nodes).tobytes()
    ).hexdigest()[:10]
    return os.path.join(
        cache_root, f"{cache_key}_{n2v_dim}_seed{seed}_ep{epochs}_{h}_{device_type}.npz"
    )


def init_features(
    g: Graph,
    kind: str,
    *,
    n2v_dim: int = 16,
    seed: int = 1,
    epochs: int = 50,
    normalize: bool = True,
    cache_key: Optional[str] = None,
    cache_root: Optional[str] = None,
    device="cuda",
) -> Graph:
    """Apply init_features and the reference's re-normalization.

    The JAX package's signature plus ``cache_root`` and ``device``;
    ``n2v_dim``, ``seed``, ``epochs``, ``cache_key``, ``cache_root`` and
    ``device`` only matter to node2vec, which trains on ``device`` and is
    cached when both ``cache_key`` and ``cache_root`` are given.
    """
    if not kind:
        return g
    if kind == "degree":
        x = one_hot_degree(g)
    elif kind == "eye":
        x = eye_features(g)
    elif kind == "n2v":
        from s3grl_tpu_torch.models.n2v import node2vec_pretrain
        from s3grl_tpu_torch.utils.device import resolve_device

        dev = resolve_device(device)
        cache_path = None
        if cache_key and cache_root:
            cache_path = n2v_cache_path(
                cache_root, cache_key, g, n2v_dim, seed, epochs, dev.type
            )
        if cache_path and os.path.exists(cache_path):
            x = np.load(cache_path)["emb"]
        else:
            x = node2vec_pretrain(g, embedding_dim=n2v_dim, seed=seed, epochs=epochs,
                                  device=dev)
            if cache_path:
                os.makedirs(cache_root, exist_ok=True)
                np.savez_compressed(cache_path, emb=x)
    else:
        raise NotImplementedError(f"init_features {kind}")
    if normalize:
        x = normalize_features(x)
    return g.with_features(x)
