"""OGB link-property-prediction datasets, read offline.

Port of ``s3grl_tpu/data/ogb.py`` (reference sgrl_link_pred.py:826-838:
``PygLinkPropPredDataset(name)``, ``get_edge_split()`` and the
``NormalizeFeatures`` transform). It reads a dataset directory that was
downloaded beforehand, in the ogb package's layout; nothing is fetched, and
a missing directory raises FileNotFoundError saying how to get one.

Layout under ``{data_root}/{name with - -> _}/``::

    raw/edge.csv.gz            # one "u,v" edge per line
    raw/num-node-list.csv.gz   # one integer
    raw/node-feat.csv.gz       # optional: N rows of F floats
    raw/edge_weight.csv.gz     # optional: E weights
    split/{scheme}/train.pt    # torch-saved split dicts of tensors
    split/{scheme}/valid.pt
    split/{scheme}/test.pt

The split dicts come in the two OGB layouts that
``data/split.OgbEdgeSplit`` reads (edge, and source/target/target_node_neg;
reference utils.py:637-678). They are loaded with ``weights_only=True``:
dicts of tensors, nothing else unpickled.

As in the JAX package, every ogbl-* dataset gets plain NormalizeFeatures:
the reference's vessel-specific normalization (:830-838) is dead code
behind its ``startswith('ogbl')`` branch (:826).
"""
from __future__ import annotations

import glob
import gzip
import os
from typing import Optional, Tuple

import numpy as np
import torch

from s3grl_tpu_torch.data.graph import Graph, coalesce_edges, normalize_features, to_undirected
from s3grl_tpu_torch.data.split import OgbEdgeSplit


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def _to_numpy_tree(obj):
    """A loaded split dict with its tensors as numpy arrays."""
    if isinstance(obj, dict):
        return {k: _to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def load_ogb_dataset(
    name: str,
    data_root: str = "dataset",
    normalize: bool = True,
) -> Tuple[Graph, OgbEdgeSplit]:
    """(Graph, OgbEdgeSplit) of a downloaded ogbl-* dataset. The observed
    graph is the raw edge list symmetrized; with edge weights, duplicate
    edges are coalesced with their weights summed."""
    base = os.path.join(data_root, name.replace("-", "_"))
    raw = os.path.join(base, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"OGB dataset directory {base!r} not found. Pre-download it on "
            f"a machine with network access via "
            f"`PygLinkPropPredDataset(name={name!r}, root={data_root!r})` "
            f"(or `LinkPropPredDataset`) and copy the directory here."
        )

    edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    num_nodes = int(_read_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), np.int64)[0, 0])

    x: Optional[np.ndarray] = None
    feat_path = os.path.join(raw, "node-feat.csv.gz")
    if os.path.exists(feat_path):
        x = _read_csv_gz(feat_path, np.float32)
        if normalize:
            x = normalize_features(x)

    edge_index = to_undirected(edges.T.astype(np.int32))
    edge_weight = None
    w_path = os.path.join(raw, "edge_weight.csv.gz")
    if os.path.exists(w_path):
        w = _read_csv_gz(w_path, np.float32).reshape(-1)
        both = np.concatenate([edges.T, edges.T[::-1]], axis=1)
        edge_index, edge_weight = coalesce_edges(
            both.astype(np.int64), np.concatenate([w, w]), num_nodes
        )
        edge_index = edge_index.astype(np.int32)

    graph = Graph(num_nodes=num_nodes, edge_index=edge_index, edge_weight=edge_weight, x=x)

    split_dirs = sorted(glob.glob(os.path.join(base, "split", "*")))
    if not split_dirs:
        raise FileNotFoundError(f"no split directory under {base!r}")
    split_edge = {}
    for split in ("train", "valid", "test"):
        pt = os.path.join(split_dirs[0], f"{split}.pt")
        if not os.path.exists(pt):
            raise FileNotFoundError(f"missing OGB split file {pt!r}")
        split_edge[split] = _to_numpy_tree(torch.load(pt, map_location="cpu", weights_only=True))

    return graph, OgbEdgeSplit(
        split_edge=split_edge, num_nodes=num_nodes, edge_index=graph.edge_index
    )
