"""Skeleton graph adjacency helpers (GCN-style normalised adjacency).

Counterpart of d3dp_tpu/utils/graph.py (the reference's
common/graph_utils.py, which no entry point imports): for users who build
graph-convolutional variants on the skeleton metadata
(`data.skeleton.Skeleton`).
"""

import numpy as np


def adj_mx_from_edges(num_joints, edges, sparse=False):
    """D^-1/2 (A + I) D^-1/2, float32 (num_joints, num_joints), of the
    symmetric adjacency A of an edge list with self-loops. `sparse` is
    accepted, as the JAX package's is, and ignored: the result is dense."""
    A = np.zeros((num_joints, num_joints), dtype=np.float32)
    for i, j in edges:
        A[i, j] = 1.0
        A[j, i] = 1.0
    A = A + np.eye(num_joints, dtype=np.float32)
    d = A.sum(axis=1)
    D = np.diag(np.power(d, -0.5, where=d > 0))
    return D @ A @ D


def adj_mx_from_skeleton(skeleton):
    """The normalised adjacency of a Skeleton's parent array (a joint joined
    to its parent)."""
    parents = skeleton.parents()
    edges = [(j, p) for j, p in enumerate(parents) if p >= 0]
    return adj_mx_from_edges(len(parents), edges)
