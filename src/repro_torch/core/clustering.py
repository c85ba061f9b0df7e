"""Expert clustering (paper §4, step 1).

Centers = the M most-used experts. Every remaining expert joins the center
with the highest cosine similarity of its concat(W_U, W_G) weight features
(MergeMoE / Average / ZipIt) or of its router column (M-SMoE's
routing-policy view).

The port's copy of the reference's ``repro/core/clustering.py`` (pure NumPy / Python,
no framework): the same inputs give bit-identical results.
"""
from __future__ import annotations

import numpy as np


def _cosine_to_centers(feats: np.ndarray, center_ids: np.ndarray) -> np.ndarray:
    """feats: [N, D] fp32; returns [N, M] cosine similarity to each center."""
    f = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8)
    c = f[center_ids]                                   # [M, D]
    return f @ c.T                                      # [N, M]


def cluster_experts(wg: np.ndarray, wu: np.ndarray, counts: np.ndarray,
                    M: int, *, router: np.ndarray | None = None,
                    metric: str = "weights") -> np.ndarray:
    """Returns ``assign`` [N] int32 — cluster id in [0, M) per original expert.

    wg/wu: [N, d, f]; counts: [N] usage frequencies; router: [d, N] (only for
    metric='router'). Cluster ids are ordered by the center ranking (cluster 0
    = most-used expert's cluster).
    """
    N = wg.shape[0]
    if M >= N:
        return np.arange(N, dtype=np.int32)
    counts = np.asarray(counts, np.float64)
    center_ids = np.argsort(-counts, kind="stable")[:M]

    if metric == "router":
        assert router is not None
        feats = np.asarray(router, np.float32).T.reshape(N, -1)
    else:
        feats = np.concatenate(
            [np.asarray(wu, np.float32).reshape(N, -1),
             np.asarray(wg, np.float32).reshape(N, -1)], axis=1)

    sim = _cosine_to_centers(feats, center_ids)         # [N, M]
    assign = np.argmax(sim, axis=1).astype(np.int32)
    assign[center_ids] = np.arange(M, dtype=np.int32)   # centers stay put
    return assign


def merge_weights(assign: np.ndarray, counts: np.ndarray, M: int) -> np.ndarray:
    """Frequency-weighted B matrix entries (Theorem 1 optimum).

    Returns [N] float32: w_j = f_j / sum_{k in cluster(j)} f_k (uniform if the
    cluster saw zero traffic).
    """
    counts = np.asarray(counts, np.float64)
    w = np.zeros_like(counts)
    for c in range(M):
        members = np.where(assign == c)[0]
        tot = counts[members].sum()
        if tot > 0:
            w[members] = counts[members] / tot
        else:
            w[members] = 1.0 / max(len(members), 1)
    return w.astype(np.float32)


def summation_matrix(assign: np.ndarray, M: int) -> np.ndarray:
    """The paper's matrix A (Eq. 2): [M, N] one-hot cluster membership."""
    N = assign.shape[0]
    A = np.zeros((M, N), np.float32)
    A[assign, np.arange(N)] = 1.0
    return A


def mixing_matrix(assign: np.ndarray, counts: np.ndarray, M: int) -> np.ndarray:
    """The paper's matrix B: [N, M], column i supported on cluster C_i."""
    N = assign.shape[0]
    w = merge_weights(assign, counts, M)
    B = np.zeros((N, M), np.float32)
    B[np.arange(N), assign] = w
    return B
