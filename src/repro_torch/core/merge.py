"""MergeMoE expert merging (paper §4) + baselines (§5.1).

Row-major conventions (samples are rows): expert weights wg/wu: [N, d, f],
wd: [N, f, d]; calibration inputs X: [T, d]. The paper's column-major
``T1 P = Q`` least-squares becomes ``P @ T1r ≈ Q`` with ``T1r = lstsq(P, Q)``;
the final down projection is ``T1r @ Wd_blocks``, which collapses to
``lstsq(P, Z)`` with ``Z = Σ_j B_ji E_j(X)`` — the frequency-weighted target
outputs. Both forms are implemented; ``tests/test_merge.py`` asserts they
agree, and the simplified form is the default (it never materializes the
[T, |C|·f] stacked activations).

All solves run in fp64 on host (numpy) — this is the offline compression pass;
model-side compute stays bf16/f32.

The port's copy of the reference's ``repro/core/merge.py`` (pure NumPy / Python,
no framework): the same inputs give bit-identical results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.core import clustering as C


@dataclass
class MergeResult:
    wg: np.ndarray        # [M, d, f]
    wu: np.ndarray        # [M, d, f]
    wd: np.ndarray        # [M, f, d]
    remap: np.ndarray     # [N] int32 -> [0, M)
    assign: np.ndarray    # [N] cluster ids (== remap)
    weights: np.ndarray   # [N] intra-cluster merge weights (B entries)
    info: Dict


def _silu(x):
    return x / (1.0 + np.exp(-x))


def expert_forward(X, wg_i, wu_i, wd_i):
    """SwiGLU expert on row-major samples: [T, d] -> [T, d] (fp64)."""
    return (_silu(X @ wg_i) * (X @ wu_i)) @ wd_i


def _ridge_lstsq(P: np.ndarray, Z: np.ndarray, ridge: float) -> np.ndarray:
    """argmin_W ||P W - Z||_F^2 + ridge*tr(WᵀW)·scale ;  P: [T, f], Z: [T, d]."""
    f = P.shape[1]
    G = P.T @ P
    lam = ridge * (np.trace(G) / max(f, 1) + 1e-12)
    return np.linalg.solve(G + lam * np.eye(f), P.T @ Z)


# ---------------------------------------------------------------------------
# MergeMoE (ours)
# ---------------------------------------------------------------------------

def merge_mergemoe(wg, wu, wd, counts, X, M, *, ridge: float = 1e-6,
                   literal_t1: bool = False) -> MergeResult:
    """The paper's method. X: [T, d] calibration inputs for THIS layer."""
    wg = np.asarray(wg, np.float64)
    wu = np.asarray(wu, np.float64)
    wd = np.asarray(wd, np.float64)
    X = np.asarray(X, np.float64)
    N, d, f = wg.shape

    assign = C.cluster_experts(wg, wu, counts, M, metric="weights")
    w = C.merge_weights(assign, counts, M)

    out_g = np.zeros((M, d, f))
    out_u = np.zeros((M, d, f))
    out_d = np.zeros((M, f, d))
    resid = np.zeros(M)
    for c in range(M):
        members = np.where(assign == c)[0]
        wm = w[members]                                   # sums to 1
        # T2/T3 = weighted average (Eq. 4)
        g_m = np.einsum("j,jdf->df", wm, wg[members])
        u_m = np.einsum("j,jdf->df", wm, wu[members])
        # merged intermediate activations P = σ(X g_m) ⊙ (X u_m)
        P = _silu(X @ g_m) * (X @ u_m)                    # [T, f]
        if literal_t1:
            # paper-literal: stack member intermediates Q [T, |C|f], solve
            # T1r = lstsq(P, Q), then wd = T1r @ blockdiag-weighted Wd stack.
            Q = np.concatenate(
                [_silu(X @ wg[j]) * (X @ wu[j]) for j in members], axis=1)
            T1r = _ridge_lstsq(P, Q, ridge)               # [f, |C|f]
            Wd_blocks = np.concatenate(
                [wj * wd[j] for wj, j in zip(wm, members)], axis=0)
            d_m = T1r @ Wd_blocks
        else:
            # simplified (equivalent): solve directly against merged outputs
            Z = np.zeros((X.shape[0], d))
            for wj, j in zip(wm, members):
                Z += wj * expert_forward(X, wg[j], wu[j], wd[j])
            d_m = _ridge_lstsq(P, Z, ridge)               # [f, d]
            resid[c] = float(np.linalg.norm(P @ d_m - Z) /
                             (np.linalg.norm(Z) + 1e-12))
        out_g[c], out_u[c], out_d[c] = g_m, u_m, d_m

    return MergeResult(out_g, out_u, out_d, assign.astype(np.int32), assign, w,
                       info={"method": "mergemoe", "resid": resid})


# ---------------------------------------------------------------------------
# M-SMoE (Li et al., 2023): frequency-weighted PARAMETER averaging
# ---------------------------------------------------------------------------

def merge_msmoe(wg, wu, wd, counts, X, M, *, router=None) -> MergeResult:
    wg = np.asarray(wg, np.float64)
    wu = np.asarray(wu, np.float64)
    wd = np.asarray(wd, np.float64)
    N = wg.shape[0]
    assign = C.cluster_experts(wg, wu, counts, M, router=router,
                               metric="router" if router is not None else "weights")
    w = C.merge_weights(assign, counts, M)
    out = []
    for mat in (wg, wu, wd):
        m = np.zeros((M,) + mat.shape[1:])
        for c in range(M):
            members = np.where(assign == c)[0]
            m[c] = np.einsum("j,j...->...", w[members], mat[members])
        out.append(m)
    return MergeResult(out[0], out[1], out[2], assign.astype(np.int32),
                       assign, w, info={"method": "msmoe"})


# ---------------------------------------------------------------------------
# Average (Choshen et al., 2022 adapted): uniform parameter averaging
# ---------------------------------------------------------------------------

def merge_average(wg, wu, wd, counts, X, M) -> MergeResult:
    N = wg.shape[0]
    assign = C.cluster_experts(wg, wu, counts, M, metric="weights")
    uniform = np.ones(N)
    w = C.merge_weights(assign, uniform, M)   # uniform within cluster
    out = []
    for mat in (np.asarray(wg, np.float64), np.asarray(wu, np.float64),
                np.asarray(wd, np.float64)):
        m = np.zeros((M,) + mat.shape[1:])
        for c in range(M):
            members = np.where(assign == c)[0]
            m[c] = mat[members].mean(axis=0)
        out.append(m)
    return MergeResult(out[0], out[1], out[2], assign.astype(np.int32),
                       assign, w, info={"method": "average"})


# ---------------------------------------------------------------------------
# ZipIt (Stoica et al., 2023 adapted): activation-correlation neuron matching
# ---------------------------------------------------------------------------

def merge_zipit(wg, wu, wd, counts, X, M) -> MergeResult:
    """Adaptation of ZipIt to expert merging: within each cluster, members are
    zipped into the center one at a time; intermediate neurons of the member
    are permuted to the center's most-correlated neurons (greedy match on the
    calibration activations), then frequency-weighted-averaged."""
    wg = np.asarray(wg, np.float64)
    wu = np.asarray(wu, np.float64)
    wd = np.asarray(wd, np.float64)
    X = np.asarray(X, np.float64)
    N, d, f = wg.shape
    assign = C.cluster_experts(wg, wu, counts, M, metric="weights")
    w = C.merge_weights(assign, counts, M)
    cnt = np.asarray(counts, np.float64)

    def acts(i):
        h = _silu(X @ wg[i]) * (X @ wu[i])
        h = h - h.mean(axis=0, keepdims=True)
        n = np.linalg.norm(h, axis=0) + 1e-8
        return h / n

    out_g = np.zeros((M, d, f))
    out_u = np.zeros((M, d, f))
    out_d = np.zeros((M, f, d))
    for c in range(M):
        members = list(np.where(assign == c)[0])
        # center = most used member
        center = members[int(np.argmax(cnt[members]))]
        g_m, u_m, d_m = wg[center].copy(), wu[center].copy(), wd[center].copy()
        mass = max(cnt[center], 1.0)
        base = acts(center)
        for j in members:
            if j == center:
                continue
            corr = base.T @ acts(j)                       # [f, f]
            # greedy one-to-one matching
            perm = np.full(f, -1, np.int64)
            flat = np.argsort(-corr, axis=None)
            used_r, used_c = np.zeros(f, bool), np.zeros(f, bool)
            filled = 0
            for idx in flat:
                r, cc = divmod(int(idx), f)
                if not used_r[r] and not used_c[cc]:
                    perm[r] = cc
                    used_r[r], used_c[cc] = True, True
                    filled += 1
                    if filled == f:
                        break
            wj = max(cnt[j], 1.0)
            a = mass / (mass + wj)
            b = wj / (mass + wj)
            g_m = a * g_m + b * wg[j][:, perm]
            u_m = a * u_m + b * wu[j][:, perm]
            d_m = a * d_m + b * wd[j][perm, :]
            mass += wj
        out_g[c], out_u[c], out_d[c] = g_m, u_m, d_m
    return MergeResult(out_g, out_u, out_d, assign.astype(np.int32),
                       assign, w, info={"method": "zipit"})


# Compatibility view of the registry in repro_torch.core.plan (the canonical home
# of strategy registration); kept so ``for method in MG.METHODS`` call sites
# and the CLI keep working.
METHODS = {
    "mergemoe": merge_mergemoe,
    "msmoe": merge_msmoe,
    "average": merge_average,
    "zipit": merge_zipit,
}


def merge_layer(method: str, wg, wu, wd, counts, X, M, *,
                router=None, **kw) -> MergeResult:
    """Single-layer merge through the strategy registry. Prefer building a
    :class:`repro_torch.core.plan.CompressionPlan` for whole-model compression."""
    from repro_torch.core import plan as PLAN   # local: plan imports this module
    return PLAN.get_strategy(method).merge(wg, wu, wd, counts, X, M,
                                           router=router, **kw)
