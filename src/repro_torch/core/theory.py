"""Theorem 1 machinery (paper §4 + Appendix A).

Objective (after the paper's simplification):
    J(B) = Σ_i f_i (u_i - e_i)ᵀ W (u_i - e_i),   W = Y0ᵀ Y0,  u_i = B a_i
where a_i is column i of A. Theorem 1: the frequency-weighted B
(B_ji = f_j / Σ_{k∈C_i} f_k) is a global minimum.

``tests/test_theory.py`` verifies this numerically (hypothesis sweeps random
perturbations of B and asserts J never decreases).

The port's copy of the reference's ``repro/core/theory.py`` (pure NumPy / Python,
no framework): the same inputs give bit-identical results.
"""
from __future__ import annotations

import numpy as np


def objective(B: np.ndarray, A: np.ndarray, W: np.ndarray,
              f: np.ndarray) -> float:
    """J(B) as above. B: [N, M]; A: [M, N]; W: [N, N] PSD; f: [N] >= 0."""
    N = A.shape[1]
    U = B @ A                                    # [N, N]; column i = u_i
    J = 0.0
    for i in range(N):
        v = U[:, i].copy()
        v[i] -= 1.0
        J += float(f[i]) * float(v @ W @ v)
    return J


def optimal_B(assign: np.ndarray, f: np.ndarray, M: int) -> np.ndarray:
    """Theorem 1's minimizer."""
    from repro_torch.core.clustering import mixing_matrix
    return mixing_matrix(assign, f, M)


def quasi_frobenius(Y: np.ndarray) -> np.ndarray:
    """QF(Y): per-expert squared Frobenius norms. Y: [d, N] stacked expert
    outputs (columns). Returns [N]."""
    return np.sum(np.asarray(Y, np.float64) ** 2, axis=0)


def output_error(Y: np.ndarray, B: np.ndarray, A: np.ndarray,
                 r: np.ndarray) -> float:
    """||(Y B A - Y) diag-mask routing||_F for a single sample: Y [d, N],
    r [N] masked routing weights. Measures the compressed-vs-original output
    gap that MergeMoE minimizes in expectation."""
    delta = (Y @ B @ A - Y) * r[None, :]
    return float(np.linalg.norm(delta))
