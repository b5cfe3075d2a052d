"""Closed-form predictions on deterministic quadratics (Theorem 1 /
Theorem 3), numpy only — a copy of ``repro.core.theory``.

F_i(x) = ½‖A_i x − b_i‖² has Hessian H_i = A_iᵀA_i and local optimum
x*_i = H_i⁻¹ A_iᵀ b_i.  With exact gradients, K_i local GD steps are the
affine map  x ↦ P_i x + (I − P_i) x*_i,  P_i = (I − ηH_i)^{K_i}.  FedAvg's
round map is the ω-average of these affine maps, whose fixed point is

    x̃_∞ = (I − Σ ω_i P_i)⁻¹ Σ ω_i (I − P_i) x*_i .

Theorem 1 says x̃_∞ ≠ x* exactly when step asynchronism (K_i ≠ K_j) meets
data heterogeneity (x*_i ≠ x*_j).
"""
from __future__ import annotations

import numpy as np


def local_optimum(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(A.T @ A, A.T @ b)


def global_optimum(As, bs, weights) -> np.ndarray:
    H = sum(w * A.T @ A for w, A in zip(weights, As))
    g = sum(w * A.T @ b for w, A, b in zip(weights, As, bs))
    return np.linalg.solve(H, g)


def fedavg_fixed_point(As, bs, weights, k_steps, lr: float) -> np.ndarray:
    """Exact fixed point of FedAvg-with-step-asynchronism on quadratics."""
    d = As[0].shape[1]
    I = np.eye(d)
    M_sum = np.zeros((d, d))
    v_sum = np.zeros(d)
    for w, A, b, k in zip(weights, As, bs, k_steps):
        H = A.T @ A
        P = np.linalg.matrix_power(I - lr * H, int(k))
        x_loc = local_optimum(A, b)
        M_sum += w * P
        v_sum += w * (I - P) @ x_loc
    return np.linalg.solve(I - M_sum, v_sum)


def objective_inconsistency_rhs(As, bs, weights, k_steps,
                                x_star: np.ndarray) -> float:
    """RHS of Theorem 1 (up to the O(·) constant):
    Σ_i ω_i (K_i/K_min − 1) F_i(x*)."""
    k_min = min(k_steps)
    total = 0.0
    for w, A, b, k in zip(weights, As, bs, k_steps):
        r = A @ x_star - b
        total += w * (k / k_min - 1.0) * 0.5 * float(r @ r)
    return total


def suboptimality(As, bs, weights, x: np.ndarray, x_star: np.ndarray
                  ) -> float:
    """F(x) − F(x*)."""
    def F(v):
        return sum(0.5 * w * float((A @ v - b) @ (A @ v - b))
                   for w, A, b in zip(weights, As, bs))
    return F(x) - F(x_star)
