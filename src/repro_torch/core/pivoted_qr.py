"""Column-pivoted Householder QR (port of ``repro/core/pivoted_qr.py``).

``W · P = Q · R`` with greedy column pivoting, so ``|R11| ≥ |R22| ≥ …``
ranks the orthonormal directions in Q by importance; signs are normalised so
that diag R ≥ 0.  The algorithm is the reference's step for step (trailing
column norms recomputed each step, no norm downdating), in plain float32
torch on the weight's device.  It runs once per adapted matrix at adapter
init, so it is a loop of small tensor ops rather than a kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class PivotedQR(NamedTuple):
    Q: torch.Tensor  # (L, K) orthonormal columns
    R: torch.Tensor  # (K, M) upper triangular, diag ≥ 0 and non-increasing
    perm: torch.Tensor  # (M,) int64 — W[:, perm] ≈ Q @ R


def qr_pivoted(W: torch.Tensor, num_reflectors: int | None = None) -> PivotedQR:
    """Column-pivoted reduced QR of ``W`` (L × M), float32 internally."""
    A = W.detach().to(torch.float32).clone()
    L, M = A.shape
    K = min(L, M) if num_reflectors is None else min(num_reflectors, L, M)
    dev = A.device
    V = torch.zeros((K, L), dtype=torch.float32, device=dev)
    betas = torch.zeros((K,), dtype=torch.float32, device=dev)
    perm = torch.arange(M, device=dev)
    for k in range(K):
        # pivot: trailing column with the largest ||A[k:, j]||
        sq = (A[k:, :] ** 2).sum(dim=0)
        sq[:k] = float("-inf")
        p = int(torch.argmax(sq))  # first maximum, like jnp.argmax
        if p != k:
            A[:, [k, p]] = A[:, [p, k]]
            perm[[k, p]] = perm[[p, k]]
        # Householder reflector annihilating A[k+1:, k]
        x = torch.zeros((L,), dtype=torch.float32, device=dev)
        x[k:] = A[k:, k]
        normx = torch.linalg.norm(x)
        alpha = -torch.where(x[k] >= 0, 1.0, -1.0) * normx
        v = x.clone()
        v[k] -= alpha
        vnorm2 = v @ v
        beta = torch.where(vnorm2 > 1e-30, 2.0 / vnorm2, torch.zeros_like(vnorm2))
        A -= torch.outer(v, beta * (v @ A))  # H = I - beta v vᵀ on the trailing matrix
        V[k] = v
        betas[k] = beta
    R = torch.triu(A[:K, :])
    # Q = H_0 H_1 … H_{K-1} @ I[:, :K]  (reflectors applied in reverse)
    Q = torch.eye(L, K, dtype=torch.float32, device=dev)
    for k in range(K - 1, -1, -1):
        Q -= betas[k] * torch.outer(V[k], V[k] @ Q)
    s = torch.where(torch.diagonal(R[:, :K]) < 0, -1.0, 1.0)
    return PivotedQR(Q * s[None, :], R * s[:, None], perm)


def unpermute_columns(R: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """R̃ with columns scattered back to the original order, so that
    ``Q @ R̃ ≈ W`` (instead of ``Q @ R ≈ W[:, perm]``)."""
    M = R.shape[1]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(M, device=perm.device)
    return R[:, inv]


# ---------------------------------------------------------------------------
# Rank selection (paper §3.1 eq. 4 and §4.1)
# ---------------------------------------------------------------------------


def select_rank_energy(rdiag: torch.Tensor, tau: float) -> int:
    """Smallest r with  Σ_{i≤r} R_ii² / Σ_i R_ii²  ≥ τ   (paper eq. 4)."""
    e = rdiag.to(torch.float32) ** 2
    c = torch.cumsum(e, 0) / torch.clamp(e.sum(), min=1e-30)
    return min(int((c < tau).sum()) + 1, rdiag.shape[0])


def select_rank_magnitude(rdiag: torch.Tensor, tau: float) -> int:
    """Count of |R_ii| > τ·|R_11|   (paper §4.1 'QR-LoRA configurations')."""
    a = rdiag.to(torch.float32).abs()
    return max(int((a > tau * a[0]).sum()), 1)


def select_rank(rdiag: torch.Tensor, policy: str, tau: float, fixed: int = 0) -> int:
    if policy == "energy":
        return select_rank_energy(rdiag, tau)
    if policy == "magnitude":
        return select_rank_magnitude(rdiag, tau)
    if policy == "fixed":
        return min(fixed, rdiag.shape[0])
    raise ValueError(f"unknown rank policy {policy!r}")
