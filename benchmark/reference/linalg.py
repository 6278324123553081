# Frozen copy of tpu_dialmpc_torch/dynamics/linalg.py at commit ce76357, imports made relative.
"""Unrolled small-matrix linear algebra over a batch of matrices.

Counterpart of `tpu_dialmpc/dynamics/linalg.py`: the same left-looking
Cholesky, column by column in JAX's order with its `max(·, 1e-30)` clamp on
each pivot, and the same forward and backward substitutions.  A library
factorisation (`torch.linalg.cholesky_ex`) reports a matrix that is not
positive definite through `info` instead of clamping, so it would diverge
from the JAX package exactly where the clamp acts.

Each column is a few ops over the batch: the sum over earlier columns is one
batched product (the JAX package unrolls it into one multiply-add per
column; the terms are the same, summed in another order).  Used for M⁻¹
(qacc_smooth), the Newton solver's H⁻¹ and the implicit-damping solve.
"""

from __future__ import annotations

import torch

__all__ = ["chol_factor", "chol_solve", "solve_psd"]


def chol_factor(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of (B, n, n) SPD matrices."""
    n = a.shape[-1]
    L = torch.zeros_like(a)
    for j in range(n):
        s = a[..., :, j]
        if j:
            s = s - (L[..., :, :j] @ L[..., j, :j, None])[..., 0]
        d = torch.sqrt(torch.clamp(s[..., j : j + 1], min=1e-30))
        # the strictly-upper part of the column stays zero
        L[..., j:, j] = s[..., j:] / d
    return L


def _solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L x = b with L (B, n, n) lower triangular, b (B, n)."""
    n = b.shape[-1]
    x = torch.empty_like(b)
    for i in range(n):
        s = b[..., i]
        if i:
            s = s - torch.sum(L[..., i, :i] * x[..., :i], dim=-1)
        x[..., i] = s / L[..., i, i]
    return x


def _solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lᵀ x = b (backward substitution)."""
    n = b.shape[-1]
    x = torch.empty_like(b)
    for i in range(n - 1, -1, -1):
        s = b[..., i]
        if i < n - 1:
            s = s - torch.sum(L[..., i + 1 :, i] * x[..., i + 1 :], dim=-1)
        x[..., i] = s / L[..., i, i]
    return x


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b given L = chol_factor(A)."""
    return _solve_upper_t(L, _solve_lower(L, b))


def solve_psd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems a x = b, a (B, n, n), b (B, n)."""
    return chol_solve(chol_factor(a), b)
