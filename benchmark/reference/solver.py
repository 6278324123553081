# Frozen copy of tpu_dialmpc_torch/dynamics/solver.py at commit ce76357, imports made relative.
"""Constrained forward dynamics: MuJoCo-style Newton solver, batched over
samples.

Counterpart of `tpu_dialmpc/dynamics/solver.py`.  It minimizes
  Φ(a) = ½(a−a₀)ᵀM(a−a₀) + Σᵢ sᵢ(Jᵢa − arefᵢ)
over accelerations, a₀ = qacc_smooth, with per-row costs: ½D x² on active
inequality rows (contacts, limits) where x < 0, and a two-sided Huber cost
with its knee at |x| = floss/D on friction-loss rows.  The warm start is
taken only where it beats the smooth acceleration (mj_solWarmstart); then
`model.iterations` Newton steps, each a dense Cholesky solve of
H = M + Jᵀ diag(h) J (`linalg.py`) and `ls_iterations` Newton steps on the
line search's φ'(α).  A sample stops moving once its improvement or its
gradient falls below tolerance: a `done` mask, as in the JAX solver, so
every sample runs the same ops and nothing is read back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import linalg
from .constraint import Constraints
from .model import PhysicsModel


class SolveResult(NamedTuple):
    qacc: torch.Tensor  # (B, nv)
    efc_force: torch.Tensor  # (B, nefc) constraint forces (0 when inactive)
    qfrc_constraint: torch.Tensor  # (B, nv)


def _s_terms(x, D, floss, row_active):
    """Per-row cost and its first and second derivatives in x."""
    is_friction = floss > 0.0
    knee = floss / torch.clamp(D, min=1e-30)
    quad_ineq = row_active & (~is_friction) & (x < 0.0)
    quad_fric = row_active & is_friction & (torch.abs(x) <= knee)
    lin_fric = row_active & is_friction & (torch.abs(x) > knee)

    quad = quad_ineq | quad_fric
    zero = torch.zeros_like(x)
    cost = torch.where(quad, 0.5 * D * x * x, zero) + torch.where(
        lin_fric, floss * torch.abs(x) - 0.5 * knee * floss, zero)
    dcost = torch.where(quad, D * x, zero) + torch.where(lin_fric, floss * torch.sign(x), zero)
    hcost = torch.where(quad, D, zero)
    return cost, dcost, hcost


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def solve(model: PhysicsModel, m_mat: torch.Tensor, qacc_smooth: torch.Tensor,
          qacc_warmstart: torch.Tensor, con: Constraints) -> SolveResult:
    """qacc (B, nv) and the rows' forces for M (B, nv, nv), qacc_smooth and
    qacc_warmstart (B, nv)."""
    nv = model.nv
    J, aref, D, floss, row_active = con.J, con.aref, con.D, con.floss, con.active
    if J.shape[1] == 0:
        return SolveResult(qacc=qacc_smooth, efc_force=aref, qfrc_constraint=torch.zeros_like(
            qacc_smooth))
    Jt = J.transpose(-1, -2)

    def total_cost(a):
        da = a - qacc_smooth
        x = _mv(J, a) - aref
        c, _, _ = _s_terms(x, D, floss, row_active)
        return 0.5 * _dot(da, _mv(m_mat, da)) + torch.sum(c, -1)

    # the warm start where it beats the smooth acceleration
    cost_ws = total_cost(qacc_warmstart)
    cost_sm = total_cost(qacc_smooth)
    a = torch.where((cost_ws < cost_sm)[:, None], qacc_warmstart, qacc_smooth)
    cost_prev = torch.minimum(cost_ws, cost_sm)

    tol_scale = model.tolerance * model.meaninertia * max(1, nv)
    any_active = torch.any(row_active, dim=-1)
    done = ~any_active
    for _ in range(max(1, model.iterations)):
        x = _mv(J, a) - aref
        _, dcost, hcost = _s_terms(x, D, floss, row_active)
        mda = _mv(m_mat, a - qacc_smooth)
        grad = mda + _mv(Jt, dcost)
        H = m_mat + (Jt * hcost[:, None, :]) @ J
        # H is SPD (M SPD, h >= 0)
        delta = -linalg.solve_psd(H, grad)

        # line search: Newton on φ'(α), exact for a fixed active set
        jd = _mv(J, delta)
        dmd = _dot(delta, _mv(m_mat, delta))
        dma = _dot(delta, mda)
        alpha = torch.zeros_like(dmd)
        for _ in range(max(1, model.ls_iterations)):
            _, dc, hc = _s_terms(x + alpha[:, None] * jd, D, floss, row_active)
            d1 = alpha * dmd + dma + _dot(jd, dc)
            d2 = dmd + _dot(jd, hc * jd)
            alpha = alpha - d1 / torch.clamp(d2, min=1e-30)
        alpha = torch.clamp(alpha, min=0.0)

        a_new = a + alpha[:, None] * delta
        cost_new = total_cost(a_new)
        improved = cost_prev - cost_new
        grad_norm = torch.linalg.vector_norm(grad, dim=-1)
        done_new = done | (improved < tol_scale) | (grad_norm < tol_scale)
        a = torch.where(done[:, None], a, a_new)
        cost_prev = torch.where(done, cost_prev, cost_new)
        done = done_new
    a = torch.where(any_active[:, None], a, qacc_smooth)

    _, dcost, _ = _s_terms(_mv(J, a) - aref, D, floss, row_active)
    efc_force = -dcost
    return SolveResult(qacc=a, efc_force=efc_force, qfrc_constraint=_mv(Jt, efc_force))
