# Frozen copy of tpu_dialmpc_torch/core/spline.py at commit ce76357, imports made relative.
"""Natural-cubic-Hermite spline transforms as precomputed linear maps.

The reference implements `piecewiseCubicHermiteInterpolate` as a per-call
tridiagonal solve + Hermite evaluation (dial_mpc_eigen/include/dial-core.h:69-290)
and derives `node2u` / `u2node` / `shift` from it (dial-core.h:342-358, 621-633).

The natural cubic spline is *linear in the knot values*, and the planner only
ever evaluates it on two fixed uniform time grids (`step_nodes_`, `step_us_`,
dial-core.h:406-417).  So each transform is a fixed matrix, precomputed once
in float64 on the host with numpy; applying it is one small matmul.  `shift`
composes three linear maps (node→dense, roll-with-zero-fill, dense→node) into
one matrix.  This module is numpy only and is the same code as
`tpu_dialmpc/core/spline.py`; the torch port keeps its own copy so that it
imports nothing of the JAX package.

Reference quirks (replicated by `tail_slope="ref"`, the default):

1. Duplicated tail slope: the C++ assigns the *left-end* slope of the last
   interval to the last knot (dial-core.h:205-214), i.e.
   firstDerivs[N-1] == firstDerivs[N-2], instead of the true natural-spline
   end slope.
2. Halved curvature: the tridiagonal right-hand side uses the Burden-Faires
   `alpha = 3*(...)` form (dial-core.h:134-141) whose solution is s''/2, but
   the slope recovery (dial-core.h:197) expects the *true* second derivative —
   so the reference evaluates a C¹ Hermite spline with half the natural
   spline's curvature correction, not the natural cubic spline it documents.

`tail_slope="natural"` fixes both and yields the exact natural cubic spline
(verified against scipy.interpolate.CubicSpline(bc_type="natural")).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "interp_matrix",
    "interp_matrix_linear",
    "node2u_matrix",
    "u2node_matrix",
    "shift_matrix",
    "uniform_grid",
]


def _second_derivative_matrix(knot_times: np.ndarray, rhs_scale: float) -> np.ndarray:
    """Matrix S2 with secondDerivs = S2 @ y (natural boundary conditions).

    Mirrors the tridiagonal (Thomas) solve at dial-core.h:124-169, expressed as
    a dense solve of T @ M = C @ y since N is tiny (Hnode+1 ≈ 5-6).
    `rhs_scale=3.0` replicates the reference's halved-curvature quirk (see
    module docstring); `rhs_scale=6.0` yields the true second derivatives.
    """
    t = np.asarray(knot_times, dtype=np.float64)
    n = t.shape[0]
    h = np.diff(t)
    if np.any(h <= 0):
        raise ValueError("knot times must be strictly increasing")
    T = np.zeros((n, n))
    C = np.zeros((n, n))
    T[0, 0] = 1.0
    T[n - 1, n - 1] = 1.0
    for i in range(1, n - 1):
        T[i, i - 1] = h[i - 1]
        T[i, i] = 2.0 * (t[i + 1] - t[i - 1])
        T[i, i + 1] = h[i]
        C[i, i - 1] = rhs_scale / h[i - 1]
        C[i, i] = -rhs_scale / h[i] - rhs_scale / h[i - 1]
        C[i, i + 1] = rhs_scale / h[i]
    return np.linalg.solve(T, C)


def _first_derivative_matrix(knot_times: np.ndarray, tail_slope: str) -> np.ndarray:
    """Matrix S1 with knot slopes = S1 @ y.

    Interior/left slopes per dial-core.h:186-199; the last knot follows either
    the reference's duplicated-slope quirk (dial-core.h:205-214) or the correct
    natural end slope.
    """
    t = np.asarray(knot_times, dtype=np.float64)
    n = t.shape[0]
    h = np.diff(t)
    s2 = _second_derivative_matrix(t, 3.0 if tail_slope == "ref" else 6.0)
    s1 = np.zeros((n, n))
    eye = np.eye(n)
    for i in range(n - 1):
        # B_i = (y_{i+1} - y_i)/h_i - h_i/6 * (2*M_i + M_{i+1})
        s1[i] = (eye[i + 1] - eye[i]) / h[i] - (h[i] / 6.0) * (2.0 * s2[i] + s2[i + 1])
    hl = h[n - 2]
    if tail_slope == "ref":
        # Reference re-applies the left-end formula of the last interval.
        s1[n - 1] = (eye[n - 1] - eye[n - 2]) / hl - (hl / 6.0) * (
            2.0 * s2[n - 2] + s2[n - 1]
        )
    elif tail_slope == "natural":
        # True right-end slope: s'(t_{N-1}) on [t_{N-2}, t_{N-1}].
        s1[n - 1] = (eye[n - 1] - eye[n - 2]) / hl + (hl / 6.0) * (
            s2[n - 2] + 2.0 * s2[n - 1]
        )
    else:
        raise ValueError(f"tail_slope must be 'ref' or 'natural', got {tail_slope!r}")
    return s1


def interp_matrix_linear(
    knot_times: np.ndarray, query_times: np.ndarray
) -> np.ndarray:
    """(Q, N) piecewise-linear interpolation matrix.

    The reference's unused alternative interpolator
    (`piecewiseLinearInterpolate`, dial-core.h:292-340 — both node2u/u2node
    call sites keep it commented out in favor of the cubic spline); carried
    as `spline_mode="linear"` for completeness.
    """
    t = np.asarray(knot_times, dtype=np.float64)
    q = np.asarray(query_times, dtype=np.float64)
    n = t.shape[0]
    A = np.zeros((q.shape[0], n))
    interval = 0
    for k, tq in enumerate(q):
        while interval < n - 2 and tq > t[interval + 1]:
            interval += 1
        i = min(interval, n - 2)
        u = (tq - t[i]) / (t[i + 1] - t[i])
        A[k, i] = 1.0 - u
        A[k, i + 1] = u
    return A


def interp_matrix(
    knot_times: np.ndarray,
    query_times: np.ndarray,
    tail_slope: str = "ref",
) -> np.ndarray:
    """(Q, N) matrix A such that spline(y) evaluated at query_times == A @ y.

    Interval lookup replicates the reference's single-forward-pass semantics
    (dial-core.h:244-259): queries are assumed sorted; a query exactly at a knot
    evaluates on the left interval; queries past the last knot extrapolate on
    the final interval.
    """
    if tail_slope == "linear":
        return interp_matrix_linear(knot_times, query_times)
    t = np.asarray(knot_times, dtype=np.float64)
    q = np.asarray(query_times, dtype=np.float64)
    n = t.shape[0]
    if n < 2:
        raise ValueError("need at least 2 knot points")
    s1 = _first_derivative_matrix(t, tail_slope)
    eye = np.eye(n)
    A = np.zeros((q.shape[0], n))
    interval = 0
    for k, tq in enumerate(q):
        while interval < n - 2 and tq > t[interval + 1]:
            interval += 1
        i = min(interval, n - 2)
        h = t[i + 1] - t[i]
        u = (tq - t[i]) / h
        u2, u3 = u * u, u * u * u
        h00 = 2.0 * u3 - 3.0 * u2 + 1.0
        h10 = u3 - 2.0 * u2 + u
        h01 = -2.0 * u3 + 3.0 * u2
        h11 = u3 - u2
        A[k] = eye[i] * h00 + eye[i + 1] * h01 + h * (s1[i] * h10 + s1[i + 1] * h11)
    return A


def uniform_grid(n_intervals: int, tmax: float) -> np.ndarray:
    """Time grid `i / n * tmax` for i in [0..n] (dial-core.h:406-417)."""
    return np.arange(n_intervals + 1, dtype=np.float64) / float(n_intervals) * tmax


def node2u_matrix(
    hnode: int, hsample: int, ctrl_dt: float, tail_slope: str = "ref"
) -> np.ndarray:
    """(Hsample+1, Hnode+1) dense-control interpolation matrix (dial-core.h:342-349)."""
    tmax = ctrl_dt * hsample
    return interp_matrix(
        uniform_grid(hnode, tmax), uniform_grid(hsample, tmax), tail_slope
    )


def u2node_matrix(
    hnode: int, hsample: int, ctrl_dt: float, tail_slope: str = "ref"
) -> np.ndarray:
    """(Hnode+1, Hsample+1) resampling matrix (dial-core.h:351-358)."""
    tmax = ctrl_dt * hsample
    return interp_matrix(
        uniform_grid(hsample, tmax), uniform_grid(hnode, tmax), tail_slope
    )


def shift_matrix(
    hnode: int, hsample: int, ctrl_dt: float, tail_slope: str = "ref"
) -> np.ndarray:
    """(Hnode+1, Hnode+1) receding-horizon shift as one linear map.

    Composes node→dense, roll-up-one-with-zero-tail, dense→node
    (dial-core.h:621-633).
    """
    a = node2u_matrix(hnode, hsample, ctrl_dt, tail_slope)
    b = u2node_matrix(hnode, hsample, ctrl_dt, tail_slope)
    roll = np.zeros((hsample + 1, hsample + 1))
    for i in range(hsample):
        roll[i, i + 1] = 1.0
    return b @ roll @ a
