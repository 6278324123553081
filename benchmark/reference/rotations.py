# Frozen copy of tpu_dialmpc_torch/core/rotations.py at commit ce76357, imports made relative.
"""Quaternion / rotation math (w, x, y, z convention, MuJoCo-compatible).

Batched torch counterpart of `tpu_dialmpc/core/rotations.py`: every function
maps over arbitrary leading axes, so a sample axis is free.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "quat_mul",
    "quat_inv",
    "rotate",
    "inv_rotate",
    "quat_to_mat",
    "quat_integrate",
    "quat_to_yaw",
    "quat_to_yaw_eigen",
    "normalize_quat",
    "global_to_body_velocity",
    "local_to_global_velocity",
]


def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Hamilton product p ⊗ q, (..., 4)."""
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack(
        [
            pw * qw - px * qx - py * qy - pz * qz,
            pw * qx + px * qw + py * qz - pz * qy,
            pw * qy - px * qz + py * qw + pz * qx,
            pw * qz + px * qy - py * qx + pz * qw,
        ],
        dim=-1,
    )


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (negation is exact: the same bits as
    multiplying by (1, -1, -1, -1), with no constant made from host data)."""
    return torch.cat((q[..., :1], -q[..., 1:]), -1)


def rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q, Rodrigues form.

    r = 2 u (u·v) + (s² − u·u) v + 2 s (u × v)
    """
    s = q[..., :1]
    u = q[..., 1:]
    v = v.expand(torch.broadcast_shapes(v.shape, u.shape))
    u = u.expand(v.shape)
    return (
        2.0 * u * torch.sum(u * v, dim=-1, keepdim=True)
        + (s * s - torch.sum(u * u, dim=-1, keepdim=True)) * v
        + 2.0 * s * torch.linalg.cross(u, v, dim=-1)
    )


def inv_rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate by the inverse quaternion."""
    return rotate(v, quat_inv(q))


def global_to_body_velocity(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """World-frame vector → body frame."""
    return inv_rotate(v, q)


def local_to_global_velocity(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Body-frame vector → world frame."""
    return rotate(v, q)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion → (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by body-frame angular velocity over dt
    (MuJoCo `mju_quatIntegrate`): q ← q ⊗ exp(½ ω dt), renormalized."""
    theta = torch.linalg.vector_norm(omega_local, dim=-1) * dt
    half = 0.5 * theta
    small = theta < 1e-9
    sin_over = torch.where(
        small, 0.5, torch.sin(half) / torch.where(small, 1.0, theta)
    )
    dq = torch.cat(
        [torch.cos(half)[..., None], omega_local * (dt * sin_over)[..., None]],
        dim=-1,
    )
    return normalize_quat(quat_mul(q, dq))


def quat_to_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw (Z euler) in (-π, π] from (..., 4) quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_to_yaw_eigen(q: torch.Tensor) -> torch.Tensor:
    """Eigen-`eulerAngles(2,1,0)`-compatible yaw, range [0, π]: the true yaw
    plus π whenever it is negative (see the JAX package's docstring)."""
    yaw = quat_to_yaw(q)
    return torch.where(yaw < 0.0, yaw + math.pi, yaw)
