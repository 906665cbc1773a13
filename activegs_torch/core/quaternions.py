"""Quaternion / rotation utilities (port of `activegs_tpu/core/quaternions.py`).
Quaternions are (w, x, y, z), real part first."""

from __future__ import annotations

import torch


def _norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Safe L2 normalization."""
    return v / torch.clamp(_norm(v, dim), min=eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, in the reference's op order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation matrix."""
    r, x, y, z = q.unbind(-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion, robust
    4-candidate construction, standardized to w >= 0."""
    b = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(b + (9,)).unbind(-1)
    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))
    cand = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
        ],
        dim=-2,
    )
    cand = cand / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    best = torch.argmax(q_abs, dim=-1)
    q = torch.take_along_dim(cand, best[..., None, None], dim=-2).squeeze(-2)
    q = torch.where(q[..., :1] < 0, -q, q)
    return normalize(q)


def normal_to_quaternion(z: torch.Tensor):
    """Surfel frame whose third column is the given normal: returns
    (quat (..., 4), R (..., 3, 3)) with R = [x | y | z] columns."""
    z = normalize(z)
    ref = torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device).expand(z.shape)
    alt = torch.tensor([0.0, 1.0, 0.0], dtype=z.dtype, device=z.device).expand(z.shape)
    ref = torch.where(torch.abs(z[..., :1]) > 0.99, alt, ref)
    x = ref - torch.sum(ref * z, -1, keepdim=True) * z
    x = normalize(x)
    y = normalize(cross(z, x))
    rot = torch.stack([x, y, z], dim=-1)
    return matrix_to_quaternion(rot), rot


def rotation_from_z(z: torch.Tensor) -> torch.Tensor:
    """Camera rotation whose +z (view) axis is `z`, with no roll (y axis
    derived from world -z "down")."""
    z = normalize(z)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=z.dtype, device=z.device).expand(z.shape)
    collinear = torch.abs(torch.abs(torch.sum(z * down, -1, keepdim=True)) - 1.0) < 1e-6
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device).expand(z.shape)
    x = normalize(torch.where(collinear, x_axis, cross(down, z)))
    y = normalize(cross(z, x))
    return torch.stack([x, y, z], dim=-1)


def slerp_vec(v1: torch.Tensor, v2: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Spherical interpolation between two unit vectors at times t (K,),
    falling back to v2 for (near-)parallel inputs."""
    v1 = normalize(v1)
    v2 = normalize(v2)
    dot = torch.clamp(torch.sum(v1 * v2, -1), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    t = t[..., None]
    out = (torch.sin((1 - t) * theta) * v1 + torch.sin(t * theta) * v2) / torch.clamp(
        sin_theta, min=1e-12
    )
    out = torch.where(theta < 1e-3, v2, out)
    return normalize(out)
