"""Rotation representations: euler / matrix / continuous 6D / quaternion —
counterpart of morig_tpu/geometry/rotations.py, on tensors of any leading
shape, with the same conventions (R = Rx Ry Rz; quaternions (x, y, z, w))
and the same branch choices.
"""
from __future__ import annotations

import torch


def euler_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """XYZ-intrinsic euler angles (..., 3) -> R = Rx @ Ry @ Rz (..., 3, 3)."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    shape = angles.shape[:-1] + (3, 3)
    Rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(shape)
    Ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(shape)
    Rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(shape)
    return Rx @ Ry @ Rz


def matrix_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of euler_to_matrix: y = asin(R02), x = atan2(-R12, R22), z =
    atan2(-R01, R00) away from gimbal lock; the singular branch pins z = 0."""
    y = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    singular = torch.cos(y).abs() < 1e-6
    x = torch.where(singular, torch.atan2(R[..., 2, 1], R[..., 1, 1]),
                    torch.atan2(-R[..., 1, 2], R[..., 2, 2]))
    z = torch.where(singular, torch.zeros_like(y), torch.atan2(-R[..., 0, 1], R[..., 0, 0]))
    return torch.stack([x, y, z], -1)


def matrix_to_6d(R: torch.Tensor) -> torch.Tensor:
    """The first two columns, concatenated."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], -1)


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def sixd_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt continuous 6D -> rotation matrix (columns x, y, z)."""
    a, b = d6[..., :3], d6[..., 3:]
    x = _normalize(a)
    z = _normalize(torch.linalg.cross(x, b, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], -1)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (x, y, z, w): Shepperd's method,
    all four branches computed and one selected per matrix (trace > 0,
    else the largest diagonal entry), square roots clamped at 1e-12."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def branch(parts, s):
        return torch.stack(parts, -1) / (2.0 * torch.sqrt(torch.clamp(s, min=1e-12)))[..., None]

    q0 = branch([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], 1.0 + tr)
    q1 = branch([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], 1.0 + m00 - m11 - m22)
    q2 = branch([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], 1.0 - m00 + m11 - m22)
    q3 = branch([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], 1.0 - m00 - m11 + m22)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    return _normalize(torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3))))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], -1).reshape(q.shape[:-1] + (3, 3))
