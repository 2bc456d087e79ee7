"""Small math utilities (counterpart of ``utils/mathx.py``). Every
function broadcasts over any leading axes."""

from __future__ import annotations

import torch


def quat_to_euler(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> (roll, pitch, yaw), yaw in (-pi, pi]."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    y_sqr = y * y
    t0 = 2.0 * (w * x + y * z)
    t1 = 1.0 - 2.0 * (x * x + y_sqr)
    roll = torch.atan2(t0, t1)
    t2 = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(t2)
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y_sqr + z * z)
    yaw = torch.atan2(t3, t4)
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rot(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> 3x3 rotation matrix (body -> world)."""
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz], -1),
    ], dim=-2)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) -> quaternion (w,x,y,z), R = Rz(yaw) Ry(pitch)
    Rx(roll)."""
    hr, hp, hy = euler[..., 0] / 2, euler[..., 1] / 2, euler[..., 2] / 2
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw-only rotation matrix."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, zero], -1),
        torch.stack([s, c, zero], -1),
        torch.stack([zero, zero, one], -1),
    ], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], dim=-2)


def pseudo_inverse_3x3(m: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Tikhonov-regularized adjugate inverse of a 3x3 SPD matrix (the
    reference's SVD pseudo-inverse of the terrain-fit normal matrix)."""
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    a = m + eps * tr[..., None, None] * torch.eye(3, dtype=m.dtype,
                                                  device=m.device)
    cof = torch.stack([
        torch.stack([a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1],
                     a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                     a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]],
                    -1),
        torch.stack([a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2],
                     a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                     a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]],
                    -1),
        torch.stack([a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0],
                     a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                     a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]],
                    -1),
    ], dim=-2)
    det = (a[..., 0, 0] * cof[..., 0, 0] + a[..., 0, 1] * cof[..., 1, 0]
           + a[..., 0, 2] * cof[..., 2, 0])
    return cof / det[..., None, None]


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of general 3x3 matrices (no
    pivoting)."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    a20, a21, a22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def inv3_spd(m: torch.Tensor) -> torch.Tensor:
    """:func:`inv3` for symmetric 3x3 blocks: reads only the upper
    triangle."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 1], m[..., 1, 2], m[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / det
    return torch.stack([
        torch.stack([co00, co01, co02], dim=-1),
        torch.stack([co01, co11, co12], dim=-1),
        torch.stack([co02, co12, co22], dim=-1),
    ], dim=-2) * inv_det[..., None, None]


def solve3(m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3x3 solve via :func:`inv3`: (..., 3, 3) x (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", inv3(m), b)


def cal_dihedral_angle(n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """Unsigned angle between two plane normals."""
    cos_a = torch.abs(torch.sum(n1 * n2, dim=-1)) / (
        torch.linalg.vector_norm(n1, dim=-1)
        * torch.linalg.vector_norm(n2, dim=-1))
    return torch.arccos(torch.clamp(cos_a, -1.0, 1.0))


def wrap_yaw_error(err: torch.Tensor, desired: torch.Tensor,
                   actual: torch.Tensor) -> torch.Tensor:
    """Re-reference desired yaw by +-2 pi when the raw error exceeds
    1.5 pi (A1RobotControl.cpp:328-332)."""
    pi = 3.1415926
    err = torch.where(err > pi * 1.5, desired - 2 * pi - actual, err)
    return torch.where(err < -pi * 1.5, desired + 2 * pi - actual, err)
