"""SE(3) / SO(3) helpers on tensors (counterpart of cerebro_tpu/geometry/se3.py,
the functions verification, PnP, Umeyama and the pose graph call).

Conventions: poses are 4x4 homogeneous matrices ``w_T_c`` (camera -> world),
quaternions are ``(w, x, y, z)``, Euler order is yaw-pitch-roll (Z-Y-X
intrinsic), matching the reference's ``PoseManipUtils``. Every function
broadcasts over leading batch axes.
"""

from __future__ import annotations

import math

import torch


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3) rotation + (...,3) translation -> (...,4,4) pose."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def ypr_to_rot(ypr: torch.Tensor) -> torch.Tensor:
    """(yaw, pitch, roll) in radians -> rotation matrix R = Rz(y)Ry(p)Rx(r)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_ypr(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (yaw, pitch, roll) radians (ZYX)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (w,x,y,z), branch-free
    Shepperd-style selection (the candidate with the largest pivot)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], -1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], -1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], -1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    idx = pivots.argmax(dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(qs, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) cross-product (skew) matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sincos_coeffs(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3 from theta^2,
    with Taylor forms near zero."""
    small = theta2 < 1e-6
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    t_safe = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t_safe) / t_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t_safe)) / t2_safe)
    C = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (t_safe - torch.sin(t_safe)) / (t2_safe * t_safe)
    )
    return A, B, C


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, with a Taylor form near zero."""
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    A, B, _ = _sincos_coeffs(theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A * W + B * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (...,3), through the quaternion
    (exact for every angle in [0, pi])."""
    q = rot_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    n_safe = torch.where(small, torch.ones_like(n), n)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-6), theta / n_safe)
    return scale[..., None] * qv


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(...,6) twist (v, w) -> (...,4,4) pose."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    W2 = W @ W
    _, B, C = _sincos_coeffs(theta2)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = eye + B * W + C * W2
    return make_pose(so3_exp(w), (V @ v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) pose -> (...,6) twist (v, w)."""
    w = so3_log(T[..., :3, :3])
    theta2 = (w * w).sum(-1)[..., None, None]
    W = hat(w)
    small = theta2 < 1e-6
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    A, B, _ = _sincos_coeffs(theta2)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - A / (2.0 * B)) / t2_safe)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(W.shape)
    Vinv = eye - 0.5 * W + coef * (W @ W)
    v = (Vinv @ T[..., :3, 3, None])[..., 0]
    return torch.cat([v, w], dim=-1)


def yaw_translation_pose(yaw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """4-DOF pose (yaw about Z + translation), the parameterization of the
    4-DOF pose graph."""
    z = torch.zeros_like(yaw)
    return make_pose(ypr_to_rot(torch.stack([yaw, z, z], dim=-1)), t)


def pose_delta_metrics(A: torch.Tensor, B: torch.Tensor):
    """Return (max |ypr| in degrees, max |t| in metres) of delta = A^-1 B
    (the 3-way consistency metric, ref src/ProcessedLoopCandidate.cpp:63-87)."""
    D = pose_inverse(A) @ B
    ypr_deg = rot_to_ypr(D[..., :3, :3]) * (180.0 / math.pi)
    t = D[..., :3, 3]
    return ypr_deg.abs().amax(dim=-1), t.abs().amax(dim=-1)
