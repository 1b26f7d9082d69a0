"""Rotation algebra in PyTorch (port of posegen_tpu/skeleton/rotations.py).

Every function takes arbitrary leading batch dimensions and works on the
trailing axes. rot6d keeps the JAX package's column layout: the first two
columns of R, flattened row-major from a (3, 2) view, i.e. interleaved
[r00, r01, r10, r11, r20, r21].
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrices [v]_x."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def axisang_to_rot(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3).

    Rodrigues formula with the first-order expansion R ~ I + [w]_x near zero
    angle (the sqrt sees a masked operand, so its gradient stays finite).
    """
    theta_sq = (axisang**2).sum(-1, keepdim=True)
    small = theta_sq < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    K = _skew(axisang / theta)
    t = theta[..., None]
    eye = torch.eye(3, dtype=axisang.dtype, device=axisang.device).expand(K.shape)
    rot = eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    rot_small = eye + _skew(axisang)
    return torch.where(small[..., None], rot_small, rot)


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) (w, x, y, z).

    Branch-free Shepperd's method: all four candidate solutions, the one
    with the largest diagonal combination kept (the first on a tie).
    """
    m = rot
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1), min=0.0))
    cands = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    cands = cands / (2.0 * torch.clamp(q_abs, min=0.1 * _EPS))[..., None]
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    quat = torch.gather(cands, -2, idx)[..., 0, :]
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def quat_to_axisang(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) (w, x, y, z) -> axis-angle (..., 3)."""
    quat = torch.where(quat[..., :1] < 0, -quat, quat)  # w >= 0: angle in [0, pi]
    w = torch.clamp(quat[..., 0], -1.0, 1.0)
    xyz = quat[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm[..., 0], w)
    small = norm < 1e-6
    axis = xyz / torch.where(small, torch.ones_like(norm), norm)
    # small angle: 2 xyz / w is the first-order axis-angle
    w1 = quat[..., :1]
    safe_w = torch.where(w1.abs() < 1e-6, torch.ones_like(w1), w1)
    return torch.where(small, 2.0 * xyz / safe_w, axis * angle[..., None])


def rot_to_axisang(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3)."""
    return quat_to_axisang(rot_to_quat(rot))


def axisang_to_quat(axisang: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternions (..., 4) (w, x, y, z)."""
    theta = torch.linalg.norm(axisang, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-6
    k = torch.where(small, 0.5 - theta**2 / 48.0,
                    torch.sin(half) / torch.where(small, torch.ones_like(theta), theta))
    return torch.cat([torch.cos(half), axisang * k], dim=-1)


def rot6d_to_rot(x: torch.Tensor) -> torch.Tensor:
    """6D rotation representation (..., 6) -> rotation matrices (..., 3, 3):
    Gram-Schmidt on the two encoded columns (Zhou et al. CVPR'19)."""
    m = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True), min=_EPS)
    b2u = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2u / torch.clamp(torch.linalg.norm(b2u, dim=-1, keepdim=True), min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rot_to_rot6d(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> 6D representation (..., 6): the
    first two columns, flattened from the (3, 2) view row-major (the exact
    inverse of `rot6d_to_rot`)."""
    return rot[..., :3, :2].reshape(*rot.shape[:-2], 6)


def rot6d_to_axisang(x: torch.Tensor) -> torch.Tensor:
    return rot_to_axisang(rot6d_to_rot(x))


def bones_to_rot(bones: torch.Tensor) -> torch.Tensor:
    """Dispatch on representation size (3 = axis-angle, 6 = rot6d)."""
    if bones.shape[-1] == 3:
        return axisang_to_rot(bones)
    if bones.shape[-1] == 6:
        return rot6d_to_rot(bones)
    raise NotImplementedError(f"unknown bone representation dim {bones.shape[-1]}")
