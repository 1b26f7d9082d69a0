"""Rotation algebra in PyTorch (port of posegen_tpu/skeleton/rotations.py:17-58)."""

from __future__ import annotations

import torch


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
