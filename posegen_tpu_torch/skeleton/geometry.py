"""Bounding geometry (port of posegen_tpu/skeleton/geometry.py:19-60, 179-186)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from posegen_tpu_torch.skeleton.skeleton import Skeleton, skeleton_from_n_joints


def get_kp_bounding_cylinder(
    kp: torch.Tensor,
    skel: Optional[Skeleton] = None,
    ext_scale: float = 0.00035,
    extend_mm: float = 250.0,
    top_expand_ratio: float = 1.0,
    bot_expand_ratio: float = 0.25,
    head: str = "-y",
) -> torch.Tensor:
    """Vertical bounding cylinder per pose (reference skeleton_utils.py:635-685).

    kp: (J, 3) or (B, J, 3) keypoints.
    head: axis along which the person stands ('-y' for SPIN data, 'z' SURREAL).
    Returns (..., 5): [cx, cz, radius, top, bot] where (cx, cz) are the root's
    ground-plane coordinates.
    """
    if head.endswith("z"):
        g_axes, h_axis = [0, 1], 2
    elif head.endswith("y"):
        g_axes, h_axis = [0, 2], 1
    else:
        raise NotImplementedError(f"head orientation {head!r} not supported")
    flip = -1.0 if head.startswith("-") else 1.0
    if skel is None:
        skel = skeleton_from_n_joints(kp.shape[-2])

    root_loc = kp[..., skel.root_id, :]
    dist = torch.linalg.norm(kp[..., g_axes] - root_loc[..., None, g_axes], dim=-1)
    max_dist = dist.amax(-1)
    h = flip * kp[..., h_axis]
    ext = extend_mm * ext_scale
    radius = max_dist + ext
    top = flip * (h.amax(-1) + ext * top_expand_ratio)
    bot = flip * (h.amin(-1) - ext * bot_expand_ratio)
    return torch.stack(
        [root_loc[..., g_axes[0]], root_loc[..., g_axes[1]], radius, top, bot],
        dim=-1,
    )


def calculate_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed-offset angle between vectors, shifted by pi/2
    (reference skeleton_utils.py:687-698)."""
    dot = (a * b).sum(-1)
    na = torch.linalg.norm(a, dim=-1)
    nb = torch.linalg.norm(b, dim=-1)
    cos = torch.clamp(dot / (na * nb), -1.0 + 1e-6, 1.0 - 1e-6)
    return torch.arccos(cos) - 0.5 * math.pi
