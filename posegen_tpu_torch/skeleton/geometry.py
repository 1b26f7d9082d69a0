"""Bounding geometry: per-pose cylinders, cylinder -> 2D boxes, joint frames
(port of posegen_tpu/skeleton/geometry.py).

`get_kp_bounding_cylinder` and `calculate_angle` run on torch tensors; the
camera and joint-frame helpers are host numpy, as in the JAX package, so
the integer boxes that pick an image's rays come out identical.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton, skeleton_from_n_joints


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


def focal_to_intrinsic(focal, dtype=np.float32) -> np.ndarray:
    """Pinhole intrinsic (3, 4) (reference skeleton_utils.py:1423-1431).

    Projects OpenCV-convention camera points (x right, y down, z forward);
    principal-point offsets are applied by the caller.
    """
    if np.ndim(focal) == 0:
        fx = fy = float(focal)
    else:
        f = np.reshape(np.asarray(focal), (-1,))
        fx, fy = (float(f[0]), float(f[0])) if f.size < 2 else (float(f[0]), float(f[1]))
    return np.array(
        [[fx, 0, 0, 0], [0, fy, 0, 0], [0, 0, 1, 0]],
        dtype=dtype,
    )


def cylinder_to_box_2d(
    cylinder_params: np.ndarray,
    hwf: Tuple[int, int, float],
    w2c: Optional[np.ndarray] = None,
    scale: float = 1.0,
    center=None,
    make_int: bool = True,
    n_rad: int = 50,
):
    """Project cylinder cap circles to the image and take the 2D bbox
    (reference skeleton_utils.py:700-787).

    Returns (tl, br, pts_2d). tl/br are (N, 2) int (or (2,) if single).
    """
    H, W, focal = hwf
    cp = np.asarray(cylinder_params)
    squeeze = cp.ndim == 1
    cp = np.atleast_2d(cp)
    root, radius = cp[:, :2], cp[:, 2:3]
    top, bot = cp[:, 3:4], cp[:, 4:5]

    rads = np.linspace(0.0, 2 * np.pi, n_rad)
    x = root[:, 0:1] + np.cos(rads)[None] * radius
    z = root[:, 1:2] + np.sin(rads)[None] * radius
    ones = np.ones_like(x)
    top_cap = np.stack([x, top * ones, z, ones], axis=-1)
    bot_cap = np.stack([x, bot * ones, z, ones], axis=-1)
    cap_pts = np.concatenate([top_cap, bot_cap], axis=-2).reshape(-1, 4)

    intrinsic = focal_to_intrinsic(focal)
    if w2c is not None:
        cap_pts = cap_pts @ w2c.T
    cap_pts = (cap_pts @ intrinsic.T).reshape(len(cp), -1, 3)
    pts_2d = cap_pts[..., :2] / cap_pts[..., 2:3]

    min_xy = pts_2d.min(axis=-2)
    max_xy = pts_2d.max(axis=-2)
    if make_int:
        min_xy = np.floor(min_xy).astype(np.int64)
        max_xy = np.ceil(max_xy).astype(np.int64)

    tl = min_xy.copy()
    br = max_xy.copy()
    if center is None:
        off = np.array([int(W * 0.5), int(H * 0.5)])
    else:
        off = np.array([int(center[0]), int(center[1])])
    tl = tl + off
    br = br + off

    if scale != 1.0:
        half_w = (max_xy[:, 0] - min_xy[:, 0]) * 0.5 * scale
        half_h = (max_xy[:, 1] - min_xy[:, 1]) * 0.5 * scale
        cx = (br[:, 0] + tl[:, 0]) * 0.5
        cy = (br[:, 1] + tl[:, 1]) * 0.5
        tl = np.stack([cx - half_w, cy - half_h], axis=-1)
        br = np.stack([cx + half_w, cy + half_h], axis=-1)
        if make_int:
            tl = np.floor(tl).astype(np.int64)
            br = np.ceil(br).astype(np.int64)

    tl[:, 0] = np.clip(tl[:, 0], 0, W - 1)
    br[:, 0] = np.clip(br[:, 0], 0, W - 1)
    tl[:, 1] = np.clip(tl[:, 1], 0, H - 1)
    br[:, 1] = np.clip(br[:, 1], 0, H - 1)

    if squeeze:
        return tl[0], br[0], pts_2d[0]
    return tl, br, pts_2d


def create_local_coord(vec: np.ndarray) -> np.ndarray:
    """Orthonormal frame whose z-axis aligns with `vec`
    (reference skeleton_utils.py:586-616)."""
    vec = np.asarray(vec, dtype=np.float32)
    n = np.linalg.norm(vec)
    eye = np.eye(3, dtype=np.float32)
    if np.isclose(n, 0.0):
        return eye
    z = vec / n
    # pick the least-aligned canonical axis as helper
    helper = eye[np.argmin(np.abs(z))]
    x = np.cross(helper, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z]).astype(np.float32)


def get_per_joint_coords(rest_pose: np.ndarray, skel: Skeleton = SMPL_SKELETON) -> np.ndarray:
    """Per-joint frames with z pointing from the joint toward its parent
    (reference skeleton_utils.py:618-632, 'parent-centered')."""
    coords = []
    for i, p in enumerate(skel.joint_trees):
        vec = rest_pose[p] - rest_pose[i]
        vec = vec / (np.linalg.norm(vec) + 1e-5)
        coords.append(create_local_coord(vec))
    return np.stack(coords)


def bone_lengths(kp: np.ndarray, skel: Skeleton = SMPL_SKELETON) -> np.ndarray:
    """Per-joint distance to parent (reference skeleton_utils.py:1455)."""
    parents = skel.parents()
    return np.linalg.norm(kp[..., :, :] - np.take(kp, parents, axis=-2), axis=-1)
