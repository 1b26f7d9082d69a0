"""Forward kinematics, level-parallel and batched
(port of posegen_tpu/skeleton/kinematics.py:29-150).

FK walks the kinematic tree one topological level at a time: each level is
one batched (..., L, 4, 4) @ (..., L, 4, 4) product against the parents'
transforms, so SMPL's 24 joints take 9 products instead of a 24-step chain.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from posegen_tpu_torch.skeleton.rotations import axisang_to_rot
from posegen_tpu_torch.skeleton.skeleton import (
    SMPL_REST_POSE,
    SMPL_SKELETON,
    Skeleton,
    topological_levels,
)


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the [0, 0, 0, 1] row appended."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def _local_transforms(rots: torch.Tensor, rest_pose: torch.Tensor,
                      parents: np.ndarray, root_id: int) -> torch.Tensor:
    """Per-joint transform relative to the parent frame, (..., J, 4, 4):
    [R | rest_j - rest_parent]; the root keeps its absolute rest location
    (reference skeleton_utils.py:355)."""
    J = rest_pose.shape[-2]
    idx = torch.as_tensor(parents, device=rest_pose.device)
    t = rest_pose - rest_pose.index_select(-2, idx)
    root = (torch.arange(J, device=rest_pose.device) == root_id)[:, None]
    t = torch.where(root, rest_pose, t)
    return _homogeneous(torch.cat([rots, t[..., None]], dim=-1))


def fk_l2ws(rots: torch.Tensor, rest_pose: torch.Tensor,
            skel: Skeleton = SMPL_SKELETON) -> torch.Tensor:
    """Local-to-world 4x4 transforms for every joint.

    rots: (..., J, 3, 3) per-joint rotations (relative to parent).
    rest_pose: (..., J, 3) rest pose joint locations.
    Returns (..., J, 4, 4), l2w[j] = l2w[parent[j]] @ local[j].
    """
    parents = skel.parents()
    local = _local_transforms(rots, rest_pose, parents, skel.root_id)
    l2w = local.clone()  # level-0 (root) rows already correct
    for level in topological_levels(skel)[1:]:
        idx = list(level)
        pidx = [int(parents[j]) for j in level]
        l2w[..., idx, :, :] = l2w[..., pidx, :, :] @ local[..., idx, :, :]
    return l2w


def smpl_l2ws(pose: torch.Tensor, rest_pose: Optional[torch.Tensor] = None,
              scale: float = 1.0, skel: Skeleton = SMPL_SKELETON) -> torch.Tensor:
    """Axis-angle SMPL pose (..., J, 3) -> local-to-world transforms
    (..., J, 4, 4) (reference get_smpl_l2ws, skeleton_utils.py:334)."""
    if rest_pose is None:
        rest_pose = torch.as_tensor(SMPL_REST_POSE, device=pose.device)
    rest_pose = torch.as_tensor(rest_pose, dtype=pose.dtype, device=pose.device) * scale
    rest_pose = rest_pose.expand(*pose.shape[:-1], 3)
    return fk_l2ws(axisang_to_rot(pose), rest_pose, skel)


def invert_rigid(tf: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid 4x4 transforms: [R|t]^-1 = [R^T | -R^T t]."""
    Rt = tf[..., :3, :3].transpose(-1, -2)
    t = tf[..., :3, 3:]
    return _homogeneous(torch.cat([Rt, -Rt @ t], dim=-1))
