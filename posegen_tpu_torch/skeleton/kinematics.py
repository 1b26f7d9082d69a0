"""Forward kinematics, level-parallel and batched
(port of posegen_tpu/skeleton/kinematics.py).

FK walks the kinematic tree one topological level at a time: each level is
one batched (..., L, 4, 4) @ (..., L, 4, 4) product against the parents'
transforms, so SMPL's 24 joints take 9 products instead of a 24-step chain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posegen_tpu_torch.skeleton.rotations import axisang_to_rot, bones_to_rot
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


def smpl_l2ws_from_rots(rots: torch.Tensor, rest_pose: Optional[torch.Tensor] = None,
                        scale: float = 1.0, skel: Skeleton = SMPL_SKELETON) -> torch.Tensor:
    """Rotation-matrix variant of `smpl_l2ws`: (..., J, 3, 3) -> (..., J, 4, 4)
    (reference get_smpl_l2ws_torch with axis_to_matrix=False)."""
    if rest_pose is None:
        rest_pose = torch.as_tensor(SMPL_REST_POSE, device=rots.device)
    rest_pose = torch.as_tensor(rest_pose, dtype=rots.dtype, device=rots.device) * scale
    return fk_l2ws(rots, rest_pose.expand(*rots.shape[:-2], 3), skel)


def pose_to_kinematic(bones: torch.Tensor, pelvis: torch.Tensor, rest_pose: torch.Tensor,
                      skel: Skeleton = SMPL_SKELETON
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full pose -> (kps (..., J, 3), skts = inverse(l2w) (..., J, 4, 4), l2ws,
    rots). bones (..., J, 3 | 6) are axis-angle or rot6d joint rotations;
    pelvis (..., 3) is added to every joint's world translation (reference
    pose_opt.py:372-445)."""
    rots = bones_to_rot(bones)
    rest_pose = torch.as_tensor(rest_pose, dtype=rots.dtype, device=rots.device)
    l2ws = fk_l2ws(rots, rest_pose.expand(*rots.shape[:-2], 3), skel)
    # pelvis into the translation column: (..., 1, 3) -> (..., 1, 4, 4)
    l2ws = l2ws + F.pad(pelvis[..., None, :, None], (3, 0, 0, 1))
    return l2ws[..., :3, 3], invert_rigid(l2ws), l2ws, rots


def rest_pose_from_l2ws(l2ws: torch.Tensor, skel: Skeleton = SMPL_SKELETON) -> torch.Tensor:
    """Rest-pose joint positions recovered from (J, 4, 4) l2w matrices
    (reference skeleton_utils.py:465-482)."""
    parents = skel.parents()
    kp = l2ws[:, :3, 3]
    rest = [None] * skel.n_joints
    rest[skel.root_id] = kp[skel.root_id]
    for level in topological_levels(skel)[1:]:
        for j in level:
            p = int(parents[j])
            rest[j] = rest[p] + l2ws[p, :3, :3].T @ (kp[j] - kp[p])
    return torch.stack(rest)
