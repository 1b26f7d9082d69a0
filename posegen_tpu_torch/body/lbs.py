"""Linear blend skinning in PyTorch (port of posegen_tpu/body/lbs.py).

The reference's vendored SMPL-X library (smplx/smplx/lbs.py:152-374:
`lbs`, `blend_shapes`, `vertices2joints`, `batch_rigid_transform`) as
batched products and a level-parallel kinematic chain: every joint of one
depth is composed with its parent in one 4 x 4 product. Every product runs
in float32 (`torch.matmul`, or a broadcast sum).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from posegen_tpu_torch.skeleton.rotations import axisang_to_rot


def blend_shapes(betas: torch.Tensor, shape_disps: torch.Tensor) -> torch.Tensor:
    """Per-vertex displacement from shape coefficients.

    betas: (B, n_betas); shape_disps: (V, 3, n_betas) -> (B, V, 3).
    """
    V, C, L = shape_disps.shape
    return torch.matmul(betas, shape_disps.reshape(V * C, L).T).reshape(-1, V, C)


def vertices2joints(J_regressor: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Regress joint locations from mesh vertices: (J, V), (B, V, 3) -> (B, J, 3)."""
    return torch.matmul(J_regressor, vertices)


def _levels_from_parents(parents: np.ndarray) -> Tuple[Tuple[int, ...], ...]:
    parents = np.asarray(parents)
    depth = np.zeros(len(parents), np.int64)
    for j in range(1, len(parents)):
        depth[j] = depth[parents[j]] + 1
    return tuple(
        tuple(int(i) for i in np.flatnonzero(depth == d)) for d in range(int(depth.max()) + 1)
    )


def batch_rigid_transform(
    rot_mats: torch.Tensor,
    joints: torch.Tensor,
    parents: np.ndarray,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics for the skinning chain.

    rot_mats: (B, J, 3, 3); joints: (B, J, 3) rest locations; parents[0] == -1
    or 0. Returns (posed_joints (B, J, 3), rel_transforms (B, J, 4, 4)) where
    rel_transforms map rest-pose-relative coordinates to posed space
    (A_k = G_k - pack(G_k @ j_k), the standard SMPL formulation).
    """
    B, J = joints.shape[:2]
    parents = np.asarray(parents).copy()
    parents[0] = 0
    dev = joints.device

    rel_joints = joints - joints[:, torch.as_tensor(parents, device=dev)]
    rel_joints = torch.cat([joints[:, :1], rel_joints[:, 1:]], 1)

    top = torch.cat([rot_mats, rel_joints[..., None]], -1)  # (B, J, 3, 4)
    bottom = torch.zeros(B, J, 1, 4, dtype=joints.dtype, device=dev)
    bottom[..., 0, 3] = 1.0
    local = torch.cat([top, bottom], -2)  # (B, J, 4, 4)

    g = local.clone()
    for level in _levels_from_parents(parents)[1:]:
        idx = torch.as_tensor(level, device=dev)
        pidx = torch.as_tensor([parents[j] for j in level], device=dev)
        g[:, idx] = torch.matmul(g[:, pidx], local[:, idx])

    posed_joints = g[..., :3, 3]
    # A = G - pack(G @ j): subtract the rest-joint-induced translation
    gj = (g[..., :3, :3] * joints[:, :, None, :]).sum(-1)
    rel = g.clone()
    rel[..., :3, 3] = g[..., :3, 3] - gj
    return posed_joints, rel


def lbs(
    betas: torch.Tensor,
    pose: torch.Tensor,
    v_template: torch.Tensor,
    shapedirs: torch.Tensor,
    posedirs: torch.Tensor,
    J_regressor: torch.Tensor,
    parents: np.ndarray,
    lbs_weights: torch.Tensor,
    pose2rot: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SMPL skinning (mirrors smplx/smplx/lbs.py:152-248).

    betas: (B, n_betas); pose: (B, J*3) axis-angle or (B, J, 3, 3) rotmats;
    v_template: (V, 3); shapedirs: (V, 3, n_betas); posedirs: (P, V*3) with
    P = 9*(J-1); J_regressor: (J, V); lbs_weights: (V, J).
    Returns (vertices (B, V, 3), joints (B, J, 3)).
    """
    B = betas.shape[0]
    J = J_regressor.shape[0]

    v_shaped = v_template[None] + blend_shapes(betas, shapedirs)
    j_rest = vertices2joints(J_regressor, v_shaped)

    if pose2rot:
        rot_mats = axisang_to_rot(pose.reshape(B, J, 3))
    else:
        rot_mats = pose.reshape(B, J, 3, 3)

    # pose blendshapes from the non-root rotations' deviation from identity
    eye = torch.eye(3, dtype=v_template.dtype, device=v_template.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)  # (B, 9*(J-1))
    v_posed = v_shaped + torch.matmul(pose_feature, posedirs).reshape(B, -1, 3)

    posed_joints, A = batch_rigid_transform(rot_mats, j_rest, parents)

    # skinning: per-vertex blended transform
    T = torch.matmul(lbs_weights, A.reshape(B, J, 16)).reshape(B, -1, 4, 4)
    v_hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    verts = (T[..., :3, :] * v_hom[:, :, None, :]).sum(-1)
    return verts, posed_joints
