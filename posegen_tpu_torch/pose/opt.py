"""Learnable per-frame pose refinement (port of posegen_tpu/pose/opt.py).

The pose "layer" is a params dict {'pelvis': (F, 3), 'bones': (F, J, D)} of
float32 leaf tensors that require grad, plus `pose_apply`, which gathers the
rows of a batch of frame indices and runs level-parallel FK. Gradients flow
from the photometric loss through the encodings and FK into these params;
the train step's pose optimizer (train/trainer.py) updates them.

Multiview sharing (reference pose_opt.py:290-295): `kp_map` maps a dataset
frame to its shared pose row, so several cameras optimize one pose; the
pelvis and the root bone stay per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.kinematics import pose_to_kinematic
from posegen_tpu_torch.skeleton.rotations import (
    axisang_to_rot, rot6d_to_rot, rot_to_axisang, rot_to_rot6d,
)
from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton


@dataclasses.dataclass(frozen=True)
class PoseOptConfig:
    """Static pose-optimization settings (reference run_nerf.py opt_* flags)."""

    use_rot6d: bool = True
    opt_pelvis: bool = True
    depth: int = 0  # optimize only joints up to this tree depth (0 = all)
    opt_pose_tol: float = 0.0  # hinge tolerance on the anchor loss
    # parsed for config parity; the reference train loop never reads it
    # (see get_kp_reg_loss)
    opt_pose_type: str = "B"
    ext_scale: float = 0.001  # for the MPJPC stat (reference --ext_scale)


def init_pose_params(
    cfg: PoseOptConfig,
    bones: np.ndarray,
    kp3d: np.ndarray,
    skel: Skeleton = SMPL_SKELETON,
    kp_map: Optional[np.ndarray] = None,
    kp_uidxs: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, anchors) from estimated poses, on `device`.

    bones: (F, J, 3) axis-angle estimates; kp3d: (F, J, 3) world joints (the
    pelvis param is kp3d[:, root], reference create_popt pose_opt.py:14-83).
    Multiview (kp_map / kp_uidxs given, reference init_kp_params
    pose_opt.py:277-296): the pelvis and the root bone keep F rows, the
    non-root bones one (U, J - 1, D) table indexed by kp_map[frame].
    The params are float32 leaves that require grad; the anchors are
    detached copies for the regularizer.
    """
    dev = resolve_device(device)
    pelvis = torch.as_tensor(np.asarray(kp3d)[:, skel.root_id].astype(np.float32))
    b = torch.as_tensor(np.asarray(bones, dtype=np.float32))
    if cfg.use_rot6d:
        b = rot_to_rot6d(axisang_to_rot(b))
    if kp_map is not None:
        uidx = torch.as_tensor(np.asarray(kp_uidxs), dtype=torch.long)
        params = {"pelvis": pelvis, "root_bones": b[:, skel.root_id],
                  "bones": b[uidx, skel.root_id + 1:]}
    else:
        params = {"pelvis": pelvis, "bones": b}
    anchors = {k: v.to(dev).clone() for k, v in params.items()}
    params = {k: v.to(dev).clone().requires_grad_(True) for k, v in params.items()}
    return params, anchors


def gather_pose_rows(params: Dict[str, torch.Tensor], idx: torch.Tensor,
                     kp_map: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pelvis (B, 3), bones (B, J, D)) for frame indices, the multiview
    layout resolved (reference idx_to_params, pose_opt.py:322-333)."""
    idx = idx.reshape(-1).long()
    pelvis = params["pelvis"].index_select(0, idx)
    if "root_bones" in params:
        if kp_map is None:
            raise ValueError("multiview pose params need kp_map")
        rb = params["root_bones"].index_select(0, idx)[:, None]
        other = params["bones"].index_select(0, kp_map.long().index_select(0, idx))
        return pelvis, torch.cat([rb, other], dim=1)
    return pelvis, params["bones"].index_select(0, idx)


def pose_apply(params: Dict[str, torch.Tensor], idx: torch.Tensor, rest_pose: torch.Tensor,
               skel: Skeleton = SMPL_SKELETON, kp_map: Optional[torch.Tensor] = None):
    """Gather the pose rows of frame indices idx (B,) and run FK ->
    (kps (B, J, 3), bones, skts, l2ws)."""
    pelvis, bones = gather_pose_rows(params, idx, kp_map)
    kps, skts, l2ws, _ = pose_to_kinematic(bones, pelvis, rest_pose, skel)
    return kps, bones, skts, l2ws


def _canon_bones(bones: torch.Tensor) -> torch.Tensor:
    """Bone params -> what the reference losses compare: rot6d params
    orthonormalized through the rotation matrix and re-extracted
    (trainer.py:391-396); axis-angle params raw."""
    if bones.shape[-1] == 6:
        return rot_to_rot6d(rot6d_to_rot(bones))
    return bones


def kp_reg_loss(cfg: PoseOptConfig, params: Dict[str, torch.Tensor],
                anchors: Dict[str, torch.Tensor], idx: torch.Tensor,
                kp_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pose regularizer the reference train loop runs
    (trainer._compute_kp_loss, core/trainer.py:385-408): squared difference
    of canonical bones against the anchors, the root joint excluded, hinged
    at opt_pose_tol, summed over the last axis and averaged. Unscaled: the
    caller multiplies by opt_pose_coef."""
    _, b = gather_pose_rows(params, idx, kp_map)
    _, b0 = gather_pose_rows(anchors, idx, kp_map)
    kp_loss = ((b0 - _canon_bones(b)) ** 2)[:, 1:]
    kp_loss = torch.clamp(kp_loss - cfg.opt_pose_tol, min=0.0)
    return kp_loss.sum(-1).mean()


def mpjpc_stat(cfg: PoseOptConfig, kps: torch.Tensor, anchor_kps: torch.Tensor) -> torch.Tensor:
    """Mean per-joint change against the anchor estimate
    (reference trainer.py:438-440)."""
    return torch.linalg.norm(kps.detach() - anchor_kps, dim=-1).mean() / cfg.ext_scale


def temporal_loss(params: Dict[str, torch.Tensor], idx: torch.Tensor, temp_val: torch.Tensor,
                  rest_pose: torch.Tensor, kps: torch.Tensor, bones: torch.Tensor,
                  skel: Skeleton = SMPL_SKELETON,
                  kp_map: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Second-difference smoothness penalty on bones and FK joints, the
    neighbour frames (wrapping around, like torch's negative indexing in
    reference trainer.py:413) evaluated through the pose layer and detached,
    masked by per-frame temporal validity (reference trainer.py:410-436).
    kps / bones: the batch's FK joints and canonical bones (with gradient).
    Unscaled: the caller multiplies by temp_coef."""
    n = params["pelvis"].shape[0]  # frames (the bones table is U rows when multiview)
    idx = idx.reshape(-1).long()
    with torch.no_grad():
        pk, pb, _, _ = pose_apply(params, (idx - 1) % n, rest_pose, skel, kp_map)
        nk, nb, _, _ = pose_apply(params, (idx + 1) % n, rest_pose, skel, kp_map)
        pb, nb = _canon_bones(pb), _canon_bones(nb)
    ang_vel = (((bones - pb) - (nb - bones)) ** 2).sum(-1)
    joint_vel = (((kps - pk) - (nk - kps)) ** 2).sum(-1)
    return ((ang_vel + joint_vel) * temp_val[..., None]).mean()


def get_kp_reg_loss(
    preds: Dict[str, torch.Tensor],
    regs: Dict[str, torch.Tensor],
    gts: Optional[Dict[str, torch.Tensor]] = None,
    opt_pose_coefs: float = 1.0,
    opt_pose_type: str = "B",
    opt_rot6d: bool = False,
    opt_pose_tol: float = 0.0,
    use_temp_loss: bool = False,
    use_temp_vel: bool = False,
    temp_coef: float = 0.05,
    ext_scale: float = 0.001,
    root_id: int = 0,
):
    """The opt_pose_type objective family of reference core/pose_opt.py:
    124-201. Nothing in the reference calls it (its train loop runs
    `kp_reg_loss`); it is kept as a library component, as in the JAX
    package. Types B / BE / RD / RDE, with 'L1' anywhere in the name for an
    L1 distance; 'E' drops the global terms (root bone and pelvis).

    preds: current {'kps', 'bones', 'rots'}; regs: the anchors of the same,
    plus 'temp_kps' / 'temp_bones' / 'temp_rots' stacked [prev; next] and
    'temp_valid' / 'temp_valid_next' when use_temp_loss.
    -> (kp_loss, temp_loss, mpjpc, kp_gt_dist or None)."""
    kps, bones, rots = preds["kps"], preds["bones"], preds["rots"]
    reg_kps, reg_bones, reg_rots = regs["kps"], regs["bones"], regs["rots"]
    kp_sqr_diff = ((reg_kps - kps) ** 2).sum(-1)

    if "L1" in opt_pose_type:
        def loss_fn(a, b):
            return (a - b).abs()
    else:
        def loss_fn(a, b):
            return (a - b) ** 2
    coef_on_global = "E" not in opt_pose_type

    if opt_rot6d:
        reg_bones = reg_rots[..., :3, :2].reshape(*reg_rots.shape[:-2], 6)
    if opt_pose_type.startswith("RD"):
        bone_loss = loss_fn(rots, reg_rots)
    elif opt_pose_type.startswith("B"):
        bone_loss = loss_fn(reg_bones, bones)
    else:
        raise NotImplementedError("Regularization target un-specified")
    pelv_loss = loss_fn(reg_kps[:, root_id], kps[:, root_id]).sum(-1)

    # hinge: zero inside the tolerance band, (loss - tol) outside
    mask = (bone_loss > opt_pose_tol).to(bone_loss.dtype)
    bone_loss = (mask * (bone_loss - opt_pose_tol)).sum(-1)
    if coef_on_global:
        kp_loss = (bone_loss.mean() + pelv_loss.mean()) * opt_pose_coefs
    else:
        kp_loss = bone_loss[:, root_id + 1:].mean() * opt_pose_coefs

    temp_loss = kp_loss.new_zeros(())
    if use_temp_loss:
        nb = bones.shape[0]
        temp_valid = regs["temp_valid"]
        if opt_rot6d:
            tr = regs["temp_rots"]
            temp_bones = tr[..., :3, :2].reshape(*tr.shape[:-2], 6)
        else:
            temp_bones = regs["temp_bones"]
        if temp_bones.shape[0] != 2 * nb:
            raise ValueError(f"temp_bones has {temp_bones.shape[0]} rows, not 2 x {nb}")
        prev_bones, next_bones = temp_bones.split(nb, 0)
        prev_kps, next_kps = regs["temp_kps"].split(nb, 0)
        if not use_temp_vel:
            temp_loss = loss_fn(prev_bones, bones).sum(-1)
            temp_loss = (temp_loss * temp_valid[..., None]).mean() * temp_coef
        else:
            # both the previous and the next pose need to be valid
            temp_valid = (regs["temp_valid_next"] + temp_valid) // 2
            ang_vel = (((bones - prev_bones) - (next_bones - bones)) ** 2).sum(-1)
            joint_vel = (((kps - prev_kps) - (next_kps - kps)) ** 2).sum(-1)
            temp_loss = ((ang_vel + joint_vel) * temp_valid[..., None]).mean() * temp_coef
        kp_loss = kp_loss + temp_loss

    mpjpc = torch.sqrt(kp_sqr_diff.detach()).mean() / ext_scale
    kp_gt_dist = None
    if gts is not None:
        kp_gt_dist = torch.linalg.norm(kps.detach() - gts["kps"], dim=-1).mean() / ext_scale
    return kp_loss, temp_loss, mpjpc, kp_gt_dist


def pose_params_to_pose_data(params: Dict[str, torch.Tensor], rest_pose: torch.Tensor,
                             skel: Skeleton = SMPL_SKELETON,
                             kp_map: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """Refined poses for the data layer (reference pose_ckpt_to_pose_data,
    pose_opt.py:523-581): kp3d, axis-angle bones, skts and l2ws per frame,
    the multiview params expanded back to frame rows through kp_map."""
    with torch.no_grad():
        n = params["pelvis"].shape[0]
        idx = torch.arange(n, device=params["pelvis"].device)
        _, bones = gather_pose_rows(params, idx, kp_map)
        kps, skts, l2ws, _ = pose_to_kinematic(bones, params["pelvis"], rest_pose, skel)
        if bones.shape[-1] == 6:
            bones = rot_to_axisang(rot6d_to_rot(bones))
    return {"kp3d": kps.cpu().numpy(), "bones": bones.cpu().numpy(),
            "skts": skts.cpu().numpy(), "l2ws": l2ws.cpu().numpy()}
