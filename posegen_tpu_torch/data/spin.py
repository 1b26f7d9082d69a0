"""SPIN/HMR estimate -> NeRF training data conversion (port of
posegen_tpu/data/spin.py).

Turns per-image SPIN outputs (betas, weak-perspective cams, rotation
matrices, crop bboxes) into world keypoints, axis-angle bones, w2l
transforms, bounding cylinders, NeRF-convention cameras and per-image
focals: the H5 schema's pose block (reference core/process_spin.py:46-232).

The camera maths is float64 numpy, as in the JAX package. The kinematics
(rotations, FK, the rigid inverses, the cylinders) run in float32 torch on
the caller's `device`; the SMPL rest pose runs on the model's device. Every
function returns numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.cameras import swap_mat
from posegen_tpu_torch.skeleton.geometry import bone_lengths, get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws_from_rots
from posegen_tpu_torch.skeleton.rotations import rot_to_axisang
from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE, SMPL_SKELETON


def convert_crop_cam_to_orig_img_and_focal(
    cam: np.ndarray,
    bbox: np.ndarray,
    img_width: float,
    img_height: float,
    focal: float = 5000.0,
    resized_width: float = 224.0,
    new_focal: Optional[float] = None,
) -> np.ndarray:
    """Weak-perspective crop camera -> original-image camera + focal
    (reference process_spin.py:46-96, VIBE-style).

    cam: (N, 3) [s, tx, ty]; bbox: (N, 3+) [cx, cy, h].
    Returns (N, 4) [focal, tx, ty, cz] float32.
    """
    cam = np.asarray(cam, np.float64)
    bbox = np.asarray(bbox, np.float64)
    s = cam[:, 0]
    cz = 2.0 * focal / (resized_width * s)
    cx, cy, h = bbox[:, 0], bbox[:, 1], bbox[:, 2]
    hw, hh = img_width / 2.0, img_height / 2.0

    f = h / resized_width * focal
    sx = s * (h / img_width)
    sy = s * (h / img_height)
    tx = (cx - hw) / hw / sx + cam[:, 1]
    ty = (cy - hh) / hh / sy + cam[:, 2]

    if new_focal is not None:
        cz = cz * new_focal / f
        f = np.full_like(f, new_focal)
    return np.stack([f, tx, ty, cz], axis=-1).astype(np.float32)


def rest_pose_from_betas(betas: np.ndarray, smpl_model=None) -> np.ndarray:
    """Mean rest-pose joints over the sequence's betas (reference
    get_keypoints_from_betas, process_spin.py:97-127), through the SMPL
    model on its own device; SMPL_REST_POSE without a model."""
    if smpl_model is None:
        return SMPL_REST_POSE.copy()
    dev = smpl_model.v_template.device
    with torch.no_grad():
        b = torch.as_tensor(np.asarray(betas, np.float32), device=dev)
        out = smpl_model(betas=b, body_pose=b.new_zeros(len(b), (smpl_model.n_joints - 1) * 3))
    rest = out["joints"].cpu().numpy()
    rest = rest - rest[:, :1]
    return rest.mean(0).astype(np.float32)


def keypoints_from_spin(
    joints: np.ndarray,
    rot_mats: np.ndarray,
    rest_pose: np.ndarray,
    ext_scale: float = 1.0,
    align_joint_idx: int = 8,
    ref_pose: np.ndarray = SMPL_REST_POSE,
    scale_rest_pose: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """SPIN joints + rotmats -> (kp3d, bones, skts, scaled rest_pose, scale)
    (reference process_spin.py:128-156); the rotations and FK on `device`."""
    dev = resolve_device(device)
    if scale_rest_pose:
        ref = ref_pose * ext_scale
        pose_scale = float(
            bone_lengths(ref).mean() / max(bone_lengths(rest_pose).mean(), 1e-9)
        )
    else:
        pose_scale = 1.0
    rest_pose = rest_pose * pose_scale

    with torch.no_grad():
        rots = torch.as_tensor(np.asarray(rot_mats, np.float32), device=dev)
        bones = rot_to_axisang(rots).cpu().numpy().astype(np.float32)
        l2ws = smpl_l2ws_from_rots(
            rots, rest_pose=torch.as_tensor(np.asarray(rest_pose, np.float32), device=dev)
        ).cpu().numpy()
        pelvis = np.asarray(joints)[:, align_joint_idx] * pose_scale
        l2ws[:, :, :3, 3] += pelvis[:, None]
        kp3d = l2ws[:, :, :3, 3].copy().astype(np.float32)
        skts = invert_rigid(torch.as_tensor(l2ws, device=dev)).cpu().numpy().astype(np.float32)
    return kp3d, bones, skts, rest_pose.astype(np.float32), pose_scale


def pred_cams_to_orig_cam_params(
    cameras: np.ndarray,
    bboxes: np.ndarray,
    img_width: float = 512,
    img_height: float = 512,
    resized_width: float = 224,
    focal: float = 5000.0,
    ext_scale: float = 1.0,
    new_focal: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (focals (N,), c2ws (N, 4, 4)) in NeRF convention
    (reference process_spin.py:157-181)."""
    orig = convert_crop_cam_to_orig_img_and_focal(
        cameras, bboxes, img_width, img_height,
        focal=focal, resized_width=resized_width, new_focal=new_focal,
    )
    focals = orig[:, 0]
    trans = orig[:, 1:] * ext_scale
    c2ws = np.broadcast_to(np.eye(4, dtype=np.float32), (len(orig), 4, 4)).copy()
    c2ws[:, :3, 3] = -trans
    return focals.astype(np.float32), swap_mat(c2ws).astype(np.float32)


def process_spin_data(
    betas: np.ndarray,
    cameras: np.ndarray,
    joints: np.ndarray,
    rot_mats: np.ndarray,
    bboxes: np.ndarray,
    rest_pose: Optional[np.ndarray] = None,
    smpl_model=None,
    align_joint_idx: int = 8,
    focal: float = 5000.0,
    res=512,
    resized_res: float = 224,
    ext_scale: float = 0.001,
    dataset_ext_scale: float = 0.25 / 0.00035,
    new_focal: Optional[float] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Full pipeline (reference process_spin_data, process_spin.py:182-232);
    the kinematics on `device`."""
    dev = resolve_device(device)
    res_h, res_w = (res, res) if isinstance(res, (int, float)) else res
    ext_scale = ext_scale * dataset_ext_scale

    if rest_pose is None:
        rest_pose = rest_pose_from_betas(betas, smpl_model)
    kp3d, bones, skts, rest_pose, pose_scale = keypoints_from_spin(
        joints, rot_mats, rest_pose, ext_scale, align_joint_idx, device=dev
    )
    with torch.no_grad():
        cyls = get_kp_bounding_cylinder(
            torch.as_tensor(kp3d, device=dev), skel=SMPL_SKELETON,
            ext_scale=ext_scale / dataset_ext_scale, extend_mm=250, head="-y",
        ).cpu().numpy().astype(np.float32)
    focals, c2ws = pred_cams_to_orig_cam_params(
        cameras, bboxes, img_width=res_w, img_height=res_h,
        resized_width=resized_res, focal=focal,
        ext_scale=pose_scale, new_focal=new_focal,
    )
    return {
        "kp3d": kp3d, "bones": bones, "cyls": cyls, "skts": skts,
        "rest_pose": rest_pose, "ext_scale": np.float32(ext_scale),
        "c2ws": c2ws, "focals": focals, "pose_scale": np.float32(pose_scale),
    }
