"""Per-dataset offline processors -> the standard H5 schema (port of
posegen_tpu/data/loaders.py).

The reference's load_{surreal,h36m,perfcap,mixamo,zju,3dhp}.py offline
paths, rebuilt around two shared primitives:

  * `pose_block_from_bones`: FK + cylinders from axis-angle poses (the
    SURREAL / Mixamo / ZJU path: poses come with the dataset),
  * `data/spin.process_spin_data`: poses estimated by SPIN (the H36M /
    PerfCap / 3DHP path).

Each `process_*` function takes decoded arrays (images, masks, poses,
cameras); `data/ingest.py` walks the raw archives. The kinematics run in
float32 torch on `device`; the arrays written are numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from posegen_tpu_torch.data.spin import process_spin_data
from posegen_tpu_torch.data.writer import dilate_masks, write_pose_h5
from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws
from posegen_tpu_torch.skeleton.rotations import axisang_to_rot, rot_to_axisang
from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE

# SURREAL's fixed generation shape coefficients (reference load_surreal.py:113)
SURREAL_BETA = np.array(
    [-0.8010307, 0.6838105, 0.7480726, -1.1379223, -0.32415348,
     -0.8404733, -0.4795286, -0.63125765, -0.13453396, 1.4934114],
    dtype=np.float32,
)

# SURREAL -> NeRF root-bone rotation (reference load_surreal.py:103-111)
SURREAL_ROT_ROOTBONE = np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], dtype=np.float32
)

# SURREAL world -> NeRF world (reference load_surreal.py:108-111)
SURREAL_ROT_GLOB = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], dtype=np.float32
)

# the fixed skeleton-range normalization (reference load_surreal.py:18)
SURREAL_DATASET_EXT_SCALE = 0.25 / 0.00035


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as a broadcast sum: a float32 matmul may
    take TF32 on the card, the sum never does."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def pose_block_from_bones(
    bones: np.ndarray,
    rest_pose: Optional[np.ndarray] = None,
    pelvis: Optional[np.ndarray] = None,
    kp3d_override: Optional[np.ndarray] = None,
    scale: float = 1.0,
    ext_scale: float = 0.001,
    head: str = "-y",
    root_rot: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Axis-angle poses -> {kp3d, bones, skts, cyls, rest_pose}, the
    kinematics on `device`.

    root_rot: optional (3, 3) world rotation applied to the root bone (the
    SURREAL coordinate fix, load_surreal.py:103-111).
    kp3d_override: (N, J, 3) dataset-provided joint locations that REPLACE
    every l2w translation; FK contributes rotations only (the reference
    skt_from_smpl(kp_3d=...) path, skeleton_utils.py:323-332, used by the
    SURREAL processor whose metadata carries ground-truth joints3D).
    """
    dev = resolve_device(device)
    bones = np.asarray(bones, np.float32)
    with torch.no_grad():
        if root_rot is not None:
            rot = _mat3(torch.as_tensor(np.asarray(root_rot, np.float32), device=dev)[None],
                        axisang_to_rot(torch.as_tensor(bones[:, 0], device=dev)))
            bones = bones.copy()
            bones[:, 0] = rot_to_axisang(rot).cpu().numpy()

        rest = (rest_pose if rest_pose is not None else SMPL_REST_POSE).astype(np.float32)
        l2ws = smpl_l2ws(torch.as_tensor(bones, device=dev),
                         rest_pose=torch.as_tensor(rest, device=dev), scale=scale).cpu().numpy()
        if kp3d_override is not None:
            l2ws[:, :, :3, 3] = np.asarray(kp3d_override, np.float32)
        elif pelvis is not None:
            l2ws[:, :, :3, 3] += np.asarray(pelvis, np.float32)[:, None]
        kp3d = l2ws[:, :, :3, 3].copy()
        skts = invert_rigid(torch.as_tensor(l2ws, device=dev)).cpu().numpy().astype(np.float32)
        cyls = get_kp_bounding_cylinder(torch.as_tensor(kp3d, device=dev), ext_scale=ext_scale,
                                        head=head).cpu().numpy().astype(np.float32)
    return {
        "kp3d": kp3d.astype(np.float32),
        "bones": bones,
        "skts": skts,
        "cyls": cyls,
        "rest_pose": rest * scale,
    }


def _assemble(
    h5_path: str,
    imgs: np.ndarray,
    masks: np.ndarray,
    pose_block: Dict[str, np.ndarray],
    c2ws: np.ndarray,
    focals: np.ndarray,
    kp_idxs: Optional[np.ndarray] = None,
    cam_idxs: Optional[np.ndarray] = None,
    bkgds: Optional[np.ndarray] = None,
    bkgd_idxs: Optional[np.ndarray] = None,
    centers: Optional[np.ndarray] = None,
    ext_scale: float = 0.001,
    dilate_iters: int = 2,
) -> str:
    n = imgs.shape[0]
    data = {
        "imgs": imgs.astype(np.uint8),
        "masks": masks.astype(np.uint8),
        "sampling_masks": dilate_masks(masks.astype(np.uint8), iters=dilate_iters),
        "c2ws": np.asarray(c2ws, np.float32),
        "focals": np.asarray(focals, np.float32),
        "kp_idxs": np.arange(n) if kp_idxs is None else np.asarray(kp_idxs),
        "cam_idxs": np.arange(n) if cam_idxs is None else np.asarray(cam_idxs),
        "ext_scale": np.float32(ext_scale),
        **pose_block,
    }
    if bkgds is not None:
        data["bkgds"] = bkgds.astype(np.uint8)
        data["bkgd_idxs"] = (
            np.zeros(n, np.int64) if bkgd_idxs is None else np.asarray(bkgd_idxs)
        )
    if centers is not None:
        data["centers"] = np.asarray(centers, np.float32)
    return write_pose_h5(h5_path, data)


def process_surreal(
    h5_path: str,
    imgs: np.ndarray,  # (N, H, W, 3)
    masks: np.ndarray,  # (N, H, W, 1) person segmentation
    bones: np.ndarray,  # (N_kp, 24, 3) SMPL axis-angle
    joints3d: np.ndarray,  # (N_kp, 24, 3) SURREAL world joints
    c2ws: np.ndarray,  # (N, 4, 4) NeRF convention
    focals: np.ndarray,
    kp_idxs: np.ndarray,
    cam_idxs: np.ndarray,
    bkgds: Optional[np.ndarray] = None,
    bkgd_idxs: Optional[np.ndarray] = None,
    ext_scale: float = 0.001,
    device="cuda",
) -> str:
    """SURREAL (reference process_surreal_data, load_surreal.py:98-300):
    dataset-provided poses AND ground-truth joints3D (which replace the FK
    translations: skt_from_smpl(kp_3d=...)), world rotated by rot_glob,
    root-bone rotation fix, '-y' head axis."""
    full_scale = ext_scale * SURREAL_DATASET_EXT_SCALE
    kp3d = np.asarray(joints3d, np.float32) * full_scale @ SURREAL_ROT_GLOB.T
    block = pose_block_from_bones(
        bones,
        kp3d_override=kp3d,
        scale=full_scale,
        ext_scale=ext_scale,
        head="-y",
        root_rot=SURREAL_ROT_ROOTBONE,
        device=device,
    )
    return _assemble(
        h5_path, imgs, masks, block, c2ws, focals, kp_idxs, cam_idxs,
        bkgds=bkgds, bkgd_idxs=bkgd_idxs, ext_scale=full_scale,
    )


def process_spin_estimated(
    h5_path: str,
    imgs: np.ndarray,
    masks: np.ndarray,
    betas: np.ndarray,
    cameras: np.ndarray,  # (N, 3) SPIN weak-perspective
    joints: np.ndarray,  # (N, J>=9, 3) SPIN joints
    rot_mats: np.ndarray,  # (N, 24, 3, 3)
    bboxes: np.ndarray,  # (N, 3) [cx, cy, h]
    bkgds: Optional[np.ndarray] = None,
    bkgd_idxs: Optional[np.ndarray] = None,
    res=512,
    ext_scale: float = 0.001,
    smpl_model=None,
    kp_idxs: Optional[np.ndarray] = None,
    cam_idxs: Optional[np.ndarray] = None,
    gt_kp3d: Optional[np.ndarray] = None,
    dilate_iters: int = 2,
    device="cuda",
) -> str:
    """H36M / PerfCap / Mixamo / 3DHP: poses from SPIN estimates
    (reference process_h36m_data load_h36m.py:114-250, load_perfcap.py,
    load_mixamo.py, load_3dhp.py:81; all feed read_spin_data ->
    process_spin_data)."""
    spin = process_spin_data(
        betas, cameras, joints, rot_mats, bboxes,
        res=res, ext_scale=ext_scale, smpl_model=smpl_model, device=device,
    )
    block = {
        k: spin[k] for k in ("kp3d", "bones", "skts", "cyls", "rest_pose")
    }
    if gt_kp3d is not None:
        block["gt_kp3d"] = np.asarray(gt_kp3d, np.float32)
    return _assemble(
        h5_path, imgs, masks, block, spin["c2ws"], spin["focals"],
        kp_idxs=kp_idxs, cam_idxs=cam_idxs,
        bkgds=bkgds, bkgd_idxs=bkgd_idxs, ext_scale=float(spin["ext_scale"]),
        dilate_iters=dilate_iters,
    )


def process_mixamo(
    h5_path: str,
    imgs: np.ndarray,
    masks: np.ndarray,
    bones: np.ndarray,
    pelvis: np.ndarray,
    c2ws: np.ndarray,
    focals: np.ndarray,
    rest_pose: Optional[np.ndarray] = None,
    ext_scale: float = 0.001,
    device="cuda",
) -> str:
    """Mixamo (reference load_mixamo.py:161): animation-provided SMPL poses,
    white background renders."""
    block = pose_block_from_bones(
        bones, rest_pose=rest_pose, pelvis=pelvis, ext_scale=ext_scale, device=device
    )
    return _assemble(h5_path, imgs, masks, block, c2ws, focals, ext_scale=ext_scale)


def process_zju(
    h5_path: str,
    imgs: np.ndarray,
    masks: np.ndarray,
    smpl_poses: np.ndarray,  # (N_kp, 72) ZJU SMPL params
    smpl_transl: np.ndarray,  # (N_kp, 3)
    c2ws: np.ndarray,
    focals: np.ndarray,
    centers: Optional[np.ndarray] = None,
    kp_idxs: Optional[np.ndarray] = None,
    cam_idxs: Optional[np.ndarray] = None,
    rest_pose: Optional[np.ndarray] = None,
    ext_scale: float = 0.001,
    device="cuda",
) -> str:
    """ZJU-MoCap (reference load_zju.py:70-130 get_smpls + ZJUMocapDataset):
    SMPL params provided per frame, multi-camera."""
    bones = np.asarray(smpl_poses, np.float32).reshape(-1, 24, 3)
    block = pose_block_from_bones(
        bones, rest_pose=rest_pose, pelvis=smpl_transl, ext_scale=ext_scale, device=device
    )
    return _assemble(
        h5_path, imgs, masks, block, c2ws, focals,
        kp_idxs=kp_idxs, cam_idxs=cam_idxs, centers=centers, ext_scale=ext_scale,
    )
