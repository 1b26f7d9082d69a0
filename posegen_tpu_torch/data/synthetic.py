"""Synthetic dataset builder (port of posegen_tpu/data/synthetic.py) — a
tiny self-contained SURREAL stand-in.

Generates posed SMPL skeletons on a camera ring and rasterizes per-joint
gaussian blobs as "images" (plus exact masks), then writes the standard H5
schema. The look-at camera is also what the bullet-time renders
(`render.image._bullet_c2ws`) build on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from posegen_tpu_torch.data.writer import dilate_masks, write_pose_h5
from posegen_tpu_torch.skeleton.cameras import nerf_c2w_to_extrinsic, world_to_cam
from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws
from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE


def _look_at_c2w(origin: np.ndarray, target: np.ndarray) -> np.ndarray:
    """NeRF-convention camera-to-world looking from origin at target."""
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    # NeRF convention: x right, y up, z backward
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, origin
    return c2w


def make_synthetic_h5(
    path: str,
    n_images: int = 8,
    H: int = 64,
    W: int = 64,
    n_poses: Optional[int] = None,
    focal: float = 80.0,
    seed: int = 0,
    cam_dist: float = 2.5,
) -> str:
    """Write a synthetic dataset of n_images H x W views -> path. The
    kinematics run in float32 on the host."""
    rng = np.random.default_rng(seed)
    n_poses = n_poses or n_images
    bones = (rng.standard_normal((n_poses, 24, 3)) * 0.15).astype(np.float32)
    with torch.no_grad():
        l2ws_t = smpl_l2ws(torch.from_numpy(bones), scale=0.4)
        kp3d = l2ws_t[..., :3, 3].numpy()
        skts = invert_rigid(l2ws_t).numpy()
        cyls = get_kp_bounding_cylinder(l2ws_t[..., :3, 3], ext_scale=0.001).numpy()

    thetas = np.linspace(0, 2 * np.pi, n_images, endpoint=False)
    c2ws = np.stack(
        [
            _look_at_c2w(
                np.array([cam_dist * np.cos(t), 0.3, cam_dist * np.sin(t)], np.float32),
                kp3d[i % n_poses, 0],
            )
            for i, t in enumerate(thetas)
        ]
    )

    imgs = np.zeros((n_images, H, W, 3), np.uint8)
    masks = np.zeros((n_images, H, W, 1), np.uint8)
    colors = (rng.uniform(0.3, 1.0, (24, 3)) * 255).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    # blob radius scales with resolution (2.5 px at the 64^2 default): at
    # fixed pixels a 256^2 scene degenerates to tiny dots on black
    sigma = 2.5 * H / 64.0
    for i in range(n_images):
        kp = kp3d[i % n_poses]
        ext = nerf_c2w_to_extrinsic(c2ws[i])
        pix = world_to_cam(kp, ext, H, W, focal)
        img = np.zeros((H, W, 3), np.float32)
        m = np.zeros((H, W), np.float32)
        for j in range(24):
            d2 = (yy - pix[j, 1]) ** 2 + (xx - pix[j, 0]) ** 2
            blob = np.exp(-d2 / (2 * sigma**2))
            img += blob[..., None] * colors[j]
            m = np.maximum(m, blob)
        imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        masks[i, ..., 0] = (m > 0.05).astype(np.uint8)

    data = {
        "imgs": imgs,
        "masks": masks,
        "sampling_masks": dilate_masks(masks),
        "kp3d": kp3d.astype(np.float32),
        "bones": bones,
        "skts": skts.astype(np.float32),
        "cyls": cyls.astype(np.float32),
        "rest_pose": (SMPL_REST_POSE * 0.4).astype(np.float32),
        "c2ws": c2ws.astype(np.float32),
        "focals": np.full((n_images,), focal, np.float32),
        "kp_idxs": np.arange(n_images) % n_poses,
        "cam_idxs": np.arange(n_images),
        "bkgd_idxs": np.zeros(n_images, np.int64),
        "bkgds": np.zeros((1, H, W, 3), np.uint8),
        "ext_scale": np.float32(0.001),
    }
    return write_pose_h5(path, data)
