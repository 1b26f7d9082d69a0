"""Camera conventions and ray generation (port of
posegen_tpu/skeleton/cameras.py).

NeRF-style c2w with camera axes [right, up, backward]; extrinsics in the
OpenCV convention [right, down, forward] (reference
core/utils/skeleton_utils.py:529-537, 1401-1454 and
core/utils/ray_utils.py:6-61). `swap_mat`, the c2w / extrinsic conversions
and `ndc_rays` take torch tensors or numpy arrays and return the same kind;
`world_to_cam`, `get_rays_np` and the rotation builders are host numpy, as
in the JAX package; `get_rays` runs on the device of its c2w.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.skeleton.geometry import focal_to_intrinsic


def swap_mat(mat):
    """Flip the y/z camera axes: NeRF c2w <-> OpenCV-style pose.

    Equivalent to right-multiplying by diag(1, -1, -1, 1)
    (reference skeleton_utils.py:1401-1410).
    """
    if isinstance(mat, torch.Tensor):
        return torch.cat([mat[..., 0:1], -mat[..., 1:2], -mat[..., 2:3], mat[..., 3:]], dim=-1)
    return np.concatenate([mat[..., 0:1], -mat[..., 1:2], -mat[..., 2:3], mat[..., 3:]], axis=-1)


def _inv(mat):
    return torch.linalg.inv(mat) if isinstance(mat, torch.Tensor) else np.linalg.inv(mat)


def nerf_c2w_to_extrinsic(c2w):
    """NeRF camera-to-world -> OpenCV world-to-camera (reference :529)."""
    return _inv(swap_mat(c2w))


def nerf_extrinsic_to_c2w(ext):
    """OpenCV world-to-camera -> NeRF camera-to-world (reference :535)."""
    return swap_mat(_inv(ext))


def world_to_cam(pts: np.ndarray, extrinsic: np.ndarray, H, W, focal,
                 center=None) -> np.ndarray:
    """Project world points to pixel coordinates
    (reference skeleton_utils.py:1435-1453). Host-side (numpy)."""
    if center is None:
        off_x, off_y = W * 0.5, H * 0.5
    else:
        off_x, off_y = center
    if pts.shape[-1] < 4:
        pts = np.concatenate([pts, np.ones((*pts.shape[:-1], 1), pts.dtype)], -1)
    intrinsic = focal_to_intrinsic(focal)
    cam = pts @ extrinsic.T @ intrinsic.T
    xy = cam[..., :2] / cam[..., 2:3]
    xy = np.where(np.isinf(xy), 0.0, xy)
    xy[..., 0] += off_x
    xy[..., 1] += off_y
    return xy


def get_rays(
    H: int,
    W: int,
    focal,
    c2w: torch.Tensor,
    center: Optional[Tuple[float, float]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole rays for a full image (reference ray_utils.py:6-28), made on
    c2w's device.

    Returns (rays_o, rays_d), each (H, W, 3). Directions are *not* normalised
    (lengths encode pixel footprint; the compositor multiplies by |d|).
    """
    dev = c2w.device
    f = np.reshape(np.asarray(focal, np.float32), (-1,))
    focal_x = float(f[0])
    focal_y = float(f[1]) if f.size > 1 else focal_x
    if center is None:
        off_x, off_y = W * 0.5, H * 0.5
    else:
        off_x, off_y = center
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # image y grows downward; the NeRF camera frame has +y up and -z forward
    dirs = torch.stack([(i - off_x) / focal_x, -(j - off_y) / focal_y, -torch.ones_like(i)],
                       dim=-1)
    # broadcast-sum, not a 3x3 matmul: a float32 matmul may take TF32 on the
    # card (torch.backends.cuda.matmul.allow_tf32); the sum never does
    c2w = c2w.float()
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_rays_np(H, W, focal, c2w, center=None):
    """Host-side numpy version (reference ray_utils.py:31-61)."""
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32), indexing="xy"
    )
    f = np.reshape(np.asarray(focal, dtype=np.float32), (-1,))
    focal_x = f[0]
    focal_y = f[1] if f.size > 1 else f[0]
    if center is None:
        off_x, off_y = W * 0.5, H * 0.5
    else:
        off_x, off_y = center
    dirs = np.stack(
        [(i - off_x) / focal_x, -(j - off_y) / focal_y, -np.ones_like(i)], axis=-1
    )
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape)
    return rays_o, rays_d


def rotate_x(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    return np.array(
        [[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def rotate_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def rotate_z(psi: float) -> np.ndarray:
    c, s = np.cos(psi), np.sin(psi)
    return np.array(
        [[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
    )


def translate(tx: float, ty: float, tz: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [tx, ty, tz]
    return m


def ndc_rays(H, W, focal, near, rays_o, rays_d):
    """Shift rays to normalized device coordinates
    (reference ray_utils.py:64-81; forward-facing scenes, unused by the
    human pipelines but part of the ray toolbox)."""
    stack = torch.stack if isinstance(rays_o, torch.Tensor) else np.stack
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = (
        -1.0 / (W / (2.0 * focal))
        * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    )
    d1 = (
        -1.0 / (H / (2.0 * focal))
        * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    )
    d2 = -2.0 * near / rays_o[..., 2]
    return stack([o0, o1, o2], -1), stack([d0, d1, d2], -1)
