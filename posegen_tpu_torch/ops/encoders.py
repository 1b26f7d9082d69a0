"""Skeleton-relative input encoders (port of posegen_tpu/ops/encoders.py:27-170).

Shapes:
  pts:   (N_rays, N_samples, 3)      world-space query points
  skts:  (N_rays, N_joints, 4, 4)    world-to-local per joint
  kps:   (N_rays, N_joints, 3)       posed joint locations
  bones: (N_rays, N_joints, 3)       axis-angle joint rotations
  rays_d:(N_rays, 3)                 ray directions
"""

from __future__ import annotations

from typing import Optional

import torch

from posegen_tpu_torch.skeleton.geometry import calculate_angle


def transform_batch_pts(pts: torch.Tensor, skts: torch.Tensor) -> torch.Tensor:
    """World points -> per-joint local coordinates: (N, S, 3), (N, J, 4, 4)
    -> (N, S, J, 3)."""
    R = skts[..., :3, :3]
    t = skts[..., :3, 3]
    return torch.einsum("njab,nsb->nsja", R, pts) + t[:, None]


def transform_batch_rays(rays_d: torch.Tensor, skts: torch.Tensor) -> torch.Tensor:
    """Ray directions rotated into each joint frame: (N, 3) -> (N, 1, J, 3)."""
    return torch.einsum("njab,nb->nja", skts[..., :3, :3], rays_d)[:, None]


def reldist_encode(pts, pts_t: Optional[torch.Tensor], kps) -> torch.Tensor:
    """Per-joint distances (N, S, J) — the paper's `v` encoding."""
    if pts_t is not None:
        return torch.linalg.norm(pts_t, dim=-1)
    return torch.linalg.norm(pts[:, :, None] - kps[:, None], dim=-1)


def relpos_encode(pts, pts_t: Optional[torch.Tensor], kps) -> torch.Tensor:
    """Per-joint offsets flattened (N, S, J*3)."""
    if pts_t is not None:
        return pts_t.reshape(*pts_t.shape[:-2], -1)
    rel = pts[:, :, None] - kps[:, None]
    return rel.reshape(*rel.shape[:-2], -1)


def kpcat_encode(pts, pts_t, kps) -> torch.Tensor:
    """Concat world point with all keypoints (N, S, 3 + J*3)."""
    N, S = pts.shape[:2]
    kps_flat = kps.reshape(N, 1, -1).expand(N, S, -1)
    return torch.cat([pts, kps_flat], dim=-1)


def vecnorm_encode(vecs: torch.Tensor, refs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L2-normalise trailing 3-vectors and flatten joints: (..., J, 3) -> (..., J*3);
    with `refs` (N, S, ...), broadcast the (N, 1, J*3) result over S."""
    n = vecs / torch.clamp(torch.linalg.norm(vecs, dim=-1, keepdim=True), min=1e-12)
    n = n.reshape(*n.shape[:2], -1)
    if refs is not None:
        n = n.expand(*refs.shape[:2], n.shape[-1])
    return n


def rayang_encode(rays_t: torch.Tensor, pts_t: torch.Tensor) -> torch.Tensor:
    """Angle between local ray dir and local point dir, per joint (N, S, J)."""
    return calculate_angle(pts_t, rays_t)


def identity_expand_encode(inputs: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
    """Tile per-ray features across samples: (N, ...) -> (N, S, -1)."""
    N, S = refs.shape[:2]
    return inputs.reshape(N, 1, -1).expand(N, S, -1)


# dispatch tables mirroring the reference flag values
# (reference raycasters.py:251-305)

def kp_encoder_dims(kp_dist_type: str, n_joints: int) -> tuple[int, int]:
    """(input_dims, cutoff_dims) for a kp encoder flag value."""
    if kp_dist_type == "reldist":
        return n_joints, n_joints
    if kp_dist_type == "relpos":
        return n_joints * 3, n_joints
    if kp_dist_type == "cat":
        return n_joints * 3 + 3, n_joints
    if kp_dist_type == "querypts":
        return 3, 3
    raise NotImplementedError(f"kp_dist_type {kp_dist_type!r}")


def view_encoder_dims(view_type: str, n_joints: int) -> int:
    if view_type in ("relray", "world"):
        return n_joints * 3
    if view_type == "rayangle":
        return n_joints
    raise NotImplementedError(f"view_type {view_type!r}")


def bone_encoder_dims(bone_type: str, n_joints: int) -> int:
    if bone_type in ("reldir", "axisang"):
        return n_joints * 3
    if bone_type == "Nope":
        return 0
    raise NotImplementedError(f"bone_type {bone_type!r}")


def encode_kp(kp_dist_type: str, pts, pts_t, kps) -> torch.Tensor:
    if kp_dist_type == "reldist":
        return reldist_encode(pts, pts_t, kps)
    if kp_dist_type == "relpos":
        return relpos_encode(pts, pts_t, kps)
    if kp_dist_type == "cat":
        return kpcat_encode(pts, pts_t, kps)
    if kp_dist_type == "querypts":
        return pts
    raise NotImplementedError(f"kp_dist_type {kp_dist_type!r}")


def encode_view(view_type: str, rays_t, pts_t, rays_d) -> torch.Tensor:
    if view_type == "relray":
        return vecnorm_encode(rays_t, refs=pts_t)
    if view_type == "rayangle":
        return rayang_encode(rays_t, pts_t)
    if view_type == "world":
        return identity_expand_encode(rays_d, refs=pts_t)
    raise NotImplementedError(f"view_type {view_type!r}")


def encode_bone(bone_type: str, pts_t, bones) -> Optional[torch.Tensor]:
    if bone_type == "reldir":
        return _bone_reldir(pts_t)
    if bone_type == "axisang":
        return identity_expand_encode(bones, refs=pts_t)
    if bone_type == "Nope":
        return None
    raise NotImplementedError(f"bone_type {bone_type!r}")


def _bone_reldir(pts_t: torch.Tensor) -> torch.Tensor:
    """'reldir' bone encoding: normalised local point direction per joint,
    (N, S, J, 3) -> (N, S, J*3)."""
    n = pts_t / torch.clamp(torch.linalg.norm(pts_t, dim=-1, keepdim=True), min=1e-12)
    return n.reshape(*pts_t.shape[:2], -1)
