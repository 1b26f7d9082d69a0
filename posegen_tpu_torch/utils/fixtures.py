"""Synthetic problem builders (port of posegen_tpu/utils/fixtures.py).

The pose and the rays come from numpy's generator exactly as in the JAX
package, so a seed gives both frameworks the same problem; the weights come
from a torch.Generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.render.raycast import PoseCtx, RaycastConfig, init_raycaster
from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws


def make_pose_ctx(
    seed: int = 0,
    n_poses: int = 1,
    with_cam_idx: bool = False,
    pose_scale: float = 0.2,
    device="cuda",
) -> PoseCtx:
    """A plausible random SMPL pose context, computed on the host in float32
    and moved to `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bones = torch.as_tensor(
        (rng.standard_normal((n_poses, 24, 3)) * pose_scale).astype(np.float32))
    l2ws = smpl_l2ws(bones)
    kps = l2ws[..., :3, 3]
    skts = invert_rigid(l2ws)
    cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001)
    cam_idxs = torch.zeros((n_poses, 1), dtype=torch.long) if with_cam_idx else None
    return PoseCtx(
        kps=kps.to(dev), skts=skts.to(dev), bones=bones.to(dev), cyls=cyls.to(dev),
        cam_idxs=None if cam_idxs is None else cam_idxs.to(dev),
    )


def make_rays(n_rays: int, seed: int = 1, target_center=(0.0, 0.0, 0.0),
              dist: float = 2.0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rays from a ring of viewpoints aimed at the subject."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, (n_rays,))
    origins = np.stack(
        [dist * np.cos(theta), rng.uniform(-0.5, 0.5, (n_rays,)), dist * np.sin(theta)],
        axis=-1,
    ).astype(np.float32)
    jitter = rng.uniform(-0.3, 0.3, (n_rays, 3)).astype(np.float32)
    dirs = np.asarray(target_center, dtype=np.float32) + jitter - origins
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return torch.as_tensor(origins).to(dev), torch.as_tensor(dirs).to(dev)


def make_problem(
    cfg: Optional[RaycastConfig] = None,
    n_rays: int = 1024,
    seed: int = 0,
    device="cuda",
) -> Tuple[RaycastConfig, Dict, PoseCtx, torch.Tensor, torch.Tensor]:
    """(cfg, params, ctx, rays_o, rays_d) ready for render_rays, on `device`
    (CUDA by default; raises without a card)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = RaycastConfig()
    params = init_raycaster(cfg, torch.Generator().manual_seed(seed), device=dev)
    ctx = make_pose_ctx(seed, with_cam_idx=cfg.opt_framecode, device=dev)
    rays_o, rays_d = make_rays(n_rays, seed + 1, device=dev)
    return cfg, params, ctx, rays_o, rays_d


def make_train_batch(
    cfg: RaycastConfig,
    n_rays: int = 1024,
    seed: int = 0,
    opt_pose: bool = False,
    n_frames: int = 4,
    n_groups: int = 1,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """A synthetic training batch matching make_train_step's expectations, on
    `device`: the JAX package's numpy draws in its order.

    n_groups > 1 produces the RayBatchLoader grouped layout: pose rows
    (kp3d / skts / bones / cyls) carried per image group (G rows), rays
    contiguous per group (n_rays % n_groups == 0). With opt_pose the batch
    holds per-group frame indices `kp_idx` (int32) instead of skts / bones;
    with cfg.opt_framecode, `cam_idxs` (n_rays, 1) int32 zeros.
    """
    if n_rays % n_groups:
        raise ValueError(f"n_rays {n_rays} is not a multiple of n_groups {n_groups}")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed + 7)
    ctx = make_pose_ctx(seed, n_poses=n_groups, device=dev)
    rays_o, rays_d = make_rays(n_rays, seed + 1, device=dev)
    on_dev = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    batch = {
        "rays_o": rays_o,
        "rays_d": rays_d,
        "target_s": on_dev(rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)),
        "cyls": ctx.cyls,
        "fgs": on_dev(rng.integers(0, 2, (n_rays, 1)).astype(np.float32)),
    }
    if opt_pose:
        # kp_idx is per image GROUP (the RayBatchLoader contract)
        batch["kp_idx"] = on_dev(rng.integers(0, n_frames, (n_groups,)).astype(np.int32))
        batch["kp3d"] = ctx.kps
    else:
        batch["kp3d"] = ctx.kps
        batch["skts"] = ctx.skts
        batch["bones"] = ctx.bones
    if cfg.opt_framecode:
        batch["cam_idxs"] = torch.zeros((n_rays, 1), dtype=torch.int32, device=dev)
    return batch
