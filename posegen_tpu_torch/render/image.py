"""Whole-image rendering (port of posegen_tpu/render/image.py).

Capability parity with reference run_nerf.py:28-147 (`render_path`) and
core/utils/ray_utils.py:83-136 (`kp_to_valid_rays`): render only the rays
whose pixels fall inside the pose's projected bounding-cylinder box, then
composite onto a background.

GPU mechanics. The box math is host numpy, as in the JAX package, so the
integer boxes and `valid_idx` come out identical; `ctx.cyls` is read on the
host once per frame for it. Everything after stays on the render's device
(the device of the pose context):
- rays are generated on the device from the ~60-byte cam pack of
  `make_cam` (`rays_from_box`), one slice per chunk; the last chunk is
  ragged, not padded (the kernels' persistent grid takes any point count),
  so no padding lane exists;
- host arrays (cam packs, valid_idx, backgrounds) go up through pinned
  memory without a stream synchronisation, and every chunk of a frame (in
  `render_images_pipelined`, of every frame) is dispatched before the first
  device-to-host copy;
- only KEEP_MAPS leave the render; the background is composited on the
  device and the maps scattered into the frame with one `index_copy_`; each
  frame is copied back once, cast to float16 first when `half_readback` is
  set (so the f16 rounding comes after the composite; the JAX package
  rounds the maps, then composites in float32 on the host).

The route of each chunk is `render_rays(..., perturb=0, raw_noise_std=0,
eval_mean_code=ctx.cam_idxs is None, coarse_rgb=False)`: on CUDA tensors
whose config passes the gate, one `posegen_dual` and one `posegen_field`
launch per chunk.

render_fn hook: a function tagged `takes_cam = True` is called as
`render_fn(params, cam, start, n, ctx)` with the device cam pack and the
chunk's first box offset and ray count (the JAX hook takes (params, cam,
start, ctx) at a fixed chunk: the port's chunks are ragged); any other as
`render_fn(params, rays_o, rays_d, ctx)` on host-made rays. Either returns
a dict holding KEEP_MAPS for its rays.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from posegen_tpu_torch.data.synthetic import _look_at_c2w
from posegen_tpu_torch.render.raycast import PoseCtx, RaycastConfig, render_rays
from posegen_tpu_torch.skeleton.cameras import get_rays_np, nerf_c2w_to_extrinsic
from posegen_tpu_torch.skeleton.geometry import cylinder_to_box_2d


def valid_rays_for_pose(
    H: int,
    W: int,
    focal,
    c2w: np.ndarray,
    cyl: np.ndarray,
    center=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Rays restricted to the cylinder's 2D bbox (host numpy).

    Returns (rays_o (V,3), rays_d (V,3), valid_idx (V,) flat pixel indices,
    (tl, br) box corners).
    """
    rays_o, rays_d = get_rays_np(H, W, focal, c2w, center=center)
    tl, br, valid_idx = valid_box_for_pose(H, W, focal, c2w, cyl, center)
    ro = rays_o.reshape(-1, 3)[valid_idx]
    rd = rays_d.reshape(-1, 3)[valid_idx]
    return ro.astype(np.float32), rd.astype(np.float32), valid_idx, (tl, br)


def valid_box_for_pose(
    H: int, W: int, focal, c2w: np.ndarray, cyl: np.ndarray, center=None,
    window=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tl, br, valid_idx): the pose cylinder's 2D bbox and the flat pixel
    indices inside it, the single source of the box convention for both
    the host-ray and device-raygen render paths.

    window: optional (lo, hi) pixel interval; the box is intersected with
    the square [lo, hi) x [lo, hi). Used by the GAN feedback renderer: SPIN
    consumes only the center crop (reference run_gan.py:2069 reads
    image[100:412, 100:412]), so rays outside the crop are waste there."""
    w2c = nerf_c2w_to_extrinsic(np.asarray(c2w))
    tl, br, _ = cylinder_to_box_2d(np.asarray(cyl), [H, W, focal], w2c, center=center)
    if window is not None:
        lo, hi = int(window[0]), int(window[1])
        tl = np.maximum(tl, lo)
        br = np.minimum(br, hi)
        # degenerate intersection (pose fully outside the crop): keep one
        # pixel, as the JAX package does
        br = np.maximum(br, tl + 1)
    yy, xx = np.meshgrid(
        np.arange(tl[1], br[1]), np.arange(tl[0], br[0]), indexing="ij"
    )
    valid_idx = (yy * W + xx).reshape(-1)
    return tl, br, valid_idx


KEEP_MAPS = ("rgb_map", "acc_map", "disp_map")


def make_cam(
    H: int,
    W: int,
    focal,
    c2w: np.ndarray,
    tl: np.ndarray,
    br: np.ndarray,
    center=None,
) -> Dict[str, np.ndarray]:
    """Pack the per-image camera + valid-ray box for on-device ray
    generation: ~60 bytes per frame in place of the rays' 6 MB at 512^2.
    Layout:
      c2w  (3, 4) f32   camera-to-world
      foff (4,)   f32   [focal_x, focal_y, off_x, off_y]
      box  (4,)   i32   [tl_x, tl_y, box_width, n_valid]
    """
    f = np.reshape(np.asarray(focal, dtype=np.float32), (-1,))
    fx = float(f[0])
    fy = float(f[1]) if f.size > 1 else fx
    if center is None:
        off_x, off_y = W * 0.5, H * 0.5
    else:
        off_x, off_y = float(center[0]), float(center[1])
    bw = int(br[0] - tl[0])
    bh = int(br[1] - tl[1])
    return {
        "c2w": np.asarray(c2w, np.float32)[:3, :4],
        "foff": np.asarray([fx, fy, off_x, off_y], np.float32),
        "box": np.asarray([int(tl[0]), int(tl[1]), bw, bw * bh], np.int32),
    }


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array -> a fresh tensor on `dev`; to a card through pinned
    memory and non-blocking, so no stream synchronisation."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.clone()


def rays_from_box(cam: Dict[str, torch.Tensor], start: int, n: int):
    """Rays for flat box offsets [start, start + n) on the cam pack's device:
    the twin of `get_rays_np` restricted to the valid-ray box (row-major,
    `valid_idx`'s order). Offsets past n_valid clamp to the last valid ray,
    as in the JAX package (the port's renders never ask for them)."""
    box, foff, c2w = cam["box"], cam["foff"], cam["c2w"]
    j = start + torch.arange(n, dtype=torch.int32, device=box.device)
    j = torch.minimum(j, box[3] - 1)
    y = (box[1] + j // box[2]).float()
    x = (box[0] + j % box[2]).float()
    dirs = torch.stack([(x - foff[2]) / foff[0], -(y - foff[3]) / foff[1], -torch.ones_like(x)],
                       dim=-1)
    # broadcast-sum, as get_rays: never TF32
    rays_d = (dirs[..., None, :] * c2w[:3, :3]).sum(-1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def _eval_maps(cfg: RaycastConfig, params, rays_o, rays_d, ctx: PoseCtx, use_fused):
    # a ctx WITHOUT cam_idxs evals with the mean code; one WITH them uses the
    # real per-frame codes (reference render_testset, run_nerf.py:574)
    out = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0, raw_noise_std=0.0,
                      eval_mean_code=ctx.cam_idxs is None, coarse_rgb=False,
                      use_fused=use_fused)
    return {k: out[k] for k in KEEP_MAPS}


def _raygen_render_fn(cfg: RaycastConfig, use_fused=None):
    """The default device-raygen render: rays from the cam pack, then the
    eval render (`render_rays`'s route rule; use_fused as there)."""

    def fn(params, cam, start, n, ctx):
        o, d = rays_from_box(cam, start, n)
        return _eval_maps(cfg, params, o, d, ctx, use_fused)

    fn.takes_cam = True
    return fn


def _default_render_fn(cfg: RaycastConfig):
    """The eval render on host-made rays (no takes_cam)."""

    def fn(params, rays_o, rays_d, ctx):
        return _eval_maps(cfg, params, rays_o, rays_d, ctx, None)

    return fn


def _cat_maps(outs, keys, dev) -> Dict[str, torch.Tensor]:
    if not outs:
        return {k: torch.zeros((0, 3) if k == "rgb_map" else (0,), device=dev) for k in keys}
    return {k: torch.cat([o[k].float() for o in outs]) for k in keys}


def _render_chunks(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    rays_o: np.ndarray,
    rays_d: np.ndarray,
    ctx: PoseCtx,
    chunk: int,
    render_fn=None,
) -> Dict[str, torch.Tensor]:
    """Host-made rays, uploaded once, rendered chunk by chunk on the
    context's device -> KEEP_MAPS, (V, ...) float32 on that device. All
    chunks are dispatched before anything is read back."""
    dev = ctx.kps.device
    ro, rd = _upload(rays_o, dev), _upload(rays_d, dev)
    if render_fn is None:
        render_fn = _default_render_fn(cfg)
    n = ro.shape[0]
    outs = [render_fn(params, ro[i:i + chunk], rd[i:i + chunk], ctx) for i in range(0, n, chunk)]
    return _cat_maps(outs, KEEP_MAPS, dev)


def _render_chunks_cam(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    cam: Dict[str, Any],
    ctx: PoseCtx,
    chunk: int,
    render_fn=None,
) -> Dict[str, torch.Tensor]:
    """Device-raygen twin of `_render_chunks`: the host pack of `make_cam`
    goes up once; each chunk's rays are made on the device."""
    dev = ctx.kps.device
    n = int(cam["box"][3])
    cam_dev = {k: _upload(v, dev) for k, v in cam.items()}
    if render_fn is None:
        render_fn = _raygen_render_fn(cfg)
    outs = [render_fn(params, cam_dev, i, min(chunk, n - i), ctx) for i in range(0, n, chunk)]
    return _cat_maps(outs, KEEP_MAPS, dev)


def _readback(t: torch.Tensor, half: bool) -> np.ndarray:
    """One device-to-host copy (float16 when `half`) -> float32 numpy."""
    if half:
        t = t.to(torch.float16)
    return t.cpu().float().numpy()


def render_image(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    H: int,
    W: int,
    focal,
    c2w: np.ndarray,
    ctx: PoseCtx,
    chunk: int = 4096,
    center=None,
    bg: Optional[np.ndarray] = None,
    white_bkgd: bool = False,
    render_fn=None,
    half_readback: bool = False,
) -> Dict[str, np.ndarray]:
    """Render one image on the context's device (reference render_path inner
    loop, run_nerf.py:77-138).

    bg: optional (H, W, 3) background composited as rgb + (1-acc)*bg.
    Returns dict with 'rgb' (H, W, 3), 'acc' (H, W), 'disp' (H, W), 'bbox',
    'valid_idx' (host numpy).
    """
    dev = ctx.kps.device
    cyl = ctx.cyls[0].detach().cpu().numpy()
    if render_fn is None or getattr(render_fn, "takes_cam", False):
        tl, br, valid_idx = valid_box_for_pose(H, W, focal, c2w, cyl, center)
        cam = make_cam(H, W, focal, c2w, tl, br, center=center)
        ret = _render_chunks_cam(cfg, params, cam, ctx, chunk, render_fn)
    else:
        rays_o, rays_d, valid_idx, (tl, br) = valid_rays_for_pose(H, W, focal, c2w, cyl, center)
        ret = _render_chunks(cfg, params, rays_o, rays_d, ctx, chunk, render_fn)

    if white_bkgd and bg is None:
        bg = np.ones((H, W, 3), dtype=np.float32)
    # one frame of [r, g, b, acc, disp] rows, the maps scattered in at once
    frame = torch.zeros((H * W, 5), dtype=torch.float32, device=dev)
    idx = _upload(valid_idx.astype(np.int64), dev)
    rgb, acc = ret["rgb_map"], ret["acc_map"]
    if bg is not None:
        frame[:, :3] = _upload(np.asarray(bg, np.float32).reshape(-1, 3), dev)
        rgb = rgb + (1.0 - acc[..., None]) * frame[idx, :3]
    frame.index_copy_(0, idx, torch.cat([rgb, acc[:, None], ret["disp_map"][:, None]], 1))
    host = _readback(frame, half_readback)
    return {
        "rgb": host[:, :3].reshape(H, W, 3),
        "acc": host[:, 3].reshape(H, W),
        "disp": host[:, 4].reshape(H, W),
        "bbox": (tl, br),
        "valid_idx": valid_idx,
    }


def render_images_pipelined(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    H: int,
    W: int,
    focal,
    c2ws: Sequence[np.ndarray],
    ctxs: Sequence[PoseCtx],
    cyls: np.ndarray,
    chunk: int = 4096,
    white_bkgd: bool = False,
    render_fn=None,
    half_readback: bool = False,
    window=None,
) -> np.ndarray:
    """Render K (camera, pose) pairs with the device kept busy: every chunk
    of every frame is dispatched before the first readback, then all frames
    come back in one copy. The GAN feedback renderer's hot path (reference
    run_gan.py:2041-2091 renders rpi = 20 images per feedback event).

    cyls: (K, 5) HOST cylinder rows (the 2D box math is numpy); the pose
    contexts live on the render's device. Only device-raygen (takes_cam)
    render_fns are supported. Returns (K, H, W, 3) float32 composited
    frames (black background, or white).
    """
    if render_fn is None:
        render_fn = _raygen_render_fn(cfg)
    if not getattr(render_fn, "takes_cam", False):
        raise ValueError("render_images_pipelined needs a device-raygen "
                         "(takes_cam) render_fn")
    K = len(c2ws)
    dev = ctxs[0].kps.device
    boxes = [valid_box_for_pose(H, W, focal, c2ws[k], cyls[k], window=window) for k in range(K)]
    cams = [make_cam(H, W, focal, c2ws[k], tl, br) for k, (tl, br, _) in enumerate(boxes)]
    # three uploads for all frames' cam packs, one for their pixel indices
    cams_dev = {key: _upload(np.stack([c[key] for c in cams]), dev) for key in cams[0]}
    sizes = [len(v) for _, _, v in boxes]
    idx_all = _upload(np.concatenate([v for _, _, v in boxes]).astype(np.int64), dev)
    frames = torch.full((K, H * W, 3), 1.0 if white_bkgd else 0.0, device=dev)
    for k, idx in enumerate(torch.split(idx_all, sizes)):
        cam = {key: v[k] for key, v in cams_dev.items()}
        n = sizes[k]
        outs = [render_fn(params, cam, i, min(chunk, n - i), ctxs[k]) for i in range(0, n, chunk)]
        ret = _cat_maps(outs, ("rgb_map", "acc_map"), dev)
        rgb = ret["rgb_map"]
        if white_bkgd:
            rgb = rgb + (1.0 - ret["acc_map"][..., None])
        frames[k].index_copy_(0, idx, rgb)
    return _readback(frames, half_readback).reshape(K, H, W, 3)


def render_path(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    render_poses: Sequence[np.ndarray],
    hwf: Tuple[int, int, float],
    ctxs: Sequence[PoseCtx],
    chunk: int = 4096,
    centers=None,
    bgs=None,
    white_bkgd: bool = False,
    verbose: bool = False,
    render_fn=None,
    half_readback: bool = False,
) -> Dict[str, np.ndarray]:
    """Render a sequence of (camera, pose) pairs (reference run_nerf.py:28-147).

    When there are fewer pose contexts than cameras, pose i % len(ctxs) is
    used (matching kp_to_valid_rays' cyl_idx convention)."""
    H, W, focal = hwf
    rgbs, accs, disps, bboxes = [], [], [], []
    t0 = time.time()
    for i, c2w in enumerate(render_poses):
        ctx = ctxs[i % len(ctxs)]
        bg = None if bgs is None else bgs[i % len(bgs)]
        center = None if centers is None else centers[i]
        f = focal if np.ndim(focal) == 0 else focal[i]
        out = render_image(
            cfg, params, H, W, f, c2w, ctx, chunk=chunk, center=center,
            bg=bg, white_bkgd=white_bkgd, render_fn=render_fn,
            half_readback=half_readback,
        )
        rgbs.append(out["rgb"])
        accs.append(out["acc"])
        disps.append(out["disp"])
        bboxes.append(np.concatenate(out["bbox"]))
        if verbose:
            print(f"render {i}: {time.time() - t0:.3f}s")
            t0 = time.time()
    return {
        "rgbs": np.stack(rgbs),
        "accs": np.stack(accs),
        "disps": np.stack(disps),
        "bboxes": np.stack(bboxes),
    }


def _bullet_c2ws(center: np.ndarray, dist: float, n: int, y: float = 0.3) -> np.ndarray:
    """n cameras on a ring of radius `dist` at height y, all looking at
    `center`: run_render's bullet-time cameras (posegen_tpu/cli/
    run_render.py:144)."""
    return np.stack(
        [
            _look_at_c2w(np.array([dist * np.cos(t), y, dist * np.sin(t)], np.float32), center)
            for t in np.linspace(0, 2 * np.pi, n, endpoint=False)
        ]
    )
