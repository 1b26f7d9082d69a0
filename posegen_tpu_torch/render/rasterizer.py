"""Mesh rasterizer for turntable previews and overlays (port of
posegen_tpu/render/rasterizer.py).

The JAX package rasterizes in numpy, one face at a time: it projects the
vertices, shades each face (Lambertian, from world normals), sorts the
faces far to near by their nearest vertex and paints each over its
clamped bounding box where the pixel centre is inside (barycentrics >= 0)
and nearer than the z-buffer (a strict <). The port keeps the host part in
float64 numpy as JAX has it (the projection, the shading, the visibility
test and the paint order, the same `np.argsort` call, since its order on
ties is part of the result) and does the per-pixel part on `device`,
vectorised over (face, pixel) pairs in chunks of faces: the bounding
boxes, the barycentrics and depths in float64 in JAX's order of
operations, and the z-test. Painting far to near with a strict < leaves at
each pixel the covering face of least depth, and among equal depths the
first in the paint order; the port computes that winner with two
`scatter_reduce("amin")` passes (depth, then paint rank among the faces at
that depth) and writes its colour. The arithmetic is elementwise IEEE
float64 on both devices, so the images equal JAX's, on the CPU and on the
card alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.cameras import nerf_c2w_to_extrinsic

PAIR_CHUNK = 1 << 22  # (face, pixel) pairs a chunk of faces may expand to


def _winners(p0, p1, p2, H: int, W: int, dev: torch.device) -> np.ndarray:
    """p0, p1, p2: (F, 3) float64 screen x, y and depth of the visible faces'
    corners, in paint order. -> (H * W,) int64: the paint rank of each
    pixel's winning face, -1 where none covers it."""
    n_faces = len(p0)
    if n_faces == 0:
        return np.full(H * W, -1, np.int64)
    a = torch.as_tensor(p0, device=dev)
    b = torch.as_tensor(p1, device=dev)
    c = torch.as_tensor(p2, device=dev)
    xs = torch.stack([a[:, 0], b[:, 0], c[:, 0]])
    ys = torch.stack([a[:, 1], b[:, 1], c[:, 1]])
    # JAX's max(floor(min), 0) and min(ceil(max) + 1, W); clamping both ends
    # to [0, W] keeps every empty box empty
    x0 = xs.amin(0).floor().clamp(0, W).to(torch.int64)
    x1 = (xs.amax(0).ceil() + 1).clamp(0, W).to(torch.int64)
    y0 = ys.amin(0).floor().clamp(0, H).to(torch.int64)
    y1 = (ys.amax(0).ceil() + 1).clamp(0, H).to(torch.int64)
    d = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    bw, bh = x1 - x0, y1 - y0
    keep = (bw > 0) & (bh > 0) & ~(d.abs() < 1e-12)
    area = torch.where(keep, bw * bh, torch.zeros_like(bw))

    HW = H * W
    none = n_faces  # a rank past every face: no winner
    zbuf = torch.full((HW,), float("inf"), dtype=torch.float64, device=dev)
    best = torch.full((HW,), none, dtype=torch.int64, device=dev)
    areas = area.cpu().numpy()
    ends = np.cumsum(areas)
    start = 0
    while start < n_faces:
        # the faces [start, stop) expand to at most PAIR_CHUNK pairs (one face at least)
        base = ends[start - 1] if start else 0
        stop = max(int(np.searchsorted(ends, base + PAIR_CHUNK, side="right")), start + 1)
        n_pairs = int(ends[stop - 1] - base)
        if n_pairs:
            f_idx = torch.arange(start, stop, device=dev)
            f = torch.repeat_interleave(f_idx, area[start:stop], output_size=n_pairs)
            offs = torch.cumsum(area[start:stop], 0) - area[start:stop]
            off = torch.arange(n_pairs, device=dev) - offs[f - start]
            px = x0[f] + off % bw[f]
            py = y0[f] + off // bw[f]
            xp = px.to(torch.float64) + 0.5
            yp = py.to(torch.float64) + 0.5
            ax, ay, az = a[f, 0], a[f, 1], a[f, 2]
            bx, by, bz = b[f, 0], b[f, 1], b[f, 2]
            cx, cy, cz = c[f, 0], c[f, 1], c[f, 2]
            df = d[f]
            w0 = ((by - cy) * (xp - cx) + (cx - bx) * (yp - cy)) / df
            w1 = ((cy - ay) * (xp - cx) + (ax - cx) * (yp - cy)) / df
            w2 = 1.0 - w0 - w1
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
            zi = w0 * az + w1 * bz + w2 * cz
            pix = (py * W + px)[inside]
            zi, f = zi[inside], f[inside]
            cz_min = torch.full((HW,), float("inf"), dtype=torch.float64, device=dev)
            cz_min.scatter_reduce_(0, pix, zi, "amin")
            at_min = zi == cz_min[pix]
            c_best = torch.full((HW,), none, dtype=torch.int64, device=dev)
            c_best.scatter_reduce_(0, pix[at_min], f[at_min], "amin")
            better = (cz_min < zbuf) | ((cz_min == zbuf) & (c_best < best))
            zbuf = torch.where(better, cz_min, zbuf)
            best = torch.where(better, c_best, best)
        start = stop
    best = best.cpu().numpy()
    best[best == none] = -1
    return best


def rasterize_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    c2w: np.ndarray,
    H: int,
    W: int,
    focal: float,
    colors: Optional[np.ndarray] = None,
    bg: float = 1.0,
    light_dir=(0.3, 0.8, 0.5),
    device="cuda",
) -> np.ndarray:
    """Render one view -> (H, W, 3) float32 [0, 1] (numpy), the pixel work
    on `device` (CUDA by default; raises without a card).

    verts (V, 3) world; faces (F, 3); colors optional (V, 3).
    """
    dev = resolve_device(device)
    ext = nerf_c2w_to_extrinsic(np.asarray(c2w, np.float64))
    hom = np.concatenate([verts, np.ones((len(verts), 1))], -1)
    cam = hom @ ext.T  # (V, 4)
    z = cam[:, 2]
    x = cam[:, 0] / np.maximum(z, 1e-9) * focal + W / 2.0
    y = cam[:, 1] / np.maximum(z, 1e-9) * focal + H / 2.0

    if colors is None:
        colors = np.full((len(verts), 3), 0.75)

    # per-face lambertian shading from world normals
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    ld = np.asarray(light_dir, np.float64)
    ld /= np.linalg.norm(ld)
    shade = 0.35 + 0.65 * np.abs(n @ ld)  # (F,)

    p0 = np.stack([x[faces[:, 0]], y[faces[:, 0]], z[faces[:, 0]]], -1)
    p1 = np.stack([x[faces[:, 1]], y[faces[:, 1]], z[faces[:, 1]]], -1)
    p2 = np.stack([x[faces[:, 2]], y[faces[:, 2]], z[faces[:, 2]]], -1)
    fcol = (colors[faces[:, 0]] + colors[faces[:, 1]] + colors[faces[:, 2]]) / 3.0
    fcol = fcol * shade[:, None]

    visible = (p0[:, 2] > 1e-6) & (p1[:, 2] > 1e-6) & (p2[:, 2] > 1e-6)
    order = np.argsort(-np.minimum(np.minimum(p0[:, 2], p1[:, 2]), p2[:, 2]))
    order = order[visible[order]]
    win = _winners(np.ascontiguousarray(p0[order], np.float64),
                   np.ascontiguousarray(p1[order], np.float64),
                   np.ascontiguousarray(p2[order], np.float64), H, W, dev)
    img = np.full((H * W, 3), bg, np.float64)
    hit = win >= 0
    img[hit] = fcol[order[win[hit]]]
    return img.reshape(H, W, 3).astype(np.float32)


def overlay_mesh(
    img: np.ndarray,
    verts: np.ndarray,
    faces: np.ndarray,
    c2w: np.ndarray,
    focal: float,
    alpha: float = 0.8,
    color=(0.65, 0.75, 0.9),
    device="cuda",
) -> np.ndarray:
    """Composite a mesh render over an image (the reference's pyrender SMPL
    debug overlay, core/misc/renderer.py:7-83). img: (H, W, 3) [0, 1]."""
    H, W = img.shape[:2]
    colors = np.tile(np.asarray(color, np.float64), (len(verts), 1))
    ren = rasterize_mesh(verts, faces, c2w, H, W, focal, colors=colors, bg=-1.0, device=device)
    fg = ~np.all(ren == -1.0, axis=-1)  # bg sentinel marks untouched pixels
    out = img.astype(np.float32).copy()
    out[fg] = alpha * ren[fg] + (1 - alpha) * out[fg]
    return out


def turntable_render(
    verts: np.ndarray,
    faces: np.ndarray,
    n_views: int = 12,
    H: int = 256,
    W: int = 256,
    focal: float = 250.0,
    dist: Optional[float] = None,
    device="cuda",
) -> np.ndarray:
    """Orbit the mesh (reference render_mesh.py's turntable loop)
    -> (n_views, H, W, 3)."""
    from posegen_tpu_torch.data.synthetic import _look_at_c2w

    dev = resolve_device(device)
    center = verts.mean(0)
    if dist is None:
        dist = float(np.linalg.norm(verts - center, axis=-1).max() * 3.0 + 1e-6)
    frames = []
    for t in np.linspace(0, 2 * np.pi, n_views, endpoint=False):
        eye = center + np.array([dist * np.cos(t), 0.3 * dist, dist * np.sin(t)])
        c2w = _look_at_c2w(eye.astype(np.float32), center.astype(np.float32))
        frames.append(rasterize_mesh(verts, faces, c2w, H, W, focal, device=dev))
    return np.stack(frames)
