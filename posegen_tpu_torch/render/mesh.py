"""Mesh extraction: density grid -> triangle mesh -> .ply (port of
posegen_tpu/render/mesh.py).

Capability parity with the reference's mesh path (run_render.py:975-991:
density cube around the root joint -> marching cubes -> .ply). The density
grid comes from the render's device (`render_mesh_density`: on a card,
kernel 2's density-only mode); the iso-surface runs on the host: the JAX
package's vectorized numpy marching tetrahedra (6 tets per cube, no case
tables), kept here as its own copy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# cube corner offsets (i, j, k)
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int64,
)
# 6-tetrahedra decomposition of a cube (corner indices)
_TETS = np.array(
    [
        [0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
        [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6],
    ],
    dtype=np.int64,
)


def marching_tetrahedra(
    grid: np.ndarray, iso: float = 0.0, origin=(0.0, 0.0, 0.0), spacing=1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the iso-surface of a scalar grid.

    grid: (Nx, Ny, Nz) scalar field. Returns (vertices (V, 3), faces (F, 3)).
    Vertices lie on grid edges, linearly interpolated to the iso level.
    """
    f = grid.astype(np.float64) - iso
    nx, ny, nz = (d - 1 for d in grid.shape)
    if min(nx, ny, nz) < 1:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # corner coordinates for every cube: (C, 8, 3)
    base = np.stack(
        np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
        axis=-1,
    ).reshape(-1, 1, 3)
    corners = base + _CORNERS[None]  # (C, 8, 3)
    vals = f[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    # gather tetra vertices: (C, 6, 4, 3) coords and (C, 6, 4) values
    tet_pts = corners[:, _TETS]
    tet_vals = vals[:, _TETS]
    tet_pts = tet_pts.reshape(-1, 4, 3)
    tet_vals = tet_vals.reshape(-1, 4)

    inside = tet_vals > 0.0
    n_in = inside.sum(-1)

    verts_out = []

    def edge_interp(p0, v0, p1, v1):
        t = v0 / (v0 - v1)
        return p0 + t[:, None] * (p1 - p0)

    # order tet corners so the "inside" ones come first: argsort puts False
    # (outside) first with stable sort on ~inside
    order = np.argsort(~inside, axis=-1, kind="stable")
    pts_s = np.take_along_axis(tet_pts.astype(np.float64), order[..., None], axis=1)
    vals_s = np.take_along_axis(tet_vals, order, axis=1)

    # case 1 / 3 inside: one triangle (inside vertex vs the other three)
    for k, flip in ((1, False), (3, True)):
        sel = n_in == k
        if not sel.any():
            continue
        p, v = pts_s[sel], vals_s[sel]
        if k == 3:
            # reorder so the single OUTSIDE vertex is first
            p, v = p[:, ::-1], v[:, ::-1]
        a = edge_interp(p[:, 0], v[:, 0], p[:, 1], v[:, 1])
        b = edge_interp(p[:, 0], v[:, 0], p[:, 2], v[:, 2])
        c = edge_interp(p[:, 0], v[:, 0], p[:, 3], v[:, 3])
        tri = np.stack([a, b, c] if not flip else [a, c, b], axis=1)
        verts_out.append(tri.reshape(-1, 3))

    # case 2 inside: quad -> two triangles
    sel = n_in == 2
    if sel.any():
        p, v = pts_s[sel], vals_s[sel]
        # inside: 0,1; outside: 2,3
        e02 = edge_interp(p[:, 0], v[:, 0], p[:, 2], v[:, 2])
        e03 = edge_interp(p[:, 0], v[:, 0], p[:, 3], v[:, 3])
        e12 = edge_interp(p[:, 1], v[:, 1], p[:, 2], v[:, 2])
        e13 = edge_interp(p[:, 1], v[:, 1], p[:, 3], v[:, 3])
        tri1 = np.stack([e02, e03, e13], axis=1)
        tri2 = np.stack([e02, e13, e12], axis=1)
        verts_out.append(tri1.reshape(-1, 3))
        verts_out.append(tri2.reshape(-1, 3))

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    tri_verts = np.concatenate(verts_out, axis=0)
    # merge duplicate vertices
    keys = np.round(tri_verts * 1e6).astype(np.int64)
    uniq, idx = np.unique(keys, axis=0, return_inverse=True)
    verts = np.zeros((uniq.shape[0], 3))
    np.add.at(verts, idx, tri_verts)
    counts = np.bincount(idx, minlength=uniq.shape[0]).astype(np.float64)
    verts /= counts[:, None]
    faces = idx.reshape(-1, 3)
    # drop degenerate faces
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    verts = verts * spacing + np.asarray(origin)
    return verts.astype(np.float32), faces[good]


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    """ASCII .ply export (trimesh-free)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")
    return path


def extract_mesh(
    cfg, params, ctx, radius: float = 1.0, res: int = 64, threshold: float = 10.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Device density grid -> host iso-surface
    (reference render_mesh, run_render.py:975-991)."""
    from posegen_tpu_torch.render.raycast import render_mesh_density

    sigma = render_mesh_density(cfg, params, ctx, radius=radius, res=res).cpu().numpy()
    spacing = 2.0 * radius / res
    root = ctx.kps[0, 0].detach().cpu().numpy()
    origin = root - radius
    return marching_tetrahedra(sigma, iso=threshold, origin=origin, spacing=spacing)
