"""Skeleton overlays and plots on the host, in numpy (port of
posegen_tpu/utils/visualization.py).

The JAX package draws with cv2 (`cv2.circle` filled, `cv2.line`, LINE_8);
the port imports no cv2 (it is not among the packages the card's machine
promises), so it rasterises with cv2's own integer rules: the filled circle
is cv2's midpoint walk of horizontal spans, the line of width 1 cv2's
8-connected Bresenham walk after its `clipLine` to the image, and a thicker
line cv2's `ThickLine`: a quad in 16-bit fixed point filled by
`FillConvexPoly` (outline by the fixed-point `Line2`, then scanline spans)
and a round cap at each end. The overlays and masks match cv2's pixel for
pixel, also for keypoints outside the frame. The plotly figures import
plotly lazily and are None where it is not installed, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from posegen_tpu_torch.skeleton.cameras import nerf_c2w_to_extrinsic, world_to_cam
from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton

XY_SHIFT = 16  # cv2's fixed point for thick lines and polygons
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _fill_circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """cv2's `Circle(..., fill=1)` (drawing.cpp): spans y = cy -+ dy over
    x in [cx - dx, cx + dx] and y = cy -+ dx over [cx - dy, cx + dy]."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            if 0 <= y < h and x0 <= x1:
                img[y, x0:x1 + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip_line(w: int, h: int, p1, p2):
    """cv2's clipLine to [0, w-1] x [0, h-1] -> (inside, p1, p2)."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8  # noqa: E731
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """cv2's `Line(..., 8)`: a LineIterator from left to right."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:  # left to right
        dx, dy, (x, y) = -dx, -dy, (x2, y2)
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - (dy + dy), dx + dx, -(dy + dy)
    for _ in range(dx + 1):
        img[y, x] = color
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:  # y always moves, x when the error says so
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _line2(img: np.ndarray, p1, p2, color) -> None:
    """cv2's `Line2`: an 8-connected line between ends in 16-bit fixed point."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy, (x1, y1, x2, y2) = -dy, (x2, y2, x1, y1)
        x_step, y_step = XY_ONE, _cdiv(dy * XY_ONE, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx, (x1, y1, x2, y2) = -dx, (x2, y2, x1, y1)
        x_step, y_step = _cdiv(dx * XY_ONE, ay | 1), XY_ONE
        ecount = (y2 - y1) >> XY_SHIFT
    x1, y1 = x1 + _HALF, y1 + _HALF

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    put((x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1, y1 >> XY_SHIFT)
            x1, y1 = x1 + 1, y1 + y_step
    else:
        y1 >>= XY_SHIFT
        for _ in range(ecount + 1):
            put(x1 >> XY_SHIFT, y1)
            x1, y1 = x1 + x_step, y1 + 1


def _fill_convex_poly(img: np.ndarray, v, color) -> None:
    """cv2's `FillConvexPoly` of vertices in 16-bit fixed point, LINE_8: the
    outline by `_line2`, then one span a row between two edges that step in
    fixed point, each end rounded by half a pixel, clipped to the image."""
    h, w = img.shape[:2]
    npts = len(v)
    p0 = v[-1]
    for p in v:
        _line2(img, p0, p, color)
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(p[0] for p in v) + _HALF) >> XY_SHIFT, (max(p[0] for p in v) + _HALF) >> XY_SHIFT
    ymin, ymax = (min(ys) + _HALF) >> XY_SHIFT, (max(ys) + _HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [vertex index, direction, x, dx, the row where it ends]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges, y = npts, ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % npts
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + _HALF) >> XY_SHIFT
                if ty > y:
                    xs, xe = v[idx0][0], v[idx][0]
                    e[2:] = [xs, _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y)), ty]
                    e[0] = idx
                    break
                idx0, idx = idx, (idx + di) % npts
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((edge[0][2], edge[1][2]))
            x1, x2 = (left + _HALF) >> XY_SHIFT, (right + _HALF) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, thickness: int, color) -> None:
    """cv2's `line(img, p0, p1, color, thickness)`, LINE_8: width 1 is
    `_line8`; a thicker segment is first clipped to the image grown by
    `thickness` on every side, then drawn by `ThickLine`."""
    if thickness <= 1:
        _line8(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    t = thickness
    inside, p0, p1 = _clip_line(w + 2 * t, h + 2 * t, (p0[0] + t, p0[1] + t),
                                (p1[0] + t, p1[1] + t))
    if not inside:
        return
    p0, p1 = (p0[0] - t, p0[1] - t), (p1[0] - t, p1[1] - t)
    (x0, y0), (x1, y1) = [(x << XY_SHIFT, y << XY_SHIFT) for x, y in (p0, p1)]
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)  # cvRound: half to even
        _fill_convex_poly(img, [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy),
                                (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)], color)
    for x, y in (p0, p1):  # the round caps
        _fill_circle(img, x, y, (half + _HALF) >> XY_SHIFT, color)


def draw_skeleton2d(img: np.ndarray, kp2d: np.ndarray, skel: Skeleton = SMPL_SKELETON,
                    color=(0, 255, 0), radius: int = 2) -> np.ndarray:
    """Draw joints + bones on an image (reference skeleton_utils.py:1479)."""
    out = np.ascontiguousarray(img.copy())
    if out.dtype != np.uint8:
        out = (np.clip(out, 0, 1) * 255).astype(np.uint8)
    color = np.asarray(color, np.uint8)[:out.shape[2] if out.ndim == 3 else 1]
    if out.ndim == 2:
        color = color[0]
    parents = skel.parents()
    for j in range(skel.n_joints):
        p = parents[j]
        x0, y0 = int(kp2d[j, 0]), int(kp2d[j, 1])
        _fill_circle(out, x0, y0, radius, color)
        if p != j:
            _line8(out, (x0, y0), (int(kp2d[p, 0]), int(kp2d[p, 1])), color)
    return out


def draw_skeletons_3d(imgs: np.ndarray, kps: np.ndarray, c2ws: np.ndarray, H: int, W: int,
                      focals, centers=None, skel: Skeleton = SMPL_SKELETON) -> np.ndarray:
    """Project each frame's 3-D keypoints into its camera and overlay the
    skeleton (reference skeleton_utils.py:1467-1477)."""
    out = []
    for i in range(len(imgs)):
        f = focals if np.ndim(focals) == 0 else focals[i]
        ext = nerf_c2w_to_extrinsic(np.asarray(c2ws[i]))
        center = None if centers is None else centers[i]
        kp2d = world_to_cam(np.asarray(kps[i]), ext, H, W, f, center)
        out.append(draw_skeleton2d(imgs[i], kp2d, skel))
    return np.stack(out)


def create_kp_mask(H: int, W: int, kp2d: np.ndarray, skel: Skeleton = SMPL_SKELETON,
                   thickness: int = 12) -> np.ndarray:
    """(H, W, 1) uint8 mask around the projected skeleton: each bone a line
    of `thickness`, each joint a filled circle of radius `thickness`
    (reference create_kp_masks, skeleton_utils.py:867-913)."""
    mask = np.zeros((H, W), np.uint8)
    parents = skel.parents()
    for j in range(skel.n_joints):
        p = parents[j]
        a = (int(kp2d[j, 0]), int(kp2d[j, 1]))
        b = (int(kp2d[p, 0]), int(kp2d[p, 1]))
        _thick_line(mask, a, b, thickness, 1)
        _fill_circle(mask, a[0], a[1], thickness, 1)
    return mask[..., None]


def plot_skeleton3d(kp: np.ndarray, skel: Skeleton = SMPL_SKELETON, fig=None):
    """Interactive plotly 3-D skeleton (reference skeleton_utils.py:915-1028).
    Returns None when plotly isn't installed."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    fig = fig or go.Figure()
    parents = skel.parents()
    for j in range(skel.n_joints):
        p = parents[j]
        fig.add_trace(go.Scatter3d(
            x=[kp[j, 0], kp[p, 0]], y=[kp[j, 1], kp[p, 1]], z=[kp[j, 2], kp[p, 2]],
            mode="lines+markers", marker=dict(size=3), showlegend=False))
    return fig


def plot_cameras(c2ws: np.ndarray, scale: float = 0.2, fig=None):
    """Camera axes in 3-D (reference skeleton_utils.py:1030-1220). Returns
    None when plotly isn't installed."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    fig = fig or go.Figure()
    for c2w in np.asarray(c2ws):
        o = c2w[:3, 3]
        for axis, color in zip(range(3), ("red", "green", "blue")):
            d = c2w[:3, axis] * scale
            fig.add_trace(go.Scatter3d(
                x=[o[0], o[0] + d[0]], y=[o[1], o[1] + d[1]], z=[o[2], o[2] + d[2]],
                mode="lines", line=dict(color=color), showlegend=False))
    return fig


def plot_cylinder(cyl: np.ndarray, n_seg: int = 32, fig=None):
    """Bounding cylinder wireframe (reference skeleton_utils.py:1222-1273).
    Returns None when plotly isn't installed."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    fig = fig or go.Figure()
    cx, cz, r, top, bot = [float(v) for v in cyl]
    theta = np.linspace(0, 2 * np.pi, n_seg)
    for h in (top, bot):
        fig.add_trace(go.Scatter3d(
            x=cx + r * np.cos(theta), y=np.full(n_seg, h), z=cz + r * np.sin(theta),
            mode="lines", showlegend=False))
    return fig
