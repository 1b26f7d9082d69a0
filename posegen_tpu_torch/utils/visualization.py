"""Skeleton overlays on the host, in numpy (port of
posegen_tpu/utils/visualization.py::draw_skeleton2d).

The JAX package draws with cv2 (`cv2.circle` filled, `cv2.line` of width 1,
both LINE_8); the port imports no cv2 (it is not among the packages the
card's machine promises), so it rasterises with
cv2's own integer rules: the filled circle is cv2's midpoint walk of
horizontal spans, the line is cv2's 8-connected Bresenham walk after its
`clipLine` to the image, so the overlays match cv2's pixel for pixel, also
for keypoints outside the frame.
"""

from __future__ import annotations

import numpy as np

from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton


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
