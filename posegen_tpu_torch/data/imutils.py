"""Image crop, resize and flips on the host, in numpy (port of
posegen_tpu/data/imutils.py).

The JAX package resizes with cv2 (INTER_LINEAR in `crop` and the SPIN
datasets, INTER_AREA in the eval harness's `_resize_normalize`); the port
imports no cv2 (it is not among the packages the card's machine promises),
so it computes cv2 5.0's own rules, bit-equal in this package's tests:
  * INTER_LINEAR: half-pixel centres, f = float32((d + 0.5) * src / dst -
    0.5), the source index floor(f) and the weight f - floor(f); along x an
    index past either edge is clamped with weight 0, along y the weight
    stays and the rows are clipped to the image;
  * uint8 two-tap passes (`resize_linear_u8`, and `resize_area_u8` where it
    interpolates): 11-bit fixed-point weights (round(w * 2048)), an exact
    integer pass along x, then the vertical pass as cv2's vector code
    computes it on every element: each row value shifted right by 4,
    multiplied by its weight keeping the high 16 bits, the two summed and
    rounded by (s + 2) >> 2 (cv2 5.0's build for x86 applies this rule to
    the whole row);
  * uint8 INTER_AREA (`resize_area_u8`), by the ratio: an integer ratio on
    both axes sums each box exactly, then rounds by (s + 2) >> 2 at 2 x 2 on
    1, 3 or 4 channels (cv2's vector rule) and float32(s) * (1.f / area)
    to the nearest even integer otherwise; another downscale on both axes
    takes cv2's area table (each source sample's overlap / cell width in
    float32) and sums rows, then columns, in float32 in cv2's order,
    rounding to the nearest even; an upscale on either axis is the two-tap
    pass with cv2's area taps (the index floor(d * src / dst), the weight
    (d + 1) - (i + 1) * dst / src modulo 1);
  * float (`resize_linear`): float64 weights and sums, cv2's float64 path
    (which `crop`'s float64 canvas takes) to within an ulp of the result:
    cv2 contracts one product into a fused multiply-add.
`rot_aa` takes cv2.Rodrigues' rules in numpy (float64).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# SMPL left/right joint swap (reference constants: SMPL_POSE_FLIP_PERM base)
SMPL_JOINT_FLIP_PERM = [
    0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15, 17, 16, 19, 18,
    21, 20, 23, 22,
]

IMG_NORM_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_NORM_STD = np.array([0.229, 0.224, 0.225], np.float32)
_COEF_ONE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit weights
_EPS = float(np.finfo(np.float64).eps)  # cv2's DBL_EPSILON test of an integer ratio


def _linear_taps(n_src: int, n_dst: int, clamp: bool, dtype=np.float32):
    """cv2's taps along one axis -> (i0, i1, w0, w1), w of `dtype` (float32
    for uint8 images, float64 for float64 ones)."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(dtype)
    i = np.floor(f).astype(np.int64)
    f = f - i.astype(dtype)
    if clamp:
        lo, hi = i < 0, i >= n_src - 1
        f[lo | hi] = 0.0
        i[lo], i[hi] = 0, n_src - 1
    w0, w1 = dtype(1.0) - f, f
    return np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), w0, w1


def _check(img: np.ndarray, size) -> Tuple[int, int]:
    w, h = (int(s) for s in size)
    if img.ndim not in (2, 3) or min(img.shape[:2]) < 1 or w < 1 or h < 1:
        raise ValueError(f"resize of a {img.shape} image to {(w, h)}")
    return w, h


def _area_taps(n_src: int, n_dst: int, clamp: bool):
    """cv2's INTER_AREA taps where it interpolates (an upscale on either
    axis): the source index floor(d * scale), the weight of the next
    sample float32((d + 1) - (i + 1) / scale) taken modulo 1 (0 where it is
    not positive); along x an index at the last sample is clamped with
    weight 0 -> (i0, i1, w0, w1)."""
    inv = n_dst / n_src
    d = np.arange(n_dst)
    i = np.floor(d * (1.0 / inv)).astype(np.int64)
    f = ((d + 1) - (i + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0.0), f - np.floor(f)).astype(np.float32)
    if clamp:
        hi = i >= n_src - 1
        f[hi], i[hi] = 0.0, n_src - 1
    return np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), np.float32(1.0) - f, f


def _two_tap_u8(img: np.ndarray, w: int, h: int, x_taps, y_taps) -> np.ndarray:
    """cv2's uint8 two-tap resize on the given taps: 11-bit weights, an
    exact pass along x, the vector rule's vertical pass (module doc)."""
    H, W = img.shape[:2]
    x0, x1, ax0, ax1 = x_taps
    y0, y1, ay0, ay1 = y_taps
    ax0, ax1, ay0, ay1 = (np.rint(a * np.float32(_COEF_ONE)).astype(np.int64)
                          for a in (ax0, ax1, ay0, ay1))
    src = img.reshape(H, W, -1).astype(np.int64)
    rows = (src[:, x0] * ax0[:, None] + src[:, x1] * ax1[:, None]).reshape(H, -1)
    hi0 = (np.clip(rows[y0] >> 4, -32768, 32767) * ay0[:, None]) >> 16
    hi1 = (np.clip(rows[y1] >> 4, -32768, 32767) * ay1[:, None]) >> 16
    out = np.clip((hi0 + hi1 + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def _check_u8(img, size, name: str) -> Tuple[np.ndarray, int, int]:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{name} takes uint8 images, not {img.dtype}")
    w, h = _check(img, size)
    return img, w, h


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_LINEAR) of a uint8
    (H, W) or (H, W, C) image; size is (width, height), as cv2 takes it."""
    img, w, h = _check_u8(img, size, "resize_linear_u8")
    H, W = img.shape[:2]
    return _two_tap_u8(img, w, h, _linear_taps(W, w, clamp=True),
                       _linear_taps(H, h, clamp=False))


def _area_tab(n_src: int, n_dst: int, scale: float):
    """cv2's computeResizeAreaTab as dense (n_dst, k) index and float32
    weight arrays, each row's taps in cv2's order (a partial first sample,
    the whole ones, a partial last), padded with weight-0 taps."""
    rows = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(math.floor(f2), n_src - 1)
        s1 = min(math.ceil(f1), s2)
        taps = [(s1 - 1, (s1 - f1) / cell)] if s1 - f1 > 1e-3 else []
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_dst, k), np.int64)
    wt = np.zeros((n_dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def resize_area_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_AREA) of a uint8 (H, W)
    or (H, W, C) image; size is (width, height), as cv2 takes it. cv2 5.0's
    three rules (module doc), bit-equal."""
    img, w, h = _check_u8(img, size, "resize_area_u8")
    H, W = img.shape[:2]
    if (w, h) == (W, H):
        return img.copy()
    sx, sy = 1.0 / (w / W), 1.0 / (h / H)
    if sx < 1 or sy < 1:  # an upscale on either axis: cv2 interpolates
        return _two_tap_u8(img, w, h, _area_taps(W, w, clamp=True),
                           _area_taps(H, h, clamp=False))
    src = img.reshape(H, W, -1)
    ix, iy = round(sx), round(sy)
    if abs(sx - ix) < _EPS and abs(sy - iy) < _EPS:  # integer ratios: box sums
        s = src.reshape(h, iy, w, ix, -1).astype(np.int64).sum((1, 3))
        if ix == iy == 2 and src.shape[2] in (1, 3, 4):
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32) * (np.float32(1.0) / np.float32(ix * iy)))
        return np.clip(out, 0, 255).astype(np.uint8).reshape((h, w) + img.shape[2:])
    xi, xw = _area_tab(W, w, sx)
    yi, yw = _area_tab(H, h, sy)
    f = src.astype(np.float32)
    rows = f[:, xi[:, 0]] * xw[None, :, 0, None]
    for j in range(1, xi.shape[1]):
        rows = rows + f[:, xi[:, j]] * xw[None, :, j, None]
    acc = rows[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):
        acc = acc + rows[yi[:, j]] * yw[:, j, None, None]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_LINEAR) of a float64
    image (what cv2 computes for one); size is (width, height)."""
    img = np.asarray(img, np.float64)
    w, h = _check(img, size)
    H, W = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(W, w, clamp=True, dtype=np.float64)
    y0, y1, ay0, ay1 = _linear_taps(H, h, clamp=False, dtype=np.float64)
    src = img.reshape(H, W, -1)
    rows = src[:, x0] * ax0[:, None] + src[:, x1] * ax1[:, None]
    out = rows[y0] * ay0[:, None, None] + rows[y1] * ay1[:, None, None]
    return out.reshape((h, w) + img.shape[2:])


def get_transform(center, scale, res, rot: float = 0.0) -> np.ndarray:
    """Affine map from original-image coords to the (res x res) crop
    (reference imutils.py:12-36)."""
    h = 200.0 * scale
    t = np.zeros((3, 3))
    t[0, 0] = res[1] / h
    t[1, 1] = res[0] / h
    t[0, 2] = res[1] * (-center[0] / h + 0.5)
    t[1, 2] = res[0] * (-center[1] / h + 0.5)
    t[2, 2] = 1.0
    if rot != 0:
        rad = -rot * np.pi / 180.0
        sn, cs = np.sin(rad), np.cos(rad)
        rot_mat = np.eye(3)
        rot_mat[0, :2] = [cs, -sn]
        rot_mat[1, :2] = [sn, cs]
        t_mat = np.eye(3)
        t_mat[0, 2] = -res[1] / 2
        t_mat[1, 2] = -res[0] / 2
        t_inv = t_mat.copy()
        t_inv[:2, 2] *= -1
        t = t_inv @ rot_mat @ t_mat @ t
    return t


def transform(pt, center, scale, res, invert: bool = False, rot: float = 0.0):
    """Map a 2-D point through the crop transform, truncating as the
    reference does (reference :38-45)."""
    t = get_transform(center, scale, res, rot)
    if invert:
        t = np.linalg.inv(t)
    out = t @ np.array([pt[0] - 1.0, pt[1] - 1.0, 1.0])
    return out[:2].astype(int) + 1


def crop(img: np.ndarray, center, scale, res: Tuple[int, int], rot: float = 0.0,
         resize_fn=None) -> np.ndarray:
    """Crop + resize around (center, scale) (reference :47-95), with the JAX
    package's arithmetic: corners in the reference's (row, col) argument
    order, the rotation pad from the box height, a float64 canvas.
    resize_fn(img, (rows, cols)) overrides the final resample, by default
    `resize_linear` (cv2's float64 INTER_LINEAR)."""
    ul = np.array(transform([1, 1], center, scale, res, invert=True)) - 1
    br = np.array(transform([res[0] + 1, res[1] + 1], center, scale, res, invert=True)) - 1
    pad = int(np.linalg.norm(br - ul) / 2 - float(br[1] - ul[1]) / 2)
    if rot != 0:
        ul -= pad
        br += pad
    new_shape = [br[1] - ul[1], br[0] - ul[0]]
    if img.ndim > 2:
        new_shape += [img.shape[2]]
    new_img = np.zeros(new_shape)
    new_x = max(0, -ul[0]), min(br[0], img.shape[1]) - ul[0]
    new_y = max(0, -ul[1]), min(br[1], img.shape[0]) - ul[1]
    old_x = max(0, ul[0]), min(img.shape[1], br[0])
    old_y = max(0, ul[1]), min(img.shape[0], br[1])
    if new_x[1] <= new_x[0] or new_y[1] <= new_y[0]:
        return np.zeros((res[0], res[1], *new_shape[2:]))
    new_img[new_y[0]:new_y[1], new_x[0]:new_x[1]] = img[old_y[0]:old_y[1], old_x[0]:old_x[1]]
    if rot != 0:
        import scipy.ndimage

        new_img = scipy.ndimage.rotate(new_img, rot)
        new_img = new_img[pad:-pad, pad:-pad]
    if resize_fn is not None:
        return resize_fn(new_img, (res[0], res[1]))
    return resize_linear(new_img, (res[1], res[0]))


def normalize_for_spin(img: np.ndarray) -> np.ndarray:
    """uint8/float [0,255] HWC -> ImageNet-normalized float32 HWC."""
    x = img.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0
    return (x - IMG_NORM_MEAN) / IMG_NORM_STD


def flip_img(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1].copy()


def flip_kp(kp: np.ndarray, perm=SMPL_JOINT_FLIP_PERM, width: Optional[float] = None):
    """Flip keypoints left/right (reference :144-152)."""
    kp = kp[..., perm, :].copy()
    kp[..., 0] = (width - kp[..., 0]) if width is not None else -kp[..., 0]
    return kp


def flip_pose(pose: np.ndarray) -> np.ndarray:
    """Flip a (72,) SMPL axis-angle vector left/right (reference :154-168)."""
    out = pose.reshape(-1, 24, 3)[:, SMPL_JOINT_FLIP_PERM].reshape(pose.shape).copy()
    out[..., 1::3] = -out[..., 1::3]
    out[..., 2::3] = -out[..., 2::3]
    return out


def _rodrigues_to_mat(r: np.ndarray) -> np.ndarray:
    """cv2.Rodrigues of an axis-angle 3-vector -> 3 x 3 (float64)."""
    theta = float(np.linalg.norm(r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    k = r / theta
    c, s = np.cos(theta), np.sin(theta)
    skew = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return c * np.eye(3) + (1 - c) * np.outer(k, k) + s * skew


def _rodrigues_to_vec(R: np.ndarray) -> np.ndarray:
    """cv2.Rodrigues of a 3 x 3 rotation -> its axis-angle (float64): R
    orthonormalised by its SVD first, the near-pi branch kept."""
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt(np.sum(r * r) * 0.25)
    c = np.clip((np.trace(R) - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s >= 1e-5:
        return r * (theta / (2 * s))
    if c > 0:
        return np.zeros(3)
    r = np.sqrt(np.maximum((np.diag(R) + 1) * 0.5, 0.0))
    r[1] *= -1.0 if R[0, 1] < 0 else 1.0
    r[2] *= -1.0 if R[0, 2] < 0 else 1.0
    if abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2]) and (R[1, 2] > 0) != (r[1] * r[2] > 0):
        r[2] = -r[2]
    return r * (theta / np.linalg.norm(r))


def rot_aa(aa: np.ndarray, rot: float) -> np.ndarray:
    """In-plane rotate the global orientation axis-angle (reference :124-135)."""
    rad = np.deg2rad(-rot)
    R = np.array([[np.cos(rad), -np.sin(rad), 0], [np.sin(rad), np.cos(rad), 0], [0, 0, 1]])
    mat = _rodrigues_to_mat(np.asarray(aa, np.float64).reshape(3))
    return _rodrigues_to_vec(R @ mat).astype(aa.dtype)
