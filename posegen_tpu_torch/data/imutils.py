"""Image crop and resize on the host, in numpy (port of the parts of
posegen_tpu/data/imutils.py that gen/datasets.py reaches).

The JAX package resizes with `cv2.resize(..., interpolation=cv2.INTER_LINEAR)`;
the port imports no cv2 (it is not among the packages the card's machine
promises), so it computes cv2's own rule:
  * half-pixel centres, f = float32((d + 0.5) * src / dst - 0.5), the
    source index floor(f) and the weight f - floor(f); along x an index
    past either edge is clamped with weight 0, along y the weight stays and
    the rows are clipped to the image;
  * uint8 (`resize_linear_u8`): 11-bit fixed-point weights
    (round(w * 2048)), an exact integer pass along x, then the vertical pass
    as cv2's vector code computes it on every element: each row value
    shifted right by 4, multiplied by its weight keeping the high 16 bits,
    the two summed and rounded by (s + 2) >> 2 (cv2 5.0's build for x86
    applies this rule to the whole row; held bit-equal in
    tests/test_torch_gan_cli.py);
  * float (`resize_linear`): float64 weights and sums, cv2's float64 path
    (which `crop`'s float64 canvas takes) to within an ulp of the result:
    cv2 contracts one product into a fused multiply-add.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IMG_NORM_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_NORM_STD = np.array([0.229, 0.224, 0.225], np.float32)
_COEF_ONE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: 11-bit weights


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


def resize_linear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size, interpolation=cv2.INTER_LINEAR) of a uint8
    (H, W) or (H, W, C) image; size is (width, height), as cv2 takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear_u8 takes uint8 images, not {img.dtype}")
    w, h = _check(img, size)
    H, W = img.shape[:2]
    x0, x1, ax0, ax1 = _linear_taps(W, w, clamp=True)
    y0, y1, ay0, ay1 = _linear_taps(H, h, clamp=False)
    ax0, ax1, ay0, ay1 = (np.rint(a * np.float32(_COEF_ONE)).astype(np.int64)
                          for a in (ax0, ax1, ay0, ay1))
    src = img.reshape(H, W, -1).astype(np.int64)
    rows = (src[:, x0] * ax0[:, None] + src[:, x1] * ax1[:, None]).reshape(H, -1)
    hi0 = (np.clip(rows[y0] >> 4, -32768, 32767) * ay0[:, None]) >> 16
    hi1 = (np.clip(rows[y1] >> 4, -32768, 32767) * ay1[:, None]) >> 16
    out = np.clip((hi0 + hi1 + 2) >> 2, 0, 255).astype(np.uint8)
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
