"""Offline person-mask extraction (port of posegen_tpu/data/masks.py).

The reference builds H36M / PerfCap masks with TensorFlow DeepLab-v3
(core/process_mask.py). Extraction runs in preference order:

  1. a segmentation callable (`deeplab_segmenter`: the port's DeepLab-v3,
     data/segmenter.py, or any other),
  2. background differencing against per-camera plates (static
     backgrounds, the reference's use case) with morphological cleanup,
  3. neither: a clear error, no silent fallback.

The JAX package cleans the differenced masks with cv2; the port computes
cv2's rules in numpy / scipy.ndimage, bit-equal:
  * morphologyEx OPEN is an erosion then a dilation, CLOSE a dilation then
    an erosion, by a square k x k window whose anchor is k // 2 (so an even
    k reaches k // 2 back and k - 1 - k // 2 forward); outside the image an
    erosion reads the maximum and a dilation the minimum (cv2's default
    border value): `minimum_filter` with cval 1 and `maximum_filter` with
    cval 0 on the 0 / 1 mask;
  * connectedComponentsWithStats labels by 8-connectivity (`ndimage.label`
    with a 3 x 3 structure of ones); only each component's area is used,
    so the labels' order does not matter.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.ndimage as ndi


def morph_open(m: np.ndarray, k: int) -> np.ndarray:
    """cv2.morphologyEx(m, MORPH_OPEN, ones((k, k))) of a 0 / 1 uint8 mask."""
    m = ndi.minimum_filter(m, size=k, mode="constant", cval=1)
    return ndi.maximum_filter(m, size=k, mode="constant", cval=0)


def morph_close(m: np.ndarray, k: int) -> np.ndarray:
    """cv2.morphologyEx(m, MORPH_CLOSE, ones((k, k))) of a 0 / 1 uint8 mask."""
    m = ndi.maximum_filter(m, size=k, mode="constant", cval=0)
    return ndi.minimum_filter(m, size=k, mode="constant", cval=1)


def keep_large_components(m: np.ndarray, min_area: int) -> np.ndarray:
    """The 8-connected components of a 0 / 1 mask with at least min_area
    pixels (cv2.connectedComponentsWithStats' CC_STAT_AREA), as 0 / 1."""
    labels, n = ndi.label(m, structure=np.ones((3, 3), bool))
    area = np.bincount(labels.reshape(-1), minlength=n + 1)
    keep = area >= min_area
    keep[0] = False
    return keep[labels].astype(m.dtype)


def masks_from_background(
    imgs: np.ndarray,
    bkgd: np.ndarray,
    threshold: float = 25.0,
    open_kernel: int = 3,
    close_kernel: int = 7,
    min_area: int = 64,
) -> np.ndarray:
    """Foreground via |img - background| with morphological cleanup.

    imgs: (N, H, W, 3) uint8; bkgd: (H, W, 3) or (N, H, W, 3) uint8.
    Returns (N, H, W, 1) uint8.
    """
    imgs = np.asarray(imgs)
    bkgd = np.asarray(bkgd)
    if bkgd.ndim == 3:
        bkgd = bkgd[None]
    out = np.zeros((*imgs.shape[:3], 1), np.uint8)
    for i in range(imgs.shape[0]):
        diff = np.abs(
            imgs[i].astype(np.int16) - bkgd[min(i, len(bkgd) - 1)].astype(np.int16)
        ).max(-1)
        m = (diff > threshold).astype(np.uint8)
        m = morph_close(morph_open(m, open_kernel), close_kernel)
        out[i, ..., 0] = keep_large_components(m, min_area)
    return out


def deeplab_segmenter(
    weights_path: Optional[str] = None,
    person_class: int = 15,
    device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """The bundled person segmenter: the port's DeepLab-v3
    (data/segmenter.py, the analog of the reference's TF DeepLab), loading
    torchvision deeplabv3_resnet50 weights from a local .pth, on `device`."""
    from posegen_tpu_torch.data.segmenter import deeplab_person_segmenter

    return deeplab_person_segmenter(weights_path, person_class=person_class, device=device)


def extract_person_masks(
    imgs: np.ndarray,
    bkgd: Optional[np.ndarray] = None,
    segmenter: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    **kwargs,
) -> np.ndarray:
    """Dispatch: segmenter model > background differencing."""
    if segmenter is not None:
        masks = np.stack([np.asarray(segmenter(img)) for img in imgs])
        if masks.ndim == 3:
            masks = masks[..., None]
        return (masks > 0).astype(np.uint8)
    if bkgd is not None:
        return masks_from_background(imgs, bkgd, **kwargs)
    raise ValueError(
        "mask extraction needs either a `segmenter` callable (the reference "
        "uses TF DeepLab, core/process_mask.py) or background plates for "
        "differencing"
    )
