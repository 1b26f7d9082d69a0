"""H5 dataset writer (port of posegen_tpu/data/writer.py): the on-disk
schema every loader reads, written through the port's own HDF5 writer
(`data/hdf5.py`).

Schema (N images, J joints, C cameras):
  imgs            (N, H, W, 3) uint8        uncompressed
  masks           (N, H, W, 1) uint8        foreground
  sampling_masks  (N, H, W, 1) uint8        dilated fg (pixel sampler domain)
  kp3d            (N_kp, J, 3) f32          posed joints (world)
  bones           (N_kp, J, 3) f32          axis-angle
  skts            (N_kp, J, 4, 4) f32       world-to-local
  cyls            (N_kp, 5) f32             bounding cylinders
  rest_pose       (J, 3) f32
  c2ws            (N, 4, 4) f32             NeRF-convention camera-to-world
  focals          (N,) or (N, 2) f32
  centers         (N, 2) f32 (optional)     principal points
  bkgds           (C, H, W, 3) uint8        per-camera background plates
  bkgd_idxs       (N,) i64                  image -> background
  kp_idxs         (N,) i64                  image -> pose row
  cam_idxs        (N,) i64                  image -> camera/framecode row
  img_shape       (3,) i64                  [H, W, 3]
  ext_scale       () f32
  sampling_idxs   (sum of valid pixels,) i32  each image's valid flat pixels
  sampling_idx_offsets  (N + 1,) i64          their offsets

The JAX writer stores the image-like datasets in per-image chunks; this one
stores every dataset contiguously, so each image is still one contiguous
byte range of the file (and the JAX loader takes its unchunked fast path on
these files).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from posegen_tpu_torch.data.hdf5 import write_h5


def write_pose_h5(path: str, data: Dict[str, np.ndarray]) -> str:
    """Write the dataset dict, with the per-image sampling-mask valid-pixel
    index lists (`sampling_idxs` int32 ragged concat + `sampling_idx_offsets`)
    that let the native batch assembler skip the per-batch mask scans."""
    out = {k: np.asarray(v) for k, v in data.items()}
    out["img_shape"] = np.asarray(out["imgs"].shape[1:], dtype=np.int64)
    if "sampling_masks" in out and "sampling_idxs" not in out:
        sm = out["sampling_masks"]
        flat = sm.reshape(sm.shape[0], -1)
        lists = [np.flatnonzero(r > 0).astype(np.int32) for r in flat]
        offsets = np.zeros(len(lists) + 1, np.int64)
        np.cumsum([len(l) for l in lists], out=offsets[1:])
        out["sampling_idxs"] = np.concatenate(lists) if offsets[-1] else np.empty(0, np.int32)
        out["sampling_idx_offsets"] = offsets
    return write_h5(path, out)


def dilate_masks(masks: np.ndarray, kernel: int = 5, iters: int = 2) -> np.ndarray:
    """Grow fg masks so the sampler sees boundary pixels
    (reference process_spin.py uses cv2.dilate on sampling masks)."""
    import scipy.ndimage as ndi

    out = np.empty_like(masks)
    structure = np.ones((kernel, kernel), dtype=bool)
    for i in range(masks.shape[0]):
        m = masks[i, ..., 0] > 0
        out[i, ..., 0] = ndi.binary_dilation(m, structure, iterations=iters)
    return out.astype(masks.dtype)
