"""Pose pools and image datasets for the GAN / SPIN-fine-tune loops (port of
posegen_tpu/gen/datasets.py).

Capability parity with the reference's data plumbing:
  * AMASS pose pool + repeated 3DPW validation 2-D targets
    (data_preparation, run_gan.py:2140-2154),
  * `pose_dataset` over NeRF-rendered (image, pose) pairs
    (run_gan.py:1634-1656),
  * `mpii_nerf_dataset` mixing MPII crops with renders at a 1:frac ratio
    (run_gan.py:1657-1720).

Host code, as in the JAX package: images are read by the port's readers
(`utils/images.read_image`: PNG, and baseline JPEG such as MPII's by the
port's own decoder), resized by cv2's uint8 INTER_LINEAR rule
(`data/imutils.resize_linear_u8`), and the pose targets come from
`gen/loop.fk_joints` on the CPU.
"""

from __future__ import annotations

import glob
import os
import warnings
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.data.imutils import normalize_for_spin, resize_linear_u8
from posegen_tpu_torch.gen.loop import fk_joints
from posegen_tpu_torch.utils.images import read_image


def _joints(bones: np.ndarray, pose_scale: float) -> np.ndarray:
    """(1, 24, 3) axis-angles -> (24, 3) float32 world joints, on the CPU."""
    return fk_joints(torch.as_tensor(np.asarray(bones, np.float32)), pose_scale)[0].numpy()


def load_amass_pool(path: str, subsample: int = 10) -> np.ndarray:
    """AMASS processed npz -> (N, 24, 3) axis-angle pool, 1/`subsample`
    (reference run_gan.py:2141-2142)."""
    data = np.load(path, allow_pickle=True)
    if hasattr(data, "files"):  # npz: 'pose3d' or fall back to the first array
        key = "pose3d" if "pose3d" in data.files else data.files[0]
        poses = np.asarray(data[key])
    else:  # plain .npy
        poses = np.asarray(data)
    poses = poses[::subsample]
    return poses.reshape(len(poses), -1)[:, : 24 * 3].reshape(-1, 24, 3).astype(np.float32)


def load_target_2d(path: str, repeats: int = 200) -> np.ndarray:
    """3DPW validation 2-D poses, tiled (reference run_gan.py:2145-2146)."""
    data = np.load(path, allow_pickle=True)
    t2d = np.asarray(data["pose2d"] if "pose2d" in data.files else data[data.files[0]])
    return np.repeat(t2d, repeats=repeats, axis=0).astype(np.float32)


def pose_batches(
    pool: np.ndarray, batch_size: int, seed: int = 0, drop_last: bool = True
) -> Iterator[np.ndarray]:
    """Shuffled epoch iterator over a pose pool."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(pool))
    end = len(perm) - (len(perm) % batch_size if drop_last else 0)
    for i in range(0, end, batch_size):
        yield pool[perm[i : i + batch_size]]


class RenderedPoseDataset:
    """(image, pose) pairs from the GAN's dataset sink
    (reference pose_dataset, run_gan.py:1634-1656): images at
    {dir}/image/%05d.png, poses at {dir}/poses_axis_angles*.npy.

    cache=True (default) keeps prepared (crop+resize+normalize) items in
    memory after first access (~600 KB an item at the default res; pass
    cache=False for giant sinks)."""

    def __init__(self, output_dir: str, crop: Tuple[int, int] = (100, 412),
                 res: int = 224, pose_scale: float = 0.4, cache: bool = True):
        self.img_dir = os.path.join(output_dir, "image")
        self.crop = crop
        self.res = res
        self.pose_scale = pose_scale
        self._cache: Optional[Dict[int, Dict[str, np.ndarray]]] = {} if cache else None
        pose_files = sorted(
            glob.glob(os.path.join(output_dir, "poses_axis_angles*.npy")),
            key=lambda p: int("".join(c for c in os.path.basename(p) if c.isdigit()) or 0),
        )
        self.bones = (np.concatenate([np.load(p) for p in pose_files]) if pose_files
                      else np.zeros((0, 24, 3), np.float32))
        n_pngs = len(glob.glob(os.path.join(self.img_dir, "*.png")))
        if self.bones.shape[0] != n_pngs:
            # a reused output_dir pairs fresh images with stale pose files
            # (the reference sink has the same hazard) — make it loud
            warnings.warn(
                f"RenderedPoseDataset: {n_pngs} pngs but "
                f"{self.bones.shape[0]} pose rows in {output_dir!r} — "
                "stale files from a previous run? (image, pose) pairs may "
                "be mismatched; clear the directory between runs",
                stacklevel=2,
            )
        self.n = min(len(self.bones), n_pngs)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        img = read_image(os.path.join(self.img_dir, f"{i:05d}.png"))[..., :3]
        lo, hi = self.crop
        img = resize_linear_u8(img[lo:hi, lo:hi], (self.res, self.res))
        item = {"image": normalize_for_spin(img),
                "pose": _joints(self.bones[i:i + 1], self.pose_scale)}
        if self._cache is not None:
            self._cache[i] = item
        return item

    def batches(self, batch_size: int = 32, seed: int = 0):
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self))
        for s in range(0, len(perm) - batch_size + 1, batch_size):
            items = [self[int(i)] for i in perm[s : s + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class MPIIPoseDataset:
    """MPII crops with SMPL pose annotations (reference mpii_nerf_dataset's
    MPII half, run_gan.py:1657-1692): square crop around (center, scale),
    FK'd 24-joint targets at pose_scale."""

    def __init__(self, annot_path: str, img_dir: str, res: int = 224,
                 pose_scale: float = 0.4):
        self.img_dir = img_dir
        self.res = res
        self.pose_scale = pose_scale
        d = np.load(annot_path, allow_pickle=True)
        self.pose = np.asarray(d["pose"], np.float32)
        self.imgname = [str(x) for x in d["imgname"]]
        self.center = np.asarray(d["center"], np.float32)
        self.scale = np.asarray(d["scale"], np.float32)

    def __len__(self) -> int:
        return len(self.imgname)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = read_image(os.path.join(self.img_dir, self.imgname[i]))[..., :3]
        c, s = self.center[i], self.scale[i] * 200.0
        x1 = int(np.clip(c[0] - s / 2, 0, img.shape[1]))
        x2 = int(np.clip(c[0] + s / 2, 0, img.shape[1]))
        y1 = int(np.clip(c[1] - s / 2, 0, img.shape[0]))
        y2 = int(np.clip(c[1] + s / 2, 0, img.shape[0]))
        patch = img[y1:y2, x1:x2]
        if patch.size == 0:
            patch = img
        patch = resize_linear_u8(patch, (self.res, self.res))
        return {"image": normalize_for_spin(patch),
                "pose": _joints(self.pose[i].reshape(1, 24, 3), self.pose_scale)}


class MixedSpinDataset:
    """1:(frac-1) MPII:NeRF mix (reference mpii_nerf_dataset,
    run_gan.py:1657 — defined but never instantiated there either: the
    reference's train_spin runs sequential NeRF-then-MPII phases per epoch,
    which spin_driver mirrors)."""

    def __init__(self, mpii: MPIIPoseDataset, nerf: RenderedPoseDataset, frac: int = 10):
        self.mpii = mpii
        self.nerf = nerf
        self.frac = frac

    def __len__(self) -> int:
        return min(len(self.nerf) * self.frac // max(self.frac - 1, 1),
                   len(self.mpii) * self.frac)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if idx % self.frac == 0:
            return self.mpii[(idx // self.frac) % len(self.mpii)]
        return self.nerf[(idx - idx // self.frac - 1) % len(self.nerf)]
