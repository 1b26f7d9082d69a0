"""Host-side ray dataset + prefetching batch loader (port of
posegen_tpu/data/h5dataset.py).

Capability parity with the reference's BaseH5Dataset / RayImageSampler /
ray_collate_fn (core/dataset.py:20-543, 730-802):

  * Metadata (poses, cameras, cylinders, pixel-dir table) lives in RAM,
    read through the port's own HDF5 reader (data/hdf5.py); image pixels
    are read from one np.memmap of the file at the reader's row offsets
    (each image is one contiguous byte range in the files the writers
    produce). Compressed or foreign files take the numpy path on the
    reader's decoded arrays.
  * Every batch has a FIXED shape: N_images x rays_per_image pixels,
    flattened to (N_rand, ...); batches hold the JAX loader's keys, dtypes
    and values for the same file and seed.
  * Sampling is numpy RNG on the host (the native sampler, data/native.py,
    on the common configuration); the device only ever sees dense arrays.
  * A background thread (or worker processes) keeps a small queue of ready
    batches; with `pin_memory` the loader hands out pinned host tensors for
    non-blocking uploads (the reference's DataLoader(num_workers=16,
    pin_memory=True), core/load_data.py:78-80).

Variants of the reference are expressed as flags: patch sampling
(`patch_size`), in-box background sampling (`n_box_rays`, the reference's
"nms" samples, dataset.py:324-344), mask-only sampling, and multi-subject
concatenation (`ConcatH5Dataset` analog via `ConcatRayDataset`).
"""

from __future__ import annotations

import os
import queue
import sys
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from posegen_tpu_torch.data import native
from posegen_tpu_torch.data.hdf5 import H5File

# the image-like datasets whose rows the loader reads through the memmap
IMAGE_KEYS = ("imgs", "masks", "sampling_masks", "bkgds")

# --use_val validation sequences, matched by name prefix
# (reference load_h36m.py:384 val_sets)
VAL_SEQ_PREFIXES = ("Greeting-", "Walking-", "Posing-")


class H5RayDataset:
    """One subject's H5 file; samples pixels/rays per image."""

    def __init__(
        self,
        h5_path: str,
        n_rays_per_image: int = 48,
        patch_size: int = 1,
        n_box_rays: int = 0,
        mask_image: bool = False,
        white_bkgd: bool = False,
        load_refined: Optional[str] = None,
        camera: Optional[int] = None,
        n_cams: Optional[int] = None,
        multiview: bool = False,
        subset_kps=None,
        split: Optional[str] = None,  # None/'train'/'val' (--use_val)
        seed: int = 0,
    ):
        self.h5_path = h5_path
        self.camera = camera
        self.n_rays = n_rays_per_image
        self.patch_size = patch_size
        self.n_box_rays = n_box_rays
        self.mask_image = mask_image
        self.white_bkgd = white_bkgd
        self.rng = np.random.default_rng(seed)
        self._arrays: Dict[str, np.ndarray] = {}  # decoded image-like datasets

        f = H5File(h5_path)
        try:
            keys = f.datasets
            read = f.read
            img_shape = read("img_shape")
            self.H, self.W = int(img_shape[0]), int(img_shape[1])
            self.n_images = keys["imgs"].shape[0]
            self.kp3d = read("kp3d").astype(np.float32)
            self.bones = read("bones").astype(np.float32)
            self.skts = read("skts").astype(np.float32)
            self.cyls = read("cyls").astype(np.float32)
            self.rest_pose = read("rest_pose").astype(np.float32)
            self.c2ws = read("c2ws").astype(np.float32)
            self.focals = read("focals").astype(np.float32)
            self.centers = read("centers").astype(np.float32) if "centers" in keys else None
            self.kp_idxs = (
                read("kp_idxs").astype(np.int64)
                if "kp_idxs" in keys
                else np.arange(self.n_images)
            )
            self.cam_idxs = (
                read("cam_idxs").astype(np.int64)
                if "cam_idxs" in keys
                else np.arange(self.n_images)
            )
            self.bkgd_idxs = (
                read("bkgd_idxs").astype(np.int64)
                if "bkgd_idxs" in keys
                else np.zeros(self.n_images, np.int64)
            )
            self.has_bkgd = "bkgds" in keys
            self.ext_scale = float(read("ext_scale")[()]) if "ext_scale" in keys else 0.001
            self._img_paths = read("img_paths") if "img_paths" in keys else None
            # per-row file offsets of the uncompressed image-like datasets
            # (read through one np.memmap, opened lazily) and their row shapes
            self._filemap = None
            self._offsets: Dict[str, np.ndarray] = {}
            self._row_shape: Dict[str, tuple] = {}
            for name in IMAGE_KEYS:
                if name in keys:
                    self._row_shape[name] = tuple(keys[name].shape[1:])
                    offs = f.row_offsets(name)
                    if offs is not None:
                        self._offsets[name] = offs
            # the native batch assembler's fast path: every image dataset
            # (and the backgrounds, when present) in the memmap
            self._row_offs: Optional[Dict[str, np.ndarray]] = None
            self._sidx_off = None  # (byte_off, (N+1,) elem offsets) valid lists
            self._init_fast(f)
        finally:
            f.close()

        # image subsetting (reference --camera single-camera variants,
        # load_h36m.py camera_name; --rand_train_kps kp-subset files,
        # load_surreal.py:320-364): remap per-image metadata and keep a
        # file-row map for the pixel reads
        self._img_map = None
        if split in ("train", "val"):
            # --use_val train/val split by sequence-name prefix (reference
            # H36MDataset init_meta, load_h36m.py:384-417: val_sets
            # Greeting-/Walking-/Posing- matched on img_paths[i].split('/')[1])
            if self._img_paths is None:
                raise ValueError(
                    "use_val needs img_paths in the H5 to split sequences "
                    "(reference load_h36m.py:384-417); surreal instead uses "
                    "a sibling *_val.h5 file"
                )
            def _seq(p):
                parts = os.fsdecode(p).split("/")
                return parts[1] if len(parts) > 1 else parts[0]

            is_val = np.asarray(
                [any(_seq(p).startswith(v) for v in VAL_SEQ_PREFIXES)
                 for p in self._img_paths]
            )
            sel = np.flatnonzero(is_val if split == "val" else ~is_val)
            if sel.size == 0:
                raise ValueError(
                    f"use_val: the '{split}' split selects no images "
                    f"(val prefixes: {VAL_SEQ_PREFIXES})"
                )
            self._select_images(sel)
        if camera is not None:
            sel = np.flatnonzero(self.cam_idxs == camera)
            if sel.size == 0:
                raise ValueError(
                    f"camera {camera} selects no images (cam ids: "
                    f"{np.unique(self.cam_idxs)})"
                )
            self._select_images(sel)
        if n_cams is not None:
            uniq = np.unique(self.cam_idxs)
            if n_cams < uniq.size:
                # the reference's --N_cams camera subset is the FIXED trio
                # [0, 3, 6] whenever fewer than all cameras are requested
                # (load_surreal.py:364 selected_cams, ignoring the actual
                # count); honor that for n_cams = 3 and take its prefix for
                # smaller counts
                keep = np.asarray([0, 3, 6])[:n_cams]
                sel = np.flatnonzero(np.isin(self.cam_idxs, keep))
                if sel.size == 0:
                    raise ValueError(
                        f"--N_cams={n_cams} (cameras {keep.tolist()}) selects "
                        f"no images (cam ids: {uniq})"
                    )
                self._select_images(sel)
        if subset_kps is not None:
            keys = (
                np.load(subset_kps) if isinstance(subset_kps, str)
                else np.asarray(subset_kps)
            )
            sel = np.flatnonzero(np.isin(self.kp_idxs, np.unique(keys)))
            if sel.size == 0:
                raise ValueError("subset_kps selects no images")
            self._select_images(sel)

        if self._img_map is not None and self._img_paths is not None:
            self._img_paths = self._img_paths[self._img_map]

        # per-image temporal validity for --use_temp_loss (reference
        # get_temporal_validity, load_h36m.py:290-304: frame i is valid iff
        # its PREVIOUS frame belongs to the same sequence directory;
        # perfcap's rule — all-ones except the first frame,
        # load_perfcap.py:84-85 — is the no-img_paths fallback). temp_val is
        # the TemporalDatasetWrapper form (dataset.py:723-727): both the
        # prev and next edges must be valid.
        valid = np.ones(self.n_images, np.float32)
        valid[0] = 0.0
        if self._img_paths is not None:
            dirs = [os.path.dirname(os.fsdecode(p)) for p in self._img_paths]
            for i in range(1, self.n_images):
                if dirs[i] != dirs[i - 1]:
                    valid[i] = 0.0
        self.temp_validity = valid
        self.temp_val = (valid + np.roll(valid, -1)).astype(np.int64) // 2

        # multiview pose sharing (reference _load_multiview_pose,
        # load_h36m.py:422-431): frames of the same motion set map onto
        # shared pose rows; non-root joints averaged across views
        self.kp_map = self.kp_uidxs = None
        if multiview:
            if self._img_paths is None:
                raise ValueError("--multiview needs img_paths in the H5")
            if self._img_map is not None:
                raise ValueError(
                    "image subsets (--use_val/--camera/--N_cams/"
                    "--rand_train_kps) cannot combine with --multiview — "
                    "the reference raises the same way ('Subset is not "
                    "supported for multiview optimization', dataset.py:198)"
                )
            if self.kp3d.shape[0] != self.n_images:
                raise ValueError(
                    "multiview expects one pose row per image "
                    "(reference asserts no idx_map, dataset.py:198)"
                )
            from posegen_tpu_torch.data.multiview import map_data_to_n_views

            (self.kp_map, self.kp_uidxs, self.kp3d, self.bones,
             self.skts) = map_data_to_n_views(
                self._img_paths, self.kp3d, self.bones, self.rest_pose
            )

        if load_refined is not None:
            self._load_refined(load_refined)

        # precomputed camera-frame pixel directions (reference init_meta,
        # dataset.py:125-182): one (H, W, 3) table reused by every image
        self._pixel_dirs = self._make_pixel_dirs()

    def _select_images(self, sel: np.ndarray) -> None:
        """Keep the `sel` image rows (composable: camera + kp subsets)."""
        self._img_map = sel if self._img_map is None else self._img_map[sel]
        self.n_images = sel.size
        self.c2ws = self.c2ws[sel]
        if self.focals.ndim:
            self.focals = self.focals[sel]
        if self.centers is not None:
            self.centers = self.centers[sel]
        self.kp_idxs = self.kp_idxs[sel]
        self.cam_idxs = self.cam_idxs[sel]
        self.bkgd_idxs = self.bkgd_idxs[sel]

    def __getstate__(self):
        # picklable for loader worker processes: drop the memmap and the
        # decoded arrays (reopened lazily in the child)
        state = dict(self.__dict__)
        state["_filemap"] = None
        state["_arrays"] = {}
        return state

    # -- zero-copy batch assembly ------------------------------------------
    def _init_fast(self, f: H5File) -> None:
        """Enable the native batch assembler when every image dataset is
        uncompressed uint8 with contiguous rows (the files the writers
        produce); compressed or foreign files keep the numpy path."""
        if not {"imgs", "masks", "sampling_masks"} <= set(self._offsets):
            return
        if self.has_bkgd and "bkgds" not in self._offsets:
            return
        self._row_offs = self._offsets
        # optional ingest-time valid-pixel index lists (data/writer.py)
        if "sampling_idxs" in f.datasets and "sampling_idx_offsets" in f.datasets:
            off = f.data_offset("sampling_idxs")
            if off is not None and f.datasets["sampling_idxs"].dtype == np.dtype("<i4"):
                self._sidx_off = (int(off), f.read("sampling_idx_offsets").astype(np.int64))

    @property
    def filemap(self) -> Optional[np.memmap]:
        if self._filemap is None and self._offsets:
            self._filemap = np.memmap(self.h5_path, dtype=np.uint8, mode="r")
        return self._filemap

    def _rows(self, name: str, rows) -> np.ndarray:
        """Rows of an image-like dataset (a copy): from the memmap at the
        reader's row offsets, else from the reader's decoded array."""
        rows = np.asarray(rows, np.int64)
        offs = self._offsets.get(name)
        if offs is None:
            if name not in self._arrays:
                with H5File(self.h5_path) as f:
                    self._arrays[name] = f.read(name)
            return self._arrays[name][rows]
        shape = self._row_shape[name]
        n = int(np.prod(shape))
        fm = self.filemap
        return np.stack([fm[offs[r]:offs[r] + n].reshape(shape) for r in rows.reshape(-1)]
                        ).reshape(*rows.shape, *shape)

    def sample_batch(self, idxs, seed: int) -> Optional[Dict[str, np.ndarray]]:
        """Assemble a whole (G * rays_per_image) batch in ONE native call
        over the mmapped file; None when the fast path does not apply."""
        if (
            self._row_offs is None
            or self.patch_size > 1
            or self.n_box_rays > 0
            or self.centers is not None
        ):
            return None
        if native.get_lib() is None or self.filemap is None:
            return None
        idxs = np.asarray(idxs, np.int64)
        rows = self._img_map[idxs] if self._img_map is not None else idxs
        base = self.filemap.ctypes.data
        offs = self._row_offs
        img_addr = (base + offs["imgs"][rows]).astype(np.uint64)
        mask_addr = (base + offs["masks"][rows]).astype(np.uint64)
        smask_addr = (base + offs["sampling_masks"][rows]).astype(np.uint64)
        bkgd_addr = (
            (base + offs["bkgds"][self.bkgd_idxs[idxs]]).astype(np.uint64)
            if self.has_bkgd
            else None
        )
        valid_addr = valid_cnt = None
        if self._sidx_off is not None:
            byte0, eoffs = self._sidx_off
            valid_addr = (base + byte0 + 4 * eoffs[rows]).astype(np.uint64)
            valid_cnt = (eoffs[rows + 1] - eoffs[rows]).astype(np.int64)

        focals = self.focals
        if focals.ndim == 0:
            fx = np.full(len(idxs), float(focals), np.float32)
            fy = fx
        elif focals.ndim == 1:
            fx = focals[idxs].astype(np.float32)
            fy = fx
        else:
            fx = focals[idxs, 0].astype(np.float32)
            fy = focals[idxs, 1].astype(np.float32)

        out = native.assemble_batch(
            img_addr, mask_addr, smask_addr, bkgd_addr, valid_addr, valid_cnt,
            self._pixel_dirs.reshape(-1, 3),
            self.c2ws[idxs][:, :3, :4].reshape(len(idxs), 12),
            fx, fy, self.H * self.W,
            self.n_rays, seed,
        )
        target, fg, bg = out["target_s"], out["fgs"], out["bgs"]
        if self.white_bkgd and not self.has_bkgd:
            bg = np.ones_like(bg)
        if self.mask_image or self.white_bkgd:
            target = target * fg + bg * (1.0 - fg)
        kp_rows = self.kp_idxs[idxs]
        n_rays = self.n_rays
        return {
            "rays_o": out["rays_o"],
            "rays_d": out["rays_d"],
            "target_s": target,
            "fgs": fg,
            "bgs": bg,
            "kp3d": self.kp3d[kp_rows],
            "bones": self.bones[kp_rows],
            "skts": self.skts[kp_rows],
            "cyls": self.cyls[kp_rows],
            "kp_idx": kp_rows.astype(np.int32),
            "temp_val": self.temp_val[idxs].astype(np.float32),
            "cam_idxs": np.repeat(
                self.cam_idxs[idxs].astype(np.int32), n_rays
            )[:, None],
        }

    # -- reference PoseRefinedDataset (dataset.py:544-568) ------------------
    def _load_refined(self, ckpt_path: str):
        """Overwrite poses with refined ones from a pose checkpoint
        (native .npz from save_checkpoint or a torch .tar), on the host."""
        import torch

        from posegen_tpu_torch.pose.opt import pose_params_to_pose_data
        from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
        from posegen_tpu_torch.train.checkpoints import load_pose_params

        # load_pose_params keeps every key — multiview checkpoints carry
        # {'pelvis', 'root_bones', 'bones'} and need the dataset's kp_map
        # to expand the shared bone table back to per-frame rows
        pose_params = load_pose_params(ckpt_path, device="cpu")
        kp_map = getattr(self, "kp_map", None)
        data = pose_params_to_pose_data(
            {k: v.detach().float() for k, v in pose_params.items()},
            torch.as_tensor(self.rest_pose),
            kp_map=None if kp_map is None else torch.as_tensor(kp_map),
        )
        self.kp3d = data["kp3d"]
        self.bones = np.asarray(data["bones"])
        self.skts = data["skts"]
        with torch.no_grad():
            self.cyls = get_kp_bounding_cylinder(
                torch.as_tensor(self.kp3d), ext_scale=self.ext_scale).numpy().astype(np.float32)

    def _make_pixel_dirs(self) -> np.ndarray:
        i, j = np.meshgrid(
            np.arange(self.W, dtype=np.float32),
            np.arange(self.H, dtype=np.float32),
            indexing="xy",
        )
        cx, cy = self.W * 0.5, self.H * 0.5
        # focal applied per-image at sample time (focals can vary)
        return np.stack([i - cx, -(j - cy), -np.ones_like(i)], axis=-1)

    def _sample_pixels(self, smask: np.ndarray) -> np.ndarray:
        """Flat pixel indices for one image (reference sample_pixels,
        dataset.py:277-344)."""
        valid = np.flatnonzero(smask.reshape(-1) > 0)
        if valid.size == 0:
            valid = np.arange(self.H * self.W)
        n_fg = self.n_rays - self.n_box_rays
        if self.patch_size > 1:
            # patch sampling: pick top-left corners, expand to patches
            n_patches = max(n_fg // (self.patch_size**2), 1)
            corners = self.rng.choice(valid, size=n_patches)
            ys, xs = corners // self.W, corners % self.W
            ys = np.clip(ys, 0, self.H - self.patch_size)
            xs = np.clip(xs, 0, self.W - self.patch_size)
            dy, dx = np.meshgrid(
                np.arange(self.patch_size), np.arange(self.patch_size), indexing="ij"
            )
            idx = ((ys[:, None, None] + dy) * self.W + xs[:, None, None] + dx).reshape(-1)
            idx = idx[: n_fg]
        else:
            idx = self.rng.choice(valid, size=n_fg, replace=valid.size < n_fg)
        if self.n_box_rays > 0:
            # in-box samples outside the mask (reference _sample_in_box2d)
            ys, xs = np.nonzero(smask[..., 0] > 0)
            if ys.size:
                y0, y1 = ys.min(), ys.max() + 1
                x0, x1 = xs.min(), xs.max() + 1
            else:
                y0, y1, x0, x1 = 0, self.H, 0, self.W
            by = self.rng.integers(y0, y1, self.n_box_rays)
            bx = self.rng.integers(x0, x1, self.n_box_rays)
            idx = np.concatenate([idx, by * self.W + bx])
        return idx

    def sample_image(self, img_idx: int) -> Dict[str, np.ndarray]:
        """Sample rays/targets from one image -> dict of (n_rays, ...).

        Uses the native C++ sampler (data/csrc/host_sampler.cpp) for the common
        configuration; falls back to the numpy path for patch/box sampling
        and principal-point offsets.
        """
        native = self._sample_image_native(img_idx)
        if native is not None:
            return native
        row = int(self._img_map[img_idx]) if self._img_map is not None else img_idx
        img = self._rows("imgs", row).reshape(-1, 3).astype(np.float32) / 255.0
        mask = self._rows("masks", row).reshape(-1, 1).astype(np.float32)
        smask = self._rows("sampling_masks", row)

        pix = self._sample_pixels(np.asarray(smask))
        c2w = self.c2ws[img_idx]
        focal = self.focals[img_idx] if self.focals.ndim else float(self.focals)
        fx = focal if np.ndim(focal) == 0 else focal[0]
        fy = fx if np.ndim(focal) == 0 else focal[1]

        dirs = self._pixel_dirs.reshape(-1, 3)[pix].copy()
        if self.centers is not None:
            cx, cy = self.centers[img_idx]
            dirs[:, 0] += self.W * 0.5 - cx
            dirs[:, 1] -= self.H * 0.5 - cy
        dirs[:, 0] /= fx
        dirs[:, 1] /= fy
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()

        target = img[pix]
        fg = mask[pix]
        if self.has_bkgd:
            bkgd = self._rows("bkgds", self.bkgd_idxs[img_idx]).reshape(-1, 3)
            bg = bkgd[pix].astype(np.float32) / 255.0
        elif self.white_bkgd:
            bg = np.ones_like(target)
        else:
            bg = np.zeros_like(target)
        if self.mask_image or self.white_bkgd:
            target = target * fg + bg * (1.0 - fg)

        kp_i = int(self.kp_idxs[img_idx])
        n = pix.shape[0]
        # pose arrays are PER-IMAGE rows (leading dim 1): batches concatenate
        # them to (n_images, ...) and the trainer expands on device — sending
        # per-ray copies would ship ~256x redundant bytes to the accelerator
        return {
            "rays_o": rays_o.astype(np.float32),
            "rays_d": rays_d.astype(np.float32),
            "target_s": target,
            "fgs": fg,
            "bgs": bg,
            "kp3d": self.kp3d[kp_i : kp_i + 1],
            "bones": self.bones[kp_i : kp_i + 1],
            "skts": self.skts[kp_i : kp_i + 1],
            "cyls": self.cyls[kp_i : kp_i + 1],
            "kp_idx": np.full((1,), kp_i, np.int32),  # per image GROUP
            "temp_val": np.full((1,), self.temp_val[img_idx], np.float32),
            "cam_idxs": np.full((n, 1), self.cam_idxs[img_idx], np.int32),
        }

    def _sample_image_native(self, img_idx: int) -> Optional[Dict[str, np.ndarray]]:
        """C++ fast path: scan+draw+gather in one native call."""
        if self.patch_size > 1 or self.n_box_rays > 0 or self.centers is not None:
            return None
        if native.get_lib() is None:
            return None
        row = int(self._img_map[img_idx]) if self._img_map is not None else img_idx
        img = self._rows("imgs", row).reshape(-1, 3)
        mask = self._rows("masks", row).reshape(-1)
        smask = self._rows("sampling_masks", row).reshape(-1)
        focal = self.focals[img_idx] if self.focals.ndim else float(self.focals)
        fx = focal if np.ndim(focal) == 0 else focal[0]
        fy = fx if np.ndim(focal) == 0 else focal[1]
        bkgd = (
            self._rows("bkgds", self.bkgd_idxs[img_idx]).reshape(-1, 3)
            if self.has_bkgd
            else None
        )
        out = native.sample_and_gather(
            smask, img, mask, self._pixel_dirs.reshape(-1, 3),
            self.c2ws[img_idx], float(fx), float(fy),
            self.n_rays, int(self.rng.integers(0, 2**63 - 1)), bkgd=bkgd,
        )
        target, fg, bg = out["target_s"], out["fgs"], out["bgs"]
        if self.white_bkgd and not self.has_bkgd:
            bg = np.ones_like(bg)
        if self.mask_image or self.white_bkgd:
            target = target * fg + bg * (1.0 - fg)
        kp_i = int(self.kp_idxs[img_idx])
        n = self.n_rays
        return {
            "rays_o": out["rays_o"],
            "rays_d": out["rays_d"],
            "target_s": target,
            "fgs": fg,
            "bgs": bg,
            "kp3d": self.kp3d[kp_i : kp_i + 1],
            "bones": self.bones[kp_i : kp_i + 1],
            "skts": self.skts[kp_i : kp_i + 1],
            "cyls": self.cyls[kp_i : kp_i + 1],
            "kp_idx": np.full((1,), kp_i, np.int32),  # per image GROUP
            "temp_val": np.full((1,), self.temp_val[img_idx], np.float32),
            "cam_idxs": np.full((n, 1), self.cam_idxs[img_idx], np.int32),
        }

    def get_render_data(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        """Full-image eval data (reference get_render_data, dataset.py:490)."""
        idxs = list(idxs)
        rows = (
            [int(self._img_map[i]) for i in idxs]
            if self._img_map is not None
            else idxs
        )
        out = {
            "imgs": self._rows("imgs", rows).astype(np.float32) / 255.0,
            "masks": self._rows("masks", rows).astype(np.float32),
            "c2ws": self.c2ws[idxs],
            "focals": self.focals[idxs] if self.focals.ndim else self.focals,
            "kp3d": self.kp3d[self.kp_idxs[idxs]],
            "bones": self.bones[self.kp_idxs[idxs]],
            "skts": self.skts[self.kp_idxs[idxs]],
            "cyls": self.cyls[self.kp_idxs[idxs]],
            "cam_idxs": self.cam_idxs[idxs],
            "kp_idxs": self.kp_idxs[idxs],
            "hwf": (self.H, self.W, self.focals[idxs[0]] if self.focals.ndim else float(self.focals)),
        }
        if self.has_bkgd:
            out["bkgds"] = (
                self._rows("bkgds", self.bkgd_idxs[idxs]).astype(np.float32)
                / 255.0
            )
        return out

    def close(self):
        self._filemap = None
        self._arrays = {}


class ConcatRayDataset:
    """Multi-subject concatenation with index offsets
    (reference ConcatH5Dataset, dataset.py:570-693)."""

    def __init__(self, datasets: List[H5RayDataset]):
        self.datasets = datasets
        self.n_images = sum(d.n_images for d in datasets)
        self._offsets = np.cumsum([0] + [d.n_images for d in datasets])
        self._kp_offsets = np.cumsum([0] + [d.kp3d.shape[0] for d in datasets])
        self._cam_offsets = np.cumsum(
            [0] + [int(d.cam_idxs.max()) + 1 for d in datasets]
        )
        self.rest_pose = datasets[0].rest_pose
        self.kp3d = np.concatenate([d.kp3d for d in datasets])
        self.bones = np.concatenate([d.bones for d in datasets])

    def sample_image(self, img_idx: int) -> Dict[str, np.ndarray]:
        d_i = int(np.searchsorted(self._offsets, img_idx, side="right") - 1)
        local = img_idx - self._offsets[d_i]
        out = self.datasets[d_i].sample_image(int(local))
        out["kp_idx"] = out["kp_idx"] + np.int32(self._kp_offsets[d_i])
        out["cam_idxs"] = out["cam_idxs"] + np.int32(self._cam_offsets[d_i])
        out["subject_idxs"] = np.full_like(out["kp_idx"], d_i)
        return out

    def sample_batch(self, idxs, seed: int) -> Optional[Dict[str, np.ndarray]]:
        """Zero-copy path for multi-subject batches: one per-image native
        call into the owning child's mmapped file (ray order preserved)."""
        idxs = np.asarray(idxs, np.int64)
        parts = []
        for k, gi in enumerate(idxs):
            d_i = int(np.searchsorted(self._offsets, gi, side="right") - 1)
            local = int(gi - self._offsets[d_i])
            out = self.datasets[d_i].sample_batch(
                np.asarray([local]), seed + 9973 * k
            )
            if out is None:
                return None  # caller falls back to the per-image slow path
            out["kp_idx"] = out["kp_idx"] + np.int32(self._kp_offsets[d_i])
            out["cam_idxs"] = out["cam_idxs"] + np.int32(self._cam_offsets[d_i])
            out["subject_idxs"] = np.full_like(out["kp_idx"], d_i)
            parts.append(out)
        return {
            k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
        }


class RayBatchLoader:
    """Batches of N_images x rays_per_image flattened rays, prefetched.

    The iterator is infinite (training-style); every __next__ returns a dict
    of fixed-shape numpy arrays (reference RayImageSampler + ray_collate_fn,
    dataset.py:756-802).

    num_workers > 0 builds batches in worker PROCESSES (the reference's
    DataLoader(num_workers=16), load_data.py:78): at 512x512 the per-batch
    mask scans + pixel gathers are CPU-bound and a single thread caps
    training at a few it/s. Each worker reopens the H5 in-process; batch
    `bid` draws from (seed, bid) alone, whichever worker takes it, and
    batches are re-ordered by id, so the sequence is the same for any worker
    count > 0. (It is not the in-process sequence, which draws from the
    loader's own RNG.)

    Multi-host (process_count > 1, the JAX loader's rule,
    posegen_tpu/data/h5dataset.py:689-726): every node builds the same
    global image permutation (seeded identically) and takes its strided
    `process_index::process_count` slice of each epoch, so data-parallel
    nodes draw disjoint image subsets with no communication; the pixel
    stream is drawn from (seed, process_index) and the workers' seeds are
    offset by 100003 x process_index. One node (count 1) draws exactly what
    it drew before.

    pin_memory: every batch is handed out as a dict of CPU tensors in pinned
    (page-locked) memory, ready for `.to("cuda", non_blocking=True)`. Each
    batch gets freshly allocated pinned buffers: PyTorch's caching host
    allocator hands a freed block out again only after the copies recorded
    on it have finished, so no batch is overwritten while its upload is in
    flight.
    """

    def __init__(
        self,
        dataset,
        n_images_per_batch: int = 64,
        prefetch: int = 2,
        seed: int = 0,
        num_workers: int = 0,
        pin_memory: bool = False,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.pin_memory = pin_memory
        self.n_images = n_images_per_batch
        self.num_workers = num_workers
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.process_index = process_index
        self.process_count = process_count
        # image permutations and pixel draws: two streams, as the JAX loader
        # draws them; the permutation stream is the same on every node, the
        # pixel stream node-distinct
        self._perm_rng = np.random.default_rng(seed)
        self.rng = (np.random.default_rng(seed) if process_count == 1
                    else np.random.default_rng((seed, process_index)))
        self.seed = seed + 100003 * process_index
        self._perm: np.ndarray = np.array([], dtype=np.int64)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._procs: list = []
        self._task_q = self._result_q = None
        self._next_bid = 0
        self._emit_bid = 0
        self._hold: Dict[int, Dict[str, np.ndarray]] = {}

    def _next_idxs(self) -> np.ndarray:
        # full-permutation sampler (reference RandIntGenerator, dataset.py:730)
        while self._perm.size < self.n_images:
            epoch = self._perm_rng.permutation(self.dataset.n_images)
            if self.process_count > 1:  # this node's shard of the epoch
                epoch = epoch[self.process_index::self.process_count]
            self._perm = np.concatenate([self._perm, epoch])
        idxs, self._perm = self._perm[: self.n_images], self._perm[self.n_images :]
        return idxs

    def make_batch(self) -> Dict[str, np.ndarray]:
        return self._batch_for(self._next_idxs(), self.rng)

    def _batch_for(self, idxs, rng) -> Dict[str, np.ndarray]:
        fast = getattr(self.dataset, "sample_batch", None)
        if fast is not None:
            out = fast(idxs, int(rng.integers(0, 2**63 - 1)))
            if out is not None:
                return out
        parts = [self.dataset.sample_image(int(i)) for i in idxs]
        return {
            k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
        }

    def _pinned(self, batch: Dict[str, np.ndarray]):
        if not self.pin_memory:
            return batch
        import torch

        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}

    def _worker(self):
        while not self._stop.is_set():
            batch = self._pinned(self.make_batch())
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    # -- multiprocessing path ------------------------------------------------
    @staticmethod
    def _mp_worker(dataset, task_q, result_q, seed):
        """Build the batches of the tasks this worker takes. Batch `bid`
        draws from (seed, bid) alone, whichever worker takes it, so the
        sequence does not depend on the workers' race for tasks. (The JAX
        loader seeds each worker's draws from its index, so its batch
        depends on which worker took the task; its worker 0 draws what
        every worker draws here.)"""
        children = getattr(dataset, "datasets", None) or [dataset]
        for ds in children:
            ds._filemap = None  # reopened in this process
        while True:
            item = task_q.get()
            if item is None:
                return
            bid, idxs = item
            try:
                for w, ds in enumerate(children):
                    ds.rng = np.random.default_rng((seed, bid, w))
                fast = getattr(dataset, "sample_batch", None)
                batch = (
                    fast(idxs, seed * 600011 + bid) if fast is not None else None
                )
                if batch is None:
                    parts = [dataset.sample_image(int(i)) for i in idxs]
                    batch = {
                        k: np.concatenate([p[k] for p in parts], axis=0)
                        for k in parts[0]
                    }
            except Exception:  # surface the error in the parent, don't die
                import traceback

                result_q.put((bid, {"__error__": traceback.format_exc()}))
                continue
            result_q.put((bid, batch))

    def _start_procs(self):
        import multiprocessing as mp

        # a 1-core host cannot benefit from worker processes; fall back to
        # the in-process prefetch thread instead of oversubscribing
        usable = max((os.cpu_count() or 1) - 1, 0)
        self.num_workers = min(self.num_workers, usable)
        if self.num_workers == 0:
            return

        # never fork once CUDA is initialised: its driver state does not
        # survive fork. spawn re-imports this package (torch and numpy) in
        # each child.
        method = "fork"
        torch_mod = sys.modules.get("torch")
        if torch_mod is not None and torch_mod.cuda.is_initialized():
            method = "spawn"
        ctx = mp.get_context(method)
        self._task_q = ctx.Queue()
        # tasks are a few indices each: an interpreter that exits (on an
        # error, with workers gone) must not wait to flush them
        self._task_q.cancel_join_thread()
        self._result_q = ctx.Queue(maxsize=max(2 * self.num_workers, 4))
        for _ in range(self.num_workers):
            p = ctx.Process(
                target=self._mp_worker,
                args=(self.dataset, self._task_q, self._result_q, self.seed + 1),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
        # keep 2 tasks in flight per worker
        for _ in range(2 * self.num_workers):
            self._submit()

    def _submit(self):
        self._task_q.put((self._next_bid, self._next_idxs()))
        self._next_bid += 1

    def _next_mp(self) -> Dict[str, np.ndarray]:
        import queue as _q

        while self._emit_bid not in self._hold:
            try:
                bid, batch = self._result_q.get(timeout=5.0)
            except _q.Empty:
                # liveness check: a killed worker (OOM, signal) would
                # otherwise hang training forever instead of erroring
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} loader worker(s) died "
                        f"(exitcodes {[p.exitcode for p in dead]})"
                    )
                continue
            if isinstance(batch, dict) and "__error__" in batch:
                raise RuntimeError(
                    f"loader worker failed on batch {bid}:\n{batch['__error__']}"
                )
            self._hold[bid] = batch
        batch = self._hold.pop(self._emit_bid)
        self._emit_bid += 1
        self._submit()
        return self._pinned(batch)

    def __iter__(self):
        if self.num_workers > 0 and not self._procs:
            self._start_procs()  # may fall back to 0 on a 1-core host
        if self._procs:
            return self
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._procs:
            return self._next_mp()
        if self._thread is None:
            return self._pinned(self.make_batch())
        return self._q.get()

    def close(self):
        self._stop.set()
        if self._procs:
            for _ in self._procs:
                self._task_q.put(None)
            # drain so workers blocked on a full result queue can exit
            import queue as _q

            for p in self._procs:
                while p.is_alive():
                    try:
                        self._result_q.get(timeout=0.2)
                    except _q.Empty:
                        pass
                    p.join(timeout=0.2)
            self._procs = []
        if self._thread is not None:
            while not self._q.empty():
                self._q.get_nowait()
            self._thread.join(timeout=2.0)
            self._thread = None
