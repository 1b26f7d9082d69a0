"""Dataset catalog + loader dispatch (port of posegen_tpu/data/catalog.py).

Capability parity with reference core/load_data.py:22-143 (`DATASET_CATALOG`,
`load_data`, `get_dataset`): maps (dataset, subject) to an H5 path and builds
the ray loader + held-out render data. Paths are overridable via `data_root`
instead of the reference's hard-coded absolute paths.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from posegen_tpu_torch.data.h5dataset import ConcatRayDataset, H5RayDataset, RayBatchLoader

# dataset family -> subject -> relative h5 path (reference load_data.py:22-43)
DATASET_CATALOG: Dict[str, Dict[str, str]] = {
    "surreal": {"female": "surreal/surreal_{subject}_train.h5"},
    "h36m": {
        s: "h36m/{subject}_processed_deeplab_crop3.h5"
        for s in ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
    },
    "perfcap": {
        "weipeng": "MonoPerfCap/Weipeng_outdoor/Weipeng_outdoor_processed_h5py.h5",
        "nadia": "MonoPerfCap/Nadia_outdoor/Nadia_outdoor_processed_h5py.h5",
    },
    "mixamo": {
        c: "mixamo/{subject}_processed_h5py.h5"
        for c in ("james", "archer")
    },
    "zju": {
        s: "zju_mocap/{subject}_train_h5py.h5"
        for s in ("313", "315", "377", "386", "387", "390", "392", "393", "394")
    },
    "3dhp": {s: "3dhp/{subject}_processed.h5" for s in ("S1", "S2", "S3")},
    "synthetic": {"demo": "synthetic/demo.h5"},
}


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"
    subject: str = "demo"
    data_root: str = "data"
    n_rand: int = 3072
    n_sample_images: int = 64
    patch_size: int = 1
    n_box_rays: int = 0
    mask_image: bool = False
    white_bkgd: bool = False
    load_refined: Optional[str] = None
    multi_subjects: Optional[Sequence[str]] = None
    num_val_images: int = 2
    camera: Optional[int] = None
    n_cams: Optional[int] = None  # reference --N_cams surreal camera subset
    use_val: bool = False  # train/val sequence split (reference --use_val)
    multiview: bool = False
    subset_kps: Optional[str] = None  # --rand_train_kps kp-id .npy
    num_workers: int = 0
    seed: int = 0
    subject_idx: int = 0  # which subject's views to render for multi-subject
    #                       models (reference --subject_idx, run_render.py:60)
    process_index: int = 0  # multi-node input sharding: this node's index and
    process_count: int = 1  # the node count (parallel.mesh.node_index_count)


def resolve_h5_path(cfg: DataConfig, subject: Optional[str] = None) -> str:
    subject = subject or cfg.subject
    family = DATASET_CATALOG.get(cfg.dataset)
    if family is None or subject not in family:
        raise KeyError(f"unknown dataset/subject {cfg.dataset}/{subject}")
    rel = family[subject].format(subject=subject)
    return os.path.join(cfg.data_root, rel)


def load_data(
    cfg: DataConfig, pin_memory: bool = False
) -> Tuple[RayBatchLoader, Dict[str, Any], Dict[str, Any]]:
    """-> (loader, render_data, data_attrs), the reference's triple
    (load_data.py:71-84). `pin_memory`: the loader hands out batches in
    pinned host memory, for a CUDA trainer."""
    rays_per_image = max(cfg.n_rand // cfg.n_sample_images, 1)

    def make_ds(subject, seed, split=None, path=None):
        path = path or resolve_h5_path(cfg, subject)
        if cfg.dataset == "synthetic" and not os.path.exists(path):
            from posegen_tpu_torch.data.synthetic import make_synthetic_h5

            os.makedirs(os.path.dirname(path), exist_ok=True)
            make_synthetic_h5(path)
        return H5RayDataset(
            path,
            n_rays_per_image=rays_per_image,
            patch_size=cfg.patch_size,
            n_box_rays=cfg.n_box_rays,
            mask_image=cfg.mask_image,
            white_bkgd=cfg.white_bkgd,
            load_refined=cfg.load_refined,
            camera=cfg.camera,
            n_cams=cfg.n_cams,
            multiview=cfg.multiview,
            subset_kps=cfg.subset_kps,
            split=split,
            seed=seed,
        )

    def make_val_ds(subject):
        """--use_val: held-out views come from the val SPLIT (h36m-style
        sequence prefixes) or, for surreal, the sibling *_val.h5 file
        (reference load_data.py:117 + load_surreal.py:333)."""
        path = resolve_h5_path(cfg, subject)
        if cfg.dataset == "surreal":
            d, b = os.path.split(path)  # only the FILENAME swaps train->val
            val_path = os.path.join(d, b.replace("train", "val"))
            if not os.path.exists(val_path):
                raise FileNotFoundError(
                    f"--use_val: no surreal val file at {val_path}"
                )
            return make_ds(subject, cfg.seed + 7919, path=val_path)
        return make_ds(subject, cfg.seed + 7919, split="val")

    train_split = (
        "train" if (cfg.use_val and cfg.dataset != "surreal") else None
    )

    if cfg.multi_subjects:
        ds = ConcatRayDataset(
            [make_ds(s, cfg.seed + i, split=train_split)
             for i, s in enumerate(cfg.multi_subjects)]
        )
        if not 0 <= cfg.subject_idx < len(ds.datasets):
            raise ValueError(
                f"subject_idx {cfg.subject_idx} out of range for "
                f"{len(ds.datasets)} subjects"
            )
        base = ds.datasets[cfg.subject_idx]
        val_base = (
            make_val_ds(cfg.multi_subjects[cfg.subject_idx])
            if cfg.use_val else base
        )
    else:
        ds = base = make_ds(cfg.subject, cfg.seed, split=train_split)
        val_base = make_val_ds(cfg.subject) if cfg.use_val else base

    loader = RayBatchLoader(
        ds, n_images_per_batch=cfg.n_sample_images, seed=cfg.seed,
        num_workers=cfg.num_workers, pin_memory=pin_memory,
        process_index=cfg.process_index, process_count=cfg.process_count,
    )

    # held-out render/eval views: evenly spaced over the val source (the
    # TRAINING images unless --use_val supplies a real held-out split)
    val_idxs = np.unique(
        np.linspace(
            0,
            val_base.n_images - 1,
            min(max(cfg.num_val_images, 1), val_base.n_images),
            dtype=np.int64,
        )
    )
    render_data = val_base.get_render_data(list(val_idxs))
    if cfg.multi_subjects:
        # subject-local cam/kp idxs -> global framecode/pose rows (the same
        # offsets ConcatRayDataset applies to training batches) — without
        # the kp offset, --render_refined would index subject 0's refined
        # poses for subject k's views
        render_data["cam_idxs"] = (
            render_data["cam_idxs"] + np.int64(ds._cam_offsets[cfg.subject_idx])
        )
        render_data["kp_idxs"] = (
            render_data["kp_idxs"] + np.int64(ds._kp_offsets[cfg.subject_idx])
        )

    data_attrs = {
        "n_images": ds.n_images,
        "n_kps": ds.kp3d.shape[0] if hasattr(ds, "kp3d") else base.kp3d.shape[0],
        "n_framecodes": int(base.cam_idxs.max()) + 1
        if not cfg.multi_subjects
        else int(ds._cam_offsets[-1]),
        "rest_pose": base.rest_pose,
        "ext_scale": base.ext_scale,
        "hwf": (base.H, base.W, base.focals),
        "bones": ds.bones if hasattr(ds, "bones") else base.bones,
        "kp3d": ds.kp3d if hasattr(ds, "kp3d") else base.kp3d,
        "kp_map": getattr(base, "kp_map", None),
        "kp_uidxs": getattr(base, "kp_uidxs", None),
    }
    return loader, render_data, data_attrs
