"""Raw-archive dataset ingestion: walk real dataset downloads -> standard H5
(port of posegen_tpu/data/ingest.py).

  * SURREAL  : seq-dir glob + metadata.pkl + segm .mat + png sequences
               (reference core/load_surreal.py:98-300 process_surreal_data)
  * H36M     : SPIN-estimate h5 + DeepLab mask h5 + per-camera backgrounds +
               image files (reference core/load_h36m.py:114-250
               process_h36m_data; read_spin_data core/process_spin.py:14-43)
  * PerfCap, Mixamo, 3DHP : SPIN-estimate h5 + image / mask trees
  * ZJU      : annots.npy cameras + EasyMocap SMPL params + masks, including
               the get_smpls parameter/coordinate conversion through an SMPL
               forward pass (reference core/load_zju.py:70-330)

CLI (on the card):
    python -m posegen_tpu_torch.data.ingest {surreal,h36m,zju,perfcap,mixamo,3dhp} RAW_DIR OUT.h5
On the CPU, in-process: `main([...], device="cpu")`.

The files are read by the port's own codecs (`utils/images.read_image`,
`data/hdf5.py`; `scipy.io.loadmat` and `pickle` for SURREAL's metadata),
cv2's INTER_AREA and undistort are `data/imutils.py`'s numpy rules, and
the kinematics run in float32 torch on `device` (the SMPL forward on the
model's device).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.data.hdf5 import H5File
from posegen_tpu_torch.data.imutils import resize_area_u8, undistort_u8
from posegen_tpu_torch.data.loaders import (
    SURREAL_DATASET_EXT_SCALE,
    SURREAL_ROT_GLOB,
    SURREAL_ROT_ROOTBONE,
    pose_block_from_bones,
    process_spin_estimated,
)
from posegen_tpu_torch.data.writer import dilate_masks, write_pose_h5
from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.cameras import get_rays_np, swap_mat
from posegen_tpu_torch.skeleton.geometry import bone_lengths, get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws
from posegen_tpu_torch.skeleton.rotations import axisang_to_rot, rot_to_axisang
from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
from posegen_tpu_torch.utils.images import read_image

# ZJU ground plane -> NeRF x-z plane (reference load_zju.py:13-16)
ZJU_TO_NERF_ROT = np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]], dtype=np.float32
)


def _imread(path: str) -> np.ndarray:
    """What the JAX package's cv2.imread(path, IMREAD_UNCHANGED) reading
    gives, in RGB order: 16-bit kept, grey kept 2-D, alpha dropped; a grey +
    alpha PNG comes back as 3 channels of its grey (cv2 reads it as BGRA),
    a palette PNG as its RGB colours (with or without tRNS)."""
    img = read_image(path)
    if img.ndim == 3 and img.shape[-1] == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3] if img.ndim == 3 else img


def _prune_sampling_masks_by_cylinder(
    sampling_masks: np.ndarray,  # (N, H, W, 1) uint8, modified in place
    cyls: np.ndarray,  # (N_kp, 5)
    c2ws: np.ndarray,  # per-type (T, 4, 4)
    img_cam_indices: np.ndarray,
    H: int,
    W: int,
    focal: float,
    n_kps: int,
) -> None:
    """Zero sampling-mask pixels whose rays pass outside the bounding
    cylinder's x-z circle (reference load_surreal.py:252-270)."""
    rays_od = [get_rays_np(H, W, focal, c2w) for c2w in c2ws]
    for i, (mask, cam_idx) in enumerate(zip(sampling_masks, img_cam_indices)):
        cyl = cyls[i % n_kps]
        rays_o, rays_d = rays_od[int(cam_idx)]
        ro = rays_o.reshape(-1, 3)[:, [0, 2]]
        rd = rays_d.reshape(-1, 3)[:, [0, 2]]
        far = ro + rd * 100.0
        of = far - ro
        od = cyl[:2] - ro
        cross_z = of[:, 0] * od[:, 1] - of[:, 1] * od[:, 0]  # 2D cross product
        dist = np.abs(cross_z) / np.linalg.norm(of, axis=-1)
        mask[..., 0] *= (dist < cyl[2]).reshape(H, W).astype(np.uint8)


# ---------------------------------------------------------------------------
# SURREAL
# ---------------------------------------------------------------------------


def ingest_surreal(
    data_path: str,
    h5_file: str,
    ext_scale: float = 0.001,
    extend_iter: int = 2,
    device="cuda",
) -> str:
    """Walk a raw SURREAL-style render dump and write the training H5
    (reference process_surreal_data, load_surreal.py:98-300).

    Layout: data_path/<seq>_<take>/ with metadata.pkl, and per camera-subdir
    <a>-<b>/ holding *segm.mat (person masks) and imageSequences/*.png.
    """
    from scipy.io import loadmat

    dev = resolve_device(device)
    ext_scale = SURREAL_DATASET_EXT_SCALE * ext_scale
    data_dirs = sorted(glob.glob(os.path.join(data_path, "*_*/")))
    if not data_dirs:
        raise FileNotFoundError(f"no <seq>_<take>/ dirs under {data_path}")

    cams, kp_3d, bone_poses, render_types, seq_cam_type, focals = [], [], [], [], [], []
    fg_masks = imgs = None
    n_kp_per_seq = 0
    for i, data_dir in enumerate(data_dirs):
        with open(os.path.join(data_dir, "metadata.pkl"), "rb") as f:
            meta = pickle.load(f)
        focals.append(meta["focal"] * meta["int_scale"])

        render_type = meta["render_type"]
        cam = np.asarray(meta["cams"], np.float32)
        if render_type not in render_types:
            render_types.append(render_type)
            cam = cam.copy()
            cam[..., :3, -1] *= ext_scale
            cams.append(cam)
        seq_cam_type.append(render_types.index(render_type))

        n_kp_per_seq = int(meta["N_kp"])
        n_cam_this_seq = int(meta["N_cams"])
        n_cam_per_subdir = int(meta["N_cam_per_subdir"])
        kp_3d.append(np.asarray(meta["joints3D"], np.float32) * ext_scale)
        bone_poses.append(np.asarray(meta["poses"], np.float32).reshape(n_kp_per_seq, -1, 3))

        fg_seq = []
        for fg_path in sorted(glob.glob(os.path.join(data_dir, "*-*/", "*segm.mat"))):
            m = loadmat(fg_path)["data"]
            m = np.asarray(m).reshape(n_cam_per_subdir, n_kp_per_seq, *m.shape[-2:])
            fg_seq.append((m > 0).astype(np.uint8))
        fg_seq = np.concatenate(fg_seq, axis=0)

        if fg_masks is None:
            fg_masks = np.zeros(
                (min(n_cam_this_seq, fg_seq.shape[0]),
                 len(data_dirs) * fg_seq.shape[1], *fg_seq.shape[-2:]),
                dtype=np.uint8,
            )
        fg_masks[:, i * fg_seq.shape[1]:(i + 1) * fg_seq.shape[1]] = fg_seq[: len(fg_masks)]

        img_paths = sorted(
            glob.glob(os.path.join(data_dir, "*-*/", "imageSequences", "*.png"))
        )
        img_seq = np.array([_imread(p) for p in img_paths])
        img_seq = img_seq.reshape(-1, n_kp_per_seq, *img_seq.shape[-3:])
        if imgs is None:
            imgs = np.zeros((*fg_masks.shape, 3), dtype=np.uint8)
        imgs[:, i * n_kp_per_seq:(i + 1) * n_kp_per_seq] = img_seq[: len(imgs)]

    kp_3d = np.concatenate(kp_3d, axis=0)
    bones = np.concatenate(bone_poses, axis=0)
    n_kps = kp_3d.shape[0]
    focal = float(np.mean(focals))
    H, W = imgs.shape[-3:-1]
    n_seqs = len(data_dirs)

    imgs = imgs.reshape(-1, H, W, 3)
    fg_masks = fg_masks.reshape(-1, H, W)

    # camera index per image over the (cams_per_type, seqs*poses) layout
    # (reference get_img_cam_indices, load_surreal.py:61-78)
    seq_cam_type = np.asarray(seq_cam_type)
    n_cams_per_type = imgs.shape[0] // n_kps
    idx = np.arange(n_cams_per_type).reshape(-1, 1, 1)
    idx = np.broadcast_to(idx, (n_cams_per_type, n_seqs, n_kp_per_seq))
    img_cam_indices = (
        idx + seq_cam_type[None, :, None] * n_cams_per_type
    ).reshape(-1)

    fg_masks = fg_masks[..., None]
    sampling = (
        fg_masks.copy()
        if extend_iter == 0
        else dilate_masks(fg_masks, iters=extend_iter)
    )

    c2ws = np.concatenate([c.reshape(-1, 4, 4) for c in cams], axis=0)
    rot4 = np.eye(4, dtype=np.float32)
    rot4[:3, :3] = SURREAL_ROT_GLOB
    c2ws = rot4[None] @ c2ws

    kp_3d = kp_3d @ SURREAL_ROT_GLOB.T
    block = pose_block_from_bones(
        bones,
        kp3d_override=kp_3d,  # SURREAL ships ground-truth joints3D:
        # l2w translations come from the data, FK provides rotations only
        # (reference skt_from_smpl(kp_3d=...), load_surreal.py:243)
        scale=ext_scale,
        ext_scale=ext_scale / SURREAL_DATASET_EXT_SCALE,
        head="-y",
        root_rot=SURREAL_ROT_ROOTBONE,
        device=dev,
    )

    _prune_sampling_masks_by_cylinder(
        sampling, block["cyls"], c2ws, img_cam_indices, H, W, focal, n_kps
    )

    n = imgs.shape[0]
    data = {
        "imgs": imgs,
        "masks": fg_masks,
        "sampling_masks": sampling,
        "bkgds": (np.ones((1, H, W, 3)) * 255).astype(np.uint8),
        "bkgd_idxs": np.zeros(n, np.int64),
        "kp3d": block["kp3d"],
        "gt_kp3d": block["kp3d"],
        "bones": block["bones"],
        "skts": block["skts"],
        "cyls": block["cyls"],
        "rest_pose": SMPL_REST_POSE * ext_scale,
        "betas": np.asarray(
            [[-0.8010307, 0.6838105, 0.7480726, -1.1379223, -0.32415348,
              -0.8404733, -0.4795286, -0.63125765, -0.13453396, 1.4934114]],
            np.float32,
        ),
        "c2ws": c2ws[img_cam_indices].astype(np.float32),
        "focals": np.full(n, focal, np.float32),
        "kp_idxs": np.tile(np.arange(n_kps), n_cams_per_type),
        "cam_idxs": img_cam_indices.astype(np.int64),
        "ext_scale": np.float32(ext_scale),
    }
    return write_pose_h5(h5_file, data)


# ---------------------------------------------------------------------------
# H36M (SPIN estimates + DeepLab masks + backgrounds)
# ---------------------------------------------------------------------------

H36M_CAMERAS = ("54138969", "55011271", "58860488", "60457274")
H36M_CHAIR_SEQS = ("Sitting-", "Eating-", "Phoning-", "Smoking-")


def read_spin_h5(path: str) -> Dict[str, np.ndarray]:
    """Read a SPIN-output h5 through the port's HDF5 reader (reference
    read_spin_data, process_spin.py:14-43, uses deepdish, whose array
    payloads are ordinary HDF5 datasets, at the root or in a `data/`
    group). The reference's pickled `pred_output` SMPL objects are not
    readable without SPIN's classes; exported `joints` are required
    instead. A deepdish dump written with blosc compression is refused:
    the reader raises ValueError naming the dataset and its filter (it
    decodes deflate and shuffle only)."""
    out: Dict[str, np.ndarray] = {}
    with H5File(path) as f:
        def grab(*names):
            for n in names:
                for key in (n, f"data/{n}"):
                    if key in f.datasets:
                        return f.read(key)
            return None

        out["betas"] = grab("pred_betas", "betas")
        out["rot_mats"] = grab("pred_rot_mat", "rot_mats")
        out["bboxes"] = grab("bbox_params", "bboxes")
        out["cameras"] = grab("pred_camera", "pred_cam", "cameras")
        out["joints"] = grab("joints", "pred_joints")
        out["img_path"] = grab("img_path", "img_paths")
        if "pose_3d" in f.datasets:
            out["gt_kp3d"] = f.read("pose_3d")
    missing = [k for k, v in out.items() if v is None and k != "gt_kp3d"]
    if missing:
        raise KeyError(
            f"{path} is missing {missing}; if this is a reference deepdish "
            "dump, export `joints` from pred_output first (the pickled SMPL "
            "objects need SPIN's own classes to unpickle)"
        )
    return out


def _paths(raw) -> List[str]:
    return [p.decode() if isinstance(p, bytes) else str(p) for p in raw]


def ingest_h36m(
    data_path: str,
    h5_file: str,
    subject: str = "S9",
    ext_scale: float = 0.001,
    res: float = 1.0,
    extend_iter: int = 2,
    smpl_model=None,
    device="cuda",
) -> str:
    """SPIN h5 + mask h5 + backgrounds + image files -> training H5
    (reference process_h36m_data, load_h36m.py:114-250). The JAX package's
    quirks are kept: the background files are named by
    `subject.replace('s', '')`, a rescale takes H, W = int(H / res) and
    resizes to int(res * W), and a frame of another height than the masks
    (the 1002-row camera) loses its first and last rows."""
    dev = resolve_device(device)
    spin = read_spin_h5(
        os.path.join(data_path, f"{subject}_SPIN_rect_output-maxmin.h5")
    )

    bkgds = np.load(os.path.join(data_path, f"{subject.replace('s', '')}_clean_bkgds.npy"))
    chair_path = os.path.join(data_path, f"{subject.replace('s', '')}_chair_bkgds.npy")
    if os.path.exists(chair_path):
        bkgds = np.concatenate([bkgds, np.load(chair_path)], axis=0)

    with H5File(os.path.join(data_path, f"{subject}_mask_deeplab_crop.h5")) as f:
        masks = f.read("masks").astype(np.uint8)
    if masks.ndim <= 3:
        masks = masks[..., None]
    if masks.max() > 1:  # deeplab class ids: person is >= 2 in the dump
        masks = (masks >= 2).astype(np.uint8)

    H = W = masks.shape[-2]
    if res != 1.0:
        H, W = int(H / res), int(W / res)
        bkgds = np.array([resize_area_u8(b, (int(res * W), int(res * H))) for b in bkgds])

    cameras = H36M_CAMERAS if subject != "S1" else H36M_CAMERAS[-1:]
    imgs, cam_idxs = [], []
    for p in _paths(spin["img_path"]):
        offset = sum(len(cameras) for cs in H36M_CHAIR_SEQS if cs in p)
        cam_idx = next(
            (e + offset for e, c in enumerate(cameras) if c in p), 0
        )
        cam_idxs.append(cam_idx)
        img = _imread(os.path.join(data_path, p))
        if img.shape[0] != H:
            # the 1002x1000 camera (load_h36m.py:222-224); compare against
            # the FULL-resolution height, not the (possibly rescaled) mask
            img = img[1:-1]
        if res != 1.0:
            img = resize_area_u8(img, (int(res * W), int(res * H)))
        imgs.append(img)
    imgs = np.array(imgs, dtype=np.uint8)

    return process_spin_estimated(
        h5_file, imgs, masks,
        spin["betas"], spin["cameras"], spin["joints"], spin["rot_mats"],
        spin["bboxes"], bkgds=bkgds, bkgd_idxs=np.asarray(cam_idxs),
        res=masks.shape[1], ext_scale=ext_scale, smpl_model=smpl_model,
        dilate_iters=extend_iter, device=dev,
    )


# ---------------------------------------------------------------------------
# PerfCap / Mixamo / 3DHP (SPIN-estimate h5 + image/mask trees)
# ---------------------------------------------------------------------------


def ingest_perfcap(
    data_path: str,
    h5_file: str,
    subject: str = "Weipeng_outdoor",
    ext_scale: float = 0.001,
    extend_iter: int = 2,
    smpl_model=None,
    device="cuda",
) -> str:
    """MonoPerfCap dump -> training H5 (reference process_perfcap_data,
    load_perfcap.py:12-52): SPIN-estimate h5, images/ + masks/ trees
    (DeepLab ids, person >= 2), one static background plate."""
    dev = resolve_device(device)
    spin = read_spin_h5(
        os.path.join(data_path, "MonoPerfCap", f"MonoPerfCap-{subject}.h5")
    )
    bkgd = _imread(os.path.join(data_path, "MonoPerfCap", subject, "bkgd.png"))

    imgs, masks = [], []
    for p in _paths(spin["img_path"]):
        img = _imread(os.path.join(data_path, p))
        mask = _imread(os.path.join(data_path, p.replace("/images/", "/masks/")))
        if mask.ndim == 3:
            mask = mask[..., 0]
        imgs.append(img)
        masks.append((mask >= 2).astype(np.uint8)[..., None])
    imgs = np.array(imgs, np.uint8)
    masks = np.array(masks, np.uint8)

    return process_spin_estimated(
        h5_file, imgs, masks,
        spin["betas"], spin["cameras"], spin["joints"], spin["rot_mats"],
        spin["bboxes"], bkgds=bkgd[None], bkgd_idxs=np.zeros(len(imgs), np.int64),
        res=(imgs.shape[1], imgs.shape[2]), ext_scale=ext_scale,
        smpl_model=smpl_model, dilate_iters=extend_iter, device=dev,
    )


def ingest_mixamo(
    data_path: str,
    h5_file: str,
    subject: str = "James",
    n_cam: int = 4,
    ext_scale: float = 0.001,
    extend_iter: int = 2,
    smpl_model=None,
    device="cuda",
) -> str:
    """Mixamo render dump -> training H5 (reference process_mixamo_data,
    load_mixamo.py:14-103): SPIN-estimate h5; per-sequence camera dirs
    <subject>/<seq>/Camera_<c>/ImageNNNN.png with Masks/ siblings; white
    background composited; gt poses from metadata.pickle per sequence.

    As in the reference: kp_idx comes from the FRAME number, so all n_cam
    views of one animation frame share one pose row, and the kp-index
    offsets assume the SPIN h5 lists images cam-major per sequence with
    exactly n_cam cameras (pass --n_cam for a dump with another count)."""
    dev = resolve_device(device)
    spin = read_spin_h5(os.path.join(data_path, subject, f"{subject}.h5"))

    imgs, masks, kp_idxs, cam_idxs = [], [], [], []
    seq_dict: Dict[str, list] = {}
    for i, p in enumerate(_paths(spin["img_path"])):
        parts = p.split("/")
        d = "/".join(parts[:3])
        seq_name = parts[1]
        img_name = parts[-1]
        cam_idxs.append(int(parts[2].split("_")[-1]))
        kp_idxs.append(int(img_name[5:-4]) - 1)
        seq_dict.setdefault(seq_name, []).append(i)

        img = _imread(os.path.join(data_path, p))
        mask = _imread(os.path.join(data_path, f"{d}/Masks/{img_name}"))
        if mask.ndim == 3:
            mask = mask[..., 0]
        mask = (mask >= 2).astype(np.uint8)[..., None]
        imgs.append(img * mask + (1 - mask) * 255)
        masks.append(mask)
    imgs = np.array(imgs, np.uint8)
    masks = np.array(masks, np.uint8)
    kp_idxs = np.asarray(kp_idxs)
    cam_idxs = np.asarray(cam_idxs)

    # per-sequence ground-truth joints from metadata.pickle
    gt_kps, joint_names = [], None
    for k in seq_dict:
        with open(
            os.path.join(data_path, subject, k, "Camera_0", "metadata.pickle"),
            "rb",
        ) as f:
            meta = pickle.load(f)
        for pose in meta["gt_pose"]:
            entry = pose.item() if hasattr(pose, "item") else pose
            if joint_names is None:
                joint_names = list(entry.keys())
            gt_kps.append(np.array([entry[j] for j in joint_names]))

    # offset kp_idxs by the pose count of preceding sequences
    # (reference load_mixamo.py:66-73)
    i = 0
    for k in seq_dict:
        seq_len = len(seq_dict[k])
        kp_idxs[i * n_cam:i * n_cam + seq_len] += i
        i += seq_len // n_cam

    return process_spin_estimated(
        h5_file, imgs, masks,
        spin["betas"], spin["cameras"], spin["joints"], spin["rot_mats"],
        spin["bboxes"], res=(imgs.shape[1], imgs.shape[2]),
        ext_scale=ext_scale, smpl_model=smpl_model,
        kp_idxs=kp_idxs, cam_idxs=cam_idxs,
        gt_kp3d=np.array(gt_kps, np.float32) if gt_kps else None,
        dilate_iters=extend_iter, device=dev,
    )


def ingest_3dhp(
    data_path: str,
    h5_file: str,
    subject: str = "S1",
    ext_scale: float = 0.001,
    extend_iter: int = 2,
    smpl_model=None,
    device="cuda",
) -> str:
    """MPI-INF-3DHP dump -> training H5 (reference process_3dhp_data,
    load_3dhp.py:81-140): subject-filtered SPIN-estimate h5, imageSequence/
    + masks/ trees (person class >= 2), median background plate.

    Per-subject image resolutions follow the reference res_map
    (load_3dhp.py:14-21); gt 3D poses carried through when present.
    """
    dev = resolve_device(device)
    res_map = {
        "S1": (768, 768), "S2": (768, 768), "S3": (768, 768),
        "S4": (768, 768), "S5": (768, 1365), "S6": (768, 1365),
    }
    spin_h5 = os.path.join(data_path, "MPI_SPIN_rect_output-maxmin.h5")
    if subject in ("S5", "S6"):
        alt = os.path.join(data_path, "mpi_3dhp", "3DHP-S5S6.h5")
        if os.path.exists(alt):
            spin_h5 = alt
    spin = read_spin_h5(spin_h5)

    all_paths = _paths(spin["img_path"])
    idxs = np.asarray([i for i, p in enumerate(all_paths) if subject in p])
    if idxs.size == 0:
        raise ValueError(f"no {subject} frames in {spin_h5}")

    imgs, masks = [], []
    for i in idxs:
        p = all_paths[i]
        img = _imread(os.path.join(data_path, p))
        mask = _imread(
            os.path.join(data_path, p.replace("/imageSequence/", "/masks/"))
        )
        if mask.ndim == 3:
            mask = mask[..., 0]
        imgs.append(img)
        masks.append((mask >= 2).astype(np.uint8)[..., None])
    imgs = np.array(imgs, np.uint8)
    masks = np.array(masks, np.uint8)

    bkgd_path = os.path.join(data_path, f"{subject}_bkgd.png")
    bkgds = _imread(bkgd_path)[None] if os.path.exists(bkgd_path) else None

    gt = spin.get("gt_kp3d")
    return process_spin_estimated(
        h5_file, imgs, masks,
        spin["betas"][idxs], spin["cameras"][idxs], spin["joints"][idxs],
        spin["rot_mats"][idxs], spin["bboxes"][idxs],
        bkgds=bkgds, bkgd_idxs=np.zeros(len(imgs), np.int64),
        res=res_map.get(subject, (imgs.shape[1], imgs.shape[2])),
        ext_scale=ext_scale, smpl_model=smpl_model,
        gt_kp3d=None if gt is None else np.asarray(gt)[idxs],
        dilate_iters=extend_iter, device=dev,
    )


# ---------------------------------------------------------------------------
# ZJU-MoCap (EasyMocap params + annots.npy cameras)
# ---------------------------------------------------------------------------


def zju_get_smpls(
    subject_path: str,
    kp_idxs: Sequence[int],
    smpl_model,
    ext_scale: float = 1.0,
    scale_to_ref: bool = True,
    ref_pose: np.ndarray = SMPL_REST_POSE,
    param_dir: str = "params",
):
    """EasyMocap per-frame SMPL params -> NeRF-space pose data
    (reference get_smpls, load_zju.py:70-177), on the model's device.

    ZJU poses joints as R'(RX + T) + T' with a global rotation R'/translation
    T' outside the SMPL forward; this folds R' (plus the ground-plane
    alignment Rn) into the root rotation and corrects the translation terms
    through an SMPL forward pass, then rebuilds l2ws/skts with our FK.
    """
    dev = smpl_model.v_template.device
    bones, betas, root_rots_aa, root_locs = [], [], [], []
    for kp_idx in kp_idxs:
        params = np.load(
            os.path.join(subject_path, param_dir, f"{kp_idx}.npy"), allow_pickle=True
        ).item()
        bones.append(np.asarray(params["poses"], np.float32).reshape(-1, 24, 3))
        betas.append(np.asarray(params["shapes"], np.float32))
        root_rots_aa.append(np.asarray(params["Rh"], np.float32).reshape(-1, 3))
        root_locs.append(np.asarray(params["Th"], np.float32).reshape(-1, 3))

    bones = np.concatenate(bones, axis=0)
    betas = np.concatenate(betas, axis=0)
    Tp = np.concatenate(root_locs, axis=0)
    Rn = ZJU_TO_NERF_ROT

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    with torch.no_grad():
        rots = axisang_to_rot(t(bones)).cpu().numpy()
        zju_global = axisang_to_rot(t(np.concatenate(root_rots_aa, axis=0))).cpu().numpy()
        rots[:, 0] = Rn[None] @ zju_global
        root_bones = rot_to_axisang(t(rots[:, 0])).cpu().numpy()

        mean_betas = betas.mean(0, keepdims=True).astype(np.float32)
        B = rots.shape[0]

        # 1. pelvis location T of the zero-pose body
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 24, 3, 3))
        out0 = smpl_model(t(mean_betas), body_pose=t(eye[:, 1:]), global_orient=t(eye[:, :1]),
                          pose2rot=False)
        rest_pose = out0["joints"][0].cpu().numpy()
        T = rest_pose[:1].copy()  # (1, 3) pelvis
        rest_pose = rest_pose - rest_pose[0]

        if scale_to_ref:
            def bone_len(kp):  # the JAX package's: the 23 non-root bones
                return bone_lengths(kp)[1:]

            pose_scale = float(bone_len(ref_pose * ext_scale).mean() / bone_len(rest_pose).mean())
        else:
            pose_scale = 1.0
        rest_pose = rest_pose * pose_scale

        # 3. RnR'T and RnT' correction terms (load_zju.py:152-160)
        RnRpT = (T[None] @ np.transpose(rots[:, 0], (0, 2, 1)))  # (B, 1, 3)
        RnTp = (Rn[None] @ Tp[..., None]).reshape(B, 1, 3)

        out = smpl_model(
            t(np.repeat(mean_betas, B, 0) if betas.shape[0] != B else betas),
            body_pose=t(rots[:, 1:]), global_orient=t(rots[:, :1]), pose2rot=False,
        )
        joints = (out["joints"].cpu().numpy() - T + RnRpT + RnTp) * pose_scale
        vertices = (out["vertices"].cpu().numpy() - T + RnRpT + RnTp) * pose_scale

        root_locs = joints[:, 0]
        bones = bones.copy()
        bones[:, 0] = root_bones
        l2ws = smpl_l2ws(t(bones), rest_pose=t(rest_pose)).cpu().numpy()
        l2ws[..., :3, -1] += root_locs[:, None]
        kp3d = l2ws[..., :3, -1].copy()
        skts = invert_rigid(t(l2ws)).cpu().numpy()
    return betas, kp3d, bones, skts, rest_pose, vertices, pose_scale


def ingest_zju(
    data_path: str,
    h5_file: str,
    subject: str = "377",
    smpl_model=None,
    training_views: Sequence[int] = (0, 6, 12, 18),
    n_frames: Optional[int] = None,
    frame_offset: int = 0,
    ext_scale: float = 0.001,
    extend_iter: int = 2,
    device="cuda",
) -> str:
    """CoreView_<subject>/ (annots.npy + images + mask[_cihp]/ + params/) ->
    training H5 (reference process_zju_data, load_zju.py:180-330). Frames and
    masks are undistorted by `imutils.undistort_u8` (cv2.undistort's rule);
    the SMPL conversion runs on the model's device, the cylinders on
    `device`."""
    dev = resolve_device(device)
    subject_path = os.path.join(data_path, f"CoreView_{subject}")
    annots = np.load(
        os.path.join(subject_path, "annots.npy"), allow_pickle=True
    ).item()
    cams = annots["cams"]
    num_cams = len(cams["K"])
    frames = np.array(annots["ims"])
    if n_frames is not None:
        frames = frames[frame_offset:frame_offset + n_frames]

    img_paths, cam_idxs = [], []
    for frame in frames:
        ims = np.array(frame["ims"])[list(training_views)]
        img_paths.extend(ims.tolist())
        cam_idxs.extend(list(training_views))
    cam_idxs = np.asarray(cam_idxs)

    imgs, masks, kp_idxs = [], [], []
    for img_path, cam_idx in zip(img_paths, cam_idxs):
        K = np.asarray(cams["K"][cam_idx], np.float64)
        D = np.asarray(cams["D"][cam_idx], np.float64)
        img = _imread(os.path.join(subject_path, img_path))
        mask = _read_zju_mask(subject_path, img_path)
        img = undistort_u8(img, K, D.reshape(-1))
        mask = undistort_u8(mask, K, D.reshape(-1))
        imgs.append(img)
        masks.append((mask > 0).astype(np.uint8)[..., None])
        base = os.path.basename(img_path)
        kp_idxs.append(
            int(base.split("_")[4]) if subject in ("313", "315") else int(base[:-4])
        )
    imgs = np.array(imgs, np.uint8)
    masks = np.array(masks, np.uint8)
    kp_idxs = np.asarray(kp_idxs)

    c2ws, focals, centers = [], [], []
    for c in range(num_cams):
        R = np.asarray(cams["R"][c], np.float64)
        T = np.asarray(cams["T"][c], np.float64).reshape(3, 1) / 1000.0
        K = np.asarray(cams["K"][c], np.float64)
        ext = np.concatenate([np.concatenate([R, T], -1), [[0, 0, 0, 1.0]]], 0)
        c2w = np.linalg.inv(ext)
        c2w[:3, -1:] = ZJU_TO_NERF_ROT @ c2w[:3, -1:]
        c2w[:3, :3] = ZJU_TO_NERF_ROT @ c2w[:3, :3]
        c2ws.append(c2w)
        focals.append([K[0, 0], K[1, 1]])
        centers.append(K[:2, -1])
    c2ws = swap_mat(np.asarray(c2ws, np.float32))  # to NeRF convention

    if smpl_model is None:
        raise ValueError(
            "ingest_zju needs an SMPL model (body/smpl.load_smpl_model) to "
            "convert EasyMocap params: pass smpl_model or --smpl_path"
        )
    unique_kps = np.unique(kp_idxs)
    betas, kp3d, bones, skts, rest_pose, _, _ = zju_get_smpls(
        subject_path, unique_kps, smpl_model, ext_scale=ext_scale,
        scale_to_ref=False,
    )
    with torch.no_grad():
        cyls = get_kp_bounding_cylinder(
            torch.as_tensor(np.asarray(kp3d, np.float32), device=dev), ext_scale=ext_scale,
            head="-y").cpu().numpy().astype(np.float32)

    remap = {int(k): i for i, k in enumerate(unique_kps)}
    kp_idxs = np.asarray([remap[int(k)] for k in kp_idxs])

    n = imgs.shape[0]
    data = {
        "imgs": imgs,
        "masks": masks,
        "sampling_masks": dilate_masks(masks, iters=extend_iter),
        "kp3d": kp3d.astype(np.float32),
        "bones": bones.astype(np.float32),
        "skts": skts.astype(np.float32),
        "cyls": cyls,
        "rest_pose": rest_pose.astype(np.float32),
        "betas": betas.astype(np.float32),
        "c2ws": c2ws[cam_idxs].astype(np.float32),
        "focals": np.asarray(focals, np.float32)[cam_idxs, 0],
        "centers": np.asarray(centers, np.float32)[cam_idxs],
        "kp_idxs": kp_idxs.astype(np.int64),
        "cam_idxs": cam_idxs.astype(np.int64),
        "bkgd_idxs": np.zeros(n, np.int64),
        "bkgds": (np.zeros((1, *imgs.shape[1:]), np.uint8)),
        "ext_scale": np.float32(ext_scale),
    }
    return write_pose_h5(h5_file, data)


def _read_zju_mask(subject_path: str, img_path: str) -> np.ndarray:
    """mask_cihp/ preferred over mask/ (reference load_zju get_mask)."""
    for d in ("mask_cihp", "mask"):
        p = os.path.join(subject_path, img_path.replace("images", d))
        p = os.path.splitext(p)[0] + ".png"
        if os.path.exists(p):
            return _imread(p)
    raise FileNotFoundError(f"no mask for {img_path} under {subject_path}")


def main(argv: Optional[List[str]] = None, device="cuda") -> None:
    """The CLI; `device` is a keyword of the call, not a flag (the flags
    are the JAX package's)."""
    import argparse

    p = argparse.ArgumentParser("posegen_tpu_torch.data.ingest")
    p.add_argument("dataset", choices=("surreal", "h36m", "zju", "perfcap", "mixamo", "3dhp"))
    p.add_argument("raw_dir")
    p.add_argument("out_h5")
    p.add_argument("--subject", type=str, default="S9")
    p.add_argument("--ext_scale", type=float, default=0.001)
    p.add_argument("--res", type=float, default=1.0)
    p.add_argument("--extend_iter", type=int, default=2)
    p.add_argument("--smpl_path", type=str, default=None)
    p.add_argument("--n_frames", type=int, default=None)
    p.add_argument("--n_cam", type=int, default=4,
                   help="cameras per Mixamo sequence (reference assumes 4)")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    smpl_model = None
    if args.smpl_path:
        from posegen_tpu_torch.body.smpl import load_smpl_model

        smpl_model = load_smpl_model(args.smpl_path, device=dev)

    if args.dataset == "surreal":
        out = ingest_surreal(
            args.raw_dir, args.out_h5, ext_scale=args.ext_scale,
            extend_iter=args.extend_iter, device=dev,
        )
    elif args.dataset == "h36m":
        out = ingest_h36m(
            args.raw_dir, args.out_h5, subject=args.subject,
            ext_scale=args.ext_scale, res=args.res,
            extend_iter=args.extend_iter, smpl_model=smpl_model, device=dev,
        )
    elif args.dataset == "perfcap":
        out = ingest_perfcap(
            args.raw_dir, args.out_h5, subject=args.subject,
            ext_scale=args.ext_scale, extend_iter=args.extend_iter,
            smpl_model=smpl_model, device=dev,
        )
    elif args.dataset == "3dhp":
        out = ingest_3dhp(
            args.raw_dir, args.out_h5, subject=args.subject,
            ext_scale=args.ext_scale, extend_iter=args.extend_iter,
            smpl_model=smpl_model, device=dev,
        )
    elif args.dataset == "mixamo":
        out = ingest_mixamo(
            args.raw_dir, args.out_h5, subject=args.subject,
            n_cam=args.n_cam, ext_scale=args.ext_scale,
            extend_iter=args.extend_iter, smpl_model=smpl_model, device=dev,
        )
    else:
        out = ingest_zju(
            args.raw_dir, args.out_h5, subject=args.subject,
            smpl_model=smpl_model, ext_scale=args.ext_scale,
            extend_iter=args.extend_iter, n_frames=args.n_frames, device=dev,
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
