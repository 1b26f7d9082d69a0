"""Pose-estimator evaluation harness: 3DPW / SKI / AGORA / 3DHP (port of
posegen_tpu/evals/harness.py).

Capability parity with the reference's evaluation stack
(core/PW3D.py:20-182 `PW3D` dataset; run_gan.py:1509-1634 `evaluate`
MPJPE / PA-MPJPE / PCK / posed+unposed mesh errors with gendered SMPL GT;
render_3dpw_testset.py:1917-3016 SKI/AGORA/3DHP variants).

The datasets are host iterators over annotation files and image crops, as
in the JAX package: images through the port's readers (`utils/images.py`:
PNG, and baseline JPEG by the port's own decoder), labels.h5 through
`data/hdf5.py`, cv2's resizes in numpy (`data/imutils.py`). JAX's jitted
per-batch functions are plain functions under `torch.inference_mode()`
here, on the device of the HMR parameters: each batch's arrays are
uploaded once, and its per-sample metrics read back in one transfer. The
means and PCK are taken on the host in numpy over the concatenated float32
arrays, as JAX takes them. The evaluator leaves PyTorch's TF32 flags as
the caller set them.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.data.hdf5 import H5File
from posegen_tpu_torch.data.imutils import crop, normalize_for_spin, resize_area_u8
from posegen_tpu_torch.evals.pose import procrustes_align
from posegen_tpu_torch.gen.hmr import hmr_apply
from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws_from_rots
from posegen_tpu_torch.utils.constants import H36M_TO_J14, PW3D_TEST_SEQS
from posegen_tpu_torch.utils.images import read_image


@dataclasses.dataclass
class PoseEvalDataset:
    """Annotation-npz-driven eval set (the PW3D/SKI/AGORA/3DHP formats all
    store imgname/center/scale/pose/shape[/gender] arrays, reference
    PW3D.py:30-77)."""

    annot_files: Sequence[str]
    img_dir: str
    res: int = 224
    has_gender: bool = True

    def __post_init__(self):
        names, centers, scales, poses, betas, genders = [], [], [], [], [], []
        for f in self.annot_files:
            d = np.load(f, allow_pickle=True)
            names.extend([str(x) for x in d["imgname"]])
            centers.append(np.asarray(d["center"], np.float32))
            scales.append(np.asarray(d["scale"], np.float32))
            poses.append(np.asarray(d["pose"], np.float32))
            betas.append(np.asarray(d["shape"], np.float32))
            if self.has_gender and "gender" in d:
                genders.append(
                    np.array([0 if str(g).startswith("m") else 1 for g in d["gender"]])
                )
            else:
                genders.append(np.zeros(len(d["center"]), np.int32))
        self.imgnames = names
        self.centers = np.concatenate(centers)
        self.scales = np.concatenate(scales)
        self.poses = np.concatenate(poses)
        self.betas = np.concatenate(betas)
        self.genders = np.concatenate(genders).astype(np.int32)

    def __len__(self) -> int:
        return len(self.imgnames)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = read_image(os.path.join(self.img_dir, self.imgnames[i]))[..., :3]
        c = crop(img, self.centers[i], self.scales[i], (self.res, self.res))
        return {
            "image": normalize_for_spin(c),
            "pose": self.poses[i],
            "betas": self.betas[i],
            "gender": self.genders[i],
        }

    def batches(self, batch_size: int = 32) -> Iterator[Dict[str, np.ndarray]]:
        return _batched(self, batch_size)


def pw3d_dataset(annot_dir: str, img_dir: str, res: int = 224) -> PoseEvalDataset:
    """The 3DPW test split (reference PW3D('3dpw'), core/PW3D.py:20)."""
    files = [
        os.path.join(annot_dir, f"{s}.npz")
        for s in PW3D_TEST_SEQS
        if os.path.exists(os.path.join(annot_dir, f"{s}.npz"))
    ]
    if not files:  # single-file variants (ski/agora style)
        files = sorted(
            os.path.join(annot_dir, f)
            for f in os.listdir(annot_dir)
            if f.endswith(".npz")
        )
    return PoseEvalDataset(files, img_dir, res=res)


# joint-set maps for the extended eval sets
# SKI labels.h5 '3D' (17-joint capture order) -> the 14 evaluated joints
# (reference render_3dpw_testset.py:1980: ski_dataset.__getitem__)
SKI_TO_J14 = [4, 1, 5, 2, 6, 3, 8, 10, 11, 14, 12, 15, 13, 16]
# predicted H36M-regressed joints -> the same 14 (reference :2604 EVAL_JOINTS)
SKI_PRED_J14 = [1, 4, 2, 5, 3, 6, 8, 10, 11, 14, 12, 15, 13, 16]
# SPIN 24-joint GT superset -> 17 joints (reference constants.py:150)
J24_TO_J17 = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18, 14, 16, 17]
# H36M regressor order -> J17 (reference constants.py:79)
H36M_TO_J17 = [6, 5, 4, 1, 2, 3, 16, 15, 14, 11, 12, 13, 8, 10, 0, 7, 9]


def _resize_normalize(img: np.ndarray, res: int) -> np.ndarray:
    """cv2.resize(img, (res, res), interpolation=cv2.INTER_AREA), then SPIN's
    normalisation."""
    return normalize_for_spin(resize_area_u8(img, (res, res)))


def _batched(dataset, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
    """Stack dataset items into fixed-key batches (shared by all eval sets)."""
    for s in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(s, min(s + batch_size, len(dataset)))]
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class SkiDataset:
    """SKI-Pose test set in its REAL schema: labels.h5 with seq/cam/frame
    index columns + '2D'/'3D' arrays, images under
    seq_{:03d}/cam_{:02d}/image_{:06d}.png (reference ski_dataset,
    render_3dpw_testset.py:1963-2000)."""

    def __init__(self, root: str, split: str = "test", res: int = 224):
        self.root = os.path.join(root, split)
        self.res = res
        with H5File(os.path.join(self.root, "labels.h5")) as f:
            self.seq = np.asarray(f.read("seq"), np.int64)
            self.cam = np.asarray(f.read("cam"), np.int64)
            self.frame = np.asarray(f.read("frame"), np.int64)
            self.pose3d = np.asarray(f.read("3D"), np.float32)
            self.pose2d = np.asarray(f.read("2D"), np.float32)

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        path = os.path.join(
            self.root,
            f"seq_{self.seq[i]:03d}",
            f"cam_{self.cam[i]:02d}",
            f"image_{self.frame[i]:06d}.png",
        )
        img = read_image(path)[..., :3]
        gt = self.pose3d[i].reshape(-1, 3)[SKI_TO_J14]
        return {"image": _resize_normalize(img, self.res), "pose_3d": gt}

    def batches(self, batch_size: int = 32) -> Iterator[Dict[str, np.ndarray]]:
        return _batched(self, batch_size)


class Hp3dDataset:
    """MPI-INF-3DHP eval set in the SPIN dataset-extras npz schema:
    imgname/center/scale/S (24-joint GT with confidence) (reference
    BaseDataset, render_3dpw_testset.py:2087-2170 + evaluate_3dhp :2772)."""

    def __init__(self, annot_npz: str, img_dir: str, res: int = 224):
        self.img_dir = img_dir
        self.res = res
        d = np.load(annot_npz, allow_pickle=True)
        self.imgname = [str(x) for x in d["imgname"]]
        self.center = np.asarray(d["center"], np.float32)
        self.scale = np.asarray(d["scale"], np.float32)
        self.S = np.asarray(d["S"], np.float32)  # (N, 24, 4) xyz + conf

    def __len__(self) -> int:
        return len(self.imgname)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = read_image(os.path.join(self.img_dir, self.imgname[i]))[..., :3]
        c = crop(img, self.center[i], self.scale[i], (self.res, self.res))
        gt17 = self.S[i][J24_TO_J17, :3]  # (17, 3)
        return {"image": normalize_for_spin(c), "pose_3d": gt17}

    def batches(self, batch_size: int = 32) -> Iterator[Dict[str, np.ndarray]]:
        return _batched(self, batch_size)


class AgoraDataset:
    """AGORA test images + HRNet 2D detections pickle (list of dicts with
    'image_name' and '2dpose'), reference agora_dataset,
    render_3dpw_testset.py:1917-1961. AGORA has no public test GT; the
    evaluator exports per-person prediction pkls for the submission server
    (reference evaluate_agora :2920-3016)."""

    def __init__(self, image_dir: str, pose_pkl: str, res: int = 224, pad: int = 50):
        self.image_dir = image_dir
        self.res = res
        self.pad = pad
        with open(pose_pkl, "rb") as f:
            self.pose = pickle.load(f)

    def __len__(self) -> int:
        return len(self.pose)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        entry = self.pose[i]
        img = read_image(os.path.join(self.image_dir, entry["image_name"]))[..., :3]
        pose2d = np.asarray(entry["2dpose"], np.float32).reshape(-1, 2)
        # keypoint-driven square crop (reference process_image's bbox route)
        c = 0.5 * (pose2d.min(0) + pose2d.max(0))
        half = 0.5 * (pose2d.max(0) - pose2d.min(0)).max() + self.pad
        scale = 2.0 * half / 200.0
        cimg = crop(img, c, scale, (self.res, self.res))
        return {
            "image": normalize_for_spin(cimg),
            "pose2d": pose2d,
            "image_name": entry["image_name"],
        }


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's eps-safe distance over the last axis."""
    return torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)


class SpinEvaluator:
    """MPJPE / PA-MPJPE / PCK / mesh errors for an HMR model
    (reference evaluate.test, run_gan.py:1586-1634).

    hmr_params / hmr_state: the port's HMR trees; the evaluator runs on
    their device and moves the SMPL models there. smpl_neutral/male/female:
    posegen_tpu_torch.body.SMPLModel instances; J_regressor: (17, V) H36M
    joint regressor.
    """

    def __init__(
        self,
        hmr_params,
        hmr_state,
        smpl_neutral,
        smpl_male=None,
        smpl_female=None,
        J_regressor: Optional[np.ndarray] = None,
    ):
        self.hmr_params = hmr_params
        self.hmr_state = hmr_state
        self.device = hmr_params["conv1"]["w"].device
        self.smpl_neutral = smpl_neutral.to(self.device)
        self.smpl_male = (smpl_neutral if smpl_male is None else smpl_male).to(self.device)
        self.smpl_female = (smpl_neutral if smpl_female is None else smpl_female).to(self.device)
        self.J_reg = (
            torch.as_tensor(np.asarray(J_regressor, np.float32), device=self.device)
            if J_regressor is not None else None
        )

    def _require_jreg(self) -> None:
        """Fail fast with a clear message instead of an error deep inside
        the first batch."""
        if self.J_reg is None:
            raise ValueError(
                "SpinEvaluator needs J_regressor for joint metrics "
                "(inference / inference_joints); only "
                "export_agora_predictions works without it"
            )

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _images(self, a: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) normalised host images -> (B, 3, H, W) on the device."""
        return self._upload(np.asarray(a, np.float32)).permute(0, 3, 1, 2)

    def _predict(self, images: torch.Tensor):
        """HMR in eval mode, then the neutral SMPL on its rotations ->
        (pred_rotmat, pred_betas, pred vertices)."""
        pred_rotmat, pred_betas, _, _ = hmr_apply(self.hmr_params, self.hmr_state, images)
        pred = self.smpl_neutral(
            betas=pred_betas, body_pose=pred_rotmat[:, 1:],
            global_orient=pred_rotmat[:, :1], pose2rot=False,
        )
        return pred_rotmat, pred_betas, pred["vertices"]

    def _agora_forward(self, images: torch.Tensor):
        """HMR + SMPL + FK for the AGORA export. Both output scales are the
        REFERENCE's: verts metric (decode_smpl_params), allSmplJoints3d at
        pose scale 0.4 (get_smpl_l2ws_torch(scale=0.4)),
        render_3dpw_testset.py:2961-2989 mixes them the same way."""
        pred_rotmat, _, verts = self._predict(images)
        pose3d = smpl_l2ws_from_rots(pred_rotmat, scale=0.4)[..., :3, 3]
        return verts, pose3d

    def _joints14(self, vertices: torch.Tensor) -> torch.Tensor:
        j = torch.matmul(self.J_reg, vertices)
        return j[:, H36M_TO_J14] - j[:, :1]

    def _batch_metrics(self, images, gt_pose, gt_betas, gender) -> Dict[str, torch.Tensor]:
        pred_rotmat, pred_betas, pred_vts = self._predict(images)
        gt_m = self.smpl_male(betas=gt_betas, body_pose=gt_pose[:, 3:],
                              global_orient=gt_pose[:, :3])
        gt_f = self.smpl_female(betas=gt_betas, body_pose=gt_pose[:, 3:],
                                global_orient=gt_pose[:, :3])
        is_f = (gender == 1)[:, None, None]
        gt_vts = torch.where(is_f, gt_f["vertices"], gt_m["vertices"])

        pred_j = self._joints14(pred_vts)
        gt_j = self._joints14(gt_vts)
        mpjpe = _dist(pred_j, gt_j).mean(-1)
        pa_err = _dist(procrustes_align(pred_j, gt_j), gt_j)

        # mesh errors: posed, and unposed (identity rotations, shape only)
        pme = _dist(pred_vts, gt_vts).mean(-1)
        eye = torch.eye(3, dtype=pred_rotmat.dtype,
                        device=pred_rotmat.device).expand(*pred_rotmat.shape[:2], 3, 3)

        def unposed(model, betas):
            return model(betas=betas, body_pose=eye[:, 1:], global_orient=eye[:, :1],
                         pose2rot=False)["vertices"]

        up_gt = torch.where(is_f, unposed(self.smpl_female, gt_betas),
                            unposed(self.smpl_male, gt_betas))
        ume = _dist(unposed(self.smpl_neutral, pred_betas), up_gt).mean(-1)
        return {"mpjpe": mpjpe, "pa_mpjpe": pa_err.mean(-1), "pa_err": pa_err,
                "pme": pme, "ume": ume}

    def _joint_metrics(self, images, gt_joints, pred_select) -> Dict[str, torch.Tensor]:
        """Joints-vs-joints eval for sets with 3D-joint GT (SKI/3DHP):
        pred joints regressed from the predicted mesh, pelvis-centered by
        H36M joint 0, reordered by `pred_select` (reference evaluate_ski
        :2590-2612 / evaluate_3dhp :2840-2870). NOTE: the GT joints stay in
        their raw dataset frame (the reference's gt-centering lines are
        commented out, :2639-2641), so its MPJPE also measures the global
        offset and PA-MPJPE is the meaningful number; kept for parity."""
        _, _, verts = self._predict(images)
        j = torch.matmul(self.J_reg, verts)
        pred_j = j[:, list(pred_select)] - j[:, :1]
        err = _dist(pred_j, gt_joints)
        pa_err = _dist(procrustes_align(pred_j, gt_joints), gt_joints)
        return {"mpjpe": err.mean(-1), "pa_mpjpe": pa_err.mean(-1), "pa_err": pa_err}

    @staticmethod
    def _read_back(out: Dict[str, torch.Tensor], acc: Dict[str, List[np.ndarray]]) -> None:
        """One device-to-host transfer of a batch's per-sample metrics."""
        flat = torch.cat([v.reshape(v.shape[0], -1) for v in out.values()], 1).cpu().numpy()
        col = 0
        for k, v in out.items():
            n = int(np.prod(v.shape[1:], dtype=np.int64))
            acc.setdefault(k, []).append(flat[:, col:col + n].reshape(v.shape))
            col += n

    @staticmethod
    def _report(results: Dict[str, float]) -> Dict[str, float]:
        print("== Final Results ==")
        for k, v in results.items():
            print(f"{k}: {v:.4f}")
        return results

    def inference_joints(
        self, batches, pred_select: Sequence[int], pck_thresh: float = 0.15
    ) -> Dict[str, float]:
        """Evaluate on a joints-GT set (SkiDataset: pred_select=SKI_PRED_J14;
        Hp3dDataset: pred_select=H36M_TO_J17)."""
        self._require_jreg()
        acc: Dict[str, List[np.ndarray]] = {}
        with torch.inference_mode():
            for b in batches:
                out = self._joint_metrics(self._images(b["image"]),
                                          self._upload(b["pose_3d"]), pred_select)
                self._read_back(out, acc)
        err_all = np.concatenate(acc["pa_err"]).reshape(-1)
        return self._report({
            "mpjpe": float(np.mean(np.concatenate(acc["mpjpe"]))) * 1000.0,
            "pa_mpjpe": float(np.mean(np.concatenate(acc["pa_mpjpe"]))) * 1000.0,
            "pck": float(np.mean((err_all < pck_thresh).astype(np.float32))),
        })

    def export_agora_predictions(self, dataset: "AgoraDataset", out_dir: str) -> int:
        """AGORA submission-server export: one pkl per detected person with
        'joints' (2D, scale-aligned to the HRNet detection), 'verts', and
        'allSmplJoints3d' (reference evaluate_agora,
        render_3dpw_testset.py:2955-3016)."""
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for i in range(len(dataset)):
            item = dataset[i]
            with torch.inference_mode():
                verts, pose3d_b = self._agora_forward(self._images(item["image"][None]))
                verts, pose3d = verts[0].cpu().numpy(), pose3d_b[0].cpu().numpy()

            pose2d = item["pose2d"]
            root = 0.5 * (pose2d[11] + pose2d[12])
            pred2d = pose3d[:, :2] - pose3d[:1, :2]
            det = pose2d - root
            scale = np.linalg.norm(det) / max(np.linalg.norm(pred2d), 1e-8)
            pred2d = pred2d * scale + root

            out = {
                "joints": pred2d.astype(np.float32),
                "verts": np.asarray(verts, np.float32),
                "allSmplJoints3d": pose3d.astype(np.float32),
            }
            base = os.path.splitext(item["image_name"])[0]
            count = 0
            while os.path.exists(os.path.join(out_dir, f"{base}_personId_{count}.pkl")):
                count += 1
            with open(os.path.join(out_dir, f"{base}_personId_{count}.pkl"), "wb") as f:
                pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
            n += 1
        return n

    def inference(self, batches) -> Dict[str, float]:
        """Run the full set; prints Final Results like run_gan.py:1572-1581."""
        self._require_jreg()
        acc: Dict[str, List[np.ndarray]] = {}
        with torch.inference_mode():
            for b in batches:
                out = self._batch_metrics(
                    self._images(b["image"]), self._upload(b["pose"]),
                    self._upload(b["betas"]), self._upload(b["gender"]),
                )
                self._read_back(out, acc)
        err_all = np.concatenate(acc["pa_err"]).reshape(-1)
        return self._report({
            "mpjpe": float(np.mean(np.concatenate(acc["mpjpe"]))) * 1000.0,
            "pa_mpjpe": float(np.mean(np.concatenate(acc["pa_mpjpe"]))) * 1000.0,
            "pck": float(np.mean((err_all < 0.15).astype(np.float32))),
            "posed_mesh_error": float(np.mean(np.concatenate(acc["pme"]))),
            "unposed_mesh_error": float(np.mean(np.concatenate(acc["ume"]))),
        })
