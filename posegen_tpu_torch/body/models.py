"""SMPL-X / MANO / FLAME body models in PyTorch (port of
posegen_tpu/body/models.py).

Capability parity with the reference's vendored smplx library
(smplx/smplx/body_models.py:883 SMPLX, :1489 MANO, :1766 FLAME, plus
vertex_joint_selector.py and joint_names.py), on the port's LBS core
(`body/lbs.py`):

  * expression blendshapes as a separate expr_dirs bank concatenated with the
    shape bank at call time (body_models.py:1228-1234),
  * jaw/eye/hand pose partitioning into one flat axis-angle full_pose with a
    data-supplied pose mean (hands are flat only when flat_hand_mean),
  * PCA-compressed hand poses (hands_components, body_models.py:1201),
  * extra "joints" gathered from mesh vertices (finger tips, face/feet
    keypoints, vertex_joint_selector.py:29-77),
  * facial landmarks by barycentric interpolation over lookup faces, with
    the optional pose-dependent contour (lbs.py:30-148).

Each model is an `nn.Module` whose constants are float32 buffers (the face
and landmark indices int64), so `.to(device)` moves it, like
`body/smpl.SMPLModel`; the kinematic tree, the extra-joint vertex ids and
the neck chain stay host arrays. The forwards take and return the JAX
models' arguments and dicts. The loaders read the official files through
`body/smpl.load_raw_model` onto `device` (CUDA by default; raises without a
card).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from posegen_tpu_torch.body.lbs import lbs
from posegen_tpu_torch.body.smpl import dense_f32 as _arr
from posegen_tpu_torch.body.smpl import load_raw_model as _load_raw
from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.skeleton.rotations import axisang_to_rot

# ---------------------------------------------------------------------------
# Constant tables (model-topology data, mirrored from the reference:
# smplx/smplx/vertex_ids.py and joint_names.py; these are data, not code)
# ---------------------------------------------------------------------------

VERTEX_IDS: Dict[str, Dict[str, int]] = {
    "smplh": {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
        "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
        "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
    },
    "smplx": {
        "nose": 9120, "reye": 9929, "leye": 9448, "rear": 616, "lear": 6,
        "rthumb": 8079, "rindex": 7669, "rmiddle": 7794, "rring": 7905,
        "rpinky": 8022, "lthumb": 5361, "lindex": 4933, "lmiddle": 5058,
        "lring": 5169, "lpinky": 5286, "LBigToe": 5770, "LSmallToe": 5780,
        "LHeel": 8846, "RBigToe": 8463, "RSmallToe": 8474, "RHeel": 8635,
    },
    "mano": {
        "thumb": 744, "index": 320, "middle": 443, "ring": 554, "pinky": 671,
    },
}

_SMPLX_BODY_JOINT_NAMES = [
    "pelvis", "left_hip", "right_hip", "spine1", "left_knee", "right_knee",
    "spine2", "left_ankle", "right_ankle", "spine3", "left_foot",
    "right_foot", "neck", "left_collar", "right_collar", "head",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "jaw", "left_eye_smplhf",
    "right_eye_smplhf",
]
_FINGER_JOINT_NAMES = [
    f"{side}_{finger}{i}"
    for side in ("left", "right")
    for finger in ("index", "middle", "pinky", "ring", "thumb")
    for i in (1, 2, 3)
]
_EXTRA_VERTEX_JOINT_NAMES = [
    "nose", "right_eye", "left_eye", "right_ear", "left_ear",
    "left_big_toe", "left_small_toe", "left_heel", "right_big_toe",
    "right_small_toe", "right_heel",
    "left_thumb", "left_index", "left_middle", "left_ring", "left_pinky",
    "right_thumb", "right_index", "right_middle", "right_ring", "right_pinky",
]
_FACE_LANDMARK_NAMES = (
    [f"right_eye_brow{i}" for i in (1, 2, 3, 4, 5)]
    + [f"left_eye_brow{i}" for i in (5, 4, 3, 2, 1)]
    + ["nose1", "nose2", "nose3", "nose4"]
    + ["right_nose_2", "right_nose_1", "nose_middle", "left_nose_1", "left_nose_2"]
    + [f"right_eye{i}" for i in (1, 2, 3, 4, 5, 6)]
    + [f"left_eye{i}" for i in (4, 3, 2, 1, 6, 5)]
    + [
        "right_mouth_1", "right_mouth_2", "right_mouth_3", "mouth_top",
        "left_mouth_3", "left_mouth_2", "left_mouth_1", "left_mouth_5",
        "left_mouth_4", "mouth_bottom", "right_mouth_4", "right_mouth_5",
        "right_lip_1", "right_lip_2", "lip_top", "left_lip_2", "left_lip_1",
        "left_lip_3", "lip_bottom", "right_lip_3",
    ]
)
_FACE_CONTOUR_NAMES = (
    [f"right_contour_{i}" for i in range(1, 9)]
    + ["contour_middle"]
    + [f"left_contour_{i}" for i in range(8, 0, -1)]
)

# SMPL-X output joint ordering (reference joint_names.py:17-161): 55 skeleton
# joints, 21 vertex-selected keypoints, 51 face landmarks, 17 contour points.
SMPLX_JOINT_NAMES = (
    _SMPLX_BODY_JOINT_NAMES
    + _FINGER_JOINT_NAMES
    + _EXTRA_VERTEX_JOINT_NAMES
    + _FACE_LANDMARK_NAMES
    + _FACE_CONTOUR_NAMES
)

SMPLX_N_JOINTS = 55  # 22 body + jaw + 2 eyes + 2x15 hand
MANO_N_JOINTS = 16
FLAME_N_JOINTS = 5


def extra_joints_idxs(
    vertex_ids: Dict[str, int],
    use_hands: bool = True,
    use_feet_keypoints: bool = True,
) -> np.ndarray:
    """Vertex indices appended to the skeleton joints
    (reference vertex_joint_selector.py:36-71): 5 face keypoints, 6 feet
    keypoints, 10 finger tips."""
    idxs = [vertex_ids[k] for k in ("nose", "reye", "leye", "rear", "lear")]
    if use_feet_keypoints:
        idxs += [
            vertex_ids[k]
            for k in ("LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel")
        ]
    if use_hands:
        idxs += [
            vertex_ids[h + t]
            for h in ("l", "r")
            for t in ("thumb", "index", "middle", "ring", "pinky")
        ]
    return np.asarray(idxs, dtype=np.int64)


def vertices2landmarks(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    lmk_faces_idx: torch.Tensor,
    lmk_bary_coords: torch.Tensor,
) -> torch.Tensor:
    """Barycentric landmark interpolation (reference lbs.py:108-148).

    vertices (B, V, 3); faces (F, 3) int; lmk_faces_idx (L,) or (B, L);
    lmk_bary_coords (L, 3) or (B, L, 3) -> (B, L, 3).
    """
    B = vertices.shape[0]
    if lmk_faces_idx.dim() == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(B, -1)
    if lmk_bary_coords.dim() == 2:
        lmk_bary_coords = lmk_bary_coords[None].expand(B, -1, -1)
    lmk_faces = faces[lmk_faces_idx]  # (B, L, 3)
    batch = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_verts = vertices[batch, lmk_faces]  # (B, L, 3, 3)
    return (lmk_verts * lmk_bary_coords[..., None]).sum(2)


def find_joint_kin_chain(joint_id: int, parents: np.ndarray) -> np.ndarray:
    chain = []
    j = int(joint_id)
    while j != 0:
        chain.append(j)
        j = int(parents[j])
    chain.append(0)
    return np.asarray(chain, dtype=np.int64)


def find_dynamic_lmk_idx_and_bcoords(
    full_pose: torch.Tensor,
    dynamic_lmk_faces_idx: torch.Tensor,
    dynamic_lmk_bary_coords: torch.Tensor,
    neck_kin_chain: np.ndarray,
    pose2rot: bool = True,
):
    """Pose-dependent face-contour lookup (reference lbs.py:30-105): the
    head's y rotation (accumulated along the neck kinematic chain), in
    degrees clipped at 39 and rounded half to even, indexes a 79-bin table
    of contour faces + barycentrics."""
    B = full_pose.shape[0]
    chain = torch.as_tensor(neck_kin_chain, device=full_pose.device)
    if pose2rot:
        rot_mats = axisang_to_rot(full_pose.reshape(B, -1, 3)[:, chain])
    else:
        rot_mats = full_pose.reshape(B, -1, 3, 3)[:, chain]

    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(B, 3, 3)
    for i in range(len(neck_kin_chain)):
        rel = torch.matmul(rot_mats[:, i], rel)

    # y euler angle (reference utils.rot_mat_to_euler)
    sy = torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2)
    y_ang = torch.atan2(-rel[:, 2, 0], sy)
    y_deg = torch.round(torch.clamp(-y_ang * 180.0 / np.pi, max=39)).to(torch.int64)
    neg_vals = torch.where(y_deg < -39, torch.full_like(y_deg, 78), 39 - y_deg)
    idx = torch.where(y_deg < 0, neg_vals, y_deg)
    return dynamic_lmk_faces_idx[idx], dynamic_lmk_bary_coords[idx]


def _flat_pose(x: Optional[torch.Tensor], B: int, dim: int, like: torch.Tensor) -> torch.Tensor:
    if x is None:
        return like.new_zeros((B, dim))
    return x.reshape(B, dim)


def _landmarks(model, verts: torch.Tensor, full_pose: torch.Tensor) -> torch.Tensor:
    """The static landmarks, and the contour ones where the model has them."""
    B = verts.shape[0]
    lmk_idx, lmk_b = model.lmk_faces_idx, model.lmk_bary_coords
    if model.use_face_contour:
        dyn_idx, dyn_b = find_dynamic_lmk_idx_and_bcoords(
            full_pose, model.dynamic_lmk_faces_idx, model.dynamic_lmk_bary_coords,
            model.neck_kin_chain,
        )
        lmk_idx = torch.cat([lmk_idx[None].expand(B, -1), dyn_idx], 1)
        lmk_b = torch.cat([lmk_b[None].expand(B, -1, -1), dyn_b], 1)
    return vertices2landmarks(verts, model.faces, lmk_idx, lmk_b)


class _BodyModel(nn.Module):
    """Buffers from arrays: floats as float32, indices as int64; None kept."""

    def _buffers_from(self, floats: Dict, ints: Dict) -> None:
        for name, a in floats.items():
            self.register_buffer(name, None if a is None else _tensor(a, torch.float32))
        for name, a in ints.items():
            self.register_buffer(name, None if a is None else _tensor(a, torch.int64))


def _tensor(a, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to(dtype)
    return torch.tensor(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# SMPL-X
# ---------------------------------------------------------------------------


class SMPLXModel(_BodyModel):
    """SMPL-X constants (reference body_models.py:883-1288): v_template
    (V, 3), shapedirs (V, 3, n_betas), expr_dirs (V, 3, n_expr), posedirs
    (9 * (J - 1), V * 3), J_regressor (J = 55, V), lbs_weights (V, J),
    pose_mean (165,) (zeros but the hand means), left / right
    hand_components (n_pca, 45) when PCA hands, lmk_faces_idx (51,),
    lmk_bary_coords (51, 3), dynamic_lmk_faces_idx (79, 17),
    dynamic_lmk_bary_coords (79, 17, 3), faces (F, 3)."""

    N_BODY_JOINTS = 21

    def __init__(self, v_template, shapedirs, expr_dirs, posedirs, J_regressor, lbs_weights,
                 pose_mean, left_hand_components, right_hand_components, lmk_faces_idx,
                 lmk_bary_coords, dynamic_lmk_faces_idx, dynamic_lmk_bary_coords, faces,
                 parents, extra_joints, neck_kin_chain, use_face_contour: bool = False):
        super().__init__()
        self._buffers_from(
            dict(v_template=v_template, shapedirs=shapedirs, expr_dirs=expr_dirs,
                 posedirs=posedirs, J_regressor=J_regressor, lbs_weights=lbs_weights,
                 pose_mean=pose_mean, left_hand_components=left_hand_components,
                 right_hand_components=right_hand_components, lmk_bary_coords=lmk_bary_coords,
                 dynamic_lmk_bary_coords=dynamic_lmk_bary_coords),
            dict(lmk_faces_idx=lmk_faces_idx, dynamic_lmk_faces_idx=dynamic_lmk_faces_idx,
                 faces=faces))
        self.parents = np.asarray(parents, np.int64)
        self.extra_joints = np.asarray(extra_joints, np.int64)
        self.neck_kin_chain = np.asarray(neck_kin_chain, np.int64)
        self.use_face_contour = bool(use_face_contour)

    @property
    def use_pca(self) -> bool:
        return self.left_hand_components is not None

    @property
    def n_joints(self) -> int:
        return self.J_regressor.shape[0]

    def forward(
        self,
        betas: torch.Tensor,
        body_pose: Optional[torch.Tensor] = None,
        global_orient: Optional[torch.Tensor] = None,
        left_hand_pose: Optional[torch.Tensor] = None,
        right_hand_pose: Optional[torch.Tensor] = None,
        jaw_pose: Optional[torch.Tensor] = None,
        leye_pose: Optional[torch.Tensor] = None,
        reye_pose: Optional[torch.Tensor] = None,
        expression: Optional[torch.Tensor] = None,
        transl: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Axis-angle forward (reference SMPLX.forward, body_models.py:1110).

        Returns {'vertices' (B, V, 3), 'joints' (B, 127 [+17], 3),
        'full_pose'}. Joint layout follows SMPLX_JOINT_NAMES: 55 skeleton
        joints, 21 vertex keypoints, 51 landmarks (+17 contour if
        use_face_contour).
        """
        B = betas.shape[0]
        if expression is None:
            expression = betas.new_zeros((B, self.expr_dirs.shape[-1]))
        hand_dim = self.left_hand_components.shape[0] if self.use_pca else 45
        lh = _flat_pose(left_hand_pose, B, hand_dim, betas)
        rh = _flat_pose(right_hand_pose, B, hand_dim, betas)
        if self.use_pca:
            lh = torch.matmul(lh, self.left_hand_components)
            rh = torch.matmul(rh, self.right_hand_components)

        full_pose = torch.cat([
            _flat_pose(global_orient, B, 3, betas),
            _flat_pose(body_pose, B, self.N_BODY_JOINTS * 3, betas),
            _flat_pose(jaw_pose, B, 3, betas),
            _flat_pose(leye_pose, B, 3, betas),
            _flat_pose(reye_pose, B, 3, betas),
            lh,
            rh,
        ], -1)
        full_pose = full_pose + self.pose_mean

        shape_components = torch.cat([betas, expression], -1)
        shapedirs = torch.cat([self.shapedirs, self.expr_dirs], -1)
        verts, joints = lbs(
            shape_components, full_pose, self.v_template, shapedirs,
            self.posedirs, self.J_regressor, self.parents, self.lbs_weights,
        )
        extra = torch.as_tensor(self.extra_joints, device=verts.device)
        joints = torch.cat([joints, verts[:, extra]], 1)
        if self.lmk_faces_idx is not None:
            joints = torch.cat([joints, _landmarks(self, verts, full_pose)], 1)

        if transl is not None:
            verts = verts + transl[:, None]
            joints = joints + transl[:, None]
        return {"vertices": verts, "joints": joints, "full_pose": full_pose}


# ---------------------------------------------------------------------------
# MANO
# ---------------------------------------------------------------------------


class MANOModel(_BodyModel):
    """MANO hand model constants (reference body_models.py:1489-1697):
    v_template (778, 3), J_regressor (16, V), pose_mean (48,) (zeros(3) ++
    the hand mean), hand_components (n_pca, 45) when PCA."""

    def __init__(self, v_template, shapedirs, posedirs, J_regressor, lbs_weights, pose_mean,
                 hand_components, faces, parents):
        super().__init__()
        self._buffers_from(
            dict(v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
                 J_regressor=J_regressor, lbs_weights=lbs_weights, pose_mean=pose_mean,
                 hand_components=hand_components),
            dict(faces=faces))
        self.parents = np.asarray(parents, np.int64)

    @property
    def use_pca(self) -> bool:
        return self.hand_components is not None

    def forward(
        self,
        betas: torch.Tensor,
        hand_pose: Optional[torch.Tensor] = None,
        global_orient: Optional[torch.Tensor] = None,
        transl: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        B = betas.shape[0]
        hand_dim = self.hand_components.shape[0] if self.use_pca else 45
        hp = _flat_pose(hand_pose, B, hand_dim, betas)
        if self.use_pca:
            hp = torch.matmul(hp, self.hand_components)
        full_pose = torch.cat([_flat_pose(global_orient, B, 3, betas), hp], -1)
        full_pose = full_pose + self.pose_mean
        verts, joints = lbs(
            betas, full_pose, self.v_template, self.shapedirs, self.posedirs,
            self.J_regressor, self.parents, self.lbs_weights,
        )
        if transl is not None:
            verts = verts + transl[:, None]
            joints = joints + transl[:, None]
        return {"vertices": verts, "joints": joints, "full_pose": full_pose}


# ---------------------------------------------------------------------------
# FLAME
# ---------------------------------------------------------------------------


class FLAMEModel(_BodyModel):
    """FLAME head model constants (reference body_models.py:1766-2135).

    Joints: global, neck, jaw, left eye, right eye. Landmark tables come
    from the separate static/dynamic embedding files and are optional.
    """

    NECK_IDX = 0  # reference body_models.py:1770 (global orient drives the contour)

    def __init__(self, v_template, shapedirs, expr_dirs, posedirs, J_regressor, lbs_weights,
                 lmk_faces_idx, lmk_bary_coords, dynamic_lmk_faces_idx,
                 dynamic_lmk_bary_coords, faces, parents, neck_kin_chain,
                 use_face_contour: bool = False):
        super().__init__()
        self._buffers_from(
            dict(v_template=v_template, shapedirs=shapedirs, expr_dirs=expr_dirs,
                 posedirs=posedirs, J_regressor=J_regressor, lbs_weights=lbs_weights,
                 lmk_bary_coords=lmk_bary_coords,
                 dynamic_lmk_bary_coords=dynamic_lmk_bary_coords),
            dict(lmk_faces_idx=lmk_faces_idx, dynamic_lmk_faces_idx=dynamic_lmk_faces_idx,
                 faces=faces))
        self.parents = np.asarray(parents, np.int64)
        self.neck_kin_chain = np.asarray(neck_kin_chain, np.int64)
        self.use_face_contour = bool(use_face_contour)

    def forward(
        self,
        betas: torch.Tensor,
        global_orient: Optional[torch.Tensor] = None,
        neck_pose: Optional[torch.Tensor] = None,
        jaw_pose: Optional[torch.Tensor] = None,
        leye_pose: Optional[torch.Tensor] = None,
        reye_pose: Optional[torch.Tensor] = None,
        expression: Optional[torch.Tensor] = None,
        transl: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        B = betas.shape[0]
        if expression is None:
            expression = betas.new_zeros((B, self.expr_dirs.shape[-1]))
        full_pose = torch.cat([
            _flat_pose(global_orient, B, 3, betas),
            _flat_pose(neck_pose, B, 3, betas),
            _flat_pose(jaw_pose, B, 3, betas),
            _flat_pose(leye_pose, B, 3, betas),
            _flat_pose(reye_pose, B, 3, betas),
        ], -1)
        shape_components = torch.cat([betas, expression], -1)
        shapedirs = torch.cat([self.shapedirs, self.expr_dirs], -1)
        verts, joints = lbs(
            shape_components, full_pose, self.v_template, shapedirs,
            self.posedirs, self.J_regressor, self.parents, self.lbs_weights,
        )
        if self.lmk_faces_idx is not None:
            joints = torch.cat([joints, _landmarks(self, verts, full_pose)], 1)
        if transl is not None:
            verts = verts + transl[:, None]
            joints = joints + transl[:, None]
        return {"vertices": verts, "joints": joints, "full_pose": full_pose}


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------


def _split_shape_expr(shapedirs: np.ndarray, n_betas: int, n_expr: int):
    """Partition the shapedirs bank into shape | expression
    (reference body_models.py:1048-1068: full models store 300 shape + 100
    expression columns; trimmed models store 10 + 10)."""
    total = shapedirs.shape[-1]
    if total < 300 + 100:  # trimmed release
        shape_cols = shapedirs[..., : min(n_betas, 10)]
        expr_cols = shapedirs[..., 10 : 10 + min(n_expr, 10)]
    else:
        shape_cols = shapedirs[..., :n_betas]
        expr_cols = shapedirs[..., 300 : 300 + n_expr]
    return shape_cols, expr_cols


def _posedirs(data) -> np.ndarray:
    p = _arr(data["posedirs"])
    return p.reshape(-1, p.shape[-1]).T


def _parents(data) -> np.ndarray:
    parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
    parents[0] = 0
    return parents


def _hand_pca(data, key: str, n_pca: int, use_pca: bool):
    if not use_pca or key not in data:
        return None
    return _arr(data[key])[:n_pca]


def _hand_mean(data, key: str, flat_hand_mean: bool) -> np.ndarray:
    mean = _arr(data[key]) if key in data else np.zeros(45, np.float32)
    return np.zeros_like(mean) if flat_hand_mean else mean


def _faces(data):
    return np.asarray(data["f"], np.int64) if "f" in data else None


def load_smplx_model(
    model_path: str,
    n_betas: int = 10,
    n_expr: int = 10,
    use_pca: bool = True,
    num_pca_comps: int = 6,
    flat_hand_mean: bool = False,
    use_face_contour: bool = False,
    device="cuda",
) -> SMPLXModel:
    """Load an official SMPLX_{GENDER}.npz/.pkl onto `device`
    (fields per reference body_models.py:965-1108)."""
    dev = resolve_device(device)
    data = _load_raw(model_path)
    shape_cols, expr_cols = _split_shape_expr(_arr(data["shapedirs"]), n_betas, n_expr)
    parents = _parents(data)

    lh_mean = _hand_mean(data, "hands_meanl", flat_hand_mean)
    rh_mean = _hand_mean(data, "hands_meanr", flat_hand_mean)
    pose_mean = np.concatenate([np.zeros(3 + 21 * 3 + 9, np.float32), lh_mean, rh_mean])

    has_lmk = "lmk_faces_idx" in data
    has_dyn = use_face_contour and "dynamic_lmk_faces_idx" in data
    return SMPLXModel(
        v_template=_arr(data["v_template"]),
        shapedirs=shape_cols,
        expr_dirs=expr_cols,
        posedirs=_posedirs(data),
        J_regressor=_arr(data["J_regressor"]),
        lbs_weights=_arr(data["weights"]),
        pose_mean=pose_mean,
        left_hand_components=_hand_pca(data, "hands_componentsl", num_pca_comps, use_pca),
        right_hand_components=_hand_pca(data, "hands_componentsr", num_pca_comps, use_pca),
        lmk_faces_idx=np.asarray(data["lmk_faces_idx"], np.int64) if has_lmk else None,
        lmk_bary_coords=_arr(data["lmk_bary_coords"]) if has_lmk else None,
        dynamic_lmk_faces_idx=np.asarray(data["dynamic_lmk_faces_idx"], np.int64)
        if has_dyn else None,
        dynamic_lmk_bary_coords=_arr(data["dynamic_lmk_bary_coords"]) if has_dyn else None,
        faces=_faces(data),
        parents=parents,
        extra_joints=extra_joints_idxs(VERTEX_IDS["smplx"]),
        neck_kin_chain=find_joint_kin_chain(12, parents),
        use_face_contour=has_dyn,
    ).to(dev)


def load_mano_model(
    model_path: str,
    n_betas: int = 10,
    use_pca: bool = True,
    num_pca_comps: int = 6,
    flat_hand_mean: bool = False,
    device="cuda",
) -> MANOModel:
    """Load an official MANO_{LEFT,RIGHT}.pkl onto `device`
    (fields per reference body_models.py:1519-1625); num_pca_comps 45 turns
    PCA off."""
    dev = resolve_device(device)
    data = _load_raw(model_path)
    if num_pca_comps == 45:
        use_pca = False
    hand_mean = _hand_mean(data, "hands_mean", flat_hand_mean)
    pose_mean = np.concatenate([np.zeros(3, np.float32), hand_mean])
    return MANOModel(
        v_template=_arr(data["v_template"]),
        shapedirs=_arr(data["shapedirs"])[..., :n_betas],
        posedirs=_posedirs(data),
        J_regressor=_arr(data["J_regressor"]),
        lbs_weights=_arr(data["weights"]),
        pose_mean=pose_mean,
        hand_components=_hand_pca(data, "hands_components", num_pca_comps, use_pca),
        faces=_faces(data),
        parents=_parents(data),
    ).to(dev)


def load_flame_model(
    model_path: str,
    n_betas: int = 10,
    n_expr: int = 10,
    landmark_path: Optional[str] = None,
    contour_path: Optional[str] = None,
    device="cuda",
) -> FLAMEModel:
    """Load an official FLAME_{GENDER}.pkl/.npz plus optional landmark
    embedding files onto `device` (reference body_models.py:1836-2135)."""
    dev = resolve_device(device)
    data = _load_raw(model_path)
    shape_cols, expr_cols = _split_shape_expr(_arr(data["shapedirs"]), n_betas, n_expr)
    parents = _parents(data)

    lmk_idx = lmk_b = dyn_idx = dyn_b = None
    if landmark_path:
        lmk = _load_raw(landmark_path)
        lmk_idx = np.asarray(lmk["lmk_face_idx"], np.int64)
        lmk_b = _arr(lmk["lmk_b_coords"])
    if contour_path:
        cont = _load_raw(contour_path)
        dyn_idx = np.asarray(cont["lmk_face_idx"], np.int64)
        dyn_b = _arr(cont["lmk_b_coords"])

    return FLAMEModel(
        v_template=_arr(data["v_template"]),
        shapedirs=shape_cols,
        expr_dirs=expr_cols,
        posedirs=_posedirs(data),
        J_regressor=_arr(data["J_regressor"]),
        lbs_weights=_arr(data["weights"]),
        lmk_faces_idx=lmk_idx,
        lmk_bary_coords=lmk_b,
        dynamic_lmk_faces_idx=dyn_idx,
        dynamic_lmk_bary_coords=dyn_b,
        faces=_faces(data),
        parents=parents,
        neck_kin_chain=find_joint_kin_chain(FLAMEModel.NECK_IDX, parents),
        use_face_contour=dyn_idx is not None,
    ).to(dev)
