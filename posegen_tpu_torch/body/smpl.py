"""SMPL body model: parameter loading + a forward (port of
posegen_tpu/body/smpl.py).

Capability parity with the reference's vendored smplx body_models.py:43-497
(`SMPL` class: shape/pose blendshapes, LBS, optional extra joint regressor
for SPIN's 49-joint output, run_gan.py:1475-1506). `SMPLModel` is an
`nn.Module` whose constants are buffers, so `.to(device)` moves it. Model
weights load from the official .pkl/.npz files (not redistributable: pass
`model_path`); `make_random_model` builds a stand-in from the same numpy
draws as the JAX package's, so one seed gives both packages one model.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from posegen_tpu_torch.body.lbs import lbs, vertices2joints
from posegen_tpu_torch.device import resolve_device

SMPL_N_JOINTS = 24


class SMPLModel(nn.Module):
    """The model's constants as float32 buffers: v_template (V, 3),
    shapedirs (V, 3, n_betas), posedirs (9*(J-1), V*3), J_regressor (J, V),
    lbs_weights (V, J) and an optional extra_joint_regressor (e.g. SPIN's
    (49 or 14, V)); parents (J,) and faces (F, 3) stay host arrays."""

    def __init__(self, v_template, shapedirs, posedirs, J_regressor, parents, lbs_weights,
                 faces: Optional[np.ndarray] = None, extra_joint_regressor=None):
        super().__init__()
        def f32(a):
            if isinstance(a, torch.Tensor):
                return a.detach().to(torch.float32)
            return torch.from_numpy(np.array(a, np.float32))

        self.register_buffer("v_template", f32(v_template))
        self.register_buffer("shapedirs", f32(shapedirs))
        self.register_buffer("posedirs", f32(posedirs))
        self.register_buffer("J_regressor", f32(J_regressor))
        self.register_buffer("lbs_weights", f32(lbs_weights))
        self.register_buffer("extra_joint_regressor",
                             None if extra_joint_regressor is None else f32(extra_joint_regressor))
        self.parents = np.asarray(parents, np.int64)
        self.faces = faces

    @property
    def n_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.v_template.shape[0]

    def forward(
        self,
        betas: torch.Tensor,
        body_pose: torch.Tensor,
        global_orient: Optional[torch.Tensor] = None,
        transl: Optional[torch.Tensor] = None,
        pose2rot: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """betas (B, n_betas); body_pose (B, (J-1)*3) or (B, J-1, 3, 3);
        global_orient (B, 3) or (B, 1, 3, 3). Returns {'vertices', 'joints'}.
        """
        B = betas.shape[0]
        if pose2rot:
            if global_orient is None:
                global_orient = betas.new_zeros(B, 3)
            pose = torch.cat([global_orient.reshape(B, 3), body_pose.reshape(B, -1)], -1)
        else:
            if global_orient is None:
                global_orient = torch.eye(3, dtype=betas.dtype,
                                          device=betas.device).expand(B, 1, 3, 3)
            pose = torch.cat([global_orient.reshape(B, 1, 3, 3),
                              body_pose.reshape(B, -1, 3, 3)], 1)
        verts, joints = lbs(
            betas, pose, self.v_template, self.shapedirs, self.posedirs,
            self.J_regressor, self.parents, self.lbs_weights, pose2rot=pose2rot,
        )
        if self.extra_joint_regressor is not None:
            joints = vertices2joints(self.extra_joint_regressor, verts)
        if transl is not None:
            verts = verts + transl[:, None]
            joints = joints + transl[:, None]
        return {"vertices": verts, "joints": joints}


def load_raw_model(model_path: str):
    """Raw dict from an official body-model file (.pkl latin1 / .npz /
    .npy-pickle), shared by every body-model loader."""
    if model_path.endswith(".npz"):
        return dict(np.load(model_path, allow_pickle=True))
    if model_path.endswith(".npy"):
        return np.load(model_path, allow_pickle=True, encoding="latin1")[()]
    with open(model_path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def dense_f32(x) -> np.ndarray:
    """Densify scipy-sparse fields (J_regressor in .pkl files) -> float32."""
    if hasattr(x, "todense"):
        x = np.asarray(x.todense())
    return np.asarray(x, dtype=np.float32)


def load_smpl_model(
    model_path: str,
    n_betas: int = 10,
    extra_joint_regressor: Optional[np.ndarray] = None,
    device="cuda",
) -> SMPLModel:
    """Load an official SMPL .pkl/.npz (fields per smplx body_models.py:499+)
    onto `device`."""
    dev = resolve_device(device)
    data = load_raw_model(model_path)
    posedirs = dense_f32(data["posedirs"])
    parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
    parents[0] = 0
    return SMPLModel(
        v_template=dense_f32(data["v_template"]),
        shapedirs=dense_f32(data["shapedirs"])[..., :n_betas],
        # official layout (V, 3, P) -> (P, V*3)
        posedirs=posedirs.reshape(-1, posedirs.shape[-1]).T,
        J_regressor=dense_f32(data["J_regressor"]),
        parents=parents,
        lbs_weights=dense_f32(data["weights"]),
        faces=np.asarray(data["f"], dtype=np.int64) if "f" in data else None,
        extra_joint_regressor=extra_joint_regressor,
    ).to(dev)


def make_random_model(
    n_vertices: int = 64,
    n_joints: int = 6,
    n_betas: int = 4,
    seed: int = 0,
    device="cuda",
) -> SMPLModel:
    """Small structurally-valid stand-in model for tests: the JAX package's
    numpy draws, in its order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    parents = np.array([0] + [i // 2 for i in range(n_joints - 1)], np.int64)

    # joints spread out; vertices clustered near their governing joint
    j_locs = rng.standard_normal((n_joints, 3)).astype(np.float32)
    owner = rng.integers(0, n_joints, n_vertices)
    v_template = (j_locs[owner] + rng.normal(0, 0.1, (n_vertices, 3))).astype(np.float32)
    lbs_w = np.zeros((n_vertices, n_joints), np.float32)
    lbs_w[np.arange(n_vertices), owner] = 1.0

    # J_regressor recovering joint locations from owned vertices
    J_reg = np.zeros((n_joints, n_vertices), np.float32)
    for j in range(n_joints):
        mask = owner == j
        if mask.any():
            J_reg[j, mask] = 1.0 / mask.sum()
        else:
            J_reg[j, rng.integers(0, n_vertices)] = 1.0
    return SMPLModel(
        v_template=v_template,
        shapedirs=rng.normal(0, 0.01, (n_vertices, 3, n_betas)).astype(np.float32),
        posedirs=rng.normal(0, 0.001, (9 * (n_joints - 1), n_vertices * 3)).astype(np.float32),
        J_regressor=J_reg,
        parents=parents,
        lbs_weights=lbs_w,
    ).to(dev)
