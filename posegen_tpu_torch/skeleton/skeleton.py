"""Skeleton definitions and the SMPL rest pose (numpy data).

The port's own copy of posegen_tpu/skeleton/skeleton.py's tables (reference
skeleton_utils.py:19-282): a `Skeleton` is a hashable frozen dataclass of
joint names, parent indices and per-family cutoffs. The tests hold these
tables equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A kinematic tree.

    Attributes:
      joint_names: name per joint.
      joint_trees: parent index per joint (root points at itself).
      root_id: index of the root joint.
      cutoffs: per-joint-family cutoff distances in mm (used by the cutoff
        embedder initialisation; empty when unused).
      end_effectors: indices of leaf joints used by some regularizers.
    """

    joint_names: Tuple[str, ...]
    joint_trees: Tuple[int, ...]
    root_id: int
    cutoffs: Tuple[Tuple[str, int], ...] = ()
    end_effectors: Optional[Tuple[int, ...]] = None

    @property
    def n_joints(self) -> int:
        return len(self.joint_names)

    @property
    def nonroot_id(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.n_joints) if i != self.root_id)

    @property
    def cutoff_dict(self) -> Dict[str, int]:
        return dict(self.cutoffs)

    def parents(self) -> np.ndarray:
        return np.asarray(self.joint_trees, dtype=np.int64)


SMPL_SKELETON = Skeleton(
    joint_names=(
        "pelvis", "left_hip", "right_hip", "spine1",
        "left_knee", "right_knee", "spine2", "left_ankle",
        "right_ankle", "spine3", "left_foot", "right_foot",
        "neck", "left_collar", "right_collar", "head",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hand", "right_hand",
    ),
    joint_trees=(
        0, 0, 0, 0,
        1, 2, 3, 4,
        5, 6, 7, 8,
        9, 9, 9, 12,
        13, 14, 16, 17,
        18, 19, 20, 21,
    ),
    root_id=0,
    cutoffs=(
        ("hip", 200), ("spine", 300), ("knee", 70), ("ankle", 70),
        ("foot", 40), ("collar", 100), ("neck", 100), ("head", 120),
        ("shoulder", 70), ("elbow", 70), ("wrist", 60), ("hand", 60),
    ),
    end_effectors=(10, 11, 15, 22, 23),
)

SMPL_SKELETON_EXTENDED = Skeleton(
    joint_names=(
        "pelvis", "left_hip", "right_hip", "spine1",
        "left_knee", "right_knee", "spine2", "left_ankle",
        "right_ankle", "spine3", "left_foot", "right_foot",
        "neck", "left_collar", "right_collar", "head",
        "left_shoulder", "right_shoulder", "left_upper_arm", "right_upper_arm",
        "left_elbow", "right_elbow", "left_lower_arm", "right_lower_arm",
        "left_wrist", "right_wrist", "left_hand", "right_hand",
    ),
    joint_trees=(
        0, 0, 0, 0,
        1, 2, 3, 4,
        5, 6, 7, 8,
        9, 9, 9, 12,
        13, 14, 16, 17,
        18, 19, 20, 21,
        22, 23, 24, 25,
    ),
    root_id=0,
)

CANONICAL_SKELETON = Skeleton(
    joint_names=(
        "head_top", "neck", "right_shoulder", "right_elbow", "right_wrist",
        "left_shoulder", "left_elbow", "left_wrist", "right_hip", "right_knee",
        "right_ankle", "left_hip", "left_knee", "left_ankle", "pelvis",
        "spine", "head",
    ),
    joint_trees=(1, 15, 1, 2, 3, 1, 5, 6, 14, 8, 9, 14, 11, 12, 14, 14, 1),
    root_id=14,
)

MPI_3DHP_SKELETON = Skeleton(
    joint_names=(
        "spine3", "spine4", "spine2", "spine",
        "pelvis", "neck", "head", "head_top",
        "left_clavicle", "left_shoulder", "left_elbow", "left_wrist",
        "left_hand", "right_clavicle", "right_shoulder", "right_elbow",
        "right_wrist", "right_hand", "left_hip", "left_knee",
        "left_ankle", "left_foot", "left_toe", "right_hip",
        "right_knee", "right_ankle", "right_foot", "right_toe",
    ),
    joint_trees=(
        2, 0, 3, 4, 4, 1, 5, 6, 5, 8, 9, 10, 11, 5, 13, 14,
        15, 16, 4, 18, 19, 20, 21, 4, 23, 24, 25, 26,
    ),
    root_id=4,
)

# SMPL neutral rest-pose joint locations in the NeRF world convention
# (reference skeleton_utils.py:259-282; derived from SMPL's (x,-z,y) frame).
SMPL_REST_POSE = np.array(
    [
        [0.00000000e00, 2.30003661e-09, -9.86228770e-08],
        [1.63832515e-01, -2.17391014e-01, -2.89178602e-02],
        [-1.57855421e-01, -2.14761734e-01, -2.09642015e-02],
        [-7.04505108e-03, 2.50450850e-01, -4.11837511e-02],
        [2.42021069e-01, -1.08830070e00, -3.14962119e-02],
        [-2.47206554e-01, -1.10715497e00, -3.06970738e-02],
        [3.95125849e-03, 5.94849110e-01, -4.03754264e-02],
        [2.12680623e-01, -1.99382353e00, -1.29327580e-01],
        [-2.10857525e-01, -2.01218796e00, -1.23002514e-01],
        [9.39484313e-03, 7.19204426e-01, 2.06931755e-02],
        [2.63385147e-01, -2.12222481e00, 1.46775618e-01],
        [-2.51970559e-01, -2.12153077e00, 1.60450473e-01],
        [3.83779174e-03, 1.22592449e00, -9.78838727e-02],
        [1.91201791e-01, 1.00385976e00, -6.21964522e-02],
        [-1.77145526e-01, 9.96228695e-01, -7.55542740e-02],
        [1.68482102e-02, 1.38698268e00, 2.44048554e-02],
        [4.01985168e-01, 1.07928419e00, -7.47655183e-02],
        [-3.98825467e-01, 1.07523870e00, -9.96334553e-02],
        [1.00236952e00, 1.05217218e00, -1.35129794e-01],
        [-9.86728609e-01, 1.04515052e00, -1.40235111e-01],
        [1.56646240e00, 1.06961894e00, -1.37338534e-01],
        [-1.56946480e00, 1.05935931e00, -1.53905824e-01],
        [1.75282109e00, 1.04682994e00, -1.68231070e-01],
        [-1.75758195e00, 1.04255080e00, -1.77773550e-01],
    ],
    dtype=np.float32,
)


def skeleton_from_n_joints(n: int) -> Skeleton:
    """Guess a skeleton from the joint count (reference skeleton_utils.py:180)."""
    if n == 17:
        return CANONICAL_SKELETON
    if n == 28:
        return MPI_3DHP_SKELETON
    return SMPL_SKELETON


def topological_levels(skel: Skeleton) -> Tuple[Tuple[int, ...], ...]:
    """Group joints by depth in the kinematic tree.

    Level 0 is the root; each level's joints only depend on parents from
    earlier levels, so forward kinematics processes one level at a time with
    a single batched matmul.
    """
    parents = skel.joint_trees
    depth = [0] * skel.n_joints
    for j in range(skel.n_joints):
        d, p = 0, j
        while p != skel.root_id:
            p = parents[p]
            d += 1
            if d > skel.n_joints:  # malformed tree guard
                raise ValueError("cycle in kinematic tree")
        depth[j] = d
    max_d = max(depth)
    return tuple(
        tuple(j for j in range(skel.n_joints) if depth[j] == d)
        for d in range(max_d + 1)
    )


def per_joint_cutoffs(skel: Skeleton, ext_scale: float, default_mm: float = 500.0) -> np.ndarray:
    """Per-joint cutoff distances (world units): the first family of
    `skel.cutoffs` whose name is in the joint's name, else `default_mm`,
    times `ext_scale`."""
    out = np.full((skel.n_joints,), default_mm, dtype=np.float32)
    for i, name in enumerate(skel.joint_names):
        for fam, mm in skel.cutoff_dict.items():
            if fam in name:
                out[i] = float(mm)
                break
    return out * ext_scale
