"""Multiview pose sharing (port of posegen_tpu/data/multiview.py): map N
camera views of the same motion onto one optimized pose row.

Capability parity with the reference's H36M multiview machinery
(core/load_h36m.py:251-345 `find_motion_set` / `create_kp_mapping` /
`map_data_to_n_views`, wired by `H36MDataset._load_multiview_pose`,
load_h36m.py:422-431): frames are grouped into motion sets by the second
path component, each set's frames map onto `count // n_views` unique poses
(frame order interleaves views), non-root joints are AVERAGED across the
views of each unique pose, and the skts are rebuilt from the remapped
bones. The per-view root position/rotation stays per-frame — the pose-opt
layer optimizes shared non-root bones + per-view roots (pose/opt.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws


def find_motion_set(img_paths) -> Tuple[Dict, Dict, np.ndarray]:
    """Group frames by motion-set name (2nd path component,
    reference load_h36m.py:251-265)."""
    set_dict: Dict[str, int] = {}
    set_cnt: Dict[str, int] = {}
    set_idxs: List[int] = []
    for p in img_paths:
        p = os.fsdecode(p)
        parts = p.split("/")
        set_name = parts[1] if len(parts) > 1 else parts[0]
        if set_name not in set_dict:
            set_dict[set_name] = len(set_dict)
            set_cnt[set_name] = 1
        else:
            set_cnt[set_name] += 1
        set_idxs.append(set_dict[set_name])
    return set_dict, set_cnt, np.asarray(set_idxs)


def create_kp_mapping(
    set_dict: Dict, set_cnt: Dict, set_idxs: np.ndarray, n_views: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """frame index -> unique-pose index, + the first-view frame indices
    (reference load_h36m.py:267-288)."""
    assert n_views % 2 == 0
    kp_map, unique_indices = [], []
    acc_idx = acc_unique = 0
    for set_name in set_dict:
        num_kp_original = set_cnt[set_name]
        num_kps = num_kp_original // n_views
        kp_off = np.arange(num_kp_original) % num_kps
        kp_map.append(kp_off + acc_idx)
        unique_indices.append(kp_off + acc_unique)
        acc_idx += num_kps
        acc_unique += num_kp_original
    return np.concatenate(kp_map), np.unique(np.concatenate(unique_indices))


def map_data_to_n_views(
    img_paths,
    kp3d: np.ndarray,
    bones: np.ndarray,
    rest_pose: np.ndarray,
    n_views: int = 4,
    avg_kps: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (kp_map, kp_uidxs, kp3d', bones', skts') with non-root parts
    shared/averaged across views (reference load_h36m.py:306-345).

    Root position/rotation stays per-view; skts are rebuilt by FK from the
    remapped bones with the per-view root translation; the kinematics run in
    float32 on the host.
    """

    def set_root(k, k_unique, k_map, root_id=0):
        root = k[:, root_id : root_id + 1]
        if not avg_kps:
            other_parts = k_unique[k_map, root_id + 1 :]
        else:
            other_parts = np.zeros_like(k_unique[:, root_id + 1 :])
            for i, k_idx in enumerate(k_map):
                other_parts[k_idx] = other_parts[k_idx] + k[i, root_id + 1 :]
            other_parts = other_parts / float(n_views)
            other_parts = other_parts[k_map]
        return np.concatenate([root, other_parts], axis=1)

    set_dict, set_cnt, set_idxs = find_motion_set(img_paths)
    kp_map, kp_uidxs = create_kp_mapping(set_dict, set_cnt, set_idxs, n_views=n_views)

    unique_bones = bones[kp_uidxs]
    unique_kp3d = kp3d[kp_uidxs]

    bones = set_root(bones, unique_bones, kp_map)
    kp3d = set_root(kp3d, unique_kp3d, kp_map)

    # rebuild skts from the remapped bones; root at the per-view kp3d root
    # (reference load_h36m.py:338-342: get_smpl_l2ws + root offset + inverse)
    with torch.no_grad():
        l2ws = smpl_l2ws(torch.as_tensor(bones), rest_pose=torch.as_tensor(rest_pose),
                         scale=1.0).numpy()
        l2ws[..., :3, -1] = l2ws[..., :3, -1] + kp3d[:, 0:1]
        skts = invert_rigid(torch.from_numpy(l2ws)).numpy()

    return kp_map.astype(np.int64), kp_uidxs.astype(np.int64), kp3d, bones, skts
