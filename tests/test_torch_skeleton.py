"""posegen_tpu_torch skeleton slice against posegen_tpu: the tables, the
rotations, forward kinematics and the pose fixture, on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.skeleton import skeleton as jsk
from posegen_tpu.skeleton.rotations import axisang_to_rot as j_axisang_to_rot
from posegen_tpu.utils.fixtures import make_pose_ctx as j_make_pose_ctx
from posegen_tpu_torch.skeleton import skeleton as tsk
from posegen_tpu_torch.skeleton.rotations import axisang_to_rot
from posegen_tpu_torch.utils.fixtures import make_pose_ctx


SKELETONS = ["SMPL_SKELETON", "SMPL_SKELETON_EXTENDED", "CANONICAL_SKELETON",
             "MPI_3DHP_SKELETON"]


@pytest.mark.parametrize("name", SKELETONS)
def test_skeleton_tables_match(name):
    a, b = getattr(jsk, name), getattr(tsk, name)
    assert dataclass_fields(a) == dataclass_fields(b)
    assert jsk.topological_levels(a) == tsk.topological_levels(b)
    np.testing.assert_array_equal(a.parents(), b.parents())
    for n in (17, 24, 28):
        assert jsk.skeleton_from_n_joints(n).joint_names == tsk.skeleton_from_n_joints(n).joint_names


def dataclass_fields(s):
    return (s.joint_names, s.joint_trees, s.root_id, s.cutoffs, s.end_effectors,
            s.n_joints, s.nonroot_id)


@pytest.mark.parametrize("name", SKELETONS)
def test_per_joint_cutoffs_match(name):
    """Bit-equal, at two scales and two defaults (SMPL_SKELETON has a
    family table; the others take the default everywhere)."""
    a, b = getattr(jsk, name), getattr(tsk, name)
    for ext_scale in (1.0, 0.001):
        for default_mm in (500.0, 37.5):
            ref = jsk.per_joint_cutoffs(a, ext_scale, default_mm)
            got = tsk.per_joint_cutoffs(b, ext_scale, default_mm)
            assert got.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tsk.per_joint_cutoffs(b, 0.5), jsk.per_joint_cutoffs(a, 0.5))


def test_batched_smpl_l2ws_matches():
    from posegen_tpu.skeleton.kinematics import batched_smpl_l2ws as j_batched
    from posegen_tpu_torch.skeleton.kinematics import batched_smpl_l2ws

    rng = np.random.default_rng(6)
    pose = (0.5 * rng.standard_normal((5, 24, 3))).astype(np.float32)
    rest = (tsk.SMPL_REST_POSE + 0.01 * rng.standard_normal((24, 3))).astype(np.float32)
    ref = np.asarray(j_batched(jnp.asarray(pose), jnp.asarray(rest)))
    got = batched_smpl_l2ws(torch.as_tensor(pose), torch.as_tensor(rest)).numpy()
    assert got.shape == ref.shape == (5, 24, 4, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_rest_pose_matches():
    np.testing.assert_array_equal(jsk.SMPL_REST_POSE, tsk.SMPL_REST_POSE)
    assert tsk.SMPL_REST_POSE.dtype == np.float32


def test_axisang_to_rot_matches():
    rng = np.random.default_rng(4)
    aa = rng.standard_normal((32, 3)).astype(np.float32)
    aa[:4] *= 1e-8  # the small-angle branch
    aa[4] = 0.0
    ref = np.asarray(j_axisang_to_rot(jnp.asarray(aa)))
    got = axisang_to_rot(torch.as_tensor(aa)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed,n_poses,cam", [(0, 1, False), (3, 4, True)])
def test_make_pose_ctx_matches(seed, n_poses, cam):
    ref = j_make_pose_ctx(seed, n_poses=n_poses, with_cam_idx=cam)
    got = make_pose_ctx(seed, n_poses=n_poses, with_cam_idx=cam, device="cpu")
    for field in ("kps", "skts", "cyls", "bones"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
            atol=1e-5, rtol=0, err_msg=field,
        )
    assert (got.cam_idxs is None) == (ref.cam_idxs is None)
    if cam:
        np.testing.assert_array_equal(got.cam_idxs.numpy(), np.asarray(ref.cam_idxs))
