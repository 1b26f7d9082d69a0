"""posegen_tpu_torch pose refinement against posegen_tpu: the rotation
algebra, the kinematics of a full pose, every function of pose/opt.py
(single-view and multiview parameter layouts) and the flip-flop schedule,
on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.pose import flipflop as jff
from posegen_tpu.pose import opt as jopt
from posegen_tpu.skeleton import kinematics as jkin
from posegen_tpu.skeleton import rotations as jrot
from posegen_tpu.skeleton.skeleton import SMPL_REST_POSE
from posegen_tpu_torch.pose import flipflop as tff
from posegen_tpu_torch.pose import opt as topt
from posegen_tpu_torch.skeleton import kinematics as tkin
from posegen_tpu_torch.skeleton import rotations as trot

TOL = 1e-5  # float32 rotation algebra: both frameworks, same formulas
F_FRAMES, B = 6, 5


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, tol=TOL, err=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=tol, rtol=tol, err_msg=err)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Axis-angles (one of them below the small-angle threshold), rotation
    matrices, unnormalised rot6d and quaternions, (32, ...)."""
    rng = np.random.default_rng(11)
    aa = (rng.standard_normal((32, 3)) * 0.7).astype(np.float32)
    aa[0] = 1e-8
    aa[1] = 0.0
    rot = np.asarray(jrot.axisang_to_rot(jnp.asarray(aa)))
    r6 = (rng.standard_normal((32, 6)) + np.array([1, 0, 0, 1, 0, 0])).astype(np.float32)
    quat = np.asarray(jrot.axisang_to_quat(jnp.asarray(aa)))
    return {"aa": aa, "rot": rot, "r6": r6, "quat": quat}


ROTATIONS = {
    "axisang_to_rot": "aa", "rot_to_quat": "rot", "quat_to_axisang": "quat",
    "rot_to_axisang": "rot", "axisang_to_quat": "aa", "rot6d_to_rot": "r6",
    "rot_to_rot6d": "rot", "rot6d_to_axisang": "r6", "bones_to_rot": "aa",
    "bones_to_rot_6d": "r6",
}


@pytest.mark.parametrize("name", list(ROTATIONS))
def test_rotation_matches_jax(name):
    x = _inputs()[ROTATIONS[name]]
    fn = name.replace("_6d", "")
    _close(getattr(trot, fn)(_t(x)), getattr(jrot, fn)(jnp.asarray(x)), err=name)


@pytest.mark.parametrize("name", ["axisang_to_rot", "rot6d_to_rot"])
def test_rotation_gradients_are_finite_at_zero(name):
    """The gradient-safe branches: zero axis-angle and a degenerate rot6d
    column keep finite gradients."""
    x = torch.zeros(2, 3 if name == "axisang_to_rot" else 6, requires_grad=True)
    getattr(trot, name)(x).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


@functools.lru_cache(maxsize=None)
def _pose(rot6d: bool):
    rng = np.random.default_rng(5)
    bones = (rng.standard_normal((B, 24, 3)) * 0.3).astype(np.float32)
    if rot6d:
        bones = np.asarray(jrot.rot_to_rot6d(jrot.axisang_to_rot(jnp.asarray(bones))))
        bones = bones + rng.standard_normal(bones.shape).astype(np.float32) * 0.05
    pelvis = rng.standard_normal((B, 3)).astype(np.float32)
    return bones, pelvis


@pytest.mark.parametrize("rot6d", [False, True])
def test_pose_to_kinematic_matches_jax(rot6d):
    bones, pelvis = _pose(rot6d)
    ref = jkin.pose_to_kinematic(jnp.asarray(bones), jnp.asarray(pelvis),
                                 jnp.asarray(SMPL_REST_POSE))
    got = tkin.pose_to_kinematic(_t(bones), _t(pelvis), _t(SMPL_REST_POSE))
    for name, a, b in zip(("kps", "skts", "l2ws", "rots"), got, ref):
        _close(a, b, err=name)


def test_l2ws_from_rots_and_rest_pose_recovery_match_jax():
    bones, _ = _pose(False)
    rots = np.asarray(jrot.axisang_to_rot(jnp.asarray(bones)))
    ref = jkin.smpl_l2ws_from_rots(jnp.asarray(rots), scale=1.1)
    got = tkin.smpl_l2ws_from_rots(_t(rots), scale=1.1)
    _close(got, ref)
    _close(tkin.rest_pose_from_l2ws(got[0]), jkin.rest_pose_from_l2ws(ref[0]))
    _close(tkin.rest_pose_from_l2ws(got[0]), SMPL_REST_POSE * 1.1, tol=1e-4)


# ---------------------------------------------------------------------------
# pose/opt.py
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pose_problem(multiview: bool, rot6d: bool = True):
    """(pcfg, numpy init inputs, kp_map, JAX params + anchors, port params +
    anchors, params drifted from the anchors on both sides)."""
    rng = np.random.default_rng(3 + multiview)
    bones_aa = (rng.standard_normal((F_FRAMES, 24, 3)) * 0.3).astype(np.float32)
    kp3d = np.tile(SMPL_REST_POSE[None], (F_FRAMES, 1, 1)).astype(np.float32)
    kp3d += rng.standard_normal(kp3d.shape).astype(np.float32) * 0.05
    pcfg = jopt.PoseOptConfig(use_rot6d=rot6d, opt_pose_tol=0.01)
    tcfg = topt.PoseOptConfig(use_rot6d=rot6d, opt_pose_tol=0.01)
    kp_map = kp_uidxs = None
    if multiview:
        kp_map = np.array([0, 1, 2, 0, 1, 2], np.int32)
        kp_uidxs = np.array([0, 1, 2], np.int32)
    jp, ja = jopt.init_pose_params(pcfg, bones_aa, kp3d, kp_map=kp_map, kp_uidxs=kp_uidxs)
    tp, ta = topt.init_pose_params(tcfg, bones_aa, kp3d, kp_map=kp_map, kp_uidxs=kp_uidxs,
                                   device="cpu")
    drift = {k: rng.standard_normal(np.shape(v)).astype(np.float32) * 0.1 for k, v in jp.items()}
    jd = {k: jp[k] + drift[k] for k in jp}
    td = {k: (tp[k] + _t(drift[k])).detach().requires_grad_(True) for k in tp}
    return pcfg, tcfg, kp_map, jp, ja, tp, ta, jd, td


IDX = np.array([0, 5, 2, 2, 4], np.int32)


@pytest.mark.parametrize("multiview", [False, True])
def test_init_and_gather_match_jax(multiview):
    _, _, kp_map, jp, ja, tp, ta, _, _ = _pose_problem(multiview)
    assert set(tp) == set(jp) == set(ta)
    for k in jp:
        _close(tp[k], jp[k], err=k)
        _close(ta[k], ja[k], err=k)
        assert tp[k].requires_grad and tp[k].is_leaf and tp[k].dtype == torch.float32
        assert not ta[k].requires_grad and ta[k].data_ptr() != tp[k].data_ptr()
    km = None if kp_map is None else _t(kp_map)
    for a, b in zip(topt.gather_pose_rows(tp, _t(IDX), km),
                    jopt.gather_pose_rows(jp, jnp.asarray(IDX), kp_map)):
        _close(a, b)


@pytest.mark.parametrize("multiview", [False, True])
@pytest.mark.parametrize("rot6d", [False, True])
def test_pose_apply_and_canon_bones_match_jax(multiview, rot6d):
    _, _, kp_map, _, _, _, _, jd, td = _pose_problem(multiview, rot6d)
    km = None if kp_map is None else _t(kp_map)
    ref = jopt.pose_apply(jd, jnp.asarray(IDX), jnp.asarray(SMPL_REST_POSE), kp_map=kp_map)
    got = topt.pose_apply(td, _t(IDX), _t(SMPL_REST_POSE), kp_map=km)
    for name, a, b in zip(("kps", "bones", "skts", "l2ws"), got, ref):
        _close(a, b, err=name)
    _close(topt._canon_bones(got[1]), jopt._canon_bones(ref[1]))


def _jax_grad_and_value(fn, params):
    val, grads = jax.value_and_grad(fn)(params)
    return float(val), {k: np.asarray(v) for k, v in grads.items()}


def _port_grad_and_value(fn, params):
    for p in params.values():
        p.grad = None
    val = fn(params)
    val.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}
    return float(val.detach()), {k: g.numpy() for k, g in grads.items()}


def _assert_value_and_grads(got, ref, tol=1e-5):
    np.testing.assert_allclose(got[0], ref[0], rtol=tol, atol=1e-7)
    for k in ref[1]:
        scale = max(np.abs(ref[1][k]).max(), 1e-6)
        assert np.abs(got[1][k] - ref[1][k]).max() / scale < 1e-4, k


@pytest.mark.parametrize("multiview", [False, True])
def test_kp_reg_loss_matches_jax(multiview):
    """Value and gradient of the hinged, root-excluded regularizer; zero at
    the anchors."""
    pcfg, tcfg, kp_map, jp, ja, tp, ta, jd, td = _pose_problem(multiview)
    km = None if kp_map is None else _t(kp_map)
    ref = _jax_grad_and_value(
        lambda p: jopt.kp_reg_loss(pcfg, p, ja, jnp.asarray(IDX), kp_map), jd)
    got = _port_grad_and_value(lambda p: topt.kp_reg_loss(tcfg, p, ta, _t(IDX), km), td)
    assert ref[0] > 0
    _assert_value_and_grads(got, ref)
    assert float(topt.kp_reg_loss(tcfg, tp, ta, _t(IDX), km)) < 1e-10


@pytest.mark.parametrize("multiview", [False, True])
def test_temporal_loss_and_mpjpc_match_jax(multiview):
    """The temporal loss with wrap-around neighbours (frames 0 and 5 of 6),
    detached neighbours (the gradient reaches the batch frames only through
    kps and bones), and the MPJPC stat."""
    pcfg, tcfg, kp_map, _, _, _, _, jd, td = _pose_problem(multiview)
    km = None if kp_map is None else _t(kp_map)
    rest = SMPL_REST_POSE
    tv = np.array([1, 0, 1, 1, 1], np.float32)

    def jfn(p):
        kps, bones, _, _ = jopt.pose_apply(p, jnp.asarray(IDX), jnp.asarray(rest), kp_map=kp_map)
        return jopt.temporal_loss(p, jnp.asarray(IDX), jnp.asarray(tv), jnp.asarray(rest), kps,
                                  jopt._canon_bones(bones), kp_map=kp_map)

    def tfn(p):
        kps, bones, _, _ = topt.pose_apply(p, _t(IDX), _t(rest), kp_map=km)
        return topt.temporal_loss(p, _t(IDX), _t(tv), _t(rest), kps, topt._canon_bones(bones),
                                  kp_map=km)

    _assert_value_and_grads(_port_grad_and_value(tfn, td), _jax_grad_and_value(jfn, jd))
    anchor = np.asarray(jopt.pose_apply(jd, jnp.asarray(IDX), jnp.asarray(rest),
                                        kp_map=kp_map)[0]) + 0.01
    kps = topt.pose_apply(td, _t(IDX), _t(rest), kp_map=km)[0]
    _close(topt.mpjpc_stat(tcfg, kps, _t(anchor)),
           jopt.mpjpc_stat(pcfg, jnp.asarray(kps.detach().numpy()), jnp.asarray(anchor)),
           tol=1e-4)


@functools.lru_cache(maxsize=None)
def _family_inputs(opt_rot6d: bool):
    rng = np.random.default_rng(7 + opt_rot6d)
    D = 6 if opt_rot6d else 3

    def rots(n):
        aa = (rng.standard_normal((n, 24, 3)) * 0.4).astype(np.float32)
        return np.asarray(jrot.axisang_to_rot(jnp.asarray(aa)))

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    preds = {"kps": randn(B, 24, 3), "bones": randn(B, 24, D), "rots": rots(B)}
    regs = {"kps": randn(B, 24, 3), "bones": randn(B, 24, D), "rots": rots(B),
            "temp_kps": randn(2 * B, 24, 3), "temp_bones": randn(2 * B, 24, D),
            "temp_rots": rots(2 * B),
            "temp_valid": rng.integers(0, 2, (B,)).astype(np.float32),
            "temp_valid_next": rng.integers(0, 2, (B,)).astype(np.float32)}
    gts = {"kps": randn(B, 24, 3)}
    return preds, regs, gts


@pytest.mark.parametrize("opt_type", ["B", "BE", "RD", "RDE", "BL1", "RDEL1"])
@pytest.mark.parametrize("opt_rot6d", [False, True])
def test_get_kp_reg_loss_family_matches_jax(opt_type, opt_rot6d):
    preds, regs, gts = _family_inputs(opt_rot6d)
    for use_temp, use_vel in ((False, False), (True, False), (True, True)):
        kw = dict(opt_pose_coefs=2.0, opt_pose_type=opt_type, opt_rot6d=opt_rot6d,
                  opt_pose_tol=0.01, use_temp_loss=use_temp, use_temp_vel=use_vel)
        ref = jopt.get_kp_reg_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                   {k: jnp.asarray(v) for k, v in regs.items()},
                                   gts={"kps": jnp.asarray(gts["kps"])}, **kw)
        got = topt.get_kp_reg_loss({k: _t(v) for k, v in preds.items()},
                                   {k: _t(v) for k, v in regs.items()},
                                   gts={"kps": _t(gts["kps"])}, **kw)
        for name, a, b in zip(("kp_loss", "temp_loss", "mpjpc", "kp_gt_dist"), got, ref):
            np.testing.assert_allclose(float(a), float(b), rtol=2e-5, atol=1e-6,
                                       err_msg=f"{name} temp={use_temp} vel={use_vel}")


@pytest.mark.parametrize("multiview", [False, True])
def test_pose_params_to_pose_data_matches_jax(multiview):
    _, _, kp_map, _, _, _, _, jd, td = _pose_problem(multiview)
    ref = jopt.pose_params_to_pose_data(jd, jnp.asarray(SMPL_REST_POSE), kp_map=kp_map)
    got = topt.pose_params_to_pose_data(td, _t(SMPL_REST_POSE),
                                        kp_map=None if kp_map is None else _t(kp_map))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape
        _close(got[k], ref[k], tol=1e-4, err=k)


# ---------------------------------------------------------------------------
# pose/flipflop.py
# ---------------------------------------------------------------------------

FLIPFLOP = {
    "alternate": dict(opt_pose_interval=5),
    "warmup_stop": dict(opt_pose_interval=4, opt_pose_warmup=6, opt_pose_stop=17),
    "joint_reset": dict(opt_pose_joint=True, opt_pose_interval=3, opt_pose_reset=9),
}


@pytest.mark.parametrize("name", list(FLIPFLOP))
def test_flipflop_matches_jax(name):
    """The same turn sequence, resets, loss tracker and worst frames."""
    j = jff.PoseOptFlipFlop(jff.FlipFlopConfig(**FLIPFLOP[name]), n_kps=8)
    t = tff.PoseOptFlipFlop(tff.FlipFlopConfig(**FLIPFLOP[name]), n_kps=8)
    rng = np.random.default_rng(2)
    for i in range(24):
        assert t.step(i) == j.step(i), i
        assert t.should_reset_pose(i) == j.should_reset_pose(i)
        loss = rng.uniform(0, 1, 12)
        idx = rng.integers(0, 5, 12)  # frames 5..7 stay untouched at the prior
        t.accumulate_loss(loss, idx)
        j.accumulate_loss(loss, idx)
        np.testing.assert_array_equal(t.kp_loss_tracker, j.kp_loss_tracker)
        np.testing.assert_array_equal(t.kp_loss_cnt, j.kp_loss_cnt)
    np.testing.assert_array_equal(t.worst_frames(4), j.worst_frames(4))
    assert np.all(t.kp_loss_tracker[5:] == 10.0)
    t.reset_kp_loss_tracker()
    assert np.all(t.kp_loss_tracker == 10.0) and not t.kp_loss_cnt.any()
