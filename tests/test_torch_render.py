"""posegen_tpu_torch render_rays against posegen_tpu render_rays, at full
width (the flagship RaycastConfig: 64 + 16 samples, two 8x256 nets) on a
few rays, plus the port's packaging contract: import hygiene, the CUDA
default device, and chip_smoke.py refusing to run without a card."""

import functools
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_problem as j_make_problem
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 16
SEED = 2  # JAX weights whose render is neither empty nor opaque (acc ~0.9)
KEYS = ("rgb_map", "disp_map", "acc_map", "alpha", "rgb0", "disp0", "acc0", "alpha0")


@functools.lru_cache(maxsize=None)
def _problem(**kw):
    cfg, params, ctx, ro, rd = j_make_problem(jr.RaycastConfig(**kw), n_rays=N_RAYS, seed=SEED)
    port = (
        tr.RaycastConfig(**kw),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        tr.PoseCtx(*[None if a is None else torch.as_tensor(np.array(a)) for a in ctx]),
        torch.as_tensor(np.array(ro)), torch.as_tensor(np.array(rd)),
    )
    return (cfg, params, ctx, ro, rd), port


def _jax_render(jax_args, use_fused, **kw):
    cfg, params, ctx, ro, rd = jax_args
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32  # interpret mode at float32 activations
    try:
        out = jr.render_rays(cfg, params, ro, rd, ctx, use_fused=use_fused, **kw)
    finally:
        jfield.MM_DTYPE = orig
    return {k: np.asarray(v) for k, v in out.items()}


def _port_render(port_args, use_fused, **kw):
    cfg, params, ctx, ro, rd = port_args
    with torch.no_grad():
        out = tr.render_rays(cfg, params, ro, rd, ctx, use_fused=use_fused, **kw)
    return {k: v.numpy() for k, v in out.items()}


def _assert_close(got, ref, tol, keys=KEYS):
    for k in keys:
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=0, err_msg=k)


EVAL = dict(perturb=0.0, raw_noise_std=0.0)


@pytest.mark.parametrize("coarse_rgb", [True, False])
def test_render_matches_jax_fused(coarse_rgb):
    """Port fused path (the kernels' plain versions on the CPU) == JAX fused
    path (Pallas interpret, float32 activations): same bf16 weights, same
    recurrence, the dual co-sort branch when coarse_rgb is False."""
    j, t = _problem()
    ref = _jax_render(j, True, coarse_rgb=coarse_rgb, **EVAL)
    got = _port_render(t, True, coarse_rgb=coarse_rgb, **EVAL)
    assert 0.05 < got["acc_map"].mean() < 0.99
    _assert_close(got, ref, 1e-4)
    if not coarse_rgb:  # raw rgb rows zero: every coarse sample's colour is sigmoid(0)
        np.testing.assert_allclose(got["rgb0"], 0.5 * got["acc0"][:, None].repeat(3, 1),
                                   atol=1e-6)


def test_render_matches_jax_xla():
    """Against JAX's XLA pipeline: the port's plain pipeline to float32
    rounding; its fused path to 1e-3 (bf16 weights, and the double-angle
    recurrence against the direct sin)."""
    j, t = _problem()
    ref = _jax_render(j, False, **EVAL)
    _assert_close(_port_render(t, False, **EVAL), ref, 1e-5)
    for coarse_rgb in (True, False):
        got = _port_render(t, True, coarse_rgb=coarse_rgb, **EVAL)
        _assert_close(got, ref, 1e-3, keys=("rgb_map", "disp_map", "acc_map", "acc0"))


def test_single_net_render_matches():
    """single_net: one net, max-filtered importance weights, raws merged by
    the sort order."""
    j, t = _problem(single_net=True)
    _assert_close(_port_render(t, True, **EVAL), _jax_render(j, True, **EVAL), 1e-4)
    _assert_close(_port_render(t, False, **EVAL), _jax_render(j, False, **EVAL), 1e-5)


def test_perturbed_render_with_det_noise():
    """Stratified jitter, importance draws and density noise handed to both
    frameworks as the same numpy arrays."""
    j, t = _problem()
    cfg = t[0]
    rng = np.random.default_rng(5)
    S, I = cfg.N_samples, cfg.N_importance
    noise = {
        "coarse": rng.uniform(0, 1, (N_RAYS, S)),
        "importance": np.sort(rng.uniform(0, 1, (N_RAYS, I)), -1),
        "sigma0": rng.standard_normal((N_RAYS, S)) * 0.1,
        "sigma": rng.standard_normal((N_RAYS, S + I)) * 0.1,
    }
    noise = {k: v.astype(np.float32) for k, v in noise.items()}
    kw = dict(perturb=1.0, raw_noise_std=1.0)
    ref = _jax_render(j, False, det_noise={k: jnp.asarray(v) for k, v in noise.items()}, **kw)
    got = _port_render(t, False, det_noise={k: torch.as_tensor(v) for k, v in noise.items()},
                       **kw)
    _assert_close(got, ref, 1e-5)


def test_generator_draws_are_reproducible():
    """Without pre-drawn noise the port draws from a torch.Generator: the
    same seed gives the same render."""
    _, t = _problem()
    outs = [_port_render(t, False, perturb=1.0, raw_noise_std=1.0,
                         generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    _assert_close(outs[0], outs[1], 0.0)
    with pytest.raises(ValueError, match="generator"):
        _port_render(t, False, perturb=1.0)


def test_imports_touch_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, posegen_tpu_torch\n"
        "for m in pkgutil.walk_packages(posegen_tpu_torch.__path__, 'posegen_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from posegen_tpu_torch.pose.opt import init_pose_params, pose_apply, get_kp_reg_loss\n"
        "from posegen_tpu_torch.pose.flipflop import PoseOptFlipFlop\n"
        "from posegen_tpu_torch.skeleton.kinematics import pose_to_kinematic, rest_pose_from_l2ws\n"
        "from posegen_tpu_torch.skeleton.rotations import rot6d_to_rot, rot_to_axisang\n"
        "assert 'posegen_tpu_torch.pose.opt' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'posegen_tpu' or m.startswith('posegen_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('posegen_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18


def test_entry_points_default_to_cuda(monkeypatch):
    from posegen_tpu_torch.utils.fixtures import make_problem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_problem()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_raycaster(tr.RaycastConfig())
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params

    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_pose_params(PoseOptConfig(), np.zeros((2, 24, 3)), np.zeros((2, 24, 3)))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result, in the
    checkout and alone in a directory."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for where in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=where, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
