"""The purpose experiments of posegen_tpu_torch/tools/ (exp_bf16_delta,
exp_poseopt, exp_mining, exp_capstone_ft) against the JAX tools of tools/:
the pure helpers against the JAX tools' own functions, loaded by path (a
JAX `cmd_*` is never run: they write into the repository); the prepared
scene against the JAX package's synthetic scene and the JAX tool's
perturbation; the testopt loop against JAX's make_train_step under
testopt; the mining tools' rules; and one run of each port tool at the
smallest budget on the host, its JSON's keys against the JAX tool's.

The end-to-end runs of exp_mining and exp_capstone_ft swap the NeRF
renderer for a cheap stand-in (a 512^2 plain-pipeline frame takes a
minute here) and shrink SPIN's crop to 32^2: they check the tools'
plumbing; the renders and the HMR are held to JAX in their own tests."""

import ast
import functools
import importlib.util
import json
import os
import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
PARAM_TOL = 5e-5  # tests/test_torch_train.py's pose-step bound on the params

from posegen_tpu_torch.tools import exp_bf16_delta as PB  # noqa: E402
from posegen_tpu_torch.tools import exp_capstone_ft as PC  # noqa: E402
from posegen_tpu_torch.tools import exp_mining as PM  # noqa: E402
from posegen_tpu_torch.tools import exp_poseopt as PP  # noqa: E402


@functools.lru_cache(maxsize=None)
def jax_tool(name: str):
    """tools/{name}.py, imported by path (it defines functions only)."""
    path = ROOT / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


N_SCENE = 6  # frames of the scenes and pose sets: one shape, so JAX compiles its eager ops once


def _poses(seed: int, n: int = N_SCENE, std: float = 0.15):
    from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws

    bones = (np.random.default_rng(seed).standard_normal((n, 24, 3)) * std).astype(np.float32)
    kp3d = smpl_l2ws(torch.as_tensor(bones), scale=0.4)[..., :3, 3].numpy()
    return bones, kp3d


@functools.lru_cache(maxsize=None)
def _jax_perturbed():
    bones, kp3d = _poses(0)
    return jax_tool("exp_poseopt").perturb(bones, kp3d, 3, 0.08, 0.02)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("helper", ["_fk", "perturb", "pose_err_vs_gt", "_rd_with_params",
                                    "np_psnr"])
def test_helpers_match_the_jax_tools(helper):
    """Each pure helper against the JAX tool's function on the same numpy
    inputs: FK joints and MPJPE to 1e-5, numpy's noise exactly."""
    J = jax_tool("exp_poseopt")
    bones, kp3d = _poses(0)
    if helper == "_fk":
        _close(PP._fk(bones, kp3d[:, 0] + 0.1), J._fk(bones, kp3d[:, 0] + 0.1))
    elif helper == "perturb":
        got, want = PP.perturb(bones, kp3d, 3, 0.08, 0.02), _jax_perturbed()
        np.testing.assert_array_equal(got[0], want[0])  # the noisy bones: numpy's draws
        for g, w, what in zip(got[1:], want[1:], ("kp3d", "skts", "cyls")):
            assert g.dtype == np.float32 and g.shape == w.shape, what
            _close(g, w, what=what)
    elif helper == "pose_err_vs_gt":
        from posegen_tpu.pose.opt import PoseOptConfig, init_pose_params

        b_n, kp_n = _jax_perturbed()[:2]
        params, _ = init_pose_params(PoseOptConfig(use_rot6d=True), b_n, kp_n)
        gt = {"gt_bones": bones, "gt_kp3d": kp3d}
        got = PP.pose_err_vs_gt({k: np.asarray(v) for k, v in params.items()}, gt)
        want = J.pose_err_vs_gt(params, gt)
        assert got.keys() == want.keys() and want["mpjpe"] > 0.01
        for k in want:
            _close(got[k], want[k], what=k)
    elif helper == "_rd_with_params":
        from posegen_tpu.pose.opt import PoseOptConfig, init_pose_params

        b_n, kp_n = _jax_perturbed()[:2]
        params, _ = init_pose_params(PoseOptConfig(use_rot6d=True), b_n, kp_n)
        rd = {"kp_idxs": np.array([2, 0, 3, 5, 4, 1]),
              "imgs": np.zeros((N_SCENE, 2, 2, 3), np.float32)}
        got = PP._rd_with_params(rd, {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()})
        want = J._rd_with_params(rd, params)
        assert got.keys() == want.keys() and got["imgs"] is rd["imgs"]
        for k in ("kp3d", "bones", "skts", "cyls"):
            assert got[k].shape == want[k].shape, k
            _close(got[k], want[k], what=k)
    else:
        JB = jax_tool("exp_bf16_delta")
        rng = np.random.default_rng(1)
        a, b = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
        assert PB.np_psnr(a, b) == JB.np_psnr(a, b)
        assert PB.np_psnr(a, a) == JB.np_psnr(a, a) == float("inf")


def test_frame_diff_counts_opacity_and_psnr_off_it():
    """exp_bf16_delta.frame_diff: flips (opacity apart by > 0.5) and pixels
    whose opacity is apart by > 0.01, each with np_psnr over the rest."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    b = a + np.float32(1e-3)
    acc_a = np.full((8, 8), 0.4, np.float32)
    acc_b = acc_a.copy()
    acc_b[0, :2] = 1.0  # two flips
    acc_b[1, :3] += 0.05  # three moved
    b[0, :2] = 1.0 - a[0, :2]
    d = PB.frame_diff(a, b, acc_a, acc_b)
    assert d["opacity_flips"] == 2 and d["opacity_over_0.01"] == 5
    off_flips, agree = np.ones((8, 8), bool), np.ones((8, 8), bool)
    off_flips[0, :2] = agree[0, :2] = agree[1, :3] = False
    assert d["psnr_unflipped"] == PB.np_psnr(a[off_flips], b[off_flips])
    assert d["psnr_opacity_within_0.01"] == PB.np_psnr(a[agree], b[agree]) == pytest.approx(60.0, abs=0.01)
    assert d["psnr"] == PB.np_psnr(a, b)
    assert d["max_abs"] == float(np.abs(a.astype(np.float64) - b).max())
    assert d["pixels_over_0.1"] == 2
    assert set(PB.frame_diff(a, b)) == {"psnr", "max_abs", "pixels_over_0.1"}


def _prepare(data_dir: str, n_images: int = 6):
    args = SimpleNamespace(data_dir=data_dir, seed=0, bone_std=0.08, pelvis_std=0.02,
                           n_images=n_images, hw=32, focal=40.0)
    return PP.cmd_prepare(args)


def test_prepare_matches_the_jax_scene(tmp_path):
    """The port's prepared scene against the JAX package's make_synthetic_h5
    with the JAX tool's perturbation of its poses: integers equal, floats to
    1e-5; the GT file equal."""
    import h5py

    from posegen_tpu.data.synthetic import make_synthetic_h5
    from posegen_tpu_torch.data.hdf5 import read_h5

    path = _prepare(str(tmp_path / "port"))
    got, _ = read_h5(path)
    jpath = str(tmp_path / "jax.h5")
    make_synthetic_h5(jpath, n_images=6, H=32, W=32, focal=40.0, seed=0)
    with h5py.File(jpath, "r") as f:
        want = {k: np.asarray(f[k]) for k in f.keys()}
    gt_bones, gt_kp3d = want["bones"], want["kp3d"]
    b_n, kp_n, skts_n, cyls_n = jax_tool("exp_poseopt").perturb(gt_bones, gt_kp3d, 1, 0.08, 0.02)
    want.update(bones=b_n, kp3d=kp_n, skts=skts_n, cyls=cyls_n)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            _close(g, w, what=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    gt = np.load(os.path.join(os.path.dirname(path), "gt.npz"))
    _close(gt["gt_bones"], gt_bones)
    _close(gt["gt_kp3d"], gt_kp3d)
    assert float(gt["bone_std"]) == 0.08 and float(gt["pelvis_std"]) == 0.02


def test_soak_reads_the_prepared_scene(tmp_path):
    """--datadir "" lets data_root win: the soak's loader reads the prepared
    6-frame scene, not the default 8-image one that h36m_prot2's datadir
    would select."""
    from posegen_tpu_torch.cli.config import (
        args_to_data_config, nerf_config_parser, parse_with_config,
    )
    from posegen_tpu_torch.data.catalog import load_data

    _prepare(str(tmp_path / "dp"))
    argv = PP.soak_argv(str(tmp_path / "dp"), str(tmp_path / "logs"), ["--num_workers", "0"])
    assert argv[argv.index("--datadir") + 1] == ""
    args = parse_with_config(nerf_config_parser(), argv)
    dcfg = args_to_data_config(args)
    assert dcfg.data_root == str(tmp_path / "dp")
    loader, render_data, attrs = load_data(dcfg)
    loader.close()
    assert attrs["n_kps"] == 6 and len(attrs["bones"]) == 6
    # without the blank --datadir, the config's datadir would win over
    # data_root and select another scene
    i = argv.index("--datadir")
    kept = parse_with_config(nerf_config_parser(), argv[:i] + argv[i + 2:])
    assert args_to_data_config(kept).data_root != dcfg.data_root


N_FRAMES, RPI = N_SCENE, 16  # the helpers' frame count: JAX's eager ops compile once
NET_SEED = 1  # port nets whose renders give every pose a gradient on these batches
SMALL = dict(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32, N_samples=8,
             N_importance=4, perturb=0.0, raw_noise_std=0.0)


@functools.lru_cache(maxsize=None)
def _testopt_problem():
    """Noisy rot6d pose params over 6 frames (the port's perturb and
    init_pose_params, held to JAX above and in test_torch_pose.py), three
    batches of 2 groups x 16 rays, and JAX's testopt state (2 x 32 nets,
    the port's init) after 0..3 steps."""
    import jax
    import jax.numpy as jnp

    from posegen_tpu.render import raycast as jr
    from posegen_tpu.train import trainer as jt
    from posegen_tpu.utils.fixtures import make_rays
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params, pose_apply
    from posegen_tpu_torch.render import raycast as tr
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
    from posegen_tpu_torch.train import trainer as tt

    gt_bones, gt_kp3d = _poses(5, N_FRAMES)
    b_n, kp_n = PP.perturb(gt_bones, gt_kp3d, 6, 0.08, 0.02)[:2]
    params, anchors = init_pose_params(PoseOptConfig(use_rot6d=True), b_n, kp_n, device="cpu")
    rest = SMPL_REST_POSE * 0.4
    rng = np.random.default_rng(7)
    batches = []
    for i in range(3):
        kp_idx = np.array([i % N_FRAMES, (i + 2) % N_FRAMES], np.int32)
        with torch.no_grad():
            kps = pose_apply(params, torch.as_tensor(kp_idx), torch.as_tensor(rest))[0]
            cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001).numpy()
        ro, rd = zip(*(make_rays(RPI, seed=20 + 2 * i + g) for g in range(2)))
        batches.append({
            "rays_o": np.concatenate([np.asarray(r) for r in ro]),
            "rays_d": np.concatenate([np.asarray(r) for r in rd]),
            "target_s": rng.uniform(0, 1, (2 * RPI, 3)).astype(np.float32),
            "bgs": rng.uniform(0, 1, (2 * RPI, 3)).astype(np.float32),
            "cyls": cyls, "kp_idx": kp_idx, "kp3d": kp_n[kp_idx]})
    tkw = dict(rays_per_image=RPI, use_background=True, opt_pose=True, opt_pose_step=1,
               testopt=True, loss_fn="L1")
    jcfg, jtcfg = jr.RaycastConfig(**SMALL), jt.TrainConfig(fused_train=False, **tkw)
    to_j = lambda d: {k: jnp.asarray(v.detach().numpy()) for k, v in d.items()}  # noqa: E731
    # the port's init in JAX's tree (the same layout; JAX's own init would
    # compile for seconds): its template by eval_shape, filled leaf by leaf
    template = jax.eval_shape(lambda k: jr.init_raycaster(k, jcfg), jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(template)
    port = tr.init_raycaster(tr.RaycastConfig(**SMALL), torch.Generator().manual_seed(NET_SEED),
                             device="cpu")
    port = jax.tree_util.tree_leaves(tt.tree_map(lambda t: t.detach().numpy(), port))
    assert [a.shape for a in port] == [b.shape for b in leaves]
    variables = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in port])
    state = jt.create_train_state(variables, jtcfg, to_j(params), to_j(anchors))
    # LLVM's cheap passes: the step compiles in a fraction of the time
    step = jax.jit(jt.make_train_step(jcfg, jtcfg, jax_pcfg(), rest_pose=jnp.asarray(rest),
                                      n_frames=N_FRAMES),
                   compiler_options={"xla_backend_optimization_level": 0,
                                     "xla_llvm_disable_expensive_passes": True})
    states = [jax.tree_util.tree_map(np.array, state)]
    for i, b in enumerate(batches):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.fold_in(jax.random.PRNGKey(1), i))
        states.append(jax.tree_util.tree_map(np.array, state))
    gt = {"gt_bones": gt_bones, "gt_kp3d": gt_kp3d}
    return tkw, batches, states, gt


def jax_pcfg():
    from posegen_tpu.pose.opt import PoseOptConfig

    return PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01)


def test_testopt_loop_matches_jax():
    """Three iterations of the port's testopt loop (the NeRF frozen, the
    pose Adam every step) against JAX's make_train_step under testopt on
    the same batches (perturb 0, no raw noise: the step draws no noise):
    the pose params after each run to the pose tests' bound, the nets
    unmoved, and the loop's trajectory against the JAX tool's
    pose_err_vs_gt of JAX's params."""
    from posegen_tpu_torch.pose.opt import PoseOptConfig
    from posegen_tpu_torch.render.raycast import RaycastConfig
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
    from posegen_tpu_torch.train import trainer as tt
    from posegen_tpu_torch.utils.convert import train_state_from_numpy

    tkw, batches, states, gt = _testopt_problem()
    tcfg = tt.TrainConfig(fused_train=False, **tkw)
    state = train_state_from_numpy(states[0], tcfg, "cpu")
    assert state.opt_state is None
    step_fn = tt.make_train_step(RaycastConfig(**SMALL), tcfg,
                                 PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01),
                                 rest_pose=torch.as_tensor(SMPL_REST_POSE * 0.4),
                                 n_frames=N_FRAMES)
    nets0 = [p.detach().clone() for p in tt.param_leaves(state.params)]
    state, traj, stats = PP.testopt_loop(step_fn, state, iter(batches), 3, gt, "cpu", log=None)
    assert state.step == 3 and [r["iter"] for r in traj] == [1, 2, 3]
    assert float(stats["pose_grad_norm"]) > 0.0
    for k, p in state.pose_params.items():
        want = states[3].pose_params[k]
        assert not np.array_equal(want, states[0].pose_params[k]), k
        assert float(np.abs(p.detach().numpy() - want).max()) < PARAM_TOL, k
    for a, b in zip(tt.param_leaves(state.params), nets0):
        assert torch.equal(a.detach(), b)
    want = jax_tool("exp_poseopt").pose_err_vs_gt(states[3].pose_params, gt)
    for k in want:
        assert abs(traj[-1][k] - want[k]) < TOL, k


def test_mining_rules_match_jax(monkeypatch):
    """draw's numpy poses, mpjpe_per_sample's FK / J14 / root-centred mean
    (on HMR rotations from a stand-in forward) against the JAX package's
    functions as the JAX tools compose them, and the split rules (the
    worst-quartile pick, the mined subsample, the capstone's sample)."""
    import jax.numpy as jnp

    from posegen_tpu.gen.gan import SPIN_J14
    from posegen_tpu.gen.loop import fk_joints
    from posegen_tpu.skeleton.kinematics import smpl_l2ws_from_rots
    from posegen_tpu_torch.gen import hmr as thmr
    from posegen_tpu_torch.gen import loop, spin_train  # noqa: F401  bound before the stand-in
    from posegen_tpu_torch.skeleton.rotations import axisang_to_rot

    bones = PM.draw(11, N_SCENE, 0.3)
    ref = (np.random.default_rng(11).standard_normal((N_SCENE, 24, 3)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(bones, ref)
    assert bones.dtype == np.float32
    rot = axisang_to_rot(torch.as_tensor(PM.draw(12, N_SCENE, 0.2)))
    monkeypatch.setattr(thmr, "hmr_apply", lambda p, s, x, *a, **k: (rot, None, None, None))
    params, state = {"conv1": {"w": torch.zeros(1)}}, {}  # the forward is the stand-in
    got = PM.mpjpe_per_sample(params, state, np.zeros((N_SCENE, 3, 8, 8), np.float32), bones)
    J14 = jnp.asarray(SPIN_J14)
    pred = smpl_l2ws_from_rots(jnp.asarray(rot.numpy()), scale=0.4)[..., :3, 3][:, J14]
    gt = fk_joints(jnp.asarray(bones))[:, J14]
    want = np.asarray(jnp.mean(jnp.linalg.norm((pred - pred[:, :1]) - (gt - gt[:, :1]), axis=-1),
                               axis=-1))
    _close(got, want)
    assert PM.mpjpe_prepared(params, state, np.zeros((N_SCENE, 3, 8, 8), np.float32), bones) == \
        pytest.approx(float(np.mean(want)), abs=TOL)
    errs = np.random.default_rng(3).uniform(0, 1, 40)
    np.testing.assert_array_equal(PM.worst_quartile(errs, 10), np.argsort(errs)[-10:])


# ---------------------------------------------------------------------------
# one run of each tool at the smallest budget
# ---------------------------------------------------------------------------

def _json_keys(tool: str, func: str, var: str):
    """The keys of the dict the JAX tool's `func` builds in `var`: its
    literal's keys and every `var["key"] = ...`."""
    tree = ast.parse((ROOT / "tools" / f"{tool}.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == var and isinstance(node.value, ast.Dict):
                    keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == var and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    assert keys, (tool, func, var)
    return keys


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite(v) for v in tree)
    return not isinstance(tree, float) or np.isfinite(tree)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """A demo-config run (args.txt + a step-0 checkpoint of its 2 x 48
    nets) over a 4-image 32^2 synthetic scene: what the tools load."""
    from posegen_tpu_torch.cli.config import (
        args_to_raycast_config, args_to_train_config, dump_args, nerf_config_parser,
        parse_with_config,
    )
    from posegen_tpu_torch.data.synthetic import make_synthetic_h5
    from posegen_tpu_torch.render.raycast import init_raycaster
    from posegen_tpu_torch.train.checkpoints import save_checkpoint
    from posegen_tpu_torch.train.trainer import create_train_state

    tmp = tmp_path_factory.mktemp("proofs")
    data = tmp / "data"
    os.makedirs(data / "synthetic")
    make_synthetic_h5(str(data / "synthetic" / "demo.h5"), n_images=4, H=32, W=32, focal=40.0)
    args = parse_with_config(nerf_config_parser(), [
        "--config", str(ROOT / "configs" / "synthetic" / "demo.txt"), "--basedir", str(tmp),
        "--data_root", str(data)])
    log = str(tmp / args.expname)
    dump_args(log, args)
    cfg = args_to_raycast_config(args)
    state = create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(1),
                                              device="cpu"), args_to_train_config(args))
    return tmp, os.path.join(log, "args.txt"), save_checkpoint(log, state, step=0)


def test_bf16_delta_runs_on_the_host(demo):
    tmp, nerf_args, ckpt = demo
    out = str(tmp / "bf16")
    summary = PB.main(["--nerf_args", nerf_args, "--ckptpath", ckpt, "--hw", "24", "--cpu",
                       "--out", out])
    frame = np.load(os.path.join(out, "cpu32.npy"))
    assert frame.shape == (24, 24, 3) and np.isfinite(frame).all()
    assert summary["tf32"] == {"matmul_allow_tf32": False, "cudnn_allow_tf32": False}
    with open(os.path.join(out, "psnr.json")) as f:
        assert json.load(f)["device"] == "cpu"


def test_poseopt_runs_on_the_host(tmp_path, monkeypatch):
    """prepare -> soak (2 steps) -> evalpose -> testopt (2 iterations), the
    h36m_prot2 workload on 2 x 32 nets: the JSONs carry the JAX tool's keys
    with finite values, and the soak's pose checkpoints hold the prepared
    scene's 6 frames."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # no TensorFlow import
    common = ["--data_dir", str(tmp_path / "dp"), "--out_dir", str(tmp_path / "out"),
              "--basedir", str(tmp_path / "logs")]
    flags = ("--num_workers 0 --netdepth 2 --netwidth 32 --netdepth_fine 2 --netwidth_fine 32 "
             "--N_samples 8 --N_importance 4 --N_rand 64 --N_sample_images 4 --chunk 1024 "
             "--i_pose_weights 1 --i_print 0")
    PP.main(["prepare", "--n_images", "6", "--hw", "32", "--focal", "40"] + common)
    log_dir = PP.main(["soak", "--n_iters", "2", "--cpu", "--nerf_flags", flags] + common)
    assert os.path.exists(os.path.join(log_dir, "00000002.ckpt.npz"))
    pose = np.load(os.path.join(log_dir, "00000002.pose.npz"))
    assert pose["pose_params//bones"].shape == (6, 24, 6)
    with open(PP.main(["evalpose"] + common)) as f:
        soak = json.load(f)
    assert set(soak) == {"gt_meta", "rows"} and [r["step"] for r in soak["rows"]] == [0, 1, 2]
    assert all(set(r) == {"step", "mpjpe", "mpjpe_rc"} for r in soak["rows"]) and _finite(soak)
    res = PP.main(["testopt", "--n_iters", "2", "--tols", "0.01", "--cpu", "--nerf_flags", flags]
                  + common)
    with open(tmp_path / "out" / "testopt_recovery.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert _json_keys("exp_poseopt", "cmd_testopt", "results") <= set(res)
    (sweep,) = res["sweeps"]
    assert set(sweep) == _json_keys("exp_poseopt", "cmd_testopt", "sweep")
    assert _finite(res) and len(sweep["traj"]) == 2


def _stub_renders(monkeypatch):
    """NeRFRenderer.render_poses -> flat frames shaded by the pose (no
    render), and SPIN's crop resized to 32^2."""
    from posegen_tpu_torch.gen import loop

    def render_poses(self, bones, c2ws, window=None):
        b = np.asarray(torch.as_tensor(bones).cpu(), np.float32)
        shade = 0.5 + 0.4 * np.tanh(b.reshape(len(b), -1).mean(1))
        return np.broadcast_to(shade[:, None, None, None],
                               (len(b), self.hw, self.hw, 3)).astype(np.float32)

    monkeypatch.setattr(loop.NeRFRenderer, "render_poses", render_poses)
    monkeypatch.setattr(loop, "SPIN_RES", 32)


def test_mining_and_capstone_run_on_the_host(demo, monkeypatch):
    """exp_mining at the smallest budget (32 pretraining renders: one SPIN
    step an epoch), then run_gan on a 16-pose pool with feedback, then
    exp_capstone_ft on its sink reusing exp_mining's splits: each JSON has
    the JAX tool's keys, finite values."""
    from posegen_tpu_torch.cli import run_gan

    _stub_renders(monkeypatch)
    tmp, nerf_args, ckpt = demo
    nerf = ["--nerf_args", nerf_args, "--ckptpath", ckpt]
    mining = str(tmp / "mining")
    summary = PM.main(nerf + [
        "--out", mining, "--n_pretrain", "32", "--n_eval", "2", "--pretrain_epochs", "1",
        "--finetune_epochs", "1", "--gan_epochs", "1", "--batch_size", "4", "--pool_n", "8",
        "--rpi", "2", "--probe_every", "1", "--probe_n", "2", "--ft_n", "4",
        "--feedback_every", "1", "--pose_std", "0.15", "--cpu"])
    assert _json_keys("exp_mining", "main", "summary") <= set(summary)
    assert summary["n_mined"] == 4 and summary["n_ft"] == 4
    assert [i for i, _ in summary["probe_curves"]["feedback_on"]] == [0, 1, 2]
    assert set(summary["finetune_eval_mpjpe"]) == {"mined", "control"}
    assert set(summary["pretrained_eval"]) == {"easy", "hard_gen", "hard_nat"}
    with open(os.path.join(mining, "summary.json")) as f:
        assert _finite(json.load(f))

    pool = str(tmp / "pool.npy")
    np.save(pool, PM.draw(5, 16, 0.15))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    run_gan.main(nerf + ["--spin_ckpt", os.path.join(mining, "spin_pretrained.npz"),
                         "--amass_poses", pool, "--outputdir", str(tmp / "ro"),
                         "--runname", "capstone", "--epochs", "1", "--batch_size", "8",
                         "--rpi", "2", "--feedback_every", "1", "--feedback_start_epoch", "-1"],
                 device="cpu")
    out = str(tmp / "capstone.json")
    cap = PC.main(nerf + ["--sink", str(tmp / "ro" / "capstone"),
                          "--pretrained", os.path.join(mining, "spin_pretrained.npz"),
                          "--splits_dir", mining, "--ft_n", "4", "--finetune_epochs", "1",
                          "--n_eval", "2", "--n_pretrain", "32", "--out", out, "--cpu"])
    assert _json_keys("exp_capstone_ft", "main", "summary") <= set(cap)
    assert cap["sink_size"] == 4
    # exp_mining's eval and control renders were reused, the hard_gen split made
    assert not os.path.exists(str(tmp / "ro" / "capstone_eval" / "eval"))
    assert os.path.exists(str(tmp / "ro" / "capstone_eval" / "hard_gen"))
    with open(out) as f:
        assert _finite(json.load(f))
