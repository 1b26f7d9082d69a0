"""The port's CLI (posegen_tpu_torch/cli/) against the JAX package's
(posegen_tpu/cli/): every shipped config parses to the same namespace,
args.txt and the config records; a JAX run resumed one step by each
package gives the same checkpoint and val PSNR; the port's checkpoint loads
in JAX; evaluate_testset at render_factor 2 and its resize match JAX's."""

import dataclasses
import functools
import glob
import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.cli import config as jcfg
from posegen_tpu.cli import run_nerf as jrun
from posegen_tpu_torch.cli import config as pcfg
from posegen_tpu_torch.cli import run_nerf as prun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.txt")))
LOSS_RTOL = 1e-4  # test_torch_train.py's rules
PARAM_TOL = 5e-5
PSNR_TOL = 1e-3  # dB
IMAGE_TOL = 1e-4  # evaluate_testset's frames, port vs JAX


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_shipped_config_parses_like_jax(config, tmp_path):
    argv = ["--config", config, "--N_rand", "64"]
    a_p = pcfg.parse_with_config(pcfg.nerf_config_parser(), argv)
    a_j = jcfg.parse_with_config(jcfg.nerf_config_parser(), argv)
    assert vars(a_p) == vars(a_j)
    pcfg.dump_args(str(tmp_path / "p"), a_p)
    jcfg.dump_args(str(tmp_path / "j"), a_j)
    for name in ("args.txt", "config.txt"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    assert pcfg.txt_to_argstring(str(tmp_path / "p" / "args.txt")) == \
        jcfg.txt_to_argstring(str(tmp_path / "j" / "args.txt"))
    assert _fields(pcfg.args_to_raycast_config(a_p, 7)) == \
        _fields(jcfg.args_to_raycast_config(a_j, 7))
    assert _fields(pcfg.args_to_train_config(a_p)) == _fields(jcfg.args_to_train_config(a_j))
    d_p, d_j = _fields(pcfg.args_to_data_config(a_p)), _fields(jcfg.args_to_data_config(a_j))
    # the multi-node sharding fields, (0, 1) until the CLI sets them
    assert (d_p["process_index"], d_p["process_count"]) == (0, 1)
    assert d_p == d_j
    assert pcfg.validate_args(a_p) == jcfg.validate_args(a_j)


@pytest.mark.parametrize("flags", [
    ["--use_yuv"], ["--reg_fn", "L1"], ["--opt_pose_type", "X"],
    ["--pts_tr_type", "global", "--reg_fn", "MSE"], ["--precrop_iters", "5", "--use_bgnet"],
])
def test_validate_args_gives_jax_messages(flags, capsys):
    def outcome(mod):
        args = mod.parse_with_config(mod.nerf_config_parser(), flags)
        try:
            return "warnings", mod.validate_args(args)
        except SystemExit as e:
            return "exit", str(e)

    assert outcome(pcfg) == outcome(jcfg)


def test_datadir_maps_onto_the_catalog_root():
    for datadir in ("./data/h36m/", "/x/surreal", "elsewhere"):
        for dataset in ("h36m", "surreal"):
            argv = ["--datadir", datadir, "--dataset_type", dataset]
            a_p = pcfg.parse_with_config(pcfg.nerf_config_parser(), argv)
            a_j = jcfg.parse_with_config(jcfg.nerf_config_parser(), argv)
            assert pcfg.args_to_data_config(a_p).data_root == \
                jcfg.args_to_data_config(a_j).data_root


def _argv(root, n_iters, extra=()):
    return ["--config", os.path.join(ROOT, "configs", "synthetic", "demo.txt"),
            "--data_root", os.path.join(root, "data"), "--basedir", os.path.join(root, "logs"),
            "--n_iters", str(n_iters), "--i_print", "1", "--i_weights", str(n_iters),
            "--i_testset", "2", "--i_video", "0", "--perturb", "0", "--raw_noise_std", "0",
            "--num_workers", "0", "--n_devices", "1", *extra]


def _losses(out: str):
    return [float(m) for m in re.findall(r"^iter \d+: loss ([0-9.]+)", out, re.M)]


@functools.lru_cache(maxsize=None)
def _runs(tmp_dir: str):
    """JAX trains the demo config one step; each package resumes that run
    (copied) for one more step -> {package: (log dir, printed losses)}."""
    import contextlib
    import io

    from posegen_tpu.data.synthetic import make_synthetic_h5

    base = os.path.join(tmp_dir, "base")
    os.makedirs(os.path.join(base, "data", "synthetic"))
    make_synthetic_h5(os.path.join(base, "data", "synthetic", "demo.h5"))
    jrun.train(_argv(base, 1))
    out = {}
    for name, fn in (("jax", jrun.train),
                     ("port", functools.partial(prun.train, device="cpu"))):
        root = os.path.join(tmp_dir, name)
        shutil.copytree(base, root)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            log_dir = fn(_argv(root, 2))
        out[name] = (log_dir, buf.getvalue())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("cli")))


def test_resumed_step_matches_jax(runs):
    (j_dir, j_out), (p_dir, p_out) = runs["jax"], runs["port"]
    assert "at step 1" in p_out and "at step 1" in j_out
    lp, lj = _losses(p_out), _losses(j_out)
    assert len(lp) == len(lj) == 1
    np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)
    cp = dict(np.load(os.path.join(p_dir, "00000002.ckpt.npz")))
    cj = dict(np.load(os.path.join(j_dir, "00000002.ckpt.npz")))
    assert sorted(cp) == sorted(cj)
    moved = 0
    c1 = dict(np.load(os.path.join(j_dir, "00000001.ckpt.npz")))
    for k in cj:
        assert cp[k].dtype == cj[k].dtype and cp[k].shape == cj[k].shape, k
        if k.startswith("params"):
            assert float(np.abs(cp[k] - cj[k]).max()) < PARAM_TOL, k
            moved += not np.array_equal(cj[k], c1[k])
        elif cj[k].dtype.kind in "iu":
            np.testing.assert_array_equal(cp[k], cj[k], err_msg=k)
    assert moved >= 8
    psnr = [float(open(os.path.join(d, "psnr.txt")).read().split()[-1]) for d in (p_dir, j_dir)]
    assert abs(psnr[0] - psnr[1]) <= PSNR_TOL
    for d in (p_dir, j_dir):
        assert os.path.exists(os.path.join(d, "ssim.txt"))
        assert os.path.exists(os.path.join(d, "sched.txt"))
    # the runs differ by their directories alone
    p_args = open(os.path.join(p_dir, "args.txt"), "rb").read()
    assert p_args.replace(b"/port/", b"/jax/") == open(os.path.join(j_dir, "args.txt"),
                                                        "rb").read()


def _jax_state(log_dir):
    from posegen_tpu.render.raycast import init_raycaster
    from posegen_tpu.train.trainer import create_train_state

    args = jcfg.parse_with_config(jcfg.nerf_config_parser(),
                                  jcfg.txt_to_argstring(os.path.join(log_dir, "args.txt")))
    cfg = jcfg.args_to_raycast_config(args, n_framecodes=8)
    state = create_train_state(init_raycaster(jax.random.PRNGKey(0), cfg),
                               jcfg.args_to_train_config(args))
    return args, cfg, state


def test_port_checkpoint_loads_in_jax(runs):
    from posegen_tpu.train.checkpoints import load_checkpoint

    p_dir = runs["port"][0]
    _, _, template = _jax_state(p_dir)
    path = os.path.join(p_dir, "00000002.ckpt.npz")
    state = load_checkpoint(path, template)
    assert int(state.step) == 2
    flat = dict(np.load(path))
    leaves = jax.tree_util.tree_leaves_with_path(state.params)
    assert len(leaves) >= 8
    w = np.asarray(state.params["coarse"]["pts_linears"][0]["w"])
    np.testing.assert_array_equal(w, flat["params//coarse//pts_linears//0//w"])


def test_evaluate_testset_at_render_factor_2_matches_jax(runs):
    from posegen_tpu.data.catalog import load_data
    from posegen_tpu.train.checkpoints import load_checkpoint
    from posegen_tpu_torch.train.checkpoints import load_checkpoint as p_load
    from posegen_tpu_torch.train.trainer import create_train_state as p_create

    j_dir = runs["jax"][0]
    args, cfg, template = _jax_state(j_dir)
    path = os.path.join(j_dir, "00000002.ckpt.npz")
    j_state = load_checkpoint(path, template)
    loader, render_data, attrs = load_data(jcfg.args_to_data_config(args))
    loader.close()
    p_args = pcfg.parse_with_config(pcfg.nerf_config_parser(),
                                    pcfg.txt_to_argstring(os.path.join(j_dir, "args.txt")))
    p_cfg = pcfg.args_to_raycast_config(p_args, n_framecodes=attrs["n_framecodes"])
    from posegen_tpu_torch.render.raycast import init_raycaster as p_init

    p_state = p_load(path, p_create(p_init(p_cfg, device="cpu"),
                                    pcfg.args_to_train_config(p_args)))
    # a background plate that is not flat, so the resize is exercised
    rng = np.random.default_rng(4)
    render_data = dict(render_data)
    render_data["bkgds"] = rng.uniform(size=render_data["imgs"].shape).astype(np.float32)
    # a chunk that divides every frame's rays: a ray that misses the pose
    # cylinder takes its chunk's mean near / far, and JAX pads a ragged chunk
    # with copies of its last ray, which enter that mean (ROADMAP.md Queue 3)
    from posegen_tpu_torch.render.image import valid_box_for_pose

    H, W, _ = render_data["hwf"]
    n = [valid_box_for_pose(H // 2, W // 2, float(render_data["focals"][i]) / 2,
                            render_data["c2ws"][i], render_data["cyls"][i])[2].size
         for i in range(render_data["imgs"].shape[0])]
    chunk = math.gcd(*n)
    m_j, rgb_j = jrun.evaluate_testset(cfg, j_state, render_data, chunk=chunk,
                                       render_factor=2)
    m_p, rgb_p = prun.evaluate_testset(p_cfg, p_state, render_data, chunk=chunk,
                                       render_factor=2)
    assert rgb_p.shape == rgb_j.shape == render_data["imgs"].shape
    np.testing.assert_allclose(rgb_p, rgb_j, atol=IMAGE_TOL, rtol=0)
    assert abs(m_p["psnr"] - m_j["psnr"]) <= PSNR_TOL
    assert abs(m_p["ssim"] - m_j["ssim"]) <= 1e-4


@pytest.mark.parametrize("shape,antialias", [((20, 14), True), ((64, 48), False),
                                              ((33, 17), True)])
def test_resize_matches_jax_image_resize(shape, antialias):
    img = np.random.default_rng(1).uniform(size=(40, 28, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*shape, 3), "bilinear"))
    got = prun._resize_bilinear(img, shape, torch.device("cpu"), antialias=antialias)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_step_generator_depends_on_seed_and_step_alone():
    a = torch.rand(4, generator=prun.step_generator(3, 7, "cpu"))
    b = torch.rand(4, generator=prun.step_generator(3, 7, "cpu"))
    c = torch.rand(4, generator=prun.step_generator(3, 8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prun.train(_argv(str(tmp_path), 1))
