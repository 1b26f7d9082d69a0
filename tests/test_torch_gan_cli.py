"""The port's pose-mining stages against the JAX package's, on the CPU:
cv2's uint8 INTER_LINEAR (data/imutils.resize_linear_u8) and crop; the
GAN sink's PNGs (gen/loop.py) through the port's codec; render_testset on a
demo NeRF; gen/datasets.py on the PNGs it writes; train_spin's batches and
checkpoints; run_gan's flags, pool, checkpoints and resume, its feedback
renders into the sink, the probe and train_spin on the sink."""

import contextlib
import functools
import glob
import io
import json
import math
import os
import warnings

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import posegen_tpu.parallel.mesh as jmesh
from posegen_tpu.cli import render_testset as jrt
from posegen_tpu.cli import run_gan as jgan
from posegen_tpu.data import imutils as jim
from posegen_tpu.gen import datasets as jds
from posegen_tpu.gen import spin_driver as jsd
from posegen_tpu_torch.cli import render_testset as prt
from posegen_tpu_torch.cli import run_gan as pgan
from posegen_tpu_torch.data import imutils as pim
from posegen_tpu_torch.gen import datasets as pds
from posegen_tpu_torch.gen import loop as ploop
from posegen_tpu_torch.gen import spin_driver as psd
from posegen_tpu_torch.utils.png import read_png
from test_torch_render_cli import _run as demo_run, demo_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL = 1e-6  # FK joints, port (torch) vs JAX, float32
U8_TOL = 1  # frames read back in float16 by both renderers, as PNGs


# -- cv2's uint8 INTER_LINEAR and the crop ---------------------------------

@pytest.mark.parametrize("src,dst", [
    ((312, 312, 3), (224, 224)), ((224, 224, 3), (312, 312)), ((37, 53, 3), (71, 19)),
    ((5, 7), (3, 9)), ((1, 9, 3), (4, 4)), ((64, 64, 3), (32, 32)), ((13, 11, 2), (17, 5)),
    ((17, 15, 4), (9, 40)), ((300, 200, 3), (9, 7)),
])
def test_resize_linear_u8_is_cv2(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src, dtype=np.uint8)
    want = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(pim.resize_linear_u8(img, dst), want)


@pytest.mark.parametrize("rot", [0.0, 20.0])
def test_crop_matches_jax(rot):
    img = np.random.default_rng(3).integers(0, 256, (60, 80, 3)).astype(np.uint8)
    for center, scale in (((40.0, 30.0), 0.2), ((5.0, 50.0), 0.35)):
        want = jim.crop(img, center, scale, (24, 24), rot=rot)  # cv2's float64 resize
        got = pim.crop(img, center, scale, (24, 24), rot=rot)
        # float64 values up to 255: cv2 fuses one multiply-add, the port
        # rounds each product (a few ulps, 1e-13); the canvas is exact
        np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
        shared = lambda a, rc: cv2.resize(a, rc[::-1], interpolation=cv2.INTER_NEAREST)  # noqa
        np.testing.assert_array_equal(
            pim.crop(img, center, scale, (24, 24), rot=rot, resize_fn=shared),
            jim.crop(img, center, scale, (24, 24), rot=rot, resize_fn=shared))
    np.testing.assert_array_equal(pim.normalize_for_spin(img), jim.normalize_for_spin(img))


# -- the GAN sink -----------------------------------------------------------

def test_sink_writes_pngs_through_the_codec(tmp_path, monkeypatch):
    cfg = ploop.GanLoopConfig(output_dir=str(tmp_path))
    trainer = ploop.GanTrainer(cfg, None, device="cpu")
    imgs = np.random.default_rng(0).uniform(size=(3, 20, 24, 3)).astype(np.float32)
    bones = np.zeros((3, 24, 3), np.float32)
    trainer._save_renders(imgs, bones)
    trainer.flush_sink()
    want = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    for i in range(3):
        path = str(tmp_path / "image" / f"{i:05d}.png")
        assert np.array_equal(read_png(path), want[i])
        assert np.array_equal(imageio.imread(path), want[i])
    assert os.path.exists(tmp_path / "poses_axis_angles0.npy")

    def fail(path, img, level):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(ploop, "write_png", fail)
    trainer._save_renders(imgs[:1], bones[:1])
    with pytest.raises(OSError, match="disk full"):
        trainer.flush_sink()


# -- a demo NeRF, render_testset and the datasets on its PNGs ---------------

RT_HW = 40  # render_testset's frames: the pose box covers all 40^2 rays
TESTSET_FILES = (4, 4)  # poses in each annotation file
N_TESTSET = sum(TESTSET_FILES)


def _one_device(rays: int):
    """JAX's auto_render_fn on one device (the tests' 8 virtual CPU devices
    would shard and pad each chunk), at chunks of `rays`: one a frame."""
    return lambda cfg, chunk, use_fused=None, half_readback=False: (None, rays)


@functools.lru_cache(maxsize=None)
def _testset(tmp: str, demo: str):
    """render_testset of both packages on 8 poses from numpy seed 0 in two
    annotation files, on the demo run of tests/test_torch_render_cli.py ->
    {package: output dir}."""
    run = demo_run(demo)
    annot = os.path.join(tmp, "annot")
    os.makedirs(annot)
    rng = np.random.default_rng(0)
    for i, n in enumerate(TESTSET_FILES):
        np.savez(os.path.join(annot, f"seq{i}.npz"),
                 pose=(rng.standard_normal((n, 72)) * 0.2).astype(np.float32))
    out = {}
    real = jmesh.auto_render_fn
    jmesh.auto_render_fn = _one_device(RT_HW * RT_HW)
    try:
        for name, fn in (("jax", jrt.main), ("port", functools.partial(prt.main, device="cpu"))):
            with contextlib.redirect_stdout(io.StringIO()):
                out[name] = fn(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                                "--annot_dir", annot,
                                "--outputdir", os.path.join(tmp, name), "--render_hw", str(RT_HW)])
    finally:
        jmesh.auto_render_fn = real
    return out


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gan_cli"))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    return demo_dir(tmp_path_factory)


@pytest.fixture(scope="module")
def testset(base, demo):
    return _testset(base, demo)


def test_render_testset_matches_jax(testset):
    d_j, d_p = testset["jax"], testset["port"]
    pngs = sorted(os.listdir(os.path.join(d_j, "image")))
    assert len(pngs) == N_TESTSET and sorted(os.listdir(os.path.join(d_p, "image"))) == pngs
    np.testing.assert_allclose(np.load(os.path.join(d_p, "poses.npy")),
                               np.load(os.path.join(d_j, "poses.npy")), atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(np.load(os.path.join(d_p, "poses_axis_angles0.npy")),
                                  np.load(os.path.join(d_j, "poses_axis_angles0.npy")))
    lit = 0
    for f in pngs:
        a = read_png(os.path.join(d_p, "image", f)).astype(int)
        b = imageio.imread(os.path.join(d_j, "image", f)).astype(int)
        assert a.shape == b.shape == (RT_HW, RT_HW, 3) and np.abs(a - b).max() <= U8_TOL, f
        lit += int((b > 0).any())
    assert lit == N_TESTSET  # every frame shows the body


DS_KW = dict(crop=(4, 36), res=32)  # the test frames' window


def test_rendered_pose_dataset_matches_jax(testset):
    d = testset["jax"]  # JAX's PNGs, read by both packages
    ds_j, ds_p = jds.RenderedPoseDataset(d, **DS_KW), pds.RenderedPoseDataset(d, **DS_KW)
    assert len(ds_p) == len(ds_j) == N_TESTSET
    for i in (0, 3, 7):
        a, b = ds_p[i], ds_j[i]
        np.testing.assert_array_equal(a["image"], b["image"])  # the resize is cv2's, bit-equal
        np.testing.assert_allclose(a["pose"], b["pose"], atol=POSE_TOL, rtol=0)
    bp, bj = list(ds_p.batches(3, seed=3)), list(ds_j.batches(3, seed=3))
    assert len(bp) == len(bj) == 2  # the last 2 rows dropped
    for a, b in zip(bp, bj):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_allclose(a["pose"], b["pose"], atol=POSE_TOL, rtol=0)


def test_stale_file_warning_like_jax(testset, tmp_path):
    import shutil

    d = str(tmp_path / "stale")
    shutil.copytree(testset["jax"], d)
    for mod in (jds, pds):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.RenderedPoseDataset(d)  # 8 PNGs, 8 pose rows: quiet
    shutil.copy(os.path.join(d, "image", "00000.png"), os.path.join(d, "image", "00008.png"))
    for mod in (jds, pds):
        with pytest.warns(UserWarning, match="9 pngs but 8 pose rows"):
            assert len(mod.RenderedPoseDataset(d)) == 8


def test_pools_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    np.savez(tmp_path / "amass.npz", pose3d=rng.standard_normal((95, 82)).astype(np.float64))
    np.save(tmp_path / "amass.npy", rng.standard_normal((31, 72)))
    np.savez(tmp_path / "t2d.npz", pose2d=rng.standard_normal((4, 24, 2)))
    for f in ("amass.npz", "amass.npy"):
        a, b = pds.load_amass_pool(str(tmp_path / f)), jds.load_amass_pool(str(tmp_path / f))
        assert a.dtype == b.dtype and np.array_equal(a, b)
    a, b = pds.load_target_2d(str(tmp_path / "t2d.npz"), 3), jds.load_target_2d(
        str(tmp_path / "t2d.npz"), 3)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    pool = pds.load_amass_pool(str(tmp_path / "amass.npz"), subsample=1)
    for drop_last in (True, False):
        a = list(pds.pose_batches(pool, 8, seed=2, drop_last=drop_last))
        b = list(jds.pose_batches(pool, 8, seed=2, drop_last=drop_last))
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_mpii_refuses_jpegs_by_name(tmp_path):
    """A broken JPEG (SOI, then an APP0 segment of length 0) raises naming
    the file; MPII's valid JPEGs load (tests/test_torch_harness.py)."""
    (tmp_path / "im.jpg").write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    np.savez(tmp_path / "mpii.npz", pose=np.zeros((1, 72), np.float32), imgname=["im.jpg"],
             center=np.zeros((1, 2), np.float32), scale=np.ones(1, np.float32))
    ds = pds.MPIIPoseDataset(str(tmp_path / "mpii.npz"), str(tmp_path))
    with pytest.raises(ValueError, match="im.jpg.*JPEG"):
        ds[0]


# -- train_spin ---------------------------------------------------------------

def _recording_spin_step(seen: list):
    """For JAX's make_spin_finetune_step: a step that records what JAX's
    driver feeds it, (images, joints), and runs no HMR."""
    def make(**_):
        class Opt:
            def init(self, params):
                return None

        def step(params, state, opt_state, images, gt, key):
            seen.append((np.asarray(images), np.asarray(gt)))
            return params, opt_state, {"spin_loss": 0.0}

        return Opt(), step

    return make


def test_train_spin_batches_and_checkpoints_match_jax(testset, tmp_path, monkeypatch):
    from posegen_tpu.train.checkpoints import _unflatten_into as j_unflatten
    from posegen_tpu_torch.gen.hmr import init_hmr
    from test_torch_gen import hmr_weights

    d = testset["jax"]
    kw = dict(epochs=2, batch_size=3, seed=1, **DS_KW)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jsd, "make_spin_finetune_step", _recording_spin_step(seen["jax"]))
    jp, js = hmr_weights()
    jsd.train_spin(jp, js, d, ckpt_dir=str(tmp_path / "jax"), **kw)

    real = psd.make_spin_finetune_step

    def port_steps(**k):  # the port's real steps, with their inputs recorded
        opt, step = real(**k)

        def rec(params, state, opt_state, images, gt, masks):
            seen["port"].append((images.permute(0, 2, 3, 1).numpy(), gt.numpy()))
            return step(params, state, opt_state, images, gt, masks)

        return opt, rec

    monkeypatch.setattr(psd, "make_spin_finetune_step", port_steps)
    pp, ps = init_hmr(torch.Generator().manual_seed(0), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        _, hist = psd.train_spin(pp, ps, d, ckpt_dir=str(tmp_path / "port"), **kw)
    assert len(seen["port"]) == len(seen["jax"]) == 2 * 2  # 2 steps an epoch
    for (ip, gp), (ij, gj) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_allclose(gp, gj, atol=POSE_TOL, rtol=0)
    assert all(np.isfinite(h["spin_loss"]) for h in hist)
    for epoch in range(2):
        name = f"spin_{epoch:03d}.npz"
        fp, fj = dict(np.load(tmp_path / "port" / name)), dict(np.load(tmp_path / "jax" / name))
        assert sorted(fp) == sorted(fj)
        assert all(fp[k].shape == fj[k].shape and fp[k].dtype == fj[k].dtype for k in fj)
        tree = j_unflatten({"params": jp, "state": js}, fp)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
            {"params": jp, "state": js})


# -- run_gan --------------------------------------------------------------------

def test_gan_parser_matches_jax():
    def flags(p):
        return sorted((a.dest, tuple(a.option_strings), a.default, a.nargs, a.type, a.const)
                      for a in p._actions if a.dest != "help")

    assert flags(pgan.gan_parser()) == flags(jgan.gan_parser())
    argv = ["--epochs", "3", "--render_res", "64", "64", "--no_max", "--chunk", "100"]
    assert vars(pgan.gan_parser().parse_args(argv)) == vars(jgan.gan_parser().parse_args(argv))


def test_pose_pool_and_latest_checkpoint_match_jax(tmp_path):
    assert np.array_equal(pgan.load_pose_pool(None, 3, 50), jgan.load_pose_pool(None, 3, 50))
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "p.npz", poses=rng.standard_normal((9, 75)))
    np.save(tmp_path / "p.npy", rng.standard_normal((6, 24, 3)))
    for f in ("p.npz", "p.npy"):
        assert np.array_equal(pgan.load_pose_pool(str(tmp_path / f)),
                              jgan.load_pose_pool(str(tmp_path / f)))
    ck = tmp_path / "ck"
    assert pgan.latest_gan_checkpoint(str(ck)) == jgan.latest_gan_checkpoint(str(ck)) is None
    ck.mkdir()
    for n in ("gan_009.npz", "gan_1000.npz", "gan_best.npz", "gan_010.npz"):
        (ck / n).write_bytes(b"")
    assert pgan.latest_gan_checkpoint(str(ck)) == jgan.latest_gan_checkpoint(str(ck)) \
        == str(ck / "gan_1000.npz")


GAN_HW = 128  # feedback frames: the crop window (100, 412) clips to 28 x 28 rays
GAN_RAYS = 28 * 28


def _stub_hmr(rotmat):
    """An HMR forward that predicts the rest pose: the feedback and the
    probe run without compiling JAX's ResNet-50 (the port's forward is held
    to JAX's in tests/test_torch_gen.py)."""
    def apply(params, state, images, *args, **kwargs):
        return rotmat(images.shape[0]), None, None, None

    return apply


@functools.lru_cache(maxsize=None)
def _gan_runs(tmp: str, demo: str):
    """Each package's run_gan on the demo NeRF (batch 8, a pool of 24 poses:
    3 iterations an epoch) with feedback at every third iteration (rpi 2), an
    8-pose probe after each epoch (the batch's shapes: JAX compiles its eager
    generator once) and train_spin on the sink after the run:
    the port one epoch, then a resume to epoch 2; JAX both epochs in one run
    (a resume replays its permutation stream) -> {package: (run dir, the
    batches of each train_epoch call)}."""
    import jax.numpy as jnp

    from posegen_tpu.gen import hmr as jhmr
    from posegen_tpu.gen import loop as jloop
    from posegen_tpu_torch.gen import discriminators as pdisc
    from posegen_tpu_torch.gen import generators as pgen
    from test_torch_gen import hmr_weights, t2n

    run = demo_run(demo)
    pool = os.path.join(tmp, "pool.npy")
    np.save(pool, (np.random.default_rng(2).standard_normal((24, 24, 3)) * 0.3).astype(
        np.float32))
    out = {}
    for name, fn, loop, splits in (
            ("jax", jgan.main, jloop, [2]),
            ("port", functools.partial(pgan.main, device="cpu"), ploop, [1, 2])):
        epochs, real_epoch = [], loop.GanTrainer.train_epoch

        def record(self, batches):
            epochs.append([np.array(b) for b in batches])
            return real_epoch(self, batches)

        argv = ["--nerf_args", run["args"], "--ckptpath", run["ckpt"], "--amass_poses", pool,
                "--outputdir", os.path.join(tmp, "gan_" + name), "--batch_size", "8",
                "--rpi", "2", "--feedback_start_epoch", "-1", "--feedback_every", "3",
                "--probe_n", "8", "--train_spin_epochs", "1", "--render_hw", str(GAN_HW)]
        saved = (loop.GanTrainer.train_epoch, loop.hmr_apply, jhmr.init_hmr, jax.device_count,
                 jmesh.auto_render_fn, jloop.init_pose_generator, jloop.init_pos3d_discriminator,
                 jsd.make_spin_finetune_step)
        loop.GanTrainer.train_epoch, jmesh.auto_render_fn = record, _one_device(GAN_RAYS)
        loop.hmr_apply = _stub_hmr(
            (lambda b: jnp.broadcast_to(jnp.eye(3), (b, 24, 3, 3))) if name == "jax" else
            (lambda b: torch.eye(3).expand(b, 24, 3, 3)))
        # JAX's inits (eager jax.random: ~10 s on a CPU, 13 s more for HMR) ->
        # the same trees from the port's inits (tests/test_torch_gen.py holds
        # their layouts); its SPIN step -> a recorder (train_spin takes none
        # of its 32 on the 4 sink rows); one device: the tests' 8 virtual
        # devices would take JAX's run_gan data-parallel branch and shard
        # the render
        jloop.init_pose_generator = lambda key, cfg: t2n(
            pgen.init_pose_generator(torch.Generator().manual_seed(0), cfg, device="cpu"))
        jloop.init_pos3d_discriminator = lambda key: t2n(
            pdisc.init_pos3d_discriminator(torch.Generator().manual_seed(1), device="cpu"))
        jhmr.init_hmr = lambda key: hmr_weights()
        jsd.make_spin_finetune_step = _recording_spin_step([])
        jax.device_count = lambda *a: 1
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                for n in splits:
                    fn(argv + ["--epochs", str(n)])
        finally:
            (loop.GanTrainer.train_epoch, loop.hmr_apply, jhmr.init_hmr, jax.device_count,
             jmesh.auto_render_fn, jloop.init_pose_generator, jloop.init_pos3d_discriminator,
             jsd.make_spin_finetune_step) = saved
        out[name] = (os.path.join(tmp, "gan_" + name, "gan"), epochs)
    return out


@pytest.fixture(scope="module")
def gan_runs(base, demo):
    return _gan_runs(base, demo)


def _zeros_like_init(init):
    """JAX's init as a tree of zeros: its structure and shapes by
    jax.eval_shape, without the eager draws (~6 s of compiles on a CPU)."""
    return lambda *args: jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(lambda: init(*args)))


def test_run_gan_matches_jax(gan_runs, monkeypatch):
    from posegen_tpu.gen import loop as jloop
    from posegen_tpu.gen.generators import GenConfig
    from posegen_tpu.train.checkpoints import _unflatten_into as j_unflatten
    from test_torch_gen import hmr_weights

    (d_j, ep_j), (d_p, ep_p) = gan_runs["jax"], gan_runs["port"]
    files = lambda d: sorted(os.path.relpath(p, d) for p in glob.glob(  # noqa: E731
        os.path.join(d, "**", "*"), recursive=True) if os.path.isfile(p))
    # feedback at iterations 0 and 3 (the first of each epoch), rpi 2 frames
    # in the sink and one pose file a call; train_spin's checkpoint (4 sink
    # rows: no step of its 32)
    pngs = [f"image/{i:05d}.png" for i in range(4)]
    poses = ["poses_axis_angles0.npy", "poses_axis_angles2.npy"]
    assert files(d_p) == files(d_j) == sorted(
        ["epochs.jsonl", "gan_ckpts/gan_000.npz", "gan_ckpts/gan_001.npz",
         "spin_ckpts/spin_000.npz", *pngs, *poses])
    for f in poses:
        a, b = np.load(os.path.join(d_p, f)), np.load(os.path.join(d_j, f))
        assert a.shape == b.shape == (2, 24, 3) and a.dtype == b.dtype, f
    for f in pngs:
        a, b = read_png(os.path.join(d_p, f)), imageio.imread(os.path.join(d_j, f))
        assert a.shape == b.shape == (GAN_HW, GAN_HW, 3) and a.dtype == b.dtype == np.uint8, f
        assert np.array_equal(a, imageio.imread(os.path.join(d_p, f))), f
    recs = {k: [json.loads(x) for x in open(os.path.join(d, "epochs.jsonl"))]
            for k, d in (("jax", d_j), ("port", d_p))}
    assert [sorted(r) for r in recs["port"]] == [sorted(r) for r in recs["jax"]]
    assert [r["epoch"] for r in recs["port"]] == [0, 1]
    assert all(math.isfinite(r["probe_mpjpe"]) for rs in recs.values() for r in rs)
    # the resumed run trained epoch 1 alone, on the batches of JAX's
    # permutation stream
    assert len(ep_p) == len(ep_j) == 2 and all(len(e) == 3 for e in ep_p)
    for e_p, e_j in zip(ep_p, ep_j):
        assert all(np.array_equal(a, b) for a, b in zip(e_p, e_j))
    for n in ("gan_000.npz", "gan_001.npz"):
        fp = dict(np.load(os.path.join(d_p, "gan_ckpts", n)))
        fj = dict(np.load(os.path.join(d_j, "gan_ckpts", n)))
        assert sorted(set(fp) - {ploop.GanTrainer.TORCH_GENERATOR_KEY}) == sorted(fj)
        assert all(fp[k].shape == fj[k].shape and fp[k].dtype == fj[k].dtype for k in fj)
    for init in ("init_pose_generator", "init_pos3d_discriminator"):
        monkeypatch.setattr(jloop, init, _zeros_like_init(getattr(jloop, init)))
    trainer = jloop.GanTrainer(jloop.GanLoopConfig(n_epochs=2), None, gen_cfg=GenConfig(),
                               steps_per_epoch=3)
    trainer.load_checkpoint(os.path.join(d_p, "gan_ckpts", "gan_001.npz"))
    assert trainer.epoch == 2 and trainer.iter_num == 6 and trainer._render_count == 4
    fp = dict(np.load(os.path.join(d_p, "spin_ckpts", "spin_000.npz")))
    fj = dict(np.load(os.path.join(d_j, "spin_ckpts", "spin_000.npz")))
    assert sorted(fp) == sorted(fj)
    assert all(fp[k].shape == fj[k].shape and fp[k].dtype == fj[k].dtype for k in fj)
    jp, js = hmr_weights()
    assert jax.tree_util.tree_structure(j_unflatten({"params": jp, "state": js}, fp)) == \
        jax.tree_util.tree_structure({"params": jp, "state": js})


def test_new_entry_points_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgan.main(["--outputdir", str(tmp_path), "--epochs", "0"])
    (tmp_path / "a").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prt.main(["--nerf_args", "x/args.txt", "--ckptpath", "x.npz", "--annot_dir",
                  str(tmp_path / "a")])
