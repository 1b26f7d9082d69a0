"""The port's render CLIs (posegen_tpu_torch/cli/run_render.py, export_tar.py)
against the JAX package's, on the CPU, on one run of configs/synthetic/
demo.txt written by JAX's CLI (args.txt and its step-0 checkpoint: a train
step's compile would add ~20 s and change nothing these tests read):
load_trained of its .npz and of JAX's export_tar .tar, bit-equal; the
port's .tar in JAX's import_torch_checkpoint; each of run_render's ten
render types (and --render_refined) with the camera and pose sequence,
the frames, the written files, --eval's scores and --save_extras' maps
held to JAX's; draw_skeleton2d against JAX's (cv2) pixel for pixel."""

import contextlib
import functools
import io
import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import posegen_tpu.parallel.mesh as jmesh
import posegen_tpu.render.image as jimage
import posegen_tpu.render.raycast as jraycast
import posegen_tpu_torch.render.image as pimage
import posegen_tpu_torch.render.raycast as praycast
from posegen_tpu.cli import export_tar as jexport
from posegen_tpu.cli import run_nerf as jrun
from posegen_tpu.cli import run_render as jrr
from posegen_tpu_torch.cli import export_tar as pexport
from posegen_tpu_torch.cli import run_render as prr
from posegen_tpu_torch.train.checkpoints import _flatten
from posegen_tpu_torch.utils.png import read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_TOL = 1e-6  # cameras and pose contexts, port (torch) vs JAX, float32 FK
TOL = 1e-5  # frames read back in float32 (--eval): tests/test_torch_image.py's TOL
# frames read back in float16 (every type but --eval): JAX rounds the maps
# to float16 and composites on the host, the port composites on the device
# and rounds once, so a value within 1e-5 of a float16 rounding boundary
# lands one float16 ulp apart (2^-11 below 1)
F16_TOL = 2.0 ** -11 + TOL
U8_TOL = 1  # PNGs of those frames: one u8 level
CHUNK = 64  # the rays of a chunk, both packages


def _argv(root, n_iters):
    return ["--config", os.path.join(ROOT, "configs", "synthetic", "demo.txt"),
            "--data_root", os.path.join(root, "data"), "--basedir", os.path.join(root, "logs"),
            "--n_iters", str(n_iters), "--i_print", "1", "--i_weights", str(n_iters),
            "--i_testset", "0", "--i_video", "0", "--perturb", "0", "--raw_noise_std", "0",
            "--num_workers", "0", "--n_devices", "1"]


@contextlib.contextmanager
def _no_tensorboard():
    import sys

    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None  # its import raises ImportError
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = saved


@functools.lru_cache(maxsize=None)
def _run(tmp: str):
    """JAX's CLI writes the demo run (0 steps) -> {args, ckpt, tar (JAX's
    export), the refined-pose checkpoint and the retarget bones}."""
    # the port's scene (JAX's loader reads its file: tests/test_torch_data.py);
    # JAX's writer takes ~5 s of eager compiles on a CPU
    from posegen_tpu_torch.data.synthetic import make_synthetic_h5

    os.makedirs(os.path.join(tmp, "data", "synthetic"))
    make_synthetic_h5(os.path.join(tmp, "data", "synthetic", "demo.h5"))
    # no TensorBoard writer: its import pulls in TensorFlow (~20 s)
    with contextlib.redirect_stdout(io.StringIO()), _no_tensorboard():
        log = jrun.train(_argv(tmp, 0))
    run = {"args": os.path.join(log, "args.txt"),
           "ckpt": os.path.join(log, "00000000.ckpt.npz"), "tmp": tmp}
    run["tar"] = jexport.main(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                               "--out", os.path.join(tmp, "jax.tar")])
    # a refined-pose checkpoint (axis-angle bones + pelvis per H5 row) and
    # poses to retarget, drawn from a seed
    from posegen_tpu_torch.data.hdf5 import read_h5

    data, _ = read_h5(os.path.join(tmp, "data", "synthetic", "demo.h5"))
    rng = np.random.default_rng(7)
    bones = data["bones"] + rng.normal(0, 0.05, data["bones"].shape).astype(np.float32)
    run["refined"] = os.path.join(tmp, "refined.pose.npz")
    np.savez(run["refined"], **{"pose_params//bones": bones.astype(np.float32),
                                "pose_params//pelvis": data["kp3d"][:, 0].astype(np.float32)})
    run["retarget"] = os.path.join(tmp, "retarget.npy")
    np.save(run["retarget"], (rng.standard_normal((2, 24, 3)) * 0.2).astype(np.float32))
    return run


def demo_dir(tmp_path_factory) -> str:
    """The demo run's directory: one run a process, which
    tests/test_torch_gan_cli.py reads too."""
    return str(tmp_path_factory.getbasetemp() / "demo_run")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(demo_dir(tmp_path_factory))


def _flat(variables):
    return {k: np.asarray(v) for k, v in _flatten(variables).items()}


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("fmt", ["ckpt", "tar"])
def test_load_trained_matches_jax(run, fmt):
    t_j, cfg_j, v_j = jrr.load_trained(run["args"], run[fmt])
    t_p, cfg_p, v_p = prr.load_trained(run["args"], run[fmt], device="cpu")
    assert vars(t_p) == vars(t_j)
    assert {f: getattr(cfg_p, f) for f in cfg_j.__dataclass_fields__} == \
        {f: getattr(cfg_j, f) for f in cfg_j.__dataclass_fields__}
    _assert_bit_equal(v_p, v_j)
    assert not any(t.requires_grad for t in jax.tree_util.tree_leaves(v_p))


def test_port_export_tar_loads_in_jax(run):
    from posegen_tpu.train.checkpoints import import_torch_checkpoint

    path = pexport.main(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                         "--out", os.path.join(run["tmp"], "port.tar")], device="cpu")
    # equal to what JAX reads from its own export of the same checkpoint
    # (the .tar scheme holds a subset of the .npz's variables)
    _assert_bit_equal(import_torch_checkpoint(path)[0], import_torch_checkpoint(run["tar"])[0])


def test_unknown_args_key_gives_jax_message(run, tmp_path):
    bad = tmp_path / "args.txt"
    bad.write_text(open(run["args"]).read() + "not_a_flag = 3\n")
    msgs = []
    for fn in (jrr.load_trained, functools.partial(prr.load_trained, device="cpu")):
        with pytest.raises(SystemExit) as e:
            fn(str(bad), run["ckpt"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not_a_flag" in msgs[0]


# render type -> its extra flags (small frames, few views)
MODES = {
    "val": ["--eval", "--save_gt"],
    # the rest at 2 frames of 16 x 16 where the type allows: JAX compiles
    # each eager operation once a shape (~40 ms each on a CPU)
    "val_refined": ["--render_refined", "--refined_ckpt", "{refined}", "--render_res", "16", "16"],
    "bullet": ["--bullet_n", "2", "--render_res", "16", "16"],
    "interpolate": ["--interp_n", "2", "--render_res", "16", "16"],
    "mesh": ["--mesh_res", "10", "--mesh_thres", "0.03"],  # the demo nets' sigma: +-0.09
    "retarget": ["--retarget_bones", "{retarget}", "--render_res", "16", "16"],
    "animate": ["--render_res", "16", "16"],  # the 8 frames of the sequence
    "poserot": ["--bullet_n", "2", "--render_res", "16", "16"],
    "selected": ["--selected_idxs", "0", "1", "--render_res", "16", "16", "--save_gt"],
    # view 1's wobbled cameras see no ray of its cylinder: JAX's render_path
    # raises on an empty frame (ROADMAP.md Queue 3), so view 0 alone
    "bubble": ["--selected_idxs", "0", "--n_step", "2", "--render_res", "16", "16"],
    "correction": ["--refined_ckpt", "{refined}", "--selected_idxs", "0", "--n_step", "2",
                   "--render_res", "16", "16"],
}


def _one_device(cfg, chunk, use_fused=None, half_readback=False):
    """JAX's auto_render_fn on one device: the tests' 8 virtual CPU devices
    would shard each chunk (and pad it to the mesh)."""
    return None, chunk


@functools.lru_cache(maxsize=None)
def _render(tmp: str, mode: str):
    """Both packages' run_render of `mode` on the same run -> {package:
    (output dir, render_path's (c2ws, hwf, ctxs, out), stdout)}."""
    run = _run(tmp)
    flags = [f.format(**run) for f in MODES[mode]]
    out = {}
    for name, fn, mod, ray in (
            ("jax", jrr.run_render, jimage, jraycast),
            ("port", functools.partial(prr.run_render, device="cpu"), pimage, praycast)):
        seen, real, real_grid = [], mod.render_path, ray.render_mesh_density

        def record(cfg, params, c2ws, hwf, ctxs, **kw):
            res = real(cfg, params, c2ws, hwf, ctxs, **kw)
            seen.append((np.asarray(c2ws), hwf, ctxs, res, kw))
            return res

        def grid(*args, **kw):
            res = real_grid(*args, **kw)
            seen.append((np.asarray(res), np.asarray(args[2].kps)[0, 0]))
            return res

        mod.render_path, real_auto, ray.render_mesh_density = record, jmesh.auto_render_fn, grid
        jmesh.auto_render_fn = _one_device
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                d = fn(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                        "--render_type", mode.split("_")[0], "--outputdir",
                        os.path.join(tmp, name), "--runname", mode, "--chunk", str(CHUNK),
                        "--save_extras", *flags])
        finally:
            mod.render_path, jmesh.auto_render_fn = real, real_auto
            ray.render_mesh_density = real_grid
        out[name] = (d, seen[0] if seen else None, buf.getvalue())
    return out


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _ctx_np(ctx):
    return {k: None if v is None else np.asarray(v)
            for k, v in ctx._asdict().items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_render_type_matches_jax(run, mode):
    res = _render(run["tmp"], mode)
    (d_j, seen_j, _), (d_p, seen_p, out_p) = res["jax"], res["port"]
    assert _files(d_p) == _files(d_j)
    if mode == "mesh":
        # the density grids by the frames' rule; a grid value within that of
        # the threshold may change a tetrahedron's case, so the meshes are
        # held to the JAX package's marching_tetrahedra of each grid
        from posegen_tpu.render.mesh import marching_tetrahedra

        # (JAX's jitted grid, as run_render calls it, moves an isolated point
        # by up to a few 1e-3 against its eager call and the port; the
        # tests of the density grid in tests/test_torch_image.py take the
        # eager call: at most one point in a thousand in this run)
        far = np.abs(seen_p[0] - seen_j[0]) > TOL
        assert far.sum() <= max(1, far.size // 1000), far.sum()
        for d, (g, root) in ((d_p, seen_p), (d_j, seen_j)):
            lines = open(os.path.join(d, "mesh.ply")).read().splitlines()
            nv = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
            body = lines[lines.index("end_header") + 1:]
            v = np.array([list(map(float, x.split())) for x in body[:nv]]).reshape(nv, 3)
            f = np.array([list(map(int, x.split()))[1:] for x in body[nv:]])
            res, radius = g.shape[0] - 1, 1.0
            vw, fw = marching_tetrahedra(g, iso=0.03, origin=root - radius,
                                         spacing=2.0 * radius / res)
            assert len(vw) > 0 and v.shape == vw.shape and np.array_equal(f, fw)
            np.testing.assert_allclose(v, vw, atol=1e-6, rtol=0)  # the file's 6 decimals
        return
    c2w_j, hwf_j, ctx_j, out_j, kw_j = seen_j
    c2w_p, hwf_p, ctx_p, out_p_maps, kw_p = seen_p
    assert tuple(hwf_p) == tuple(hwf_j) and kw_p["chunk"] == CHUNK
    np.testing.assert_allclose(c2w_p, c2w_j, atol=SEQ_TOL, rtol=0)
    assert len(ctx_p) == len(ctx_j)
    for cp, cj in zip(ctx_p, ctx_j):
        cp, cj = _ctx_np(cp), _ctx_np(cj)
        for k in cj:
            if cj[k] is None:
                assert cp[k] is None, k
            else:
                np.testing.assert_allclose(cp[k], cj[k], atol=SEQ_TOL, rtol=0, err_msg=k)
    half = kw_j["half_readback"]
    assert kw_p["half_readback"] == half == (mode != "val")
    tol = F16_TOL if half else TOL
    for k in ("rgbs", "accs", "disps"):
        np.testing.assert_allclose(out_p_maps[k], out_j[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(out_p_maps["bboxes"], out_j["bboxes"])
    # every PNG (frames, GT, acc / disp maps, skeleton overlays) read back
    # by the port's codec against JAX's file read by imageio
    for f in _files(d_j):
        if f.endswith(".png"):
            a, b = read_png(os.path.join(d_p, f)).astype(int), imageio.imread(
                os.path.join(d_j, f)).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= U8_TOL, f
    if mode == "val":  # --eval
        for name in ("psnr.txt", "ssim.txt"):
            a, b = (float(open(os.path.join(d, name)).read()) for d in (d_p, d_j))
            assert abs(a - b) <= TOL, name
        s_p = np.load(os.path.join(d_p, "scores.npy"), allow_pickle=True).item()
        s_j = np.load(os.path.join(d_j, "scores.npy"), allow_pickle=True).item()
        assert sorted(s_p) == sorted(s_j)
        for k in s_j:
            np.testing.assert_allclose(s_p[k], s_j[k], atol=TOL, rtol=0, err_msg=k)
        assert "eval:" in out_p


def test_gate_refusal_clamps_the_chunk(run, tmp_path, monkeypatch):
    """The demo's width-48 nets fail the kernels' gate: a chunk above 8192
    is clamped to it, with the gate's reason, as JAX's auto_render_fn does."""
    from posegen_tpu_torch.kernels import field

    monkeypatch.setattr(field, "_WARNED_FALLBACKS", set())  # one warning per process
    seen, real = [], pimage.render_path
    pimage.render_path = lambda *a, **kw: seen.append(kw["chunk"]) or real(*a, **kw)
    try:
        with pytest.warns(UserWarning, match="netwidth=48.*clamped 65536 -> 8192"):
            prr.run_render(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                            "--render_type", "bullet", "--bullet_n", "1", "--render_res", "8",
                            "8", "--outputdir", str(tmp_path), "--no_save"], device="cpu")
    finally:
        pimage.render_path = real
    assert seen == [8192]


def test_video_is_skipped_without_imageio(run, tmp_path, monkeypatch, capsys):
    """Where imageio does not import, run_render says that the mp4 was not
    written and writes the rest, render_rgb.gif through the port's own GIF
    writer: each GIF frame is the writer's quantisation of its PNG."""
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.startswith("imageio"):
            raise ImportError("No module named 'imageio'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    d = prr.run_render(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                        "--render_type", "bullet", "--bullet_n", "2", "--render_res", "8", "8",
                        "--outputdir", str(tmp_path)], device="cpu")
    assert "render_rgb.mp4 not written" in capsys.readouterr().out
    assert _files(d) == ["bboxes.npy", "image/00000.png", "image/00001.png", "render_rgb.gif"]
    from posegen_tpu_torch.utils.gif import quantized_frames, read_gif

    pngs = np.stack([read_png(os.path.join(d, "image", f"{i:05d}.png")) for i in range(2)])
    np.testing.assert_array_equal(read_gif(os.path.join(d, "render_rgb.gif")),
                                  quantized_frames(pngs))


def test_spiral_video_gifs_read_back(run, tmp_path):
    """run_nerf.save_spiral_video writes its GIFs through the port's own
    writer: the disparity GIF reads back as its grey frames exactly, the rgb
    GIF as the writer's quantisation of its frames."""
    import types

    from posegen_tpu_torch.cli.config import args_to_data_config
    from posegen_tpu_torch.cli.run_nerf import save_spiral_video
    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.utils.gif import quantized_frames, read_gif

    targs, cfg, variables = prr.load_trained(run["args"], run["ckpt"], device="cpu")
    loader, render_data, _ = load_data(args_to_data_config(targs))
    loader.close()
    seen, real = [], pimage.render_path
    pimage.render_path = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
    try:
        rgb_path = save_spiral_video(cfg, types.SimpleNamespace(params=variables, embeds={}),
                                     render_data, str(tmp_path), 7, n_frames=4, chunk=CHUNK)
    finally:
        pimage.render_path = real
    out = seen[0]
    rgb = (np.clip(out["rgbs"], 0, 1) * 255).astype(np.uint8)
    disp = out["disps"] / max(float(out["disps"].max()), 1e-8)
    disp = (np.clip(disp, 0, 1) * 255).astype(np.uint8)
    assert rgb_path == str(tmp_path / "spiral_000007_rgb.gif") and len(rgb) == 4
    np.testing.assert_array_equal(read_gif(rgb_path), quantized_frames(rgb))
    np.testing.assert_array_equal(read_gif(str(tmp_path / "spiral_000007_disp.gif")),
                                  np.repeat(disp[..., None], 3, -1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draw_skeleton2d_matches_cv2(seed):
    from posegen_tpu.utils.visualization import draw_skeleton2d as j_draw
    from posegen_tpu_torch.utils.visualization import draw_skeleton2d as p_draw

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    # inside the frame, and (seeds 1, 2) partly and far outside it
    span = (60.0, 40.0) if seed == 0 else (200.0, 150.0)
    kp2d = np.stack([rng.uniform(-span[0] / 2 + 28, span[0] / 2 + 28, 24),
                     rng.uniform(-span[1] / 2 + 20, span[1] / 2 + 20, 24)], -1)
    np.testing.assert_array_equal(p_draw(img, kp2d), j_draw(img, kp2d))
    f = rng.uniform(size=(40, 56, 3)).astype(np.float32)
    np.testing.assert_array_equal(p_draw(f, kp2d), j_draw(f, kp2d))


def test_new_entry_points_refuse_a_missing_card(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prr.run_render(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                        "--outputdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexport.main(["--nerf_args", run["args"], "--ckptpath", run["ckpt"],
                      "--out", str(tmp_path / "x.tar")])
