"""posegen_tpu_torch's tooling against posegen_tpu's on the CPU: the mesh
rasterizer (`render/rasterizer.py`) and the turntable CLI
(`cli/render_mesh.py`), the GIF codec (`utils/gif.py`), the experiment
helpers (`utils/experiment.py`), the profiling helpers
(`utils/profiling.py`) and `utils/fixtures.make_train_batch`.

The rasterizer's images equal JAX's exactly (float64 on both sides, the
paint order's ties included). GIFs written by the port read back through
imageio / PIL as the writer's own quantisation of the frames (grey frames
exactly), and `read_gif` equals PIL on GIFs imageio writes. The bitmap
label of `add_text_to_video` is held to cv2's stamp by its bounding box
(IoU >= 0.5, nothing drawn beyond 4 pixels of cv2's box), not bit for bit.
"""

import contextlib
import functools
import io
import json
import os
import struct
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from posegen_tpu.cli import render_mesh as jrender_mesh
from posegen_tpu.data.synthetic import _look_at_c2w
from posegen_tpu.render import rasterizer as jrast
from posegen_tpu.render.mesh import marching_tetrahedra
from posegen_tpu.render.raycast import RaycastConfig as JRaycastConfig
from posegen_tpu.utils import experiment as jexp
from posegen_tpu.utils import fixtures as jfix
from posegen_tpu.utils import profiling as jprof
from posegen_tpu_torch.cli import render_mesh as trender_mesh
from posegen_tpu_torch.render import rasterizer as trast
from posegen_tpu_torch.render.mesh import save_ply
from posegen_tpu_torch.render.raycast import RaycastConfig as TRaycastConfig
from posegen_tpu_torch.utils import experiment as texp
from posegen_tpu_torch.utils import fixtures as tfix
from posegen_tpu_torch.utils import gif
from posegen_tpu_torch.utils import profiling as tprof
from posegen_tpu_torch.utils.png import read_png

# ---------------------------------------------------------------------------
# the rasterizer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sphere(n=20, r=0.5):
    """tests/test_viz_raster.py's sphere."""
    t = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(t, t, t, indexing="ij")
    verts, faces = marching_tetrahedra(r ** 2 - (x ** 2 + y ** 2 + z ** 2), origin=(-1, -1, -1),
                                       spacing=2 / (n - 1))
    return np.asarray(verts), np.asarray(faces)


def _ties_mesh():
    """Random faces, each also listed again with its corners rotated, and a
    set of coplanar faces at one depth: z ties decide pixels."""
    rng = np.random.default_rng(3)
    verts = rng.uniform(-0.6, 0.6, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (80, 3))
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    plane = np.array([[-0.5, -0.5, 0.2], [0.5, -0.5, 0.2], [0.5, 0.5, 0.2], [-0.5, 0.5, 0.2]],
                     np.float32)
    verts = np.concatenate([verts, plane])
    quad = np.array([[60, 61, 62], [60, 62, 63], [61, 62, 60], [62, 63, 60]])
    faces = np.concatenate([faces, faces[:, [1, 2, 0]], quad, quad[:, [2, 0, 1]]])
    colors = rng.uniform(0, 1, (len(verts), 3))
    return verts, faces.astype(np.int64), colors


def _behind_mesh():
    """The sphere moved so that the camera at z = 2 sits inside its far
    half: some faces lie behind the camera, some straddle its plane."""
    verts, faces = _sphere(n=14)
    return verts * 3.0 + np.array([0.0, 0.0, 1.2], np.float32), faces


C2W = _look_at_c2w(np.array([0, 0, 2.0], np.float32), np.zeros(3, np.float32))
RASTER_CASES = {
    "sphere": lambda: (*_sphere(), None),
    "ties": _ties_mesh,
    "behind_camera": lambda: (*_behind_mesh(), None),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_rasterize_mesh_equals_jax(case):
    verts, faces, colors = RASTER_CASES[case]()
    for H, W, focal in ((64, 64, 60.0), (40, 56, 35.0)):
        ref = jrast.rasterize_mesh(verts, faces, C2W, H, W, focal, colors=colors)
        got = trast.rasterize_mesh(verts, faces, C2W, H, W, focal, colors=colors, device="cpu")
        assert got.dtype == np.float32 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, ref)
        assert (got != 1.0).any()


def test_rasterize_mesh_chunks_equal_one_pass(monkeypatch):
    """Many chunks of faces (a pair budget of 64) give one pass's image."""
    verts, faces, colors = _ties_mesh()
    one = trast.rasterize_mesh(verts, faces, C2W, 48, 48, 50.0, colors=colors, device="cpu")
    monkeypatch.setattr(trast, "PAIR_CHUNK", 64)
    np.testing.assert_array_equal(
        trast.rasterize_mesh(verts, faces, C2W, 48, 48, 50.0, colors=colors, device="cpu"), one)


def test_overlay_and_turntable_equal_jax():
    verts, faces = _sphere(n=14)
    img = np.random.default_rng(0).uniform(0, 0.3, (64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        trast.overlay_mesh(img, verts, faces, C2W, 60.0, device="cpu"),
        jrast.overlay_mesh(img, verts, faces, C2W, 60.0))
    np.testing.assert_array_equal(
        trast.turntable_render(verts, faces, n_views=3, H=48, W=40, device="cpu"),
        jrast.turntable_render(verts, faces, n_views=3, H=48, W=40))


def test_render_mesh_cli_equals_jax(tmp_path):
    verts, faces = _sphere(n=12)
    ply = str(tmp_path / "m.ply")
    save_ply(ply, verts, faces)
    v2, f2 = trender_mesh.load_ply(ply)
    jv, jf = jrender_mesh.load_ply(ply)
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(f2, jf)
    argv = ["--ply", ply, "--n_views", "3", "--res", "32"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jdir = jrender_mesh.main(argv + ["--outputdir", str(tmp_path / "jax")])
        tdir = trender_mesh.main(argv + ["--outputdir", str(tmp_path / "port")], device="cpu")
    for i in range(3):
        name = f"{i:05d}.png"
        np.testing.assert_array_equal(read_png(os.path.join(tdir, name)),
                                      imageio.imread(os.path.join(jdir, name)))
    if not os.path.exists(os.path.join(tdir, "turntable.mp4")):
        assert "turntable.mp4 not written" in out.getvalue()


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _frames(seed=0, T=3, H=40, W=56):
    """Smooth gradients with noise (more than 256 colours) and a frame of 3
    colours."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    out = []
    for t in range(T - 1):
        f = np.stack([xx * 255 / W, yy * 255 / H, (xx + yy + 40 * t) % 256], -1)
        out.append(np.clip(f + rng.normal(0, 6, f.shape), 0, 255).astype(np.uint8))
    few = np.zeros((H, W, 3), np.uint8)
    few[:, W // 3:] = (200, 10, 10)
    few[H // 2:] = (0, 0, 255)
    return np.stack(out + [few])


def _pil_frames(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.stack([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)])


def test_write_gif_reads_back_as_its_quantisation(tmp_path):
    frames = _frames()
    path = gif.write_gif(str(tmp_path / "a.gif"), frames, fps=5)
    q = gif.quantized_frames(frames)
    assert len(np.unique(q[0].reshape(-1, 3), axis=0)) <= 256 < len(
        np.unique(frames[0].reshape(-1, 3), axis=0))
    np.testing.assert_array_equal(q[2], frames[2])  # <= 256 colours: exact
    np.testing.assert_array_equal(_pil_frames(path), q)
    np.testing.assert_array_equal(np.stack(imageio.mimread(path)), q)
    np.testing.assert_array_equal(gif.read_gif(path), q)
    # the median cut stays near the frame
    assert np.abs(q[:2].astype(int) - frames[:2]).mean() < 8


def test_grey_frames_round_trip_exactly(tmp_path):
    rng = np.random.default_rng(1)
    grey = rng.integers(0, 256, (3, 33, 47)).astype(np.uint8)
    grey[1] //= 64  # 4 levels: the smallest LZW code size, 2 bits
    path = gif.write_gif(str(tmp_path / "g.gif"), grey, fps=5)
    rgb = np.repeat(grey[..., None], 3, -1)
    np.testing.assert_array_equal(gif.read_gif(path), rgb)
    np.testing.assert_array_equal(_pil_frames(path), rgb)


def test_large_frames_reset_the_code_table(tmp_path):
    """A 256-colour noise frame of 200 x 300 fills the 4096-entry table many
    times over: the clear codes and the 12-bit codes read back in PIL and
    in read_gif."""
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (2, 200, 300, 3)).astype(np.uint8)
    path = gif.write_gif(str(tmp_path / "n.gif"), frames, fps=10)
    q = gif.quantized_frames(frames)
    np.testing.assert_array_equal(_pil_frames(path), q)
    np.testing.assert_array_equal(gif.read_gif(path), q)


def test_read_gif_equals_pil_on_imageio_gifs(tmp_path):
    """imageio (through Pillow) writes a global palette, later frames as
    sub-rectangles with a transparent index: read_gif composes them as PIL."""
    f = np.zeros((4, 40, 50, 3), np.uint8) + 50
    f[1, 5:10, 5:20] = 200
    f[2] = f[1]
    f[2, 30:35, 40:45] = (10, 20, 30)
    f[3] = f[2]
    f[3, 0, 0] = 1
    rng = np.random.default_rng(4)
    for name, frames in (("parts.gif", f),
                         ("noise.gif", rng.integers(0, 256, (3, 60, 70, 3)).astype(np.uint8)),
                         ("grey.gif", rng.integers(0, 256, (2, 30, 20)).astype(np.uint8))):
        path = str(tmp_path / name)
        imageio.mimwrite(path, list(frames), fps=10, loop=0)
        np.testing.assert_array_equal(gif.read_gif(path), _pil_frames(path))


def _gce_and_loop(path):
    """(delays, disposal methods of the graphic control extensions, loop
    count); imageio's later frames also set a transparent index, ours do
    not."""
    blob = open(path, "rb").read()
    delays, packed, pos = [], [], 0
    while (pos := blob.find(b"\x21\xf9\x04", pos)) >= 0:
        packed.append((blob[pos + 3] >> 2) & 7)
        delays.append(struct.unpack("<H", blob[pos + 4:pos + 6])[0])
        pos += 8
    loop = blob.find(b"NETSCAPE2.0")
    return delays, packed, struct.unpack("<H", blob[loop + 13:loop + 15])[0]


@pytest.mark.parametrize("fps", [5, 6, 12, 14, 15])
def test_delay_and_loop_fields_as_imageio_writes_them(tmp_path, fps):
    frames = np.random.default_rng(5).integers(0, 256, (3, 8, 9, 3)).astype(np.uint8)
    imageio.mimwrite(str(tmp_path / "i.gif"), list(frames), fps=fps, loop=0)
    gif.write_gif(str(tmp_path / "p.gif"), frames, fps=fps, loop=0)
    ref, got = _gce_and_loop(str(tmp_path / "i.gif")), _gce_and_loop(str(tmp_path / "p.gif"))
    assert got == ref, (got, ref)
    assert got[0] == [gif.gif_delay_cs(fps)] * 3
    with Image.open(str(tmp_path / "i.gif")) as a, Image.open(str(tmp_path / "p.gif")) as b:
        assert (a.info["duration"], a.info["loop"]) == (b.info["duration"], b.info["loop"])


def _descriptor(blob: bytes) -> int:
    """Byte offset of the first image descriptor of a file write_gif wrote."""
    return blob.index(b"\x2c\x00\x00\x00\x00")


@pytest.mark.parametrize("fault,reason", [
    ("interlace", "interlaced"),
    ("disposal3", "disposal method 3"),
    ("disposal2", "disposal method 2"),
    ("truncated", "truncated"),
    ("no_trailer", "no trailer"),
    ("not_gif", "no GIF signature"),
])
def test_read_gif_refusals(tmp_path, fault, reason):
    frames = _frames(T=2)
    blob = bytearray(open(gif.write_gif(str(tmp_path / "ok.gif"), frames, fps=5), "rb").read())
    if fault == "interlace":
        blob[_descriptor(blob) + 9] |= 0x40
    elif fault.startswith("disposal"):
        gce = blob.index(b"\x21\xf9\x04")
        blob[gce + 3] |= int(fault[-1]) << 2
    elif fault == "truncated":
        blob = blob[:_descriptor(blob) + 900]
    elif fault == "no_trailer":
        blob = blob[:-1]
    else:
        blob[:6] = b"\x89PNG\r\n"
    path = tmp_path / "bad.gif"
    path.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match=reason):
        gif.read_gif(str(path))


def test_save_video_gif_route(tmp_path):
    frames = _frames().astype(np.float32) / 255.0
    path = texp.save_video(str(tmp_path / "v.gif"), frames, fps=4, loop=0)
    u8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(gif.read_gif(path), gif.quantized_frames(u8))


# ---------------------------------------------------------------------------
# experiment helpers
# ---------------------------------------------------------------------------


def test_read_tfevent_equals_jax(tmp_path):
    from torch.utils.tensorboard import SummaryWriter

    w = SummaryWriter(str(tmp_path))
    for i in range(4):
        w.add_scalar("Val/PSNR", 20.0 + i, i * 100)
        w.add_scalar("Train/loss", 1.0 / (i + 1), i * 100)
    w.close()
    for tags in (None, ["Val/PSNR"], ["Val/PSNR", "missing"]):
        got, ref = texp.read_tfevent(str(tmp_path), tags), jexp.read_tfevent(str(tmp_path), tags)
        assert sorted(got) == sorted(ref) and ref
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    assert texp.read_tfevent(str(tmp_path / "empty")) == jexp.read_tfevent(
        str(tmp_path / "empty")) == {}


def test_read_tfevent_names_a_missing_tensorboard(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "tensorboard.backend.event_processing.event_accumulator",
                        None)
    with pytest.raises(ImportError, match="tensorboard"):
        texp.read_tfevent(str(tmp_path))


def test_experiment_helpers_equal_jax(tmp_path):
    (tmp_path / "psnr.txt").write_text("100\t21.5\n200\t23.0\n")
    (tmp_path / "ssim.txt").write_text("0.81\n0.83\n")
    for metric in ("psnr", "ssim", "lpips"):
        np.testing.assert_array_equal(texp.read_eval_result(str(tmp_path), metric),
                                      jexp.read_eval_result(str(tmp_path), metric))
    track = np.array([[1000, 20.0], [2000, 25.5], [3000, 24.0]])
    for t in (track, np.zeros((0, 2))):
        for maximum in (True, False):
            got = texp.best_value_and_step(t, maximum)
            ref = jexp.best_value_and_step(t, maximum)
            assert got == ref or (np.isnan(got[0]) and np.isnan(ref[0]) and got[1] == ref[1])
    run = tmp_path / "run"
    run.mkdir()
    (run / "spiral_002000_rgb.gif").write_bytes(b"x")
    (run / "text_spiral_002000_rgb.gif").write_bytes(b"x")
    assert texp.find_step_videos([str(run)], [2000]) == jexp.find_step_videos([str(run)], [2000])
    for fn in (texp.find_step_videos, jexp.find_step_videos):
        with pytest.raises(FileNotFoundError):
            fn([str(run)], [9000])
    rng = np.random.default_rng(0)
    vids = [rng.uniform(0, 1, (3 + i, 16 - 2 * i, 12 + i, 3)).astype(np.float32)
            for i in range(3)]
    for n_cols, pad in ((2, 2), (3, 0), (1, 5)):
        np.testing.assert_array_equal(texp.concat_video_grid(vids, n_cols, pad),
                                      jexp.concat_video_grid(vids, n_cols, pad))


def _box(mask):
    ys, xs = np.nonzero(mask)
    return ys.min(), ys.max(), xs.min(), xs.max()


@pytest.mark.parametrize("text", ["hello", "Val/PSNR 23.51 @ step 2000", "gj|{}[]", "iter é 9"])
def test_add_text_to_video_legible_where_cv2_stamps(text):
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 0.5, (2, 48, 360, 3)).astype(np.float32)
    got = texp.add_text_to_video(frames, text)
    ref = jexp.add_text_to_video(frames, text)  # cv2.putText
    assert got.dtype == np.uint8 and got.shape == ref.shape
    base = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    ours, cv2s = (got != base).any(-1), (ref != base).any(-1)
    np.testing.assert_array_equal(ours[0], ours[1])
    (a0, a1, b0, b1), (c0, c1, d0, d1) = _box(ours[0]), _box(cv2s[0])
    inter = max(0, min(a1, c1) - max(a0, c0) + 1) * max(0, min(b1, d1) - max(b0, d0) + 1)
    union = (a1 - a0 + 1) * (b1 - b0 + 1) + (c1 - c0 + 1) * (d1 - d0 + 1) - inter
    assert inter / union >= 0.5, (_box(ours[0]), _box(cv2s[0]))
    near = np.zeros_like(ours[0])
    near[max(c0 - 4, 0):c1 + 5, max(d0 - 4, 0):d1 + 5] = True
    assert not (ours[0] & ~near).any()
    assert (got[0][ours[0]] == 255).all()
    # uint8 frames are stamped as they are
    np.testing.assert_array_equal(texp.add_text_to_video(base, text), got)


def test_different_strings_give_different_stamps():
    frames = np.zeros((1, 40, 200, 3), np.uint8)
    stamps = {t: texp.add_text_to_video(frames, t) for t in ("abc", "abd", "ABC", "a bc")}
    for a in stamps:
        for b in stamps:
            assert (a == b) == np.array_equal(stamps[a], stamps[b])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_phase_timer_equals_jax(monkeypatch):
    import time

    clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.125, 3.0, 4.0, 5.0, 5.5] * 2)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    timers = []
    for mod in (jprof, tprof):
        t = mod.PhaseTimer(alpha=0.3)
        for name in ("render", "render", "load", "render", "load"):
            with t.phase(name):
                pass
        timers.append(t)
    ref, got = timers
    assert (got.ema, got.last, got.count) == (ref.ema, ref.last, ref.count)
    assert got.summary() == ref.summary()


def test_phase_timer_blocks_on_nested_tensors():
    t = tprof.PhaseTimer()
    x = torch.ones(8)
    with t.phase("work", block_on={"a": [x, (x * 2,)], "b": None}):
        x = x + 1
    assert t.count == {"work": 1} and t.ema["work"] >= 0.0


def test_annotate_and_trace_write_a_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as tr:
        with tprof.annotate("render"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert tr.path is not None and os.path.dirname(tr.path) == str(tmp_path / "trace")
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "render" for e in events)


def test_device_memory_stats_empty_on_the_cpu():
    assert tprof.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}


# ---------------------------------------------------------------------------
# make_train_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_groups,opt_pose,opt_framecode", [
    (1, False, False), (4, False, True), (4, True, False), (2, True, True),
])
def test_make_train_batch_equals_jax(n_groups, opt_pose, opt_framecode):
    kw = dict(n_rays=64, seed=3, opt_pose=opt_pose, n_frames=5, n_groups=n_groups)
    ref = jfix.make_train_batch(JRaycastConfig(opt_framecode=opt_framecode), **kw)
    got = tfix.make_train_batch(TRaycastConfig(opt_framecode=opt_framecode), device="cpu", **kw)
    assert list(got) == list(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.dtype == r.dtype and g.shape == r.shape, (k, g.dtype, r.dtype)
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=k)


def test_make_train_batch_refuses_ragged_groups():
    with pytest.raises(ValueError, match="multiple"):
        tfix.make_train_batch(TRaycastConfig(), n_rays=10, n_groups=4, device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card every new tooling entry point raises; none falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    verts, faces = _sphere(n=8)
    ply = str(tmp_path / "m.ply")
    save_ply(ply, verts, faces)
    for fn in (lambda: trast.rasterize_mesh(verts, faces, C2W, 8, 8, 10.0),
               lambda: trast.overlay_mesh(np.zeros((8, 8, 3)), verts, faces, C2W, 10.0),
               lambda: trast.turntable_render(verts, faces, n_views=1, H=8, W=8),
               lambda: trender_mesh.main(["--ply", ply, "--outputdir", str(tmp_path / "o")]),
               lambda: tfix.make_train_batch(TRaycastConfig(), n_rays=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()

