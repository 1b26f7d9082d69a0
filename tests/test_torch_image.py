"""posegen_tpu_torch's cameras, geometry, whole-image renders and mesh
extraction against posegen_tpu's on the CPU.

The host box math (cylinder boxes, valid_idx) must come out identical. The
renders run a small scene: a 24 x 32 image whose pose box (12 x 16 = 192
rays) covers part of it, 8 + 4 samples, two 2-layer 256-wide nets (the
kernels' width, so the fused route runs the kernels' plain versions).
Renders on the plain route are held to TOL, the bound tests/
test_torch_render.py holds render_rays' plain route to against JAX's XLA
path; the fused route (`use_fused=True`: the kernels' plain versions, bf16
weights, float32 activations) is held to the same TOL against JAX's fused
route (Pallas interpret mode at MM_DTYPE float32).

A render depends on its chunking where a ray misses the pose cylinder: such
a ray takes the mean near / far of the rays of its chunk that hit
(`get_near_far_in_cylinder`'s repair). JAX pads a ragged last chunk with
copies of its last ray, which then count in that mean; the port renders
the ragged chunk as it is. So the renders are compared at chunks that
divide every frame's ray count, and `test_ragged_last_chunk` holds the
port's ragged chunk against JAX's function on the same rays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.cli.run_render import _bullet_c2ws as j_bullet_c2ws
from posegen_tpu.data.synthetic import _look_at_c2w as j_look_at
from posegen_tpu.render import image as jimg
from posegen_tpu.render import mesh as jmesh
from posegen_tpu.render import raycast as jr
from posegen_tpu.skeleton import cameras as jcam
from posegen_tpu.skeleton import geometry as jgeo
from posegen_tpu.skeleton.skeleton import SMPL_REST_POSE
from posegen_tpu.utils.fixtures import make_pose_ctx
from posegen_tpu_torch.data.synthetic import _look_at_c2w as t_look_at
from posegen_tpu_torch.render import image as timg
from posegen_tpu_torch.render import mesh as tmesh
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.skeleton import cameras as tcam
from posegen_tpu_torch.skeleton import geometry as tgeo
from posegen_tpu_torch.utils.convert import params_from_numpy

TOL = 1e-5
H, W, FOCAL = 24, 32, 20.0
CHUNK = 64  # the box's 192 rays in three chunks
CFG = dict(N_samples=8, N_importance=4, netdepth=2)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def _rand_c2w(seed=0):
    rng = np.random.default_rng(seed)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0].astype(np.float32)
    c2w[:3, 3] = rng.standard_normal(3).astype(np.float32) + [0.0, 0.0, 3.0]
    return c2w


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_swap_and_extrinsics(kind):
    c2w = _rand_c2w()
    wrap = torch.as_tensor if kind == "torch" else np.asarray
    for t_fn, j_fn in ((tcam.swap_mat, jcam.swap_mat),
                       (tcam.nerf_c2w_to_extrinsic, jcam.nerf_c2w_to_extrinsic),
                       (tcam.nerf_extrinsic_to_c2w, jcam.nerf_extrinsic_to_c2w)):
        got = t_fn(wrap(c2w))
        assert isinstance(got, torch.Tensor) == (kind == "torch")
        np.testing.assert_allclose(np.asarray(got), j_fn(c2w), atol=1e-6)


@pytest.mark.parametrize("center", [None, (14.5, 13.0)])
def test_world_to_cam(center):
    pts = np.random.default_rng(1).standard_normal((10, 3)).astype(np.float32)
    ext = jcam.nerf_c2w_to_extrinsic(_rand_c2w())
    np.testing.assert_array_equal(tcam.world_to_cam(pts, ext, H, W, 30.0, center),
                                  jcam.world_to_cam(pts, ext, H, W, 30.0, center))


@pytest.mark.parametrize("focal,center", [(30.0, None), ((30.0, 26.0), (15.0, 11.5))])
def test_get_rays(focal, center):
    c2w = _rand_c2w(2)
    o, d = tcam.get_rays(H, W, focal, torch.as_tensor(c2w), center)
    jo, jd = jcam.get_rays(H, W, focal, jnp.asarray(c2w), center)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    no, nd = tcam.get_rays_np(H, W, focal, c2w, center)
    jno, jnd = jcam.get_rays_np(H, W, focal, c2w, center)
    np.testing.assert_array_equal(no, jno)
    np.testing.assert_array_equal(nd, jnd)


def test_rotations_translate_and_ndc():
    for name in ("rotate_x", "rotate_y", "rotate_z"):
        np.testing.assert_array_equal(getattr(tcam, name)(0.7), getattr(jcam, name)(0.7))
    np.testing.assert_array_equal(tcam.translate(1, 2, 3), jcam.translate(1, 2, 3))
    rng = np.random.default_rng(3)
    ro = rng.standard_normal((5, 3)).astype(np.float32)
    rd = rng.standard_normal((5, 3)).astype(np.float32)
    ref = jcam.ndc_rays(H, W, 30.0, 1.0, ro, rd)
    for wrap in (np.asarray, torch.as_tensor):
        got = tcam.ndc_rays(H, W, 30.0, 1.0, wrap(ro), wrap(rd))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(np.asarray(g), r, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("focal", [30.0, np.float32(25.0), (30.0,), (30.0, 26.0)])
def test_focal_to_intrinsic(focal):
    np.testing.assert_array_equal(tgeo.focal_to_intrinsic(focal),
                                  jgeo.focal_to_intrinsic(focal))


@pytest.mark.parametrize("kw", [{}, {"scale": 1.3}, {"center": (12.7, 9.2)},
                                {"make_int": False}, {"scale": 0.8, "make_int": False}])
@pytest.mark.parametrize("batched", [False, True])
def test_cylinder_to_box_2d(kw, batched):
    """The integer box exactly: a one-pixel shift would move valid_idx."""
    rng = np.random.default_rng(4)
    cyl = np.asarray(make_pose_ctx(0, n_poses=3).cyls)
    cyl = cyl if batched else cyl[0]
    w2c = jcam.nerf_c2w_to_extrinsic(t_look_at(np.array([2.0, 0.3, 8.0], np.float32),
                                               rng.standard_normal(3) * 0.1))
    got = tgeo.cylinder_to_box_2d(cyl, (H, W, FOCAL), w2c, **kw)
    ref = jgeo.cylinder_to_box_2d(cyl, (H, W, FOCAL), w2c, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_joint_frames_and_bone_lengths():
    for vec in ([0.0, 0.0, 0.0], [0.3, -1.0, 0.2], [0.0, 0.0, 2.0]):
        np.testing.assert_array_equal(tgeo.create_local_coord(vec), jgeo.create_local_coord(vec))
    np.testing.assert_array_equal(tgeo.get_per_joint_coords(SMPL_REST_POSE),
                                  jgeo.get_per_joint_coords(SMPL_REST_POSE))
    kp = np.asarray(make_pose_ctx(1, n_poses=2).kps)
    np.testing.assert_array_equal(tgeo.bone_lengths(kp), jgeo.bone_lengths(kp))


# ---------------------------------------------------------------------------
# boxes, cam packs and device raygen
# ---------------------------------------------------------------------------

def _cyl(seed=0):
    return np.asarray(make_pose_ctx(seed).cyls)[0]


def _camera(i=0):
    """The scene's camera i: on a ring of radius 8 at height 0.3, aimed at
    the root joint of make_pose_ctx(0)."""
    root = np.asarray(make_pose_ctx(0).kps)[0, 0]
    t = 0.25 + 0.9 * i
    return j_look_at(np.array([8 * np.sin(t), 0.3, 8 * np.cos(t)], np.float32), root)


@pytest.mark.parametrize("window", [None, (8, 20), (0, 3)])
def test_valid_box_for_pose(window):
    """Without a window, with one that cuts the box, and with one the pose
    misses entirely (a one-pixel box)."""
    cyl = _cyl()
    got = timg.valid_box_for_pose(H, W, FOCAL, _camera(), cyl, window=window)
    ref = jimg.valid_box_for_pose(H, W, FOCAL, _camera(), cyl, window=window)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    if window == (0, 3):
        assert len(got[2]) == 1
    if window is None:
        assert len(got[2]) == 192
        for g, r in zip(timg.valid_rays_for_pose(H, W, FOCAL, _camera(), cyl),
                        jimg.valid_rays_for_pose(H, W, FOCAL, _camera(), cyl)):
            for a, b in zip(g, r) if isinstance(r, tuple) else [(g, r)]:
                np.testing.assert_array_equal(a, b)


def test_make_cam_and_rays_from_box():
    """The cam pack equals JAX's; rays_from_box reproduces get_rays_np's
    rows of the box, and clamps offsets past it to the last valid ray."""
    focal, center = (30.0, 28.0), (W * 0.5 - 1.0, H * 0.5 + 2.0)
    c2w = _rand_c2w(5)
    c2w[:3, 3] = [0.0, 0.0, 9.0]
    cyl = np.asarray(make_pose_ctx(0).cyls)[0]
    ro, rd, valid_idx, (tl, br) = jimg.valid_rays_for_pose(H, W, focal, c2w, cyl, center)
    cam = timg.make_cam(H, W, focal, c2w, tl, br, center=center)
    ref = jimg.make_cam(H, W, focal, c2w, tl, br, center=center)
    for k in ref:
        assert cam[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(cam[k], ref[k])
    n = int(cam["box"][3])
    assert n == ro.shape[0] > 0
    cam_t = {k: torch.as_tensor(v) for k, v in cam.items()}
    o, d = timg.rays_from_box(cam_t, 0, n + 7)
    np.testing.assert_allclose(o.numpy()[:n], ro, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy()[:n], rd, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d.numpy()[n:], np.broadcast_to(rd[-1], (7, 3)), atol=1e-6)
    o2, d2 = timg.rays_from_box(cam_t, 5, 9)
    np.testing.assert_array_equal(d2.numpy(), d.numpy()[5:14])


def test_bullet_cameras():
    center = np.array([0.1, -0.2, 0.3], np.float32)
    np.testing.assert_array_equal(t_look_at(np.array([1.0, 2.0, 3.0], np.float32), center),
                                  j_look_at(np.array([1.0, 2.0, 3.0], np.float32), center))
    np.testing.assert_array_equal(timg._bullet_c2ws(center, 5.0, 7),
                                  j_bullet_c2ws(center, 5.0, 7))


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _scene(n_poses=1):
    """JAX and port copies of the scene: seed-0 weights (alpha bias + 2, so
    the body is partly opaque) and make_pose_ctx(0)."""
    cfg = jr.RaycastConfig(**CFG)
    params = jr.init_raycaster(jax.random.PRNGKey(0), cfg)
    for net in ("coarse", "fine"):
        params[net]["alpha_linear"]["b"] = params[net]["alpha_linear"]["b"] + 2.0
    ctxs = [make_pose_ctx(s) for s in range(n_poses)]
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    t_ctxs = [tr.PoseCtx(*[None if a is None else torch.as_tensor(np.array(a)) for a in c])
              for c in ctxs]
    return (cfg, params, ctxs), (tr.RaycastConfig(**CFG), t_params, t_ctxs)


def _bg(seed=6):
    return np.random.default_rng(seed).uniform(0, 1, (H, W, 3)).astype(np.float32)


def _jax_fused_fn(cfg, chunk):
    """JAX's device-raygen render on its fused route (interpret mode)."""

    def fn(p, cam, start, c):
        o, d = jimg.rays_from_box(cam, start, chunk)
        out = jr.render_rays(cfg, p, o, d, c, perturb=0.0, raw_noise_std=0.0,
                             eval_mean_code=c.cam_idxs is None, coarse_rgb=False, use_fused=True)
        return {k: out[k] for k in jimg.KEEP_MAPS}

    fn.takes_cam = True
    return fn


def _fused_interpret(call):
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32
    try:
        return call()
    finally:
        jfield.MM_DTYPE = orig


IMAGE_CASES = {
    "raygen": {},
    "host_rays": {"render_fn": "host"},
    "bg": {"bg": _bg()},
    "white": {"white_bkgd": True},
    "center": {"center": (W * 0.5 + 1.5, H * 0.5 - 1.0)},
    "fused": {"render_fn": "fused"},
}


@functools.lru_cache(maxsize=None)
def _jax_image(case, chunk=CHUNK):
    (cfg, params, ctxs), _ = _scene()
    kw = dict(IMAGE_CASES[case])
    if kw.get("render_fn") == "host":
        kw["render_fn"] = jimg._default_render_fn(cfg)
    if kw.get("render_fn") == "fused":
        kw["render_fn"] = _jax_fused_fn(cfg, chunk)
        return _fused_interpret(lambda: jimg.render_image(cfg, params, H, W, FOCAL, _camera(),
                                                          ctxs[0], chunk=chunk, **kw))
    return jimg.render_image(cfg, params, H, W, FOCAL, _camera(), ctxs[0], chunk=chunk, **kw)


def _port_image(case, chunk=CHUNK):
    _, (cfg, params, ctxs) = _scene()
    kw = dict(IMAGE_CASES[case])
    if kw.get("render_fn") == "host":
        kw["render_fn"] = timg._default_render_fn(cfg)
    if kw.get("render_fn") == "fused":
        kw["render_fn"] = timg._raygen_render_fn(cfg, use_fused=True)
    with torch.no_grad():
        return timg.render_image(cfg, params, H, W, FOCAL, _camera(), ctxs[0], chunk=chunk, **kw)


def _assert_image(got, ref, tol=TOL):
    for k in ("rgb", "acc", "disp"):
        assert got[k].shape == ref[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], ref[k], atol=tol, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["valid_idx"], ref["valid_idx"])
    for g, r in zip(got["bbox"], ref["bbox"]):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", list(IMAGE_CASES))
def test_render_image_matches_jax(case):
    ref = _jax_image(case)
    got = _port_image(case)
    _assert_image(got, ref)
    assert 0.1 < got["acc"][got["acc"] > 0].mean() and got["acc"].max() > 0.5
    outside = np.ones(H * W, bool)
    outside[got["valid_idx"]] = False
    bg = IMAGE_CASES[case].get("bg", np.ones((H, W, 3)) if case == "white" else np.zeros((H, W, 3)))
    np.testing.assert_array_equal(got["rgb"].reshape(-1, 3)[outside],
                                  bg.reshape(-1, 3)[outside].astype(np.float32))


def test_ragged_last_chunk():
    """192 rays at chunk 50: the port renders chunks of 50, 50, 50 and a
    ragged 42, and matches JAX's render_rays on exactly those chunks; no
    padding lane exists to reach the output. JAX's own render_image pads the
    last chunk with 8 copies of the last ray, which shift that chunk's
    repaired near / far (module docstring): it agrees on the first three."""
    (cfg, params, ctxs), _ = _scene()
    got = _port_image("raygen", chunk=50)
    ro, rd, valid_idx, _ = jimg.valid_rays_for_pose(H, W, FOCAL, _camera(), _cyl())
    render = jax.jit(lambda o, d: jr.render_rays(cfg, params, o, d, ctxs[0], perturb=0.0,
                                                 raw_noise_std=0.0, eval_mean_code=True,
                                                 coarse_rgb=False))
    want = {k: [] for k in jimg.KEEP_MAPS}
    for i in range(0, len(ro), 50):
        out = render(jnp.asarray(ro[i:i + 50]), jnp.asarray(rd[i:i + 50]))
        for k in want:
            want[k].append(np.asarray(out[k]))
    for k, name in (("rgb_map", "rgb"), ("acc_map", "acc"), ("disp_map", "disp")):
        ref = np.concatenate(want[k])
        np.testing.assert_allclose(got[name].reshape(H * W, -1)[valid_idx].reshape(ref.shape),
                                   ref, atol=TOL, rtol=0, err_msg=name)
        padded = _jax_image("raygen", chunk=50)[name].reshape(H * W, -1)[valid_idx]
        np.testing.assert_allclose(padded[:150].reshape(ref[:150].shape), ref[:150], atol=TOL,
                                   rtol=0, err_msg=name)


def test_half_readback():
    """f16 readback: the frame rounded once, after the composite."""
    (cfg, params, ctxs), (tcfg, tparams, tctxs) = _scene()
    ref = jimg.render_image(cfg, params, H, W, FOCAL, _camera(), ctxs[0], chunk=CHUNK,
                            bg=_bg(), half_readback=True)
    with torch.no_grad():
        got = timg.render_image(tcfg, tparams, H, W, FOCAL, _camera(), tctxs[0], chunk=CHUNK,
                                bg=_bg(), half_readback=True)
        full = timg.render_image(tcfg, tparams, H, W, FOCAL, _camera(), tctxs[0], chunk=CHUNK,
                                 bg=_bg())
    for k in ("rgb", "acc", "disp"):
        np.testing.assert_array_equal(got[k], full[k].astype(np.float16).astype(np.float32))
    # two f16 roundings apart at most (JAX rounds the maps, then composites)
    _assert_image(got, ref, tol=2e-3)


# (kwargs, a chunk that divides every frame's rays: 192 / 156 / 192 rays,
# and 140 / 130 / 140 in the window)
PIPELINE_CASES = {
    "black": ({}, 12),
    "white_window": ({"white_bkgd": True, "window": (6, 20)}, 10),
}


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_render_images_pipelined_matches_jax(case):
    (cfg, params, ctxs), (tcfg, tparams, tctxs) = _scene(n_poses=2)
    c2ws = [_camera(i) for i in range(3)]
    pick = [0, 1, 0]
    cyls = np.stack([np.asarray(ctxs[i].cyls)[0] for i in pick])
    kw, chunk = PIPELINE_CASES[case]
    ref = jimg.render_images_pipelined(cfg, params, H, W, FOCAL, c2ws, [ctxs[i] for i in pick],
                                       cyls, chunk=chunk, **kw)
    with torch.no_grad():
        got = timg.render_images_pipelined(tcfg, tparams, H, W, FOCAL, c2ws,
                                           [tctxs[i] for i in pick], cyls, chunk=chunk, **kw)
    assert got.shape == ref.shape == (3, H, W, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="takes_cam"):
        timg.render_images_pipelined(tcfg, tparams, H, W, FOCAL, c2ws, tctxs, cyls,
                                     render_fn=timg._default_render_fn(tcfg))


def test_render_path_matches_jax():
    """Three cameras over two poses (pose i % 2), a focal and a center per
    frame, backgrounds cycled (192 / 210 / 150 rays: chunks of 6)."""
    (cfg, params, ctxs), (tcfg, tparams, tctxs) = _scene(n_poses=2)
    c2ws = [_camera(i) for i in range(3)]
    kw = dict(chunk=6, centers=[None, (W * 0.5 + 1.0, H * 0.5), None],
              bgs=[_bg(7), _bg(8)])
    focal = np.array([FOCAL, 22.0, 18.0], np.float32)
    ref = jimg.render_path(cfg, params, c2ws, (H, W, focal), ctxs, **kw)
    with torch.no_grad():
        got = timg.render_path(tcfg, tparams, c2ws, (H, W, focal), tctxs, **kw)
    assert sorted(got) == sorted(ref)
    np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
    for k in ("rgbs", "accs", "disps"):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# density probes and meshes
# ---------------------------------------------------------------------------

RADIUS, RES = 2.5, 6


def _bf16_weights(params):
    """The nets' matrices rounded to bf16, as the eval kernels take them."""
    def rnd(tree):
        if isinstance(tree, dict):
            return {k: (np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
                        if k == "w" else rnd(v)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rnd(v) for v in tree]
        return tree
    return {k: rnd(v) if k in ("coarse", "fine") else v for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _jax_grid(bf16):
    (cfg, params, ctxs), _ = _scene()
    p = _bf16_weights(params) if bf16 else params
    return np.asarray(jr.render_mesh_density(cfg, p, ctxs[0], radius=RADIUS, res=RES))


@pytest.mark.parametrize("use_fused", [False, True])
def test_render_density_matches_jax(use_fused):
    """The plain route against JAX's XLA function; the fused route (kernel
    2's density-only mode, its plain version here) against the same
    function of the bf16-rounded weights. The grid keeps JAX's axis order."""
    (cfg, params, ctxs), (tcfg, tparams, tctxs) = _scene()
    ref = _jax_grid(use_fused)
    with torch.no_grad():
        got = tr.render_mesh_density(tcfg, tparams, tctxs[0], radius=RADIUS, res=RES,
                                     use_fused=use_fused).numpy()
    assert got.shape == ref.shape == (RES + 1,) * 3
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=TOL * scale, rtol=0)
    pts = np.random.default_rng(8).standard_normal((5, 3, 3)).astype(np.float32)
    p = _bf16_weights(params) if use_fused else params
    ref_p = np.asarray(jax.jit(lambda q, x: jr.render_pts_density(cfg, q, x, ctxs[0],
                                                                  use_fine=False))(p, pts))
    with torch.no_grad():
        got_p = tr.render_pts_density(tcfg, tparams, torch.as_tensor(pts), tctxs[0],
                                      use_fine=False, use_fused=use_fused).numpy()
    assert got_p.shape == (5, 3, 1)
    np.testing.assert_allclose(got_p, ref_p, atol=TOL * np.abs(ref_p).max(), rtol=0)


def test_extract_mesh_matches_jax(tmp_path):
    """The same vertices and faces from the same grid (threshold: the grid's
    median sigma, so the surface cuts it)."""
    (cfg, params, ctxs), (tcfg, tparams, tctxs) = _scene()
    iso = float(np.median(_jax_grid(False)))
    ref_v, ref_f = jmesh.extract_mesh(cfg, params, ctxs[0], radius=RADIUS, res=RES, threshold=iso)
    with torch.no_grad():
        v, f = tmesh.extract_mesh(tcfg, tparams, tctxs[0], radius=RADIUS, res=RES, threshold=iso)
    assert len(ref_f) > 0 and v.shape == ref_v.shape and f.shape == ref_f.shape
    np.testing.assert_array_equal(f, ref_f)
    np.testing.assert_allclose(v, ref_v, atol=1e-4)
    grid = _jax_grid(False)
    mv, mf = tmesh.marching_tetrahedra(grid, iso=iso, origin=(0.5, 0.0, -1.0), spacing=0.25)
    jv, jf = jmesh.marching_tetrahedra(grid, iso=iso, origin=(0.5, 0.0, -1.0), spacing=0.25)
    np.testing.assert_array_equal(mv, jv)
    np.testing.assert_array_equal(mf, jf)
    path = tmesh.save_ply(str(tmp_path / "t.ply"), mv, mf)
    assert open(path).read() == open(jmesh.save_ply(str(tmp_path / "j.ply"), jv, jf)).read()
