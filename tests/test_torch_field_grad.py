"""posegen_tpu_torch kernels/field_grad.py against posegen_tpu.

The trainable field's plain versions (what its wrappers run on the CPU)
are held against the oracle the JAX kernels are held to
(tests/test_fused_grad.py): jax.grad of the XLA path (encode_inputs +
nerf_apply), on the same numpy inputs, at float32, for the weights and,
through the input-gradient branch, for pts, rays_d and skts. The stash
forward is held against the JAX stash kernel in interpret mode with
float32 matmul operands. Also: the float32 gradient packing, and the
wrapper contract on the CPU. The CUDA kernels themselves run in
chip_smoke.py on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.kernels.field_grad import fused_field_stash as j_fused_field_stash
from posegen_tpu.models import nerf as jnerf
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_pose_ctx, make_rays
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.train.trainer import param_leaves, trainable
from posegen_tpu_torch.utils.convert import params_from_numpy

N_RAYS, S = 8, 6
MAX_REL = 1e-4  # per tensor: max|diff| / max(max|g|, 1e-3), tests/test_fused_grad.py:65
REL_L2 = 1e-5  # over all gradients, tests/test_fused_grad.py:70

CASES = {
    "flagship": ({}, 1),
    "freq_schedule": (dict(freq_schedule=True), 1),
    "two_groups": ({}, 2),
    "framecode": (dict(opt_framecode=True, n_framecodes=4), 2),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """JAX params, G pose rows, 8 rays x 6 samples, a loss weight per raw
    entry, and per-ray frame indices (groups get codes 0 and 2)."""
    kw, G = CASES[name]
    cfg = jr.RaycastConfig(**kw)
    params = jr.init_raycaster(jax.random.PRNGKey(0), cfg)
    if kw.get("freq_schedule"):  # mid-anneal: fractional windows on both ladders
        params = dict(params)
        params["embed_kp"] = {**params["embed_kp"], "alpha": jnp.asarray(2.3)}
        params["embed_view"] = {**params["embed_view"], "alpha": jnp.asarray(1.7)}
    params = jax.tree_util.tree_map(np.asarray, params)
    ctx = jax.tree_util.tree_map(np.array, make_pose_ctx(seed=0, n_poses=G))
    ro, rd = (np.array(a) for a in make_rays(N_RAYS, seed=1))
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(0.5, 2.0, (N_RAYS, S)), -1)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    wgt = rng.standard_normal((N_RAYS, S, 4)).astype(np.float32)
    cam = None
    if cfg.opt_framecode:
        cam = np.repeat(np.array([[0], [2]], np.int32), N_RAYS // G, axis=0)
    return kw, cfg, params, ctx, pts, rd, wgt, cam


@functools.lru_cache(maxsize=None)
def _jax_grads(name):
    """jax.grad of sum(raw * wgt) through the XLA path, pose rows per ray."""
    _, cfg, params, ctx, pts, rd, wgt, cam = _case(name)
    rep = N_RAYS // ctx.skts.shape[0]
    ctx_r = jr.PoseCtx(kps=np.repeat(ctx.kps, rep, 0), skts=np.repeat(ctx.skts, rep, 0),
                       bones=np.repeat(ctx.bones, rep, 0), cyls=ctx.cyls)
    frame_idx = None if cam is None else np.broadcast_to(cam[:, None], (N_RAYS, S, 1))

    def loss(net):
        x_pts, x_views, _ = jr.encode_inputs(cfg, params, pts, rd, ctx_r)
        raw = jnerf.nerf_apply(cfg.nerf_cfg, net, x_pts, x_views, frame_idx)
        return jnp.sum(raw * wgt)

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params["coarse"]))


def _port(name):
    kw, _, params, ctx, pts, rd, wgt, cam = _case(name)
    tp = params_from_numpy(params, "cpu")
    tctx = tr.PoseCtx(kps=torch.as_tensor(ctx.kps), skts=torch.as_tensor(ctx.skts),
                      bones=torch.as_tensor(ctx.bones), cyls=torch.as_tensor(ctx.cyls),
                      cam_idxs=None if cam is None else torch.as_tensor(cam))
    return tr.RaycastConfig(**kw), tp, tctx, torch.as_tensor(pts), torch.as_tensor(rd), \
        torch.as_tensor(wgt)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree) for p, v in _flat(x, f"{path}/{i}").items()}
    return {path: tree}


def _assert_grads_match(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for path, gr in ref.items():
        scale = max(np.abs(gr).max(), 1e-3)
        err = np.abs(got[path] - gr).max() / scale
        assert err < MAX_REL, f"{path}: rel err {err}"
    vx = np.concatenate([ref[p].ravel() for p in ref])
    vf = np.concatenate([got[p].ravel() for p in ref])
    rel_l2 = np.linalg.norm(vf - vx) / np.linalg.norm(vx)
    assert rel_l2 < REL_L2, f"gradient rel L2 {rel_l2}"


@pytest.mark.parametrize("name", list(CASES))
def test_trainable_field_grads_match_jax_autodiff(name):
    """The TrainableField Function on CPU tensors (stash + backward plain
    versions) through fused_run_net: every weight gradient of the net, and
    with framecodes the code table's, against jax.grad of the XLA path."""
    cfg, tp, tctx, pts, rd, wgt = _port(name)
    net = trainable(tp["coarse"])
    raw = tfield.fused_run_net(cfg, net, tp["embed_kp"], pts, rd, tctx,
                               view_embed_state=tp["embed_view"], trainable=True)
    (raw * wgt).sum().backward()
    got = {p: t.grad.numpy() for p, t in _flat(net).items()}
    ref = _flat(_jax_grads(name))
    assert ("/framecodes" in ref) == cfg.opt_framecode
    assert len(ref) >= 20
    _assert_grads_match(got, ref)


@pytest.mark.parametrize("name", ["flagship", "freq_schedule", "two_groups"])
def test_bwd_plain_matches_jax_autodiff(name):
    """field_bwd_plain itself, on field_stash_plain's stashes: the packed
    weight and bias gradients equal JAX's packed alike, and its per-group
    view bias gradient JAX's view bias gradient."""
    cfg, tp, tctx, pts, rd, wgt = _port(name)
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    sched = tfield._barf_sched(cfg, tp["embed_kp"], tp["embed_view"])
    poses = tfield.pack_poses(tctx.skts, tp["embed_kp"], cfg.multires, cfg.multires_views, sched)
    net = tfield.pack_net_f32(tp["coarse"], L)
    bview = tfield.group_view_bias(tp["coarse"], L)
    raw, e_pts, e_view = tgrad.field_stash_plain(pts.reshape(-1, 3), rd, S, poses, net, bview)
    d_w, d_b, d_bview = tgrad.field_bwd_plain(e_pts, e_view, wgt.reshape(-1, 4), net, bview)

    ref = tfield.pack_net_f32(params_from_numpy(_jax_grads(name), "cpu"), L)
    bv = slice(L.b_view, L.b_view + tfield.VIEW_WIDTH)
    ref_b = ref.b.clone()
    ref_b[bv] = 0.0
    got = {"w": d_w.numpy(), "b": d_b.numpy(), "bview": d_bview[0].numpy()}
    _assert_grads_match(got, {"w": ref.w.numpy(), "b": ref_b.numpy(),
                              "bview": ref.b[bv].numpy()})
    assert float(d_b[bv].abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_stash():
    """JAX fused_field_stash in interpret mode with float32 operands, on
    the flagship case's 48 points padded to one 256-point tile."""
    _, cfg, params, ctx, pts, rd, _, _ = _case("flagship")
    n = N_RAYS * S
    pts_t = np.ones((3, 256), np.float32)
    pts_t[:, :n] = pts.reshape(n, 3).T
    dirs_t = np.ones((3, 256), np.float32)
    dirs_t[:, :n] = np.repeat(rd, S, 0).T
    orig = jfield.MM_DTYPE
    jfield.MM_DTYPE = jnp.float32
    try:
        raw, e_p, e_v = j_fused_field_stash(
            pts_t, dirs_t, ctx.skts[:, :, :3, :3].reshape(1, 24, 9),
            ctx.skts[:, :, :3, 3].reshape(1, 24, 3), params["embed_kp"]["cutoff_dist"][:, None],
            params["embed_kp"]["tau"].reshape(1, 1), np.ones((1, 11), np.float32),
            np.zeros((1, 1), np.float32),
            jfield.prepare_params(params["coarse"], dtype=jnp.float32),
            depth=8, skips=(4,), tile=256, code_ch=0, nf_kp=7, nf_view=4, freq_sched=False,
            interpret=True,
        )
    finally:
        jfield.MM_DTYPE = orig
    return tuple(np.asarray(a)[:, :n].T for a in (raw, e_p, e_v))


def test_stash_forward_matches_field_plain_and_jax_stash_kernel():
    """field_stash_plain's raw is field_plain's exactly; its stashes are
    encode_plain's (rounded to mm_dtype); and raw and stashes match the JAX
    stash kernel after its component-major row permutation."""
    cfg, tp, tctx, pts, rd, _ = _port("flagship")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    poses = tfield.pack_poses(tctx.skts, tp["embed_kp"], cfg.multires, cfg.multires_views)
    net = tfield.pack_net_f32(tp["coarse"], L)
    bview = tfield.group_view_bias(tp["coarse"], L)
    p = pts.reshape(-1, 3)
    with torch.no_grad():
        raw, e_pts, e_view = tgrad.field_stash_plain(p, rd, S, poses, net, bview)
        assert torch.equal(raw, tfield.field_plain(p, rd, S, poses[0], net))
        ep, ev = tfield.encode_plain(p, rd, S, poses[0], L.nf_kp, L.nf_view)
        assert torch.equal(e_pts, ep) and torch.equal(e_view, ev)
        _, e16, v16 = tgrad.field_stash_plain(p, rd, S, poses, net, bview,
                                              mm_dtype=torch.bfloat16)
        assert e16.dtype == torch.bfloat16 and torch.equal(e16, ep.to(torch.bfloat16))
        assert torch.equal(v16, ev.to(torch.bfloat16))

    j_raw, j_ep, j_ev = _jax_stash()
    np.testing.assert_allclose(raw.numpy(), j_raw, atol=1e-4, rtol=0)
    np.testing.assert_allclose(e_pts.numpy()[:, jfield._pts_row_perm(7)], j_ep, atol=1e-5, rtol=0)
    np.testing.assert_allclose(e_view.numpy()[:, jfield._view_row_perm(4)], j_ev, atol=1e-5,
                               rtol=0)


def test_packed_f32_gradients_reach_the_leaves_in_float32():
    """pack_net_f32 keeps the weights float32 under autograd: the leaves'
    gradients through TrainableField are float32 and equal autograd through
    field_plain on the same float32 packing (a bf16 cast in the packing
    would round them)."""
    cfg, tp, tctx, pts, rd, wgt = _port("flagship")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    poses = tfield.pack_poses(tctx.skts, tp["embed_kp"], cfg.multires, cfg.multires_views)
    p, g = pts.reshape(-1, 3), wgt.reshape(-1, 4)
    grads = []
    for route in ("function", "autograd"):
        leaves = trainable(tp["coarse"])
        net = tfield.pack_net_f32(leaves, L)
        assert net.w.dtype == torch.float32 and net.w.requires_grad
        if route == "function":
            raw = tgrad.trainable_field(p, rd, S, poses, net, tfield.group_view_bias(leaves, L))
        else:
            raw = tfield.field_plain(p, rd, S, poses[0], net)
        (raw * g).sum().backward()
        grads.append([t.grad for t in param_leaves(leaves)])
    for a, b in zip(*grads):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-3)


@functools.lru_cache(maxsize=None)
def _jax_input_grads(name):
    """jax.grad of sum(raw * wgt) through the XLA path with respect to the
    net, pts, rays_d and the per-group skts (repeated per ray inside)."""
    _, cfg, params, ctx, pts, rd, wgt, cam = _case(name)
    rep = N_RAYS // ctx.skts.shape[0]
    frame_idx = None if cam is None else np.broadcast_to(cam[:, None], (N_RAYS, S, 1))

    def loss(net, pts, rd, skts):
        ctx_r = jr.PoseCtx(kps=np.repeat(ctx.kps, rep, 0), skts=jnp.repeat(skts, rep, 0),
                           bones=np.repeat(ctx.bones, rep, 0), cyls=ctx.cyls)
        x_pts, x_views, _ = jr.encode_inputs(cfg, params, pts, rd, ctx_r)
        raw = jnerf.nerf_apply(cfg.nerf_cfg, net, x_pts, x_views, frame_idx)
        return jnp.sum(raw * wgt)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(params["coarse"], pts, rd, ctx.skts)
    return jax.tree_util.tree_map(np.asarray, grads)


def _assert_input_grads(got: dict, ref: dict):
    """Per tensor: max rel 1e-4 and rel L2 1e-5 (tests/test_fused_grad.py:124-130)."""
    for k, a in ref.items():
        b = got[k]
        err = np.abs(b - a).max() / max(np.abs(a).max(), 1e-3)
        assert err < MAX_REL, f"{k}: rel err {err}"
        l2 = np.linalg.norm(b - a) / np.linalg.norm(a)
        assert l2 < REL_L2, f"{k}: rel L2 {l2}"


@pytest.mark.parametrize("name", list(CASES))
def test_input_grads_match_jax_autodiff(name):
    """fused_run_net(trainable=True, input_grads=True) on CPU tensors (the
    stash, backward and encode-backward plain versions through
    TrainableField): the gradients of pts, rays_d and the group skts, and
    of every weight (the framecode table's with framecodes), against
    jax.grad of the XLA path."""
    cfg, tp, tctx, pts, rd, wgt = _port(name)
    net = trainable(tp["coarse"])
    pts, rd = pts.clone().requires_grad_(True), rd.clone().requires_grad_(True)
    skts = tctx.skts.clone().requires_grad_(True)
    raw = tfield.fused_run_net(cfg, net, tp["embed_kp"], pts, rd, tctx._replace(skts=skts),
                               view_embed_state=tp["embed_view"], trainable=True,
                               input_grads=True)
    (raw * wgt).sum().backward()
    j_net, j_pts, j_rd, j_skts = _jax_input_grads(name)
    _assert_input_grads({"pts": pts.grad.numpy(), "rays_d": rd.grad.numpy(),
                         "skts": skts.grad.numpy()},
                        {"pts": j_pts, "rays_d": j_rd, "skts": j_skts})
    assert float(skts.grad[:, :, 3].abs().max()) == 0.0  # the [0 0 0 1] row
    ref = _flat(j_net)
    assert ("/framecodes" in ref) == cfg.opt_framecode
    _assert_grads_match({p: t.grad.numpy() for p, t in _flat(net).items()}, ref)


@functools.lru_cache(maxsize=None)
def _jax_encode_grads(name):
    """jax.grad of sum(x_pts * gp) + sum(x_views * gv) through JAX
    encode_inputs, random cotangents gp, gv in its (joint-major) channel
    order, with respect to pts, rays_d and the group skts."""
    _, cfg, params, ctx, pts, rd, _, _ = _case(name)
    rep = N_RAYS // ctx.skts.shape[0]
    rng = np.random.default_rng(9)
    pc, vc = tfield.pts_ch(cfg.multires), tfield.view_ch(cfg.multires_views)
    gp = rng.standard_normal((N_RAYS, S, pc)).astype(np.float32)
    gv = rng.standard_normal((N_RAYS, S, vc)).astype(np.float32)

    def loss(pts, rd, skts):
        ctx_r = jr.PoseCtx(kps=np.repeat(ctx.kps, rep, 0), skts=jnp.repeat(skts, rep, 0),
                           bones=np.repeat(ctx.bones, rep, 0), cyls=ctx.cyls)
        x_pts, x_views, _ = jr.encode_inputs(cfg, params, pts, rd, ctx_r)
        return jnp.sum(x_pts * gp) + jnp.sum(x_views * gv)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(pts, rd, ctx.skts)
    return gp, gv, jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("name", ["flagship", "freq_schedule", "two_groups"])
def test_encode_bwd_plain_matches_jax_autodiff(name):
    """encode_bwd_plain alone: the encodings' cotangents back to pts, the
    per-ray dirs and the pose rows, whose rot / trn slots are the skts
    gradient and whose cut, tau and octave weight slots stay zero."""
    cfg, tp, tctx, pts, rd, _ = _port(name)
    gp, gv, (j_pts, j_rd, j_skts) = _jax_encode_grads(name)
    sched = tfield._barf_sched(cfg, tp["embed_kp"], tp["embed_view"])
    poses = tfield.pack_poses(tctx.skts, tp["embed_kp"], cfg.multires, cfg.multires_views, sched)
    d_pts, d_dirs, d_poses = tgrad.encode_bwd_plain(
        pts.reshape(-1, 3), rd, S, poses, torch.as_tensor(gp).reshape(N_RAYS * S, -1),
        torch.as_tensor(gv).reshape(N_RAYS * S, -1), cfg.multires, cfg.multires_views)
    G = poses.shape[0]
    assert d_dirs.shape == (N_RAYS, 3) and d_poses.shape == poses.shape
    d_skts = torch.zeros(G, 24, 4, 4)
    d_skts[:, :, :3, :3] = d_poses[:, :216].view(G, 24, 3, 3)
    d_skts[:, :, :3, 3] = d_poses[:, 216:288].view(G, 24, 3)
    _assert_input_grads({"pts": d_pts.view(N_RAYS, S, 3).numpy(), "rays_d": d_dirs.numpy(),
                         "skts": d_skts.numpy()},
                        {"pts": j_pts, "rays_d": j_rd, "skts": j_skts})
    assert float(d_poses[:, 288:].abs().max()) == 0.0


def test_wrapper_contract():
    """Bad shapes raise; input gradients flow where autograd asks for them
    and only on the trainable path; the eval wrappers refuse operands that
    require grad under autograd instead of dropping the gradient."""
    cfg, tp, tctx, pts, rd, wgt = _port("two_groups")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    poses = tfield.pack_poses(tctx.skts, tp["embed_kp"], cfg.multires, cfg.multires_views)
    net = tfield.pack_net_f32(tp["coarse"], L)
    bview = tfield.group_view_bias(tp["coarse"], L)
    p = pts.reshape(-1, 3)
    with pytest.raises(ValueError, match="rays"):
        tgrad.fused_field_stash(p, rd[:4], S, poses, net, bview)
    with pytest.raises(ValueError, match="poses"):
        tgrad.fused_field_stash(p, rd, S, poses[:, :-1], net, bview)
    with pytest.raises(ValueError, match="pose groups"):
        tgrad.fused_field_stash(p, rd, S, poses[[0, 1, 1]], net, bview)
    with pytest.raises(ValueError, match="view bias"):
        tgrad.fused_field_stash(p, rd, S, poses, net, bview.repeat(3, 1))
    with pytest.raises(ValueError, match="layout"):
        tgrad.fused_field_stash(p, rd, S, poses, tfield.FieldNet(net.w[:-1], net.b, L), bview)
    _, e_pts, e_view = tgrad.fused_field_stash(p, rd, S, poses, net, bview)
    with pytest.raises(ValueError, match="backward operands"):
        tgrad.field_backward(wgt.reshape(-1, 4)[:-1], e_pts, e_view, net, bview)
    with pytest.raises(ValueError, match="inputs"):
        tgrad.field_backward(wgt.reshape(-1, 4), e_pts, e_view, net, bview,
                             tgrad.FieldInputs(p[:-S], rd[:-1], S, poses))
    g = wgt.reshape(-1, 4)
    out = tgrad.field_backward(g, e_pts, e_view, net, bview, tgrad.FieldInputs(p, rd, S, poses))
    assert [tuple(t.shape) for t in out[3:]] == [tuple(p.shape), tuple(rd.shape),
                                                tuple(poses.shape)]
    for a, b in zip(out[:3], tgrad.field_backward(g, e_pts, e_view, net, bview)):
        assert torch.equal(a, b)  # the weight gradients do not depend on the branch

    # autograd asks for pts only: the Function returns its gradient alone
    p_req = p.clone().requires_grad_(True)
    raw = tgrad.trainable_field(p_req, rd, S, poses, net, bview)
    (raw * g).sum().backward()
    assert torch.allclose(p_req.grad, out[3], rtol=1e-6, atol=1e-6)
    # "train" gives the inputs no gradient, as the JAX kernel does
    p_req.grad = None
    raw = tfield.fused_run_net(cfg, trainable(tp["coarse"]), tp["embed_kp"],
                               p_req.view(pts.shape), rd, tctx, trainable=True)
    raw.sum().backward()
    assert p_req.grad is None
    with pytest.raises(ValueError, match="trainable"):
        tfield.fused_run_net(cfg, tp["coarse"], tp["embed_kp"], pts, rd, tctx, input_grads=True)
    p_req.grad = None
    raw = tr._run_net(cfg, trainable(tp["coarse"]), tp, p_req.view(pts.shape), rd, tctx, False,
                      use_fused="full")
    raw.sum().backward()
    assert p_req.grad is not None and bool(torch.isfinite(p_req.grad).all())

    one = tctx._replace(kps=tctx.kps[:1], skts=tctx.skts[:1], bones=tctx.bones[:1],
                        cyls=tctx.cyls[:1])
    leaves = trainable(tp["coarse"])
    net16 = tfield.prepare_net(leaves, L)
    with pytest.raises(RuntimeError, match="trainable"):
        tfield.fused_field(p, rd, S, poses[0], net16)
    with pytest.raises(RuntimeError, match="trainable"):
        tfield.fused_dual(p, rd, S, poses[0], net16, net16)
    with pytest.raises(RuntimeError, match="trainable"):
        tr.render_rays(dataclasses.replace(cfg, perturb=0.0), {**tp, "coarse": leaves}, pts[:, 0],
                       rd, one, use_fused=True)
    with torch.no_grad():
        assert tfield.fused_field(p, rd, S, poses[0], net16).shape == (p.shape[0], 4)
    assert set(tfield.LAUNCHES) >= {"field_stash", "field_bwd", "field_bwd_inputs"}
