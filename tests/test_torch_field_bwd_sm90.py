"""posegen_tpu_torch kernel 4's weights-only backward, pass by pass.

The backward kernel (csrc/field_grad.cu) runs in two passes: (a) recompute
and backprop per 128-point tile into a bf16 workspace, (b) the weight
gradients G^T H over a fixed split of the points. Their plain versions,
`field_bwd_workspace_plain` and `field_wgrad_plain`, are what the wrappers
run on the CPU and what chip_smoke.py holds each pass to on the card. Here:

  - the workspace against the XLA path of the JAX package, per point: each
    trunk layer's output (forward_density over the first layers), the
    feature and view layers' outputs, and every layer's pre-activation
    cotangent (jax.grad with respect to a per-point copy of its bias), at
    the SURREAL layout and at h36m_prot2's (framecodes, two pose groups),
    for point counts ragged to pass (a)'s tile; the products of the
    workspace against jax.grad's weight gradients, and against
    `field_bwd_plain`, which is the workspace plus the products;
  - pass (b)'s split plan: every point in exactly one split, every output
    entry in exactly one tile, the splits summed in order against an
    unsplit float64 sum;
  - pass (a)'s shared-memory plan and the refusal: every config under
    configs/ either fits the 232,448 bytes of an H100 block or is refused
    by the port's gate exactly as by the JAX gate; every depth the layouts
    allow fits;
  - the wrapper on the CPU: the two plain passes.

The CUDA kernels themselves run in chip_smoke.py on the card.
"""

import dataclasses
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.models import nerf as jnerf
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_pose_ctx, make_rays
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import field_grad as tgrad
from posegen_tpu_torch.render import raycast as tr
from posegen_tpu_torch.utils.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_REL = 1e-4  # per tensor: max|diff| / max(max|ref|, 1e-3), tests/test_fused_grad.py:65
# layout -> RaycastConfig flags, pose groups; point counts -> (rays, samples)
LAYOUTS = {"surreal": ({}, 1), "h36m": (dict(opt_framecode=True, n_framecodes=4), 2)}
SHAPES = {1: (1, 1), 63: (7, 9), 127: (127, 1), 129: (43, 3), 300: (50, 6)}


def _groups(layout, n_pts):
    """Pose groups of a case: the layout's, where its rays split evenly."""
    G = LAYOUTS[layout][1]
    return G if SHAPES[n_pts][0] % G == 0 else 1


@functools.lru_cache(maxsize=None)
def _case(layout, n_pts):
    """JAX params (seed 2: both nets render), pose groups, rays, samples and
    a cotangent per raw entry; with framecodes, each group's code index."""
    kw, _ = LAYOUTS[layout]
    G = _groups(layout, n_pts)
    n_rays, S = SHAPES[n_pts]
    cfg = jr.RaycastConfig(**kw)
    params = jax.tree_util.tree_map(np.asarray, jr.init_raycaster(jax.random.PRNGKey(2), cfg))
    ctx = jax.tree_util.tree_map(np.array, make_pose_ctx(seed=0, n_poses=G))
    ro, rd = (np.array(a) for a in make_rays(n_rays, seed=1))
    rng = np.random.default_rng(n_pts)
    z = np.sort(rng.uniform(0.5, 2.0, (n_rays, S)), -1)
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    wgt = rng.standard_normal((n_rays, S, 4)).astype(np.float32)
    cam = None
    if cfg.opt_framecode:
        cam = np.repeat(np.arange(G, dtype=np.int32)[:, None] * 2 + 1, n_rays // G, axis=0)
    return cfg, params, ctx, pts, rd, wgt, cam


@functools.lru_cache(maxsize=None)
def _jax_reference(layout, n_pts):
    """Per point, through the JAX XLA path: each trunk layer's output, feat,
    hv, and the pre-activation cotangents of every trunk layer, the feature
    and the view layer of sum(raw * wgt) (jax.grad with respect to per-point
    biases); and jax.grad's gradients of the net."""
    cfg, params, ctx, pts, rd, wgt, cam = _case(layout, n_pts)
    n_rays, S = SHAPES[n_pts]
    rep = n_rays // ctx.skts.shape[0]
    ctx_r = jr.PoseCtx(kps=np.repeat(ctx.kps, rep, 0), skts=np.repeat(ctx.skts, rep, 0),
                       bones=np.repeat(ctx.bones, rep, 0), cyls=ctx.cyls)
    frame_idx = None if cam is None else np.broadcast_to(cam[:, None], (n_rays, S, 1))
    x_pts, x_views, _ = jr.encode_inputs(cfg, params, pts, rd, ctx_r)
    net, ncfg = params["coarse"], cfg.nerf_cfg

    hs = [jnerf.forward_density(ncfg, {"pts_linears": net["pts_linears"][:i + 1]}, x_pts)
          [..., -tfield.WIDTH:] for i in range(ncfg.depth)]
    feat = jnerf.linear(net["feature_linear"], hs[-1])
    xv = x_views
    if ncfg.use_framecode:
        xv = jnp.concatenate([xv, jnerf.framecode_lookup(net["framecodes"], frame_idx)], -1)
    hv = jax.nn.relu(jnerf.linear(net["views_linears"][0], jnp.concatenate([feat, xv], -1)))

    def loss(net, b_pts, b_feat, b_view):
        net = dict(net)
        net["pts_linears"] = [{**lay, "b": net["pts_linears"][i]["b"] + b_pts[i]}
                              for i, lay in enumerate(net["pts_linears"])]
        net["feature_linear"] = {**net["feature_linear"], "b": net["feature_linear"]["b"] + b_feat}
        (view,) = net["views_linears"]
        net["views_linears"] = [{**view, "b": view["b"] + b_view}]
        raw = jnerf.nerf_apply(ncfg, net, x_pts, x_views, frame_idx)
        return jnp.sum(raw * wgt)

    zeros = lambda w: jnp.zeros((n_rays, S, w), jnp.float32)  # noqa: E731
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        net, [zeros(tfield.WIDTH) for _ in range(ncfg.depth)], zeros(tfield.WIDTH),
        zeros(tfield.VIEW_WIDTH))
    flat = lambda a: np.asarray(a).reshape(n_pts, -1)  # noqa: E731
    return ({"hs": np.stack([flat(h) for h in hs]), "feat": flat(feat), "hv": flat(hv),
             "gz": np.stack([flat(g) for g in grads[1]]), "gfeat": flat(grads[2]),
             "gzv": flat(grads[3])},
            jax.tree_util.tree_map(np.asarray, grads[0]))


def _port_operands(layout, n_pts):
    """The port's operands of the same case: the plain stash's encodings,
    the packed net, the per-group view bias (codes folded in), g."""
    cfg, params, ctx, pts, rd, wgt, cam = _case(layout, n_pts)
    n_rays, S = SHAPES[n_pts]
    tp = params_from_numpy(params, "cpu")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    G = ctx.skts.shape[0]
    poses = tfield.pack_poses(torch.as_tensor(ctx.skts), tp["embed_kp"], cfg.multires,
                              cfg.multires_views)
    net = tfield.pack_net_f32(tp["coarse"], L)
    codes = None
    if cam is not None:
        codes = tp["coarse"]["framecodes"][torch.as_tensor(cam[::n_rays // G, 0]).long()]
    bview = tfield.group_view_bias(tp["coarse"], L, codes)
    with torch.no_grad():
        _, e_pts, e_view = tgrad.field_stash_plain(torch.as_tensor(pts).reshape(-1, 3),
                                                   torch.as_tensor(rd), S, poses, net, bview)
    return L, net, bview, e_pts, e_view, torch.as_tensor(wgt).reshape(-1, 4)


def _assert_close(name, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, f"{name}: {got.shape} != {ref.shape}"
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-3)
    assert err < MAX_REL, f"{name}: rel err {err}"


@pytest.mark.parametrize("n_pts", list(SHAPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_workspace_plain_matches_jax_autodiff(layout, n_pts):
    """Pass (a)'s plain version, per point, against the XLA path; pass (b)'s
    products of its workspace against jax.grad; and field_bwd_plain is the
    two, bit for bit."""
    L, net, bview, e_pts, e_view, g = _port_operands(layout, n_pts)
    ref, j_net = _jax_reference(layout, n_pts)
    with torch.no_grad():
        ws = tgrad.field_bwd_workspace_plain(e_pts, e_view, g, net, bview)
        d_w = tgrad.field_wgrad_plain(ws, e_pts, e_view, L)
        full = tgrad.field_bwd_plain(e_pts, e_view, g, net, bview)
    P = n_pts
    shapes = {"hs": (L.depth, P, 256), "feat": (P, 256), "hv": (P, 128), "gz": (L.depth, P, 256),
              "gfeat": (P, 256), "gzv": (P, 128), "ghead": (P, 16)}
    assert {k: tuple(ws[k].shape) for k in shapes} == shapes
    for name, r in ref.items():
        _assert_close(name, ws[name].numpy(), r)
    assert torch.equal(ws["ghead"][:, 0], g[:, 3]) and torch.equal(ws["ghead"][:, 1:4], g[:, :3])
    assert float(ws["ghead"][:, 4:].abs().max()) == 0.0
    assert torch.equal(ws["d_b"][L.b_layers[0]:L.b_layers[0] + 256], ws["gz"][0].sum(0))

    packed = tfield.pack_net_f32(params_from_numpy(j_net, "cpu"), L)
    _assert_close("d_w", d_w.numpy(), packed.w.numpy())
    bv = slice(L.b_view, L.b_view + tfield.VIEW_WIDTH)
    ref_b = packed.b.clone()
    ref_b[bv] = 0.0
    _assert_close("d_b", ws["d_b"].numpy(), ref_b.numpy())
    if layout == "surreal":  # one group, no codes: the view bias gradient is JAX's
        _assert_close("d_bview", ws["d_bview"][0].numpy(), packed.b[bv].numpy())
    assert torch.equal(full[0], d_w) and torch.equal(full[1], ws["d_b"])
    assert torch.equal(full[2], ws["d_bview"])


@pytest.mark.parametrize("n_pts", [1, 63, 2047, 2048, 4097, 32769, 131072, 245760])
def test_wgrad_split_plan_covers_every_point_once(n_pts):
    """Pass (b)'s split of the points (csrc/field_grad.cu splits_of, chunk_of):
    whole 64-point steps, every point in exactly one split, at most 16."""
    splits, chunk = tgrad.wgrad_split_plan(n_pts)
    assert 1 <= splits <= tgrad.WGRAD_MAX_SPLITS and chunk % tgrad.WGRAD_CHUNK == 0
    seen = np.zeros(n_pts, np.int64)
    for s in range(splits):
        seen[s * chunk:min(n_pts, (s + 1) * chunk)] += 1
    assert (seen == 1).all()
    assert (splits - 1) * chunk < n_pts  # no split is empty


def test_wgrad_tiles_and_split_sums():
    """Every output entry of every product lies in exactly one 128 x 256 tile
    of pass (b); the splits' float32 partial products, summed in split
    order, match the unsplit float64 product, and the order is fixed."""
    L = tfield.net_layout(8, 7, 4)
    n_pts = 6000
    rng = np.random.default_rng(0)
    ws = {"hs": torch.zeros(L.depth, n_pts, 256), "gz": torch.zeros(L.depth, n_pts, 256),
          "feat": torch.zeros(n_pts, 256), "hv": torch.zeros(n_pts, 128),
          "gfeat": torch.zeros(n_pts, 256), "gzv": torch.zeros(n_pts, 128),
          "ghead": torch.zeros(n_pts, 16)}
    prods = tgrad.wgrad_products(ws, torch.zeros(n_pts, L.pc), torch.zeros(n_pts, L.vc), L)
    assert len(prods) == L.depth + 1 + 5  # the skip consumer has two products
    covered = np.zeros(L.n_w, np.int64)
    for _, gg, x, off, ldo in prods:
        ma, nb = gg.shape[1], x.shape[1]
        cover = np.zeros((ma, nb), np.int64)
        for m0 in range(0, ma, 128):
            for n0 in range(0, nb, 256):
                cover[m0:m0 + 128, n0:n0 + 256] += 1
        assert (cover == 1).all()
        for r in range(ma):
            covered[off + r * ldo:off + r * ldo + nb] += 1
    pad = np.zeros(L.n_w, bool)
    for r in range(tfield.VIEW_WIDTH):  # the view head's zero-weight pad columns
        start = L.w_view + r * (256 + L.vcp) + 256 + L.vc
        pad[start:start + L.vcp - L.vc] = True
    assert (covered[~pad] == 1).all() and (covered[pad] == 0).all()

    G = rng.standard_normal((n_pts, 256)).astype(np.float32)
    H = rng.standard_normal((n_pts, 432)).astype(np.float32)
    splits, chunk = tgrad.wgrad_split_plan(n_pts)
    assert splits == 2

    def split_sum():
        parts = [torch.as_tensor(G[s * chunk:(s + 1) * chunk]).T @ torch.as_tensor(
            H[s * chunk:(s + 1) * chunk]) for s in range(splits)]
        out = parts[0].clone()
        for p in parts[1:]:
            out += p
        return out

    got = split_sum()
    ref = G.astype(np.float64).T @ H.astype(np.float64)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(G).max() * np.abs(H).max() * n_pts
    assert torch.equal(got, split_sum())


def _config_paths():
    return sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.txt")))


@pytest.mark.parametrize("path", _config_paths(), ids=lambda p: os.path.relpath(p, ROOT))
def test_smem_plan_fits_or_gate_refuses_like_jax(path):
    """Every repo config: the port's gate gives the JAX gate's verdict and
    reason; a config both take fits pass (a)'s shared-memory plan, which
    the backward's refusal and the trainer's kernel path agree on."""
    from posegen_tpu.cli.config import args_to_raycast_config, nerf_config_parser, \
        parse_with_config

    jcfg = args_to_raycast_config(parse_with_config(nerf_config_parser(), ["--config", path]),
                                  n_framecodes=4)
    tcfg = tr.RaycastConfig(**dataclasses.asdict(jcfg))
    reason = jfield.fused_config_disqualification(jcfg)
    assert tfield.fused_config_disqualification(tcfg) == reason
    if reason is not None:
        return
    L = tfield.net_layout(tcfg.netdepth, tcfg.multires, tcfg.multires_views)
    assert tgrad.bwd_smem_bytes(L) <= tgrad.SMEM_LIMIT
    assert tgrad.field_bwd_refusal(L) is None


def test_smem_plan_stages_and_refusal():
    """230,480 bytes at the SURREAL depth with a three-stage weight ring; two
    stages past depth 8, so every depth the layouts allow (up to 16) fits;
    a plan that does not fit is refused with its size in the reason."""
    L8 = tfield.net_layout(8, 7, 4)
    assert (tgrad.bwd_w_stages(L8), tgrad.bwd_smem_bytes(L8)) == (3, 230_480)
    assert tgrad.bwd_w_stages(tfield.net_layout(9, 7, 4)) == 2
    for depth in range(1, tfield.MAX_DEPTH + 1):
        if depth == 5:  # the skip after the last layer: no such layout
            continue
        L = tfield.net_layout(depth, 7, 4)
        assert tgrad.bwd_smem_bytes(L) <= tgrad.SMEM_LIMIT and tgrad.field_bwd_refusal(L) is None
    too_deep = dataclasses.replace(tfield.net_layout(16, 7, 4), depth=20)
    assert "246848 bytes of shared memory" in tgrad.field_bwd_refusal(too_deep)


def test_backward_on_the_cpu_is_the_two_plain_passes():
    """field_backward on CPU tensors: the plain workspace's products, its
    bias sums (field_bwd_plain's); a kernel workspace is for CUDA only."""
    L, net, bview, e_pts, e_view, g = _port_operands("h36m", 300)
    with torch.no_grad():
        d_w, d_b, d_bview = tgrad.field_backward(g, e_pts, e_view, net, bview)
        ws = tgrad.field_bwd_workspace_plain(e_pts, e_view, g, net, bview)
        assert torch.equal(d_w, tgrad.field_wgrad_plain(ws, e_pts, e_view, L))
        assert torch.equal(d_b, ws["d_b"]) and torch.equal(d_bview, ws["d_bview"])
        fake = tgrad.BwdWorkspace(torch.empty(0, dtype=torch.uint8), {})
        with pytest.raises(ValueError, match="CUDA"):
            tgrad.field_backward(g, e_pts, e_view, net, bview, workspace=fake)
