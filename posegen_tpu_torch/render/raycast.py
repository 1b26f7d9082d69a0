"""The ray engine: cylinder clip -> stratified -> encode -> MLP -> composite
-> importance -> fine pass (port of posegen_tpu/render/raycast.py).

On a CUDA device, the field evaluations of a config that passes the gate
(kernels/field.py) run in the fused CUDA kernels; the dual-net kernel takes
the coarse pass when the caller does not read rgb0. Otherwise the plain
pipeline materializes the encodings (`encode_inputs`) and applies the MLP
(`models.nerf.nerf_apply`). Training asks for use_fused="train": the
trainable kernel pair of kernels/field_grad.py on grouped poses; pose
refinement asks for "full", the same pair with gradients into pts, rays_d
and the pose rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.kernels import field as fused
from posegen_tpu_torch.models import nerf as nerf_mod
from posegen_tpu_torch.models.nerf import NeRFConfig, density_activation, init_nerf, nerf_apply
from posegen_tpu_torch.ops import embedding as emb_mod
from posegen_tpu_torch.ops import encoders as enc
from posegen_tpu_torch.ops import sampling as samp
from posegen_tpu_torch.ops.embedding import EmbedConfig
from posegen_tpu_torch.ops.embedding import identity_config as emb_identity
from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton


class PoseCtx(NamedTuple):
    """Per-ray pose conditioning (broadcastable leading dim 1 or N_rays)."""

    kps: torch.Tensor  # (B, J, 3)
    skts: torch.Tensor  # (B, J, 4, 4)
    bones: torch.Tensor  # (B, J, 3)
    cyls: torch.Tensor  # (B, 5)
    cam_idxs: Optional[torch.Tensor] = None  # (B, 1|3) framecode index


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Everything static about the renderer (mirrors reference
    create_raycaster, core/raycasters.py:17-184)."""

    n_joints: int = 24
    i_embed: int = 0  # -1 = identity (no PE, no cutoff)
    kp_dist_type: str = "reldist"
    view_type: str = "relray"
    bone_type: str = "reldir"
    multires: int = 7
    multires_views: int = 4
    multires_bones: int = 0
    use_viewdirs: bool = True
    use_cutoff: bool = True
    cutoff_viewdir: bool = True
    cutoff_bones: bool = False
    cutoff_inputs: bool = True
    cut_to_dist: bool = False
    cutoff_shift: bool = False
    normalize_cutoff: bool = False
    freq_schedule: bool = False
    init_freq: float = 0.0
    opt_framecode: bool = False
    framecode_ch: int = 16
    n_framecodes: int = 0
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: Optional[int] = None  # None = match netdepth
    netwidth_fine: Optional[int] = None  # None = match netwidth
    N_samples: int = 64
    N_importance: int = 16
    single_net: bool = False
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    ray_noise_std: float = 0.0
    lindisp: bool = False
    density_scale: float = 1.0
    density_type: str = "relu"
    softplus_shift: float = 1.0
    rgb_eps: float = 0.001
    near: float = 0.35
    far: float = 2.75

    @property
    def kp_dims(self) -> Tuple[int, int]:
        return enc.kp_encoder_dims(self.kp_dist_type, self.n_joints)

    @property
    def embed_kp_cfg(self) -> EmbedConfig:
        input_dims, cutoff_dims = self.kp_dims
        if self.i_embed == -1:
            return emb_identity(input_dims)
        return EmbedConfig(
            num_freqs=self.multires,
            input_dims=input_dims,
            cutoff=self.use_cutoff,
            cutoff_dim=cutoff_dims,
            dist_inputs=input_dims != cutoff_dims,
            cutoff_inputs=self.cutoff_inputs,
            cut_to_dist=self.cut_to_dist,
            shift_inputs=self.cutoff_shift,
            normalize=self.normalize_cutoff,
            freq_schedule=self.freq_schedule,
            init_alpha=self.init_freq,
        )

    @property
    def embed_bone_cfg(self) -> Optional[EmbedConfig]:
        dims = enc.bone_encoder_dims(self.bone_type, self.n_joints)
        if dims == 0:
            return None
        if self.i_embed == -1:
            return emb_identity(dims)
        return EmbedConfig(
            num_freqs=self.multires_bones,
            input_dims=dims,
            cutoff=self.use_cutoff and self.cutoff_bones,
            cutoff_dim=self.n_joints,
            dist_inputs=True,
            cutoff_inputs=self.cutoff_inputs,
            freq_schedule=self.freq_schedule,
            init_alpha=self.init_freq,
        )

    @property
    def embed_view_cfg(self) -> Optional[EmbedConfig]:
        if not self.use_viewdirs:
            return None
        dims = enc.view_encoder_dims(self.view_type, self.n_joints)
        if self.i_embed == -1:
            return emb_identity(dims)
        return EmbedConfig(
            num_freqs=self.multires_views,
            input_dims=dims,
            cutoff=self.use_cutoff and self.cutoff_viewdir,
            cutoff_dim=self.n_joints,
            dist_inputs=True,
            cutoff_inputs=self.cutoff_inputs,
            freq_schedule=self.freq_schedule,
            init_alpha=self.init_freq,
        )

    @property
    def nerf_cfg(self) -> NeRFConfig:
        bone_cfg = self.embed_bone_cfg
        view_cfg = self.embed_view_cfg
        return NeRFConfig(
            input_ch=self.embed_kp_cfg.out_dim,
            input_ch_bones=bone_cfg.out_dim if bone_cfg is not None else 0,
            input_ch_views=view_cfg.out_dim if view_cfg is not None else 0,
            depth=self.netdepth,
            width=self.netwidth,
            use_viewdirs=self.use_viewdirs,
            use_framecode=self.opt_framecode,
            framecode_ch=self.framecode_ch,
            n_framecodes=self.n_framecodes,
            density_scale=self.density_scale,
            density_type=self.density_type,
            softplus_shift=self.softplus_shift,
        )


def init_raycaster(
    cfg: RaycastConfig,
    generator: Optional[torch.Generator] = None,
    skel: Skeleton = SMPL_SKELETON,
    ext_scale: float = 0.001,
    cutoff_mm: float = 500.0,
    device="cuda",
) -> Dict[str, Any]:
    """The renderer's parameter/state dict on `device` (CUDA by default;
    raises without a card). Weights draw from `generator` on the host."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    nerf_cfg = cfg.nerf_cfg
    params: Dict[str, Any] = {"coarse": init_nerf(nerf_cfg, generator, dev)}
    if cfg.N_importance > 0 and not cfg.single_net:
        fine_cfg = dataclasses.replace(
            nerf_cfg,
            depth=cfg.netdepth_fine or cfg.netdepth,
            width=cfg.netwidth_fine or cfg.netwidth,
        )
        params["fine"] = init_nerf(fine_cfg, generator, dev)

    # a uniform cutoff like reference create_raycaster
    # (cutoff_kwargs['cutoff_dist'] = args.cutoff_mm * args.ext_scale)
    cutoff_dist = torch.full((skel.n_joints,), cutoff_mm * ext_scale, dtype=torch.float32)
    for name, ecfg in (("embed_kp", cfg.embed_kp_cfg),
                       ("embed_bone", cfg.embed_bone_cfg),
                       ("embed_view", cfg.embed_view_cfg)):
        if ecfg is not None:
            params[name] = emb_mod.init_embed_state(ecfg, cutoff_dist, device=dev)
    return params


def update_embed_states(
    params: Dict[str, Any],
    cfg: RaycastConfig,
    global_step,
    cutoff_step: int = 250,
    cutoff_rate: float = 10.0,
    freq_schedule_step: int = 5,
) -> Dict[str, Any]:
    """Anneal tau / BARF alpha in the embed states
    (reference raycasters.py:731-748)."""
    out = dict(params)
    for name, ecfg in (
        ("embed_kp", cfg.embed_kp_cfg),
        ("embed_bone", cfg.embed_bone_cfg),
        ("embed_view", cfg.embed_view_cfg),
    ):
        if ecfg is None or name not in params:
            continue
        st = dict(params[name])
        dev = st["tau"].device
        if ecfg.cutoff:
            st["tau"] = emb_mod.update_tau(ecfg, global_step, cutoff_step, cutoff_rate,
                                           device=dev)
        if ecfg.freq_schedule:
            st["alpha"] = emb_mod.update_alpha(
                ecfg, global_step, freq_schedule_step, float(cfg.multires - 1), device=dev
            )
        out[name] = st
    return out


def encode_inputs(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    pts: torch.Tensor,
    rays_d: torch.Tensor,
    ctx: PoseCtx,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Points + pose -> (x_pts (N,S,Ckp+Cbone), x_views, cutoff_w)
    (reference raycasters.py:476-555)."""
    N = pts.shape[0]
    kps = ctx.kps.expand(N, *ctx.kps.shape[1:])
    skts = ctx.skts.expand(N, *ctx.skts.shape[1:])
    bones = ctx.bones.expand(N, *ctx.bones.shape[1:])

    pts_t = enc.transform_batch_pts(pts, skts)
    rays_t = enc.transform_batch_rays(rays_d, skts)

    v = enc.encode_kp(cfg.kp_dist_type, pts, pts_t, kps)
    r = enc.encode_bone(cfg.bone_type, pts_t, bones)
    d = enc.encode_view(cfg.view_type, rays_t, pts_t, rays_d) if cfg.use_viewdirs else None

    if "Dist" in cfg.kp_dist_type or cfg.kp_dist_type == "reldist":
        j_dists = v
    else:
        j_dists = torch.linalg.norm(pts[:, :, None] - kps[:, None], dim=-1)

    v_e, cw = emb_mod.embed(cfg.embed_kp_cfg, v, dists=j_dists, state=params["embed_kp"])
    parts = [v_e]
    if cfg.embed_bone_cfg is not None and r is not None:
        r_e, _ = emb_mod.embed(cfg.embed_bone_cfg, r, dists=j_dists,
                               state=params["embed_bone"])
        parts.append(r_e)
    x_pts = torch.cat(parts, dim=-1)

    x_views = None
    if d is not None:
        x_views, _ = emb_mod.embed(cfg.embed_view_cfg, d, dists=j_dists,
                                   state=params["embed_view"])
    return x_pts, x_views, cw


def _run_net(
    cfg: RaycastConfig,
    net_params: Dict,
    params: Dict[str, Any],
    pts: torch.Tensor,
    rays_d: torch.Tensor,
    ctx: PoseCtx,
    eval_mean_code: bool,
    use_fused=False,
    density_only: bool = False,
) -> torch.Tensor:
    """Encode and evaluate one NeRF net over (N, S) samples -> raw (N, S, 4).

    use_fused: True (eval kernels), "train" (the trainable kernels, weight
    gradients only), "full" (the trainable kernels with input gradients:
    pose refinement) or False.
    density_only (eval kernels only): the rgb rows come back zero; sigma is
    exact."""
    if use_fused not in (False, True, "train", "full"):
        raise ValueError(f"use_fused={use_fused!r}")
    if use_fused:
        return fused.fused_run_net(
            cfg, net_params, params["embed_kp"], pts, rays_d, ctx,
            eval_mean_code=eval_mean_code,
            density_only=density_only and use_fused is True,
            view_embed_state=params.get("embed_view"),
            trainable=use_fused in ("train", "full"),
            input_grads=use_fused == "full",
        )
    x_pts, x_views, _ = encode_inputs(cfg, params, pts, rays_d, ctx)
    frame_idx = None
    if cfg.opt_framecode:
        S = pts.shape[1]
        idxs = ctx.cam_idxs
        if idxs is None:
            # mean code (reference idx < 0 eval path); the zeros only shape
            # the lookup
            idxs = torch.zeros((pts.shape[0], 1), dtype=torch.long, device=pts.device)
            eval_mean_code = True
        idxs = idxs.expand(pts.shape[0], idxs.shape[-1])
        frame_idx = idxs[:, None, :].expand(pts.shape[0], S, idxs.shape[-1])
    return nerf_apply(cfg.nerf_cfg, net_params, x_pts, x_views, frame_idx, eval_mean_code)


def render_rays(
    cfg: RaycastConfig,
    params: Dict[str, Any],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    ctx: PoseCtx,
    generator: Optional[torch.Generator] = None,
    perturb: Optional[float] = None,
    raw_noise_std: Optional[float] = None,
    eval_mean_code: bool = False,
    det_noise: Optional[Dict[str, torch.Tensor]] = None,
    use_fused=None,
    coarse_rgb: bool = True,
) -> Dict[str, torch.Tensor]:
    """Volume-render a batch of rays (reference raycasters.py:361-474).

    coarse_rgb=False (eval-only fast path): the coarse pass skips its view
    branch (the dual kernel where it applies) — rgb0 comes back zero while
    weights / acc0 / disp0 stay exact. Callers that read rgb0 keep the
    default.

    rays_o/rays_d: (N, 3). ctx fields broadcast (leading 1 or N).
    perturb/raw_noise_std default to the config (pass 0.0 for eval).
    generator: draws the stratified / importance / density noise.
    det_noise: {'coarse': (N,S), 'importance': (N,I), 'sigma0': (N,S),
      'sigma': (N,S+I)} pre-drawn noise for parity runs.
    use_fused: the fused field kernels (on the CPU, their plain versions):
      True the eval kernels, "train" the trainable pair (pose groups in
      ctx, rays contiguous per group), "full" the same with input gradients,
      False the plain pipeline; None =
      auto: the eval kernels for CUDA tensors whose config/pose passes the
      gate. True and auto both fall back to the plain pipeline, with a
      one-time named warning, where the gate (`fused_disqualification`)
      refuses the config or pose.
    Returns rgb_map/disp_map/acc_map/alpha (+ *0 coarse copies).
    """
    perturb = cfg.perturb if perturb is None else perturb
    raw_noise_std = cfg.raw_noise_std if raw_noise_std is None else raw_noise_std
    if use_fused is True or (use_fused is None and rays_o.is_cuda):
        reason = fused.fused_disqualification(cfg, ctx, params["coarse"])
        use_fused = reason is None
        if reason is not None:
            fused.warn_fused_fallback("render_rays", reason)
    elif use_fused is None:
        use_fused = False
    act = density_activation(cfg.nerf_cfg)
    dn = det_noise or {}

    N = rays_o.shape[0]
    near, far = samp.get_near_far_in_cylinder(
        rays_o, rays_d, ctx.cyls.expand(N, 5), near=cfg.near, far=cfg.far,
    )
    z_vals = samp.sample_from_lineseg(
        near, far, cfg.N_samples, perturb=perturb, lindisp=cfg.lindisp,
        generator=generator, det_noise=dn.get("coarse"),
    )
    pts = rays_o[:, None] + rays_d[:, None] * z_vals[..., None]

    coarse_density_only = (
        not coarse_rgb
        and cfg.N_importance > 0
        and not cfg.single_net  # single-net merges the coarse raw into fine
    )
    raw_fc = None  # fine-net raw on the coarse samples (dual-net kernel)
    if (
        use_fused is True
        and coarse_density_only
        and fused.supports_dual_eval(cfg, ctx, params["coarse"])
    ):
        # one encode per coarse sample for both nets: the fine pass then
        # evaluates only the fresh importance samples
        raw_c, raw_fc = fused.fused_run_net(
            cfg, params["coarse"], params["embed_kp"], pts, rays_d, ctx,
            eval_mean_code=eval_mean_code, density_only=True,
            view_embed_state=params.get("embed_view"),
            dual_params=params.get("fine", params["coarse"]),
        )
    if raw_fc is None:
        raw_c = _run_net(
            cfg, params["coarse"], params, pts, rays_d, ctx, eval_mean_code,
            use_fused, density_only=coarse_density_only and use_fused is True,
        )

    def density_noise(name, shape):
        if raw_noise_std <= 0.0:
            return None
        if name in dn:
            return dn[name]
        if generator is None:
            return None
        return (torch.randn(shape, generator=generator, device=rays_o.device)
                * raw_noise_std * cfg.density_scale)

    out_c = nerf_mod.raw2outputs(
        raw_c, z_vals, rays_d, noise=density_noise("sigma0", raw_c.shape[:-1]),
        B=cfg.density_scale, act_fn=act, rgb_eps=cfg.rgb_eps,
    )

    if cfg.N_importance <= 0:
        return _collect(out_c, None)

    z_all, z_samples, sorted_idxs = samp.isample_from_lineseg(
        z_vals, out_c["weights"], cfg.N_importance, det=(perturb == 0.0),
        is_only=cfg.single_net, generator=generator, det_noise=dn.get("importance"),
    )

    fine_params = params.get("fine", params["coarse"])
    if raw_fc is not None:
        # the dual kernel already evaluated the fine net on the coarse
        # samples; only the fresh samples need a pass. Raws merge by a
        # stable sort of z.
        pts_is = rays_o[:, None] + rays_d[:, None] * z_samples[..., None]
        raw_is = _run_net(cfg, fine_params, params, pts_is, rays_d, ctx,
                          eval_mean_code, use_fused)
        z_all, order = torch.sort(torch.cat([z_vals, z_samples], -1), dim=-1, stable=True)
        raw_f = torch.take_along_dim(torch.cat([raw_fc, raw_is], 1), order[..., None], dim=1)
    elif not cfg.single_net:
        # re-encode the merged, sorted sample set in one pass (equivalent to
        # the reference's encoding gather-merge, raycasters.py:446-469)
        pts_all = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
        raw_f = _run_net(cfg, fine_params, params, pts_all, rays_d, ctx,
                         eval_mean_code, use_fused)
    else:
        # single-net: evaluate only the new samples, merge raws by sort order
        pts_is = rays_o[:, None] + rays_d[:, None] * z_samples[..., None]
        raw_is = _run_net(cfg, fine_params, params, pts_is, rays_d, ctx,
                          eval_mean_code, use_fused)
        raw_f = torch.take_along_dim(torch.cat([raw_c, raw_is], 1),
                                     sorted_idxs[..., None], dim=1)

    out_f = nerf_mod.raw2outputs(
        raw_f, z_all, rays_d, noise=density_noise("sigma", raw_f.shape[:-1]),
        B=cfg.density_scale, act_fn=act, rgb_eps=cfg.rgb_eps,
    )
    return _collect(out_f, out_c)


def _collect(ret: Dict[str, torch.Tensor],
             ret0: Optional[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Output dict layout (reference raycasters.py:711-724)."""
    out = {
        "rgb_map": ret["rgb_map"],
        "disp_map": ret["disp_map"],
        "acc_map": ret["acc_map"],
        "alpha": ret["alpha"],
    }
    if ret0 is not None:
        out.update(
            rgb0=ret0["rgb_map"], disp0=ret0["disp_map"],
            acc0=ret0["acc_map"], alpha0=ret0["alpha"],
        )
    return out
