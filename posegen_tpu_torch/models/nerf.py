"""The skeleton-conditioned NeRF field: a dict of tensors + plain functions
(port of posegen_tpu/models/nerf.py).

  params = init_nerf(cfg, generator, device)        # dict of f32 tensors
  raw    = nerf_apply(cfg, params, x_pts, x_views, frame_idx)
  maps   = raw2outputs(raw, z_vals, rays_d, ...)

Linear weights are stored (in, out), as in the JAX package, so that a JAX
parameter tree carries over without transposes: application is x @ w + b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    """Static architecture config (reference nerf.py:12-44).

    input_ch: width of the keypoint (kp) embedding.
    input_ch_bones: width of the bone embedding (appended to kp for density).
    input_ch_views: width of the view embedding.
    """

    input_ch: int
    input_ch_bones: int = 0
    input_ch_views: int = 0
    depth: int = 8
    width: int = 256
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    use_framecode: bool = False
    framecode_ch: int = 16
    n_framecodes: int = 0
    density_scale: float = 1.0
    density_type: str = "relu"  # or 'softplus'
    softplus_shift: float = 1.0

    @property
    def dnet_input(self) -> int:
        return self.input_ch + self.input_ch_bones

    @property
    def vnet_input(self) -> int:
        off = self.framecode_ch if self.use_framecode else 0
        return self.input_ch_views + off + self.width


def _init_linear(n_in: int, n_out: int, generator, device) -> Dict[str, torch.Tensor]:
    """PyTorch-Linear-style init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), w (in, out)."""
    bound = 1.0 / math.sqrt(n_in)

    def u(*shape):
        r = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (r * (2.0 * bound) - bound).to(device)

    return {"w": u(n_in, n_out), "b": u(n_out)}


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def init_nerf(cfg: NeRFConfig, generator: torch.Generator, device) -> Dict:
    """Initialise all parameters of one NeRF net (coarse or fine). The
    generator draws on the host, so a seed gives the same weights on every
    device."""
    pts_layers = []
    for i in range(cfg.depth):
        if i == 0:
            fan_in = cfg.dnet_input
        elif (i - 1) in cfg.skips:
            fan_in = cfg.width + cfg.dnet_input
        else:
            fan_in = cfg.width
        pts_layers.append(_init_linear(fan_in, cfg.width, generator, device))

    params: Dict = {"pts_linears": pts_layers}
    if cfg.use_viewdirs:
        params["alpha_linear"] = _init_linear(cfg.width, 1, generator, device)
        params["feature_linear"] = _init_linear(cfg.width, cfg.width, generator, device)
        params["views_linears"] = [
            _init_linear(cfg.vnet_input, cfg.width // 2, generator, device)
        ]
        params["rgb_linear"] = _init_linear(cfg.width // 2, 3, generator, device)
    else:
        params["output_linear"] = _init_linear(cfg.width, 4, generator, device)
    if cfg.use_framecode:
        # xavier-normal init like the reference Optcodes (embedding.py:36-38)
        std = math.sqrt(2.0 / (cfg.n_framecodes + cfg.framecode_ch))
        params["framecodes"] = (
            torch.randn((cfg.n_framecodes, cfg.framecode_ch), generator=generator)
            * std
        ).to(device)
    return params


def forward_density(cfg: NeRFConfig, params: Dict, x_pts: torch.Tensor) -> torch.Tensor:
    """Density trunk: (..., dnet_input) -> (..., width) feature
    (reference nerf.py:94-102)."""
    h = x_pts
    for i, layer in enumerate(params["pts_linears"]):
        h = torch.relu(linear(layer, h))
        if i in cfg.skips:
            h = torch.cat([x_pts, h], dim=-1)
    return h


def framecode_lookup(
    codes: torch.Tensor,
    idx: torch.Tensor,
    eval_mean: bool = False,
) -> torch.Tensor:
    """Per-frame code retrieval (reference networks/embedding.py:17-33).

    idx: (..., 1) integer frame index, or (..., 3) [idx0, idx1, w] for
    two-code interpolation. eval_mean: use the mean code (test-time idx<0).
    """
    if eval_mean:
        mean = codes.mean(0, keepdim=True)
        return mean.expand(*idx.shape[:-1], codes.shape[-1])
    if idx.shape[-1] == 3:
        i0, i1 = idx[..., 0].long(), idx[..., 1].long()
        w = idx[..., 2:3]
        return codes[i0] * (1.0 - w) + codes[i1] * w
    return codes[idx[..., 0].long()]


def nerf_apply(
    cfg: NeRFConfig,
    params: Dict,
    x_pts: torch.Tensor,
    x_views: Optional[torch.Tensor] = None,
    frame_idx: Optional[torch.Tensor] = None,
    eval_mean_code: bool = False,
) -> torch.Tensor:
    """Full forward: embeddings -> raw (..., 4) [r, g, b, sigma]
    (reference nerf.py:104-148)."""
    h = forward_density(cfg, params, x_pts)
    if not cfg.use_viewdirs:
        return linear(params["output_linear"], h)

    alpha = linear(params["alpha_linear"], h)
    feat = linear(params["feature_linear"], h)
    if cfg.use_framecode:
        if frame_idx is None:
            raise ValueError("a framecode net needs frame_idx")
        fc = framecode_lookup(params["framecodes"], frame_idx, eval_mean_code)
        x_views = torch.cat([x_views, fc], dim=-1)
    hv = torch.cat([feat, x_views], dim=-1)
    for layer in params["views_linears"]:
        hv = torch.relu(linear(layer, hv))
    rgb = linear(params["rgb_linear"], hv)
    return torch.cat([rgb, alpha], dim=-1)


def density_activation(cfg: NeRFConfig):
    if cfg.density_type == "relu":
        return torch.relu
    if cfg.density_type == "softplus":
        return lambda x: F.softplus(x - cfg.softplus_shift)
    raise NotImplementedError(f"density activation {cfg.density_type!r}")


def raw2outputs(
    raw: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
    B: float = 1.0,
    act_fn=torch.relu,
    rgb_eps: float = 0.001,
) -> Dict[str, torch.Tensor]:
    """Alpha-composite raw network outputs along each ray
    (reference nerf.py:150-205).

    raw: (N, S, 4); z_vals: (N, S); rays_d: (N, 3).
    noise: optional pre-drawn density noise (N, S); None means no noise.
    Returns rgb_map (N,3), disp_map, acc_map, weights, alpha.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3]) * (1.0 + 2.0 * rgb_eps) - rgb_eps

    sigma = raw[..., 3] / B
    if noise is not None:
        sigma = sigma + noise
    alpha = 1.0 - torch.exp(-act_fn(sigma) * dists)

    # T_i = prod_{j<i} (1 - alpha_j + eps)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans

    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    acc = weights.sum(-1)
    disp_map = 1.0 / torch.clamp(depth_map / (acc + 1e-10), min=1e-10)
    disp_map = torch.where(torch.isclose(acc, torch.zeros_like(acc)), 0.0, disp_map)
    acc_map = torch.clamp(acc, max=1.0)

    return {
        "rgb_map": rgb_map,
        "disp_map": disp_map,
        "acc_map": acc_map,
        "weights": weights,
        "alpha": alpha,
    }
