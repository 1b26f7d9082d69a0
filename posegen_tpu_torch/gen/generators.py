"""Pose GAN generators (port of posegen_tpu/gen/generators.py).

The reference's PoseGenerator / BAGenerator / RTGenerator (run_gan.py:
767-980) as functions over params and BN-state trees, the JAX package's
trees leaf for leaf (linear weights (in, out)):
  BAGenerator: noise (32) -> Linear(256) + BN + LeakyReLU -> 2 stages of
               [Linear + BN + LReLU] x 2 -> Linear(24 * 4) -> per-joint
               (axis, theta); axis normalised, pose = axis * theta, the root
               theta scaled by 3.14 * 2.
  RTGenerator: two such trunks; R's headless trunk gives (mean, std, scale)
               -> a sampled axis-angle -> R; T's head gives xyz with z
               squared. (R, T) move the root-centred input pose.

Randomness: the noises are the dict {'ba', 'r', 'eps', 't'}; a noise that
is absent is drawn from the torch.Generator passed in its place (the JAX
package's PRNG key), on the generator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.nn.layers import batchnorm, init_batchnorm, init_linear, leaky_relu, linear
from posegen_tpu_torch.skeleton.rotations import axisang_to_rot
from posegen_tpu_torch.utils.torch_import import t_batchnorm, t_linear


@dataclasses.dataclass(frozen=True)
class GenConfig:
    n_joints: int = 24
    noise_ch: int = 32
    rt_noise_ch: int = 72
    width: int = 256
    num_stages: int = 2


def _init_trunk(gen: torch.Generator, cfg: GenConfig, noise_ch: int, out_dim: Optional[int],
                device) -> Tuple[Dict, Dict]:
    """-> (params, state) of one trunk. out_dim None = headless: the
    reference RTGenerator's R branch slices raw trunk features
    (run_gan.py:952-957, its w2_R is dead code)."""
    bn_p, bn_s = init_batchnorm(cfg.width, device)
    params = {"w_in": init_linear(gen, noise_ch, cfg.width, device), "bn_in": bn_p,
              "stages": []}
    state = {"bn_in": bn_s, "stages": []}
    for _ in range(cfg.num_stages):
        p1, s1 = init_batchnorm(cfg.width, device)
        p2, s2 = init_batchnorm(cfg.width, device)
        params["stages"].append({"w1": init_linear(gen, cfg.width, cfg.width, device), "bn1": p1,
                                 "w2": init_linear(gen, cfg.width, cfg.width, device), "bn2": p2})
        state["stages"].append({"bn1": s1, "bn2": s2})
    if out_dim is not None:
        params["w_out"] = init_linear(gen, cfg.width, out_dim, device)
    return params, state


def _block_apply(p: Dict, s: Dict, y: torch.Tensor, train: bool,
                 mesh=None) -> Tuple[torch.Tensor, Dict]:
    """One stage: [Linear + BN + LReLU] x 2."""
    y, s1 = batchnorm(p["bn1"], s["bn1"], linear(p["w1"], y), train, mesh=mesh)
    y = leaky_relu(y)
    y, s2 = batchnorm(p["bn2"], s["bn2"], linear(p["w2"], y), train, mesh=mesh)
    return leaky_relu(y), {"bn1": s1, "bn2": s2}


def _trunk_apply(params: Dict, state: Dict, noise: torch.Tensor, train: bool,
                 mesh=None) -> Tuple[torch.Tensor, Dict]:
    y = linear(params["w_in"], noise)
    y, s_in = batchnorm(params["bn_in"], state["bn_in"], y, train, mesh=mesh)
    y = leaky_relu(y)
    new_state = {"bn_in": s_in, "stages": []}
    for p, s in zip(params["stages"], state["stages"]):
        y, s_blk = _block_apply(p, s, y, train, mesh)
        new_state["stages"].append(s_blk)
    if "w_out" in params:
        y = linear(params["w_out"], y)
    return y, new_state


def init_pose_generator(gen: torch.Generator, cfg: GenConfig = GenConfig(),
                        device="cuda") -> Tuple[Dict, Dict]:
    """-> (params, bn_state) of the combined BA + RT generator, drawn from
    `gen` on the host and moved to `device`."""
    device = resolve_device(device)
    pa, sa = _init_trunk(gen, cfg, cfg.noise_ch, cfg.n_joints * 4, device)
    pr, sr = _init_trunk(gen, cfg, cfg.rt_noise_ch, None, device)
    pt, st = _init_trunk(gen, cfg, cfg.rt_noise_ch, 3, device)
    return {"ba": pa, "r": pr, "t": pt}, {"ba": sa, "r": sr, "t": st}


def draw_noises(gen: torch.Generator, batch: int, cfg: GenConfig = GenConfig()
                ) -> Dict[str, torch.Tensor]:
    """The generator's four standard-normal noises, drawn from `gen` on its
    device."""
    shapes = {"ba": (batch, cfg.noise_ch), "r": (batch, cfg.rt_noise_ch), "eps": (batch, 3),
              "t": (batch, cfg.rt_noise_ch)}
    return {k: torch.randn(s, generator=gen, device=gen.device) for k, s in shapes.items()}


def _normalized(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-8)


def ba_generator_apply(
    params: Dict, state: Dict, gen: Optional[torch.Generator], batch: int,
    cfg: GenConfig = GenConfig(), train: bool = True,
    noise: Optional[torch.Tensor] = None, mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """noise -> axis-angle bones (B, J, 3) (reference BAGenerator.forward)."""
    if noise is None:
        noise = torch.randn((batch, cfg.noise_ch), generator=gen, device=gen.device)
    y, new_state = _trunk_apply(params, state, noise, train, mesh)
    y = y.reshape(batch, cfg.n_joints, 4)
    out = _normalized(y[..., :3]) * y[..., 3:4]
    # the reference scales the root theta by literally 3.14 * 2, not 2 pi
    # (run_gan.py:887)
    return torch.cat([out[:, :1] * (3.14 * 2.0), out[:, 1:]], dim=1), new_state


def rt_generator_apply(
    params_r: Dict, params_t: Dict, state_r: Dict, state_t: Dict,
    gen: Optional[torch.Generator], kp3d: torch.Tensor,
    cfg: GenConfig = GenConfig(), train: bool = True,
    noise_r: Optional[torch.Tensor] = None,
    noise_t: Optional[torch.Tensor] = None,
    eps_axis: Optional[torch.Tensor] = None,
    mesh=None,
):
    """noise -> (R (B, 3, 3), T (B, 3), transformed pose (B, J, 3)), new
    states (reference RTGenerator.forward, run_gan.py:944-980)."""
    B = kp3d.shape[0]
    if noise_r is None:
        noise_r = torch.randn((B, cfg.rt_noise_ch), generator=gen, device=gen.device)
    if eps_axis is None:
        eps_axis = torch.randn((B, 3), generator=gen, device=gen.device)
    if noise_t is None:
        noise_t = torch.randn((B, cfg.rt_noise_ch), generator=gen, device=gen.device)

    r_feat, ns_r = _trunk_apply(params_r, state_r, noise_r, train, mesh)
    r_mean, r_std, r_scale = r_feat[:, :3], r_feat[:, 3:6] ** 2, r_feat[:, 6:7]
    R = axisang_to_rot(_normalized(r_mean + r_std * eps_axis) * r_scale)

    t_feat, ns_t = _trunk_apply(params_t, state_t, noise_t, train, mesh)
    T = torch.cat([t_feat[:, :2], t_feat[:, 2:3] ** 2], dim=-1)

    centered = kp3d - kp3d[:, :1]
    # broadcast-sum, as the skeleton code's small rotations: never TF32
    out = (R[:, None] * centered[:, :, None, :]).sum(-1) + T[:, None]
    return R, T, out, ns_r, ns_t


def pose_generator_apply(
    params: Dict, state: Dict, gen: Optional[torch.Generator], kp3d: torch.Tensor,
    cfg: GenConfig = GenConfig(), train: bool = True,
    noises: Optional[Dict[str, torch.Tensor]] = None,
    mesh=None,
) -> Tuple[Dict, Dict]:
    """The full generator (reference PoseGenerator.forward, run_gan.py:
    799-816). kp3d: (B, J, 3) real poses (the batch size and the RT
    branch's input). Returns ({'pose_ba', 'R', 'T', 'pose_rt'}, new_state).
    noises: {'ba', 'r', 'eps', 't'}, each drawn from `gen` when absent.
    mesh: sync-BN over its ranks (`nn.layers.batchnorm`), each rank on its
    rows of the batch."""
    noises = noises or {}
    pose_ba, ns_ba = ba_generator_apply(params["ba"], state["ba"], gen, kp3d.shape[0], cfg,
                                        train, noise=noises.get("ba"), mesh=mesh)
    R, T, pose_rt, ns_r, ns_t = rt_generator_apply(
        params["r"], params["t"], state["r"], state["t"], gen, kp3d, cfg, train,
        noise_r=noises.get("r"), noise_t=noises.get("t"), eps_axis=noises.get("eps"),
        mesh=mesh)
    return ({"pose_ba": pose_ba, "R": R, "T": T, "pose_rt": pose_rt},
            {"ba": ns_ba, "r": ns_r, "t": ns_t})


# ---------------------------------------------------------------------------
# torch checkpoint import (reference run_gan.py GAN checkpoints)
# ---------------------------------------------------------------------------

def _t_trunk(sd, prefix_in, prefix_bn, prefix_stages, prefix_out, device, n_stages=2):
    params = {"w_in": t_linear(sd, prefix_in, device), "stages": []}
    state = {"stages": []}
    params["bn_in"], state["bn_in"] = t_batchnorm(sd, prefix_bn, device)
    for i in range(n_stages):
        base = f"{prefix_stages}.{i}"
        p = {"w1": t_linear(sd, f"{base}.w1", device), "w2": t_linear(sd, f"{base}.w2", device)}
        s = {}
        p["bn1"], s["bn1"] = t_batchnorm(sd, f"{base}.batch_norm1", device)
        p["bn2"], s["bn2"] = t_batchnorm(sd, f"{base}.batch_norm2", device)
        params["stages"].append(p)
        state["stages"].append(s)
    if prefix_out is not None:
        params["w_out"] = t_linear(sd, prefix_out, device)
    return params, state


def import_torch_pose_generator(state_dict, device="cuda"):
    """Reference PoseGenerator state_dict -> (params, bn_state) (module names
    from run_gan.py:793-980: BAprocess.w1 / batch_norm1 / linear_stages / w2,
    RTprocess.w1_R / ... / w2_T; w2_R is dead code), on `device`."""
    device = resolve_device(device)
    pa, sa = _t_trunk(state_dict, "BAprocess.w1", "BAprocess.batch_norm1",
                      "BAprocess.linear_stages", "BAprocess.w2", device)
    pr, sr = _t_trunk(state_dict, "RTprocess.w1_R", "RTprocess.batch_norm_R",
                      "RTprocess.linear_stages_R", None, device)
    pt, st = _t_trunk(state_dict, "RTprocess.w1_T", "RTprocess.batch_norm_T",
                      "RTprocess.linear_stages_T", "RTprocess.w2_T", device)
    return {"ba": pa, "r": pr, "t": pt}, {"ba": sa, "r": sr, "t": st}
