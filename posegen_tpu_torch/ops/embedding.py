"""Positional encoding with per-joint soft cutoff
(port of posegen_tpu/ops/embedding.py:25-206).

Stateless: the annealed temperature `tau`, the BARF schedule `alpha` and
the per-joint `cutoff_dist` are explicit inputs (a dict of tensors).

  w_j   = 1 - sigmoid(tau * (dist_j - cutoff_j))          per-joint gate
  PE    = [input?, sin(f_0 x), cos(f_0 x), ..., sin(f_{NF-1} x), cos(...)]
  out   = flatten(PE * w) with optional BARF frequency window.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EmbedConfig:
    """Static embedder configuration.

    num_freqs: number of octaves (reference `multires`); frequencies are
      2**linspace(0, num_freqs-1, num_freqs).
    input_dims: trailing dim of the embedded signal.
    cutoff_dim: number of joints driving the cutoff gates.
    dist_inputs: True when input_dims != cutoff_dim — each joint's distance
      gates `input_dims // cutoff_dim` consecutive input channels.
    cutoff_inputs: also gate the raw (identity) part of the encoding.
    cut_to_dist / shift_inputs: input reparameterisations.
    """

    num_freqs: int
    input_dims: int
    include_input: bool = True
    cutoff: bool = False
    cutoff_dim: int = 24
    dist_inputs: bool = False
    cutoff_inputs: bool = False
    cut_to_dist: bool = False
    shift_inputs: bool = False
    normalize: bool = False
    freq_schedule: bool = False
    init_alpha: float = 0.0
    init_tau: float = 20.0
    log_sampling: bool = True

    @property
    def out_dim(self) -> int:
        d = self.input_dims if self.include_input else 0
        return d + 2 * self.num_freqs * self.input_dims

    @property
    def expand(self) -> int:
        if not self.dist_inputs:
            return 1
        if self.input_dims % self.cutoff_dim != 0:
            raise ValueError(
                f"input_dims {self.input_dims} not a multiple of cutoff_dim "
                f"{self.cutoff_dim}"
            )
        return self.input_dims // self.cutoff_dim

    def freq_bands(self) -> np.ndarray:
        if self.num_freqs == 0:
            return np.zeros((0,), dtype=np.float32)
        if self.log_sampling:
            return (2.0 ** np.linspace(0.0, self.num_freqs - 1, self.num_freqs)).astype(np.float32)
        return np.linspace(1.0, 2.0 ** (self.num_freqs - 1), self.num_freqs).astype(np.float32)


def identity_config(input_dims: int) -> EmbedConfig:
    """No-op embedding (reference i_embed == -1)."""
    return EmbedConfig(num_freqs=0, input_dims=input_dims, include_input=True)


def _device_of(device, t) -> Optional[torch.device]:
    """`device` when given, else the device of tensor `t`, else None (the
    default device of a new tensor)."""
    if device is not None:
        return torch.device(device)
    return t.device if isinstance(t, torch.Tensor) else None


def init_embed_state(cfg: EmbedConfig, cutoff_dist: Optional[torch.Tensor] = None,
                     device=None) -> dict:
    """The embedder's train-state quantities {'tau', 'alpha', 'cutoff_dist'},
    on `device`, or by default on the device of `cutoff_dist`."""
    device = _device_of(device, cutoff_dist)
    if cutoff_dist is None:
        cutoff_dist = torch.full((cfg.cutoff_dim,), 0.175, dtype=torch.float32)
    return {
        "tau": torch.tensor(cfg.init_tau, dtype=torch.float32, device=device),
        "alpha": torch.tensor(cfg.init_alpha, dtype=torch.float32, device=device),
        # a copy: several embed states share one cutoff table at init
        "cutoff_dist": torch.as_tensor(cutoff_dist, dtype=torch.float32).to(device).clone(),
    }


def update_tau(cfg: EmbedConfig, global_step, step: int, rate: float,
               device=None) -> torch.Tensor:
    """Exponential temperature anneal (reference cutoff_embedder.py:181-183):
    tau = init_tau * rate**(global_step / (step * 1000)), clamped at 2000.
    On `device`, or by default on the device of a tensor `global_step`."""
    gs = torch.as_tensor(global_step, dtype=torch.float32,
                         device=_device_of(device, global_step))
    return torch.clamp(cfg.init_tau * rate ** (gs / float(step * 1000)), max=2000.0)


def update_alpha(cfg: EmbedConfig, global_step, step: int,
                 target: Optional[float] = None, device=None) -> torch.Tensor:
    """Linear BARF alpha schedule (reference :185-190). On `device`, or by
    default on the device of a tensor `global_step`."""
    device = _device_of(device, global_step)
    if not cfg.freq_schedule:
        return torch.tensor(cfg.init_alpha, dtype=torch.float32, device=device)
    if target is None:
        target = float(cfg.num_freqs - 1)
    gs = torch.as_tensor(global_step, dtype=torch.float32, device=device)
    return cfg.init_alpha + (target - cfg.init_alpha) * gs / float(step * 1000)


def _schedule_w(cfg: EmbedConfig, alpha: torch.Tensor):
    """BARF frequency window, shape (2*NF, 1) over the stacked sin/cos axis
    (reference :192-197); 1.0 when unscheduled."""
    if not cfg.freq_schedule or cfg.num_freqs == 0:
        return 1.0
    freq_k = torch.log2(torch.as_tensor(cfg.freq_bands(), device=alpha.device))
    diff = torch.clamp(alpha - freq_k, 0.0, 1.0)
    w = 0.5 * (1.0 - torch.cos(math.pi * diff))
    return torch.repeat_interleave(w, 2)[:, None]


def embed(
    cfg: EmbedConfig,
    inputs: torch.Tensor,
    dists: Optional[torch.Tensor] = None,
    state: Optional[dict] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply the (cutoff) positional encoding.

    inputs: (..., input_dims) signal to encode.
    dists:  (..., cutoff_dim) per-joint distances driving the gates
            (ignored when cfg.cutoff is False; defaults to `inputs` when
            dist_inputs is False).
    state:  {'tau', 'alpha', 'cutoff_dist'} — required when cfg.cutoff.

    Returns (embedded (..., out_dim), cutoff_weights or None), channel
    layout [input, sin(f0 x), cos(f0 x), sin(f1 x), ...] each input_dims wide.
    """
    freq_bands = cfg.freq_bands()
    NF = cfg.num_freqs

    if not cfg.cutoff:
        parts = [inputs] if cfg.include_input else []
        for f in freq_bands:
            parts.append(torch.sin(inputs * float(f)))
            parts.append(torch.cos(inputs * float(f)))
        if not parts:
            return inputs, None
        return torch.cat(parts, dim=-1), None

    if state is None:
        raise ValueError("cutoff embedder needs {'tau','alpha','cutoff_dist'} state")
    tau = state["tau"]
    cutoff_dist = state["cutoff_dist"]

    x = inputs
    if cfg.dist_inputs:
        # each joint's distance/cutoff gates `expand` consecutive channels
        if dists is None:
            raise ValueError("dist_inputs embedding needs per-joint dists")
        e = cfg.expand
        gate_arg = tau * (torch.repeat_interleave(dists, e, dim=-1)
                          - torch.repeat_interleave(cutoff_dist, e, dim=-1))
    else:
        dists = inputs if dists is None else dists
        if cfg.cut_to_dist:
            x = cutoff_dist - x
        if cfg.shift_inputs:
            x = x * (2.0 / cutoff_dist) - 1.0
        gate_arg = tau * (dists - cutoff_dist)

    w = 1.0 - torch.sigmoid(gate_arg)[..., None, :]  # (..., 1, D)

    if NF > 0:
        # cos(x) = sin(x + pi/2): the whole ladder in its final layout
        fb2 = torch.repeat_interleave(
            torch.as_tensor(freq_bands, device=x.device), 2)[:, None]
        phase = torch.tensor([0.0, np.pi / 2.0], dtype=x.dtype,
                             device=x.device).repeat(NF)[:, None]
        pe = torch.sin(x[..., None, :] * fb2 + phase)  # (..., 2NF, D)
        pe = pe * _schedule_w(cfg, state["alpha"])
    else:
        pe = x.new_zeros((*x.shape[:-1], 0, x.shape[-1]))

    if cfg.include_input and cfg.cutoff_inputs:
        emb = torch.cat([inputs[..., None, :], pe], dim=-2) * w
    elif cfg.include_input:
        emb = torch.cat([inputs[..., None, :], pe * w], dim=-2)
    else:
        emb = pe * w

    if cfg.normalize:
        # L2-normalise each 3-vector group, zeroing gated-out joints
        # (reference :161-170; assumes trailing groups of 3)
        sh = emb.shape
        grouped = emb.reshape(-1, 3)
        w0 = w.reshape(-1, w.shape[-1])[:, :1]
        is_zero = torch.isclose(w0, torch.zeros_like(w0), atol=1e-6)
        norm = torch.linalg.norm(grouped, dim=-1, keepdim=True)
        grouped = grouped / torch.clamp(norm, min=1e-12)
        emb = torch.where(is_zero.reshape(-1, 1), 0.0, grouped).reshape(sh)

    return emb.reshape(*emb.shape[:-2], -1), w
