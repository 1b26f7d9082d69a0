"""Pose discriminators (port of posegen_tpu/gen/discriminators.py).

The reference's Pos3dDiscriminator (7 part-wise MLP paths over joint groups
-> 7 logits, run_gan.py:982-1026) and Pos2dDiscriminator (24 x 2 -> 1
logit, run_gan.py:1028-1046), over the JAX package's params trees.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.nn.layers import init_linear, leaky_relu, linear
from posegen_tpu_torch.utils.torch_import import t_linear

# joint groups (SMPL indexing, reference run_gan.py:1013-1020)
PART_GROUPS: Tuple[Tuple[int, ...], ...] = (
    (4, 7, 10),                          # left leg
    (5, 8, 11),                          # right leg
    (9, 13, 16, 18, 20, 22),             # left arm
    (9, 14, 17, 19, 21, 23),             # right arm
    (0, 1, 2, 3, 6, 9, 13, 14, 16, 17),  # torso
    (9, 12, 15),                         # head
    tuple(range(24)),                    # full body
)
_LAYERS = ("l1", "l2", "l3", "l4", "pred")


def _init_path(gen: torch.Generator, n_in: int, device, channel: int = 500,
               channel_mid: int = 1000) -> Dict:
    dims = (n_in, channel, channel, channel, channel_mid, 1)
    return {name: init_linear(gen, dims[i], dims[i + 1], device) for i, name in enumerate(_LAYERS)}


def _path_apply(p: Dict, x: torch.Tensor) -> torch.Tensor:
    for name in _LAYERS[:-1]:
        x = leaky_relu(linear(p[name], x))
    return linear(p["pred"], x)


def init_pos3d_discriminator(gen: torch.Generator, device="cuda") -> Dict:
    device = resolve_device(device)
    return {f"path{i}": _init_path(gen, len(g) * 3, device)
            for i, g in enumerate(PART_GROUPS)}


@functools.lru_cache(maxsize=None)
def _part_index(device: torch.device) -> Tuple[torch.Tensor, ...]:
    """PART_GROUPS as index tensors on `device`, made once: a list index
    would copy a host tensor to a card at every call."""
    return tuple(torch.tensor(g, device=device) for g in PART_GROUPS)


def pos3d_discriminator_apply(params: Dict, kp3d: torch.Tensor) -> torch.Tensor:
    """kp3d (B, 24, 3) -> logits (B, 7)."""
    B = kp3d.shape[0]
    return torch.cat([_path_apply(params[f"path{i}"], kp3d.index_select(1, g).reshape(B, -1))
                      for i, g in enumerate(_part_index(kp3d.device))], dim=-1)


def init_pos2d_discriminator(gen: torch.Generator, n_joints: int = 24, device="cuda") -> Dict:
    return _init_path(gen, n_joints * 2, resolve_device(device), channel=1000,
                      channel_mid=100)


def pos2d_discriminator_apply(params: Dict, kp2d: torch.Tensor) -> torch.Tensor:
    """kp2d (B, 24, 2) -> logits (B, 1)."""
    return _path_apply(params, kp2d.reshape(kp2d.shape[0], -1))


# torch checkpoint import (reference run_gan.py:982-1046)
_REF_PATH_NAMES = (
    "layer_left_leg", "layer_right_leg", "layer_left_arm", "layer_right_arm",
    "layer_torso", "layer_head", "layer_full_body",
)
_REF_LAYER_NAMES = ("layer_1", "layer_2", "layer_3", "layer_last", "layer_pred")


def _t_path(sd, prefix: str, device) -> Dict:
    return {ours: t_linear(sd, f"{prefix}{ref}", device)
            for ours, ref in zip(_LAYERS, _REF_LAYER_NAMES)}


def import_torch_pos3d_discriminator(state_dict, device="cuda") -> Dict:
    """Reference Pos3dDiscriminator state_dict -> params (paths ordered like
    PART_GROUPS, the reference forward's concat) on `device`."""
    device = resolve_device(device)
    return {f"path{i}": _t_path(state_dict, f"{name}.", device)
            for i, name in enumerate(_REF_PATH_NAMES)}


def import_torch_pos2d_discriminator(state_dict, device="cuda") -> Dict:
    return _t_path(state_dict, "", resolve_device(device))
