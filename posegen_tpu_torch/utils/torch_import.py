"""Shared torch-state-dict -> params converters (port of
posegen_tpu/utils/torch_import.py), for the NeRF .tar, GAN and HMR
importers:

  * Linear: torch (out, in) -> ours (in, out), applied as x @ w
  * Conv2d: OIHW as it is (the port's layout)
  * BatchNorm: weight / bias + running stats -> a (params, state) pair
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _f32(sd, key: str) -> torch.Tensor:
    return torch.as_tensor(sd[key]).detach().to("cpu", torch.float32)


def t_linear(sd, name: str, device) -> Dict[str, torch.Tensor]:
    return {"w": _f32(sd, f"{name}.weight").t().contiguous().to(device),
            "b": _f32(sd, f"{name}.bias").to(device)}


def t_conv(sd, name: str, device, bias: bool = False) -> Dict[str, torch.Tensor]:
    p = {"w": _f32(sd, f"{name}.weight").to(device)}
    if bias:
        p["b"] = _f32(sd, f"{name}.bias").to(device)
    return p


def t_batchnorm(sd, name: str, device) -> Tuple[Dict, Dict]:
    def get(key):
        return _f32(sd, f"{name}.{key}").to(device)

    return ({"scale": get("weight"), "bias": get("bias")},
            {"mean": get("running_mean"), "var": get("running_var")})
