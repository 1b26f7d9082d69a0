"""Minimal functional NN layers: params / state as dicts of tensors, pure
applies (port of posegen_tpu/nn/layers.py).

Initialisation follows PyTorch's defaults, as in the JAX package (linear and
conv: kaiming-uniform over fan_in; BN: ones / zeros, eps 1e-5, momentum
0.1). Linear weights are stored (in, out), as the JAX package stores them,
and applied as x @ w. Convolutions are NCHW with OIHW weights, PyTorch's
layout; `utils/convert.py` transposes the JAX package's HWIO weights.

"SAME" padding is XLA's: the total pad of a spatial axis is
max((ceil(n / s) - 1) * s + k - n, 0), split as (total // 2, total -
total // 2). At stride 2 it is asymmetric (conv1's 7 x 7 / 2 on 224 pads (2,
3); a 3 x 3 / 2 conv on 56 and the 3 x 3 / 2 max pool on 112 pad (0, 1)), so
PyTorch's symmetric `padding=` would compute another function; the uneven
cases pad explicitly with `F.pad` (zeros for a conv, -inf for the pool).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def init_linear(gen: torch.Generator, n_in: int, n_out: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(n_in)
    w = torch.empty(n_in, n_out).uniform_(-bound, bound, generator=gen)
    b = torch.empty(n_out).uniform_(-bound, bound, generator=gen)
    return {"w": w.to(device), "b": b.to(device)}


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x (B, in) -> x @ w + b (B, out), in one GEMM."""
    return torch.addmm(p["b"], x, p["w"])


def leaky_relu(x: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, slope)


# ---------------------------------------------------------------------------
# batch norm with explicit running-stat state
# ---------------------------------------------------------------------------

def init_batchnorm(dim: int, device="cuda") -> Tuple[Dict, Dict]:
    """-> (params {scale, bias}, state {mean, var})."""
    params = {"scale": torch.ones(dim, device=device), "bias": torch.zeros(dim, device=device)}
    state = {"mean": torch.zeros(dim, device=device), "var": torch.ones(dim, device=device)}
    return params, state


def batchnorm(
    params: Dict,
    state: Dict,
    x: torch.Tensor,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    mesh=None,
) -> Tuple[torch.Tensor, Dict]:
    """Normalise over every axis but the channel axis (axis 1: (B, C) or
    NCHW). Returns (y, new_state).

    train=True normalises with the batch's biased variance and returns the
    running stats updated as new = (1 - m) * old + m * batch, the variance
    unbiased (the JAX package's and PyTorch's rule, F.batch_norm's own);
    train=False normalises with the stored stats and returns the state
    unchanged (SPIN's BN-frozen fine-tuning, reference run_gan.py:1860-1869).

    mesh: sync-BN over the ranks of a `parallel.mesh.Mesh` (the JAX
    package's axis_name, posegen_tpu/nn/layers.py:53-80): the mean and the
    mean of squares are averaged over the ranks (one differentiable
    all-reduce), var = msq - mean^2, and the unbiased correction counts n x
    size rows; with equal shards every rank normalises with the global
    batch's moments and returns the same state.
    """
    if not train:
        y = F.batch_norm(x, state["mean"], state["var"], params["scale"], params["bias"],
                         training=False, eps=eps)
        return y, state
    if mesh is not None:
        return _synced_batchnorm(params, state, x, momentum, eps, mesh)
    mean, var = state["mean"].clone(), state["var"].clone()
    # F.batch_norm updates the running buffers it is given in place
    y = F.batch_norm(x, mean, var, params["scale"], params["bias"], training=True,
                     momentum=momentum, eps=eps)
    return y, {"mean": mean, "var": var}


def _synced_batchnorm(params: Dict, state: Dict, x: torch.Tensor, momentum: float, eps: float,
                      mesh) -> Tuple[torch.Tensor, Dict]:
    from posegen_tpu_torch.parallel.mesh import sync_sum

    axes = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    moments = sync_sum(mesh, torch.stack([x.mean(axes), (x * x).mean(axes)])) / mesh.size
    mean, msq = moments[0], moments[1]
    var = msq - mean * mean
    n = x.numel() // x.shape[1] * mesh.size
    y = ((x - mean.view(shape)) * torch.rsqrt(var + eps).view(shape) * params["scale"].view(shape)
         + params["bias"].view(shape))
    with torch.no_grad():
        new_state = {
            "mean": (1 - momentum) * state["mean"] + momentum * mean,
            "var": (1 - momentum) * state["var"] + momentum * (var * n / max(n - 1, 1)),
        }
    return y, new_state


# ---------------------------------------------------------------------------
# conv / pooling (NCHW, OIHW)
# ---------------------------------------------------------------------------

def init_conv(gen: torch.Generator, k: int, c_in: int, c_out: int, use_bias: bool = False,
              device="cuda") -> Dict[str, torch.Tensor]:
    # kaiming-uniform with a = sqrt(5) (torch Conv2d's default): U(-b, b),
    # b = sqrt(1 / fan_in)
    bound = math.sqrt(1.0 / (k * k * c_in))
    p = {"w": torch.empty(c_out, c_in, k, k).uniform_(-bound, bound, generator=gen).to(device)}
    if use_bias:
        p["b"] = torch.zeros(c_out, device=device)
    return p


def same_pads(n: int, k: int, stride: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA's "SAME" (lo, hi) padding of one spatial axis of size n."""
    k_eff = (k - 1) * dilation + 1
    total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
    return total // 2, total - total // 2


def _padded(x: torch.Tensor, k: int, stride: int, dilation: int, padding, value: float):
    """-> (x, symmetric padding for the op): an uneven "SAME" pad is applied
    here with F.pad; an even one is left to the op."""
    if padding == "VALID":
        return x, 0
    if padding != "SAME":
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    (t, b), (l, r) = (same_pads(n, k, stride, dilation) for n in x.shape[-2:])
    if t == b and l == r:
        return x, (t, l)
    return F.pad(x, (l, r, t, b), value=value), 0


def conv2d(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1, padding="SAME",
           dilation: int = 1) -> torch.Tensor:
    x, pad = _padded(x, p["w"].shape[-1], stride, dilation, padding, 0.0)
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=pad, dilation=dilation)


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2, padding="SAME") -> torch.Tensor:
    x, pad = _padded(x, k, stride, 1, padding, -math.inf)
    # max_pool2d pads with -inf itself
    return F.max_pool2d(x, k, stride, padding=pad)
