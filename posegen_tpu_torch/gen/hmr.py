"""HMR / SPIN: a ResNet-50 backbone and the iterative SMPL regressor (port of
posegen_tpu/gen/hmr.py).

The reference's HMR (run_gan.py:1188-1377): ResNet-50 trunk, 3 iterations
of a regressor emitting rot6d pose (24 x 6), betas (10) and a weak-
perspective camera (3), started from SMPL's mean parameters. Functions over
the JAX package's params and BN-state trees, in PyTorch's layout: images
NCHW, conv weights OIHW (`utils/convert.py::hmr_from_numpy` transposes the
JAX package's HWIO weights; `import_torch_hmr` takes torchvision / SPIN
weights as they are). The convolutions pad by XLA's "SAME" rule, as the JAX
package does (`nn/layers.py`), so weights imported from the reference's
torchvision ResNet (symmetric padding) compute another function in both
packages.

Dropout (the reference's drop1 / drop2) engages only in train mode and
when masks are given; `dropout_masks` draws them, so a caller (or a test)
can hold the masks fixed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.nn.layers import (
    batchnorm, conv2d, init_batchnorm, init_conv, init_linear, linear, max_pool,
)
from posegen_tpu_torch.skeleton.rotations import rot6d_to_rot
from posegen_tpu_torch.utils.torch_import import t_batchnorm, t_conv, t_linear

RESNET50_LAYERS = (3, 4, 6, 3)
NPOSE = 24 * 6
FC_WIDTH = 1024


# ---------------------------------------------------------------------------
# bottleneck blocks
# ---------------------------------------------------------------------------

def _init_bottleneck(gen: torch.Generator, c_in: int, planes: int, stride: int,
                     device) -> Tuple[Dict, Dict]:
    c_out = planes * 4
    p: Dict[str, Any] = {
        "conv1": init_conv(gen, 1, c_in, planes, device=device),
        "conv2": init_conv(gen, 3, planes, planes, device=device),
        "conv3": init_conv(gen, 1, planes, c_out, device=device),
    }
    s: Dict[str, Any] = {}
    for i, dim in (("1", planes), ("2", planes), ("3", c_out)):
        p[f"bn{i}"], s[f"bn{i}"] = init_batchnorm(dim, device)
    if stride != 1 or c_in != c_out:
        p["downsample"] = init_conv(gen, 1, c_in, c_out, device=device)
        p["down_bn"], s["down_bn"] = init_batchnorm(c_out, device)
    return p, s


def _bottleneck_apply(p: Dict, s: Dict, x: torch.Tensor, stride: int, train: bool):
    ns = {}
    y, ns["bn1"] = batchnorm(p["bn1"], s["bn1"], conv2d(p["conv1"], x), train)
    y, ns["bn2"] = batchnorm(p["bn2"], s["bn2"], conv2d(p["conv2"], y.relu(), stride=stride),
                             train)
    y, ns["bn3"] = batchnorm(p["bn3"], s["bn3"], conv2d(p["conv3"], y.relu()), train)
    if "downsample" in p:
        sc, ns["down_bn"] = batchnorm(p["down_bn"], s["down_bn"],
                                      conv2d(p["downsample"], x, stride=stride), train)
    else:
        sc = x
    return (y + sc).relu(), ns


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init_hmr(gen: torch.Generator, mean_params: Optional[Dict[str, Any]] = None,
             device="cuda") -> Tuple[Dict, Dict]:
    """-> (params, bn_state), drawn from `gen` on the host and moved to
    `device`. mean_params: {'pose' (144,), 'shape' (10,), 'cam' (3,)} from
    SPIN's smpl_mean_params.npz; identity rot6d, zero shape and cam (0.9, 0,
    0) otherwise."""
    device = resolve_device(device)
    params: Dict[str, Any] = {"conv1": init_conv(gen, 7, 3, 64, device=device)}
    state: Dict[str, Any] = {}
    params["bn1"], state["bn1"] = init_batchnorm(64, device)
    c_in = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), RESNET50_LAYERS)):
        layer_p, layer_s = [], []
        for b in range(blocks):
            stride = 2 if (li > 0 and b == 0) else 1
            p, s = _init_bottleneck(gen, c_in, planes, stride, device)
            layer_p.append(p)
            layer_s.append(s)
            c_in = planes * 4
        params[f"layer{li + 1}"] = layer_p
        state[f"layer{li + 1}"] = layer_s

    feat = 512 * 4
    params["fc1"] = init_linear(gen, feat + NPOSE + 13, FC_WIDTH, device)
    params["fc2"] = init_linear(gen, FC_WIDTH, FC_WIDTH, device)
    # 0.01-gain xavier heads (reference run_gan.py:1281-1283)
    for name, n_out in (("decpose", NPOSE), ("decshape", 10), ("deccam", 3)):
        gain = 0.01 * math.sqrt(2.0 / (FC_WIDTH + n_out))
        w = torch.randn(FC_WIDTH, n_out, generator=gen) * gain
        params[name] = {"w": w.to(device), "b": torch.zeros(n_out, device=device)}

    if mean_params is None:
        mean_params = {"pose": [1.0, 0.0, 0.0, 1.0, 0.0, 0.0] * 24, "shape": [0.0] * 10,
                       "cam": [0.9, 0.0, 0.0]}
    for key in ("pose", "shape", "cam"):
        params[f"init_{key}"] = torch.as_tensor(mean_params[key], dtype=torch.float32,
                                                device=device).reshape(1, -1)
    return params, state


def resnet_features(params: Dict, state: Dict, x: torch.Tensor, train: bool):
    """(B, 3, 224, 224) -> (B, 2048) pooled features + new BN state."""
    ns: Dict[str, Any] = {}
    y, ns["bn1"] = batchnorm(params["bn1"], state["bn1"], conv2d(params["conv1"], x, stride=2),
                             train)
    y = max_pool(y.relu(), 3, 2)
    for li in range(1, 5):
        layer_ns = []
        for b, blk in enumerate(params[f"layer{li}"]):
            stride = 2 if (li > 1 and b == 0) else 1
            y, bns = _bottleneck_apply(blk, state[f"layer{li}"][b], y, stride, train)
            layer_ns.append(bns)
        ns[f"layer{li}"] = layer_ns
    return y.mean(dim=(2, 3)), ns  # global average pool (the 7 x 7 avgpool)


def dropout_masks(gen: torch.Generator, batch: int, n_iter: int = 3, rate: float = 0.5
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The keep masks of the regressor's two dropouts, one pair per
    iteration: bool (batch, 1024), True with probability 1 - rate, drawn on
    the generator's device."""
    def keep():
        return torch.rand((batch, FC_WIDTH), generator=gen, device=gen.device) >= rate

    return [(keep(), keep()) for _ in range(n_iter)]


def hmr_apply(
    params: Dict,
    state: Dict,
    images: torch.Tensor,
    n_iter: int = 3,
    train: bool = False,
    bn_train: Optional[bool] = None,
    masks: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
    dropout_rate: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """images (B, 3, H, W) normalised -> (pred_rotmat (B, 24, 3, 3),
    pred_betas (B, 10), pred_cam (B, 3), new_bn_state).

    bn_train=False with train=True is the reference's BN-frozen SPIN
    fine-tuning mode (run_gan.py:1860-1869). Dropout engages only when train
    and `masks` (from `dropout_masks`) are given."""
    B = images.shape[0]
    bn_train = train if bn_train is None else bn_train
    feat, ns = resnet_features(params, state, images, bn_train)

    def drop(x, keep):
        if not train or masks is None:
            return x
        return torch.where(keep, x / (1.0 - dropout_rate), torch.zeros_like(x))

    pose = params["init_pose"].expand(B, NPOSE)
    shape = params["init_shape"].expand(B, 10)
    cam = params["init_cam"].expand(B, 3)
    for i in range(n_iter):
        k1, k2 = masks[i] if masks is not None else (None, None)
        xc = torch.cat([feat, pose, shape, cam], dim=-1)
        xc = drop(linear(params["fc1"], xc), k1)
        xc = drop(linear(params["fc2"], xc), k2)
        pose = linear(params["decpose"], xc) + pose
        shape = linear(params["decshape"], xc) + shape
        cam = linear(params["deccam"], xc) + cam
    return rot6d_to_rot(pose.reshape(B, 24, 6)), shape, cam, ns


# ---------------------------------------------------------------------------
# torch import
# ---------------------------------------------------------------------------

def import_torch_hmr(state_dict, params: Dict, state: Dict):
    """Overlay a torch HMR / resnet50 state dict onto (params, state) ->
    new (params, state) on the params' device. Accepts a full SPIN HMR
    checkpoint (with the fc1 / decpose heads) or a plain torchvision resnet50
    (backbone only, reference hmr() pretrained path, run_gan.py:1360-1369);
    what the dict lacks keeps its value (strict=False)."""
    sd = dict(state_dict)
    dev = params["conv1"]["w"].device
    params = {k: (list(v) if isinstance(v, list) else v) for k, v in params.items()}
    state = {k: (list(v) if isinstance(v, list) else v) for k, v in state.items()}
    if "conv1.weight" in sd:
        params["conv1"] = t_conv(sd, "conv1", dev)
    if "bn1.weight" in sd:
        params["bn1"], state["bn1"] = t_batchnorm(sd, "bn1", dev)
    for li in range(1, 5):
        for b in range(RESNET50_LAYERS[li - 1]):
            pre = f"layer{li}.{b}"
            if f"{pre}.conv1.weight" not in sd:
                continue
            blk = dict(params[f"layer{li}"][b])
            bst = dict(state[f"layer{li}"][b])
            for ci in ("1", "2", "3"):
                blk[f"conv{ci}"] = t_conv(sd, f"{pre}.conv{ci}", dev)
                blk[f"bn{ci}"], bst[f"bn{ci}"] = t_batchnorm(sd, f"{pre}.bn{ci}", dev)
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = t_conv(sd, f"{pre}.downsample.0", dev)
                blk["down_bn"], bst["down_bn"] = t_batchnorm(sd, f"{pre}.downsample.1", dev)
            params[f"layer{li}"][b] = blk
            state[f"layer{li}"][b] = bst
    for head in ("fc1", "fc2", "decpose", "decshape", "deccam"):
        if f"{head}.weight" in sd:
            params[head] = t_linear(sd, head, dev)
    for buf in ("init_pose", "init_shape", "init_cam"):
        if buf in sd:
            params[buf] = torch.as_tensor(sd[buf]).detach().to(dev, torch.float32).reshape(1, -1)
    return params, state
