"""DeepLab-v3 person segmenter (port of posegen_tpu/data/segmenter.py).

The reference builds H36M / PerfCap masks with TF DeepLab-v3
(core/process_mask.py); this is torchvision's `deeplabv3_resnet50`
architecture in the functional style of `gen/hmr.py` (params and BN state
as dicts of tensors, NCHW, OIHW), with an importer of torchvision's
checkpoint read from a local .pth (nothing is downloaded).

Atrous backbone: layer3 stride -> dilation 2, layer4 stride -> dilation 4
(output stride 8); ASPP at rates (12, 24, 36) with an image-pooling
branch; a 3 x 3 head and a 1 x 1 21-class classifier; the logits resized
bilinearly to the input (half-pixel centres, as jax.image.resize upsizes).
Class 15 is 'person' in the VOC/COCO-21 label map. The convolutions pad by
XLA's "SAME" rule (`nn/layers.py`), as the JAX package's do, so torchvision
weights compute the JAX package's function, not torchvision's (which pads
symmetrically). PyTorch's TF32 flags are left to the caller.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.nn.layers import batchnorm, conv2d, init_batchnorm, init_conv, max_pool
from posegen_tpu_torch.utils.torch_import import t_batchnorm, t_conv

RESNET50_LAYERS = (3, 4, 6, 3)
ASPP_RATES = (12, 24, 36)
N_CLASSES = 21
PERSON_CLASS = 15
# (block 0's stride, block 0's dilation, the other blocks' dilation) per
# layer, for output stride 8 (torchvision replace_stride_with_dilation=
# [False, True, True]): torchvision's _make_layer gives block 0 the
# PREVIOUS dilation (taken before `self.dilation *= stride`)
LAYER_CFG = ((1, 1, 1), (2, 1, 1), (1, 1, 2), (1, 2, 4))

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _init_block(gen: torch.Generator, c_in: int, planes: int, device) -> Tuple[Dict, Dict]:
    c_out = planes * 4
    p: Dict[str, Any] = {
        "conv1": init_conv(gen, 1, c_in, planes, device=device),
        "conv2": init_conv(gen, 3, planes, planes, device=device),
        "conv3": init_conv(gen, 1, planes, c_out, device=device),
    }
    s: Dict[str, Any] = {}
    for i, dim in (("1", planes), ("2", planes), ("3", c_out)):
        p[f"bn{i}"], s[f"bn{i}"] = init_batchnorm(dim, device)
    if c_in != c_out:
        p["downsample"] = init_conv(gen, 1, c_in, c_out, device=device)
        p["down_bn"], s["down_bn"] = init_batchnorm(c_out, device)
    return p, s


def _bn(p, s, x):
    return batchnorm(p, s, x, train=False)[0]


def _block_apply(p, s, x, stride: int, dilation: int):
    y = _bn(p["bn1"], s["bn1"], conv2d(p["conv1"], x)).relu()
    y = _bn(p["bn2"], s["bn2"], conv2d(p["conv2"], y, stride=stride, dilation=dilation)).relu()
    y = _bn(p["bn3"], s["bn3"], conv2d(p["conv3"], y))
    if "downsample" in p:
        sc = _bn(p["down_bn"], s["down_bn"], conv2d(p["downsample"], x, stride=stride))
    else:
        sc = x
    return (y + sc).relu()


def init_deeplab(gen: torch.Generator, n_classes: int = N_CLASSES,
                 device="cuda") -> Tuple[Dict, Dict]:
    """-> (params, bn_state) of deeplabv3_resnet50, drawn from `gen` on the
    host (PyTorch's default initialisers, as `nn/layers.py` draws them) and
    moved to `device`."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {"conv1": init_conv(gen, 7, 3, 64, device=dev)}
    state: Dict[str, Any] = {}
    params["bn1"], state["bn1"] = init_batchnorm(64, dev)

    c_in = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), RESNET50_LAYERS)):
        ps, ss = [], []
        for b in range(blocks):
            p, s = _init_block(gen, c_in if b == 0 else planes * 4, planes, dev)
            ps.append(p)
            ss.append(s)
        params[f"layer{li + 1}"] = ps
        state[f"layer{li + 1}"] = ss
        c_in = planes * 4

    # ASPP: 1x1 + three atrous 3x3 + image pooling, project, classify
    ap, as_ = {}, {}
    ap["conv0"] = init_conv(gen, 1, 2048, 256, device=dev)
    ap["bn0"], as_["bn0"] = init_batchnorm(256, dev)
    for i in range(len(ASPP_RATES)):
        ap[f"conv{i + 1}"] = init_conv(gen, 3, 2048, 256, device=dev)
        ap[f"bn{i + 1}"], as_[f"bn{i + 1}"] = init_batchnorm(256, dev)
    ap["pool_conv"] = init_conv(gen, 1, 2048, 256, device=dev)
    ap["pool_bn"], as_["pool_bn"] = init_batchnorm(256, dev)
    ap["project"] = init_conv(gen, 1, 256 * 5, 256, device=dev)
    ap["project_bn"], as_["project_bn"] = init_batchnorm(256, dev)
    params["aspp"], state["aspp"] = ap, as_

    params["head_conv"] = init_conv(gen, 3, 256, 256, device=dev)
    params["head_bn"], state["head_bn"] = init_batchnorm(256, dev)
    params["classifier"] = init_conv(gen, 1, 256, n_classes, use_bias=True, device=dev)
    return params, state


def deeplab_logits(params: Dict, state: Dict, x: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) normalized -> (B, n_classes, H, W) logits."""
    H, W = x.shape[-2:]
    y = _bn(params["bn1"], state["bn1"], conv2d(params["conv1"], x, stride=2)).relu()
    y = max_pool(y, 3, 2)
    for li, (stride0, dil0, dil) in enumerate(LAYER_CFG):
        for b, (p, s) in enumerate(zip(params[f"layer{li + 1}"], state[f"layer{li + 1}"])):
            y = _block_apply(p, s, y, stride0 if b == 0 else 1, dil0 if b == 0 else dil)

    ap, as_ = params["aspp"], state["aspp"]
    feats = [_bn(ap["bn0"], as_["bn0"], conv2d(ap["conv0"], y)).relu()]
    for i, r in enumerate(ASPP_RATES):
        z = conv2d(ap[f"conv{i + 1}"], y, dilation=r)
        feats.append(_bn(ap[f"bn{i + 1}"], as_[f"bn{i + 1}"], z).relu())
    pooled = conv2d(ap["pool_conv"], y.mean((2, 3), keepdim=True))
    pooled = _bn(ap["pool_bn"], as_["pool_bn"], pooled).relu()
    feats.append(pooled.expand(-1, -1, *y.shape[-2:]))
    z = _bn(ap["project_bn"], as_["project_bn"], conv2d(ap["project"], torch.cat(feats, 1)))
    z = _bn(params["head_bn"], state["head_bn"], conv2d(params["head_conv"], z.relu())).relu()
    logits = conv2d(params["classifier"], z)
    return F.interpolate(logits, size=(H, W), mode="bilinear", align_corners=False)


# ---------------------------------------------------------------------------
# torchvision weight import
# ---------------------------------------------------------------------------


def import_torch_deeplab(state_dict: Dict[str, Any], device="cuda") -> Tuple[Dict, Dict]:
    """torchvision deeplabv3_resnet50 state_dict -> (params, bn_state) on
    `device`. The auxiliary FCN head (`aux_classifier.*`, a training-time
    loss) and BN's `num_batches_tracked` counters are dropped on purpose;
    any other key that is not read raises KeyError, as a missing one does."""
    dev = resolve_device(device)
    sd = dict(state_dict)
    used = set()

    def conv(name, bias=False):
        used.add(f"{name}.weight")
        if bias:
            used.add(f"{name}.bias")
        return t_conv(sd, name, dev, bias=bias)

    def bn(name):
        used.update(f"{name}.{k}" for k in ("weight", "bias", "running_mean", "running_var"))
        return t_batchnorm(sd, name, dev)

    params: Dict[str, Any] = {"conv1": conv("backbone.conv1")}
    state: Dict[str, Any] = {}
    params["bn1"], state["bn1"] = bn("backbone.bn1")
    for li, blocks in enumerate(RESNET50_LAYERS):
        ps, ss = [], []
        for b in range(blocks):
            base = f"backbone.layer{li + 1}.{b}"
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            for ci in (1, 2, 3):
                p[f"conv{ci}"] = conv(f"{base}.conv{ci}")
                p[f"bn{ci}"], s[f"bn{ci}"] = bn(f"{base}.bn{ci}")
            if f"{base}.downsample.0.weight" in sd:
                p["downsample"] = conv(f"{base}.downsample.0")
                p["down_bn"], s["down_bn"] = bn(f"{base}.downsample.1")
            ps.append(p)
            ss.append(s)
        params[f"layer{li + 1}"] = ps
        state[f"layer{li + 1}"] = ss

    # classifier.0 = ASPP (convs 0-3, pooling 4), .1-.3 = head, .4 = logits
    ap: Dict[str, Any] = {}
    as_: Dict[str, Any] = {}
    for i in range(4):
        ap[f"conv{i}"] = conv(f"classifier.0.convs.{i}.0")
        ap[f"bn{i}"], as_[f"bn{i}"] = bn(f"classifier.0.convs.{i}.1")
    ap["pool_conv"] = conv("classifier.0.convs.4.1")
    ap["pool_bn"], as_["pool_bn"] = bn("classifier.0.convs.4.2")
    ap["project"] = conv("classifier.0.project.0")
    ap["project_bn"], as_["project_bn"] = bn("classifier.0.project.1")
    params["aspp"], state["aspp"] = ap, as_

    params["head_conv"] = conv("classifier.1")
    params["head_bn"], state["head_bn"] = bn("classifier.2")
    params["classifier"] = conv("classifier.4", bias=True)
    unread = sorted(k for k in sd if k not in used and not k.startswith("aux_classifier.")
                    and not k.endswith(".num_batches_tracked"))
    if unread:
        raise KeyError(f"import_torch_deeplab: keys not read: {unread[:8]}"
                       + (f" and {len(unread) - 8} more" if len(unread) > 8 else ""))
    return params, state


def deeplab_person_segmenter(
    weights_path: Optional[str] = None,
    person_class: int = PERSON_CLASS,
    device="cuda",
) -> Callable[[np.ndarray], np.ndarray]:
    """-> img (H, W, 3) uint8 -> person mask (H, W) uint8, run on `device`.

    weights_path: a locally downloaded torchvision deeplabv3_resnet50 .pth,
    read with torch.load(weights_only=True). Without weights the model is
    randomly initialized (seed 0), useful only for tests.
    """
    dev = resolve_device(device)
    if weights_path:
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        params, state = import_torch_deeplab(sd, device=dev)
    else:
        print(
            "[segmenter] WARNING: no weights_path — random DeepLab weights "
            "(tests only); download torchvision's deeplabv3_resnet50 .pth "
            "offline for real segmentation"
        )
        params, state = init_deeplab(torch.Generator().manual_seed(0), device=dev)

    def run(img: np.ndarray) -> np.ndarray:
        x = (img.astype(np.float32) / 255.0 - _IMAGENET_MEAN) / _IMAGENET_STD
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None])).to(dev)
            logits = deeplab_logits(params, state, x)
            return (logits[0].argmax(0) == person_class).to(torch.uint8).cpu().numpy()

    return run
