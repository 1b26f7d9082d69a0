"""Image quality metrics: PSNR and gaussian-window (MS-)SSIM (port of
posegen_tpu/evals/image.py).

Capability parity with the reference's vendored pytorch-msssim
(pytorch_msssim/__init__.py:19-132: 11x11 gaussian window, per-channel
grouped conv, optional per-pixel map) and its PSNR/SSIM eval harness
(core/utils/evaluation_helpers.py:257-385: full-image, foreground-masked and
valid-bbox variants). Images are (H, W, C) or (B, H, W, C), as in the JAX
package. The window is a depthwise `F.conv2d` (groups = C) and the
MS-SSIM downsampling an `F.avg_pool2d`, both with TF32 off: cuDNN takes
TF32 for float32 convolutions by default, and the metrics stay float32
whatever `torch.backends.cudnn.allow_tf32` says.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from posegen_tpu_torch.device import resolve_device


def psnr(pred: torch.Tensor, target: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """PSNR over the (optionally masked) pixels; inputs in [0, 1]."""
    se = (pred - target) ** 2
    if mask is not None:
        m = mask[..., None] if mask.dim() == se.dim() - 1 else mask
        m = m.to(se.dtype).expand(se.shape)
        mse = (se * m).sum() / torch.clamp(m.sum(), min=1.0)
    else:
        mse = se.mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@contextlib.contextmanager
def _float32_convolutions():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _depthwise_conv(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) depthwise 2-D convolution, VALID padding."""
    C = img.shape[1]
    return F.conv2d(img, window.expand(C, 1, *window.shape), groups=C)


def ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    val_range: float = 1.0,
    size_average: bool = True,
    full_map: bool = False,
):
    """Gaussian-window SSIM (reference pytorch_msssim/__init__.py:19-70).

    pred/target: (H, W, C) or (B, H, W, C) in [0, val_range].
    full_map=True returns the per-pixel SSIM map, (H', W', C) or
    (B, H', W', C); else (mean ssim, mean cs), per image when not
    size_average.
    """
    squeeze = pred.dim() == 3
    if squeeze:
        pred, target = pred[None], target[None]
    # clamp the window to the image (reference __init__.py:38: real_size =
    # min(window_size, height, width)): small MS-SSIM scales would otherwise
    # give an empty VALID conv (NaN mean)
    window_size = min(window_size, pred.shape[1], pred.shape[2])
    w = torch.as_tensor(_gaussian_window(window_size, sigma)).to(pred.device)
    p, t = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)

    with _float32_convolutions():
        mu1 = _depthwise_conv(p, w)
        mu2 = _depthwise_conv(t, w)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = _depthwise_conv(p * p, w) - mu1_sq
        s2 = _depthwise_conv(t * t, w) - mu2_sq
        s12 = _depthwise_conv(p * t, w) - mu12

    c1 = (0.01 * val_range) ** 2
    c2 = (0.03 * val_range) ** 2
    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    ssim_map = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map

    if full_map:
        out = ssim_map.permute(0, 2, 3, 1)
        return out[0] if squeeze else out
    if size_average:
        return ssim_map.mean(), cs_map.mean()
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def _pool2(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> 2x2 average pool, VALID (odd edges dropped)."""
    return F.avg_pool2d(img.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def ms_ssim(
    pred: torch.Tensor,
    target: torch.Tensor,
    weights: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    window_size: int = 11,
    val_range: float = 1.0,
) -> torch.Tensor:
    """Multi-scale SSIM (reference pytorch_msssim/__init__.py:73-108):
    product of per-scale contrast terms with 2x average-pool downsampling."""
    if pred.dim() == 3:
        pred, target = pred[None], target[None]
    mssim, mcs = [], []
    for _ in weights:
        s, cs = ssim(pred, target, window_size=window_size, val_range=val_range)
        mssim.append(torch.clamp(s, 0.0, 1.0))
        mcs.append(torch.clamp(cs, 0.0, 1.0))
        pred, target = _pool2(pred), _pool2(target)
    w = torch.tensor(weights, dtype=torch.float32).to(pred.device)
    mcs_s = torch.stack(mcs)
    return torch.prod(mcs_s[:-1] ** w[:-1]) * mssim[-1] ** w[-1]


def evaluate_metric(
    rgbs: np.ndarray,
    gts: np.ndarray,
    fgs: Optional[np.ndarray] = None,
    bboxes: Optional[np.ndarray] = None,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Per-image PSNR/SSIM in the reference's three variants
    (evaluation_helpers.py:257-385): full image, valid-bbox crop, fg-masked,
    computed on `device`.

    rgbs/gts: (N, H, W, 3) float in [0,1]; fgs: (N, H, W[,1]);
    bboxes: (N, 4) [x0, y0, x1, y1].
    """
    dev = resolve_device(device)
    on_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
    out: Dict[str, list] = {"psnr": [], "ssim": []}
    if bboxes is not None:
        out["psnr_box"], out["ssim_box"] = [], []
    if fgs is not None:
        out["psnr_fg"] = []
    for i in range(rgbs.shape[0]):
        p, g = on_dev(rgbs[i]), on_dev(gts[i])
        out["psnr"].append(float(psnr(p, g)))
        out["ssim"].append(float(ssim(p, g)[0]))
        if bboxes is not None:
            x0, y0, x1, y1 = [int(v) for v in bboxes[i]]
            pc, gc = p[y0:y1, x0:x1], g[y0:y1, x0:x1]
            if pc.shape[0] >= 11 and pc.shape[1] >= 11:
                out["psnr_box"].append(float(psnr(pc, gc)))
                out["ssim_box"].append(float(ssim(pc, gc)[0]))
        if fgs is not None:
            m = on_dev(fgs[i]).reshape(p.shape[0], p.shape[1])
            out["psnr_fg"].append(float(psnr(p, g, m)))
    return {k: np.asarray(v) for k, v in out.items()}
