"""3-D pose metrics: MPJPE, Procrustes-aligned PA-MPJPE, PCK, AUC (port of
posegen_tpu/evals/pose.py).

Capability parity with the reference's pose evaluation
(core/utils/evaluation_helpers.py:387-612 `procrustes`/
`Criterion3DPose_*`/`evaluate_pampjpe_from_smpl_params`, and the numpy
similarity transform + PCK in run_gan.py:1380-1464). Batched in PyTorch
(`torch.linalg.svd` over the batch, cuSOLVER on the card, as JAX's is plain
XLA); the 3 x 3 products are `torch.matmul` in float32.
`evaluate_pose_batch` keeps the eval CLIs host-simple: numpy in, floats out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error. pred/gt: (..., J, 3)."""
    return torch.linalg.norm(pred - gt, dim=-1).mean()


def similarity_transform(
    S1: torch.Tensor, S2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optimal similarity transform (scale, R, t) aligning S1 -> S2.

    S1/S2: (..., J, 3). Returns (S1_hat (..., J, 3), scale (...), R (..., 3,
    3), t (..., 3, 1)): the orthogonal Procrustes solution with the
    reflection guard d = sign(det(V U^T)) (a sign of 0 kept as 0, as JAX's
    jnp.sign gives it; reference run_gan.py:1380-1434).
    """
    mu1 = S1.mean(-2, keepdim=True)
    mu2 = S2.mean(-2, keepdim=True)
    X1, X2 = S1 - mu1, S2 - mu2
    var1 = (X1 ** 2).sum((-2, -1))
    K = torch.matmul(X1.transpose(-1, -2), X2)
    U, s, Vt = torch.linalg.svd(K)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(torch.matmul(V, Ut)))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = torch.matmul(V * diag[..., None, :], Ut)
    scale = (s * diag).sum(-1) / torch.clamp(var1, min=1e-12)
    t = mu2.transpose(-1, -2) - scale[..., None, None] * torch.matmul(R, mu1.transpose(-1, -2))
    S1_hat = scale[..., None, None] * torch.matmul(R, S1.transpose(-1, -2)) + t
    return S1_hat.transpose(-1, -2), scale, R, t


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Batched Procrustes alignment of pred onto gt: (..., J, 3)."""
    return similarity_transform(pred, gt)[0]


def pa_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Procrustes-aligned MPJPE (reconstruction error, run_gan.py:1437-1456)."""
    return mpjpe(procrustes_align(pred, gt), gt)


def per_joint_error(pred: torch.Tensor, gt: torch.Tensor, align: bool = False) -> torch.Tensor:
    if align:
        pred = procrustes_align(pred, gt)
    return torch.linalg.norm(pred - gt, dim=-1)


def pck(errors: torch.Tensor, threshold: float = 0.150) -> torch.Tensor:
    """Fraction of joints strictly under `threshold` (meters; the reference
    computes `(pampjpe < 150).mean()` on mm errors and reports the raw
    fraction, evaluation_helpers.py:592-595)."""
    return (errors < threshold).float().mean()


def auc(errors: torch.Tensor, max_threshold: float = 0.150, steps: int = 31) -> torch.Tensor:
    """Mean PCK over `steps` thresholds linspaced on [0, max_threshold]
    (the reference averages pck_at_t over linspace(0, 150, 31) rather than
    integrating, evaluation_helpers.py:597-603); returns a fraction."""
    ths = torch.linspace(0.0, max_threshold, steps, dtype=torch.float32, device=errors.device)
    return (errors.reshape(-1)[None] < ths[:, None]).float().mean(-1).mean()


def evaluate_pose_batch(
    pred: np.ndarray,
    gt: np.ndarray,
    pelvis_idx: Optional[Tuple[int, ...]] = None,
    device="cuda",
) -> dict:
    """Full metric suite for a batch of poses (meters in, mm out), computed
    on `device`.

    pelvis_idx: joints whose mean is subtracted as root alignment
    (reference uses hip midpoints for 14-joint evals)."""
    dev = resolve_device(device)
    pred = torch.as_tensor(np.asarray(pred), device=dev)
    gt = torch.as_tensor(np.asarray(gt), device=dev)
    if pelvis_idx is not None:
        pi = torch.as_tensor(pelvis_idx, device=dev)
        pred = pred - pred[..., pi, :].mean(-2, keepdim=True)
        gt = gt - gt[..., pi, :].mean(-2, keepdim=True)
    errs = per_joint_error(pred, gt)
    errs_pa = per_joint_error(pred, gt, align=True)
    return {
        "mpjpe": float(errs.mean()) * 1000.0,
        "pa_mpjpe": float(errs_pa.mean()) * 1000.0,
        "pck": float(pck(errs_pa)),
        "auc": float(auc(errs_pa)),
    }
