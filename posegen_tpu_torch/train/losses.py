"""Photometric + regularization losses (port of posegen_tpu/train/losses.py;
reference core/trainer.py:8-61). Every loss returns a scalar float32."""

from __future__ import annotations

import torch


def img2mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def img2l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def img2huber(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.1) -> torch.Tensor:
    abs_err = torch.abs(pred - target)
    quad = torch.clamp(abs_err, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (abs_err - quad))


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def acc2bce(acc: torch.Tensor, fg: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Binary cross-entropy pushing accumulated alpha toward the fg mask,
    averaged over background pixels only (fg < 1), as the reference's live
    reg path does (reduction='off', core/trainer.py:44-52, :378)."""
    bce = -(fg * torch.log(acc + eps) + (1.0 - fg) * torch.log(1.0 - acc + eps))
    bg = (fg < 1.0).to(bce.dtype)
    return torch.sum(bce * bg) / torch.clamp(torch.sum(bg), min=1.0)


def rgb_loss(loss_fn: str, pred: torch.Tensor, target: torch.Tensor,
             beta: float = 0.1) -> torch.Tensor:
    if loss_fn == "MSE":
        return img2mse(pred, target)
    if loss_fn == "L1":
        return img2l1(pred, target)
    if loss_fn == "Huber":
        return img2huber(pred, target, delta=beta)
    raise NotImplementedError(f"loss_fn {loss_fn!r}")
