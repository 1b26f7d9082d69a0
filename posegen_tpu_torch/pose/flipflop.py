"""Alternating NeRF / pose optimization scheduler (port of
posegen_tpu/pose/flipflop.py; reference PoseOptFlipFlop,
core/pose_opt.py:584-727).

It decides which parameter group takes updates at each iteration, tracks a
per-frame cumulative moving average of the photometric loss (to spot badly
fitted poses), and marks pose resets and the warmup window. The decisions
are host-side booleans; like the JAX package, the train step does not wire
them in, and a caller masks the updates it does not want.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FlipFlopConfig:
    opt_pose_joint: bool = False  # True: pose turns also train the NeRF
    opt_pose_interval: int = 20  # flip period (iterations)
    opt_pose_warmup: int = 0
    opt_pose_stop: Optional[int] = None
    opt_pose_reset: Optional[int] = None  # reset poses to anchors at step


class PoseOptFlipFlop:
    def __init__(self, cfg: FlipFlopConfig, n_kps: int):
        self.cfg = cfg
        self.pose_turn = bool(cfg.opt_pose_joint)
        self.reset_kp_loss_tracker(n_kps)

    # -- turn logic (reference peek_pose_turn / flipflop, pose_opt.py:627-660)
    def pose_active(self, i: int) -> bool:
        if self.cfg.opt_pose_stop is not None and i > self.cfg.opt_pose_stop:
            return False
        if i < self.cfg.opt_pose_warmup:
            return False
        return self.pose_turn

    def nerf_active(self, i: int) -> bool:
        if self.cfg.opt_pose_joint:
            return True
        return not self.pose_active(i)

    def step(self, i: int) -> Tuple[bool, bool]:
        """Advance to iteration i -> (nerf_active, pose_active)."""
        if self.cfg.opt_pose_interval > 0 and i > 0 and i % self.cfg.opt_pose_interval == 0:
            self.pose_turn = not self.pose_turn
        return self.nerf_active(i), self.pose_active(i)

    def should_reset_pose(self, i: int) -> bool:
        return self.cfg.opt_pose_reset is not None and i == self.cfg.opt_pose_reset

    # -- per-frame loss CMA tracker (reference pose_opt.py:640-660) ----------
    def reset_kp_loss_tracker(self, n_kps: Optional[int] = None):
        if n_kps is None:
            n_kps = self.kp_loss_tracker.shape[0]
        self.kp_loss_tracker = np.ones(n_kps) * 10.0
        self.kp_loss_cnt = np.zeros(n_kps)

    def accumulate_loss(self, loss: np.ndarray, kp_idx: np.ndarray) -> None:
        """loss: per-ray losses; kp_idx: their frame indices.

        CMA update touches only the frames present in the batch (the
        reference's scatter version, pose_opt.py:640-660, would also drag
        every untouched frame toward zero on the first call — a quirk this
        rebuild deliberately fixes so the 10.0 unoptimized-pose prior holds).
        """
        loss = np.asarray(loss).reshape(-1)
        kp_idx = np.asarray(kp_idx).reshape(-1)
        acc = np.zeros_like(self.kp_loss_tracker)
        np.add.at(acc, kp_idx, loss)
        touched = np.zeros_like(self.kp_loss_cnt)
        np.add.at(touched, kp_idx, 1.0)
        self.kp_loss_cnt += touched
        n = np.maximum(self.kp_loss_cnt, 1.0)
        upd = self.kp_loss_tracker + (acc - self.kp_loss_tracker) / n
        self.kp_loss_tracker = np.where(touched > 0, upd, self.kp_loss_tracker)

    def worst_frames(self, k: int = 10) -> np.ndarray:
        """Frames with the highest tracked loss (pose-reset candidates)."""
        return np.argsort(-self.kp_loss_tracker)[:k]
