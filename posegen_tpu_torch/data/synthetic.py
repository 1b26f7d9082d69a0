"""Synthetic scenes (port of posegen_tpu/data/synthetic.py): the look-at
camera of the synthetic dataset builder, which the bullet-time renders
(`render.image._bullet_c2ws`) build on."""

from __future__ import annotations

import numpy as np


def _look_at_c2w(origin: np.ndarray, target: np.ndarray) -> np.ndarray:
    """NeRF-convention camera-to-world looking from origin at target."""
    fwd = target - origin
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    # NeRF convention: x right, y up, z backward
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, origin
    return c2w
