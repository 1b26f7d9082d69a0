"""Experiment output helpers (port of posegen_tpu/utils/experiment.py's
`save_video`)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_video(path: str, frames: np.ndarray, fps: int = 14, **kwargs) -> Optional[str]:
    """mp4 (or, by the path's suffix, GIF) through imageio, imported here,
    lazily: the card's machine has none; kwargs go to imageio.mimwrite.
    Returns None when imageio or its writer for the format is unavailable."""
    u8 = (frames if frames.dtype == np.uint8
          else (np.clip(frames, 0, 1) * 255).astype(np.uint8))
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(u8), fps=fps, **kwargs)
        return path
    except Exception:
        return None
