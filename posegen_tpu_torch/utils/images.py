"""`read_image(path)`: the port's image reader, by the file's signature:
PNG to `utils/png.read_png`, JPEG (FF D8 FF) to `utils/jpeg.read_jpeg`.
Anything else raises ValueError naming the file."""

from __future__ import annotations

import numpy as np

from posegen_tpu_torch.utils import jpeg, png


def read_image(path: str) -> np.ndarray:
    """-> what imageio.v2.imread gives for the same PNG or JPEG file."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == png.SIGNATURE:
        return png.read_png(path)
    if head[:3] == jpeg.SIGNATURE:
        return jpeg.read_jpeg(path)
    raise ValueError(f"{path}: not a PNG or JPEG file (first bytes {head[:4].hex()})")
