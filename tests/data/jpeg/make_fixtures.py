"""Writes the JPEG fixtures of this directory and their manifest.

    python tests/data/jpeg/make_fixtures.py

Each file is written by PIL or cv2 from an image drawn from a seed; the
manifest holds each file's shape and the SHA-256 of the array bytes that
`imageio.v2.imread` returns for it (PIL on libjpeg-turbo, defaults). The
port's decoder is held to those hashes on any machine, one without PIL,
cv2 or imageio included (tests/test_torch_jpeg.py, and chip_smoke.py phase
14 on the card). The port never imports this script.
"""

from __future__ import annotations

import hashlib
import io
import json
import os

import cv2
import imageio.v2 as imageio
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
FULL = "frame_1080x1920_420.jpg"  # the full-size frame chip_smoke decodes and times


def _smooth(h: int, w: int) -> np.ndarray:
    """A smooth RGB image (gradients and one ring): small files at any size."""
    y, x = np.mgrid[:h, :w].astype(np.float64)
    r = np.hypot(y - h / 2, x - w / 3) / max(h, w)
    img = np.stack([255 * y / max(h - 1, 1), 255 * x / max(w - 1, 1),
                    127.5 + 127.5 * np.cos(12 * r)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _noisy(h: int, w: int, seed: int) -> np.ndarray:
    noise = np.random.default_rng(seed).normal(0, 24, (h, w, 3))
    return np.clip(_smooth(h, w) + noise, 0, 255).astype(np.uint8)


def _pil(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, format="JPEG", **kw)
    return b.getvalue()


def _cv2(img: np.ndarray, **kw) -> bytes:
    params = []
    for k, v in kw.items():
        params += [getattr(cv2, k), v]
    ok, enc = cv2.imencode(".jpg", img[..., ::-1] if img.ndim == 3 else img, params)
    assert ok
    return enc.tobytes()


def fixtures():
    """name -> JPEG bytes."""
    return {
        "q50_444_17x33.jpg": _pil(_noisy(17, 33, 1), quality=50, subsampling=0),
        "q75_422_250x333.jpg": _pil(_noisy(250, 333, 2), quality=75, subsampling=1),
        "q95_420_250x333.jpg": _pil(_noisy(250, 333, 3), quality=95, subsampling=2),
        "q90_440_31x45_cv2.jpg": _cv2(_noisy(31, 45, 5), IMWRITE_JPEG_QUALITY=90,
                                      IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "grey_q85_37x29.jpg": _pil(_noisy(37, 29, 6)[..., 1], quality=85),
        "optimized_420_64x48.jpg": _pil(_noisy(64, 48, 7), quality=80, optimize=True),
        "restart_420_71x53_cv2.jpg": _cv2(_noisy(71, 53, 8), IMWRITE_JPEG_QUALITY=85,
                                          IMWRITE_JPEG_RST_INTERVAL=3),
        "one_pixel_420.jpg": _pil(_noisy(1, 1, 9), quality=90, subsampling=2),
        "adobe_rgb_24x40.jpg": _pil(_noisy(24, 40, 10), quality=90, keep_rgb=True),
        FULL: _cv2(_smooth(1080, 1920), IMWRITE_JPEG_QUALITY=90,
                   IMWRITE_JPEG_SAMPLING_FACTOR=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
    }


def array_sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def main() -> None:
    manifest = {}
    for name, data in sorted(fixtures().items()):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        a = np.asarray(imageio.imread(path))
        manifest[name] = {"shape": list(a.shape), "sha256": array_sha256(a)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
