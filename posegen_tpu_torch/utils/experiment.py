"""Experiment readback and video tooling (port of
posegen_tpu/utils/experiment.py).

Capability parity with the reference's post-hoc analysis helpers
(core/utils/evaluation_helpers.py:28-219): read back TensorBoard event
files and psnr/ssim txt logs for run comparison, pick the best step, find
the videos written at a step, concatenate videos into grids, stamp text
labels onto frames, and write videos.

`add_text_to_video` stamps with a bitmap font of the port's own, in place
of JAX's `cv2.putText(img, text, (8, 24), FONT_HERSHEY_SIMPLEX, 0.7,
(255, 255, 255), 2)`: the printable ASCII characters of Hershey simplex
drawn once at that scale and stroke (cap height 15 pixels, a 2-pixel
stroke) into a bitmap table with cv2's advances
(`tests/data/font/make_font.py` prints it), white, the baseline at y = 24
from x = 8; characters outside printable ASCII print as '?'. It is legible, not bit-equal to cv2's stamp.
`save_video` writes a `.gif` through the port's own `utils/gif.py`, and an
mp4 through imageio where it is installed.
"""

from __future__ import annotations

import base64
import os
from glob import glob
from typing import Dict, Optional, Sequence

import numpy as np

from posegen_tpu_torch.utils.gif import write_gif

FONT_ROWS, FONT_COLS, FONT_ASCENT, FONT_PEN = 25, 24, 20, 2
_FONT_BITS = (
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAA"
    "HgAAHgAAHgAAHgAAHgAAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAP8AAP8AA"
    "H8AAHcAAHcAAHcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAA5wAA7wAA7wAH/8AH/8AH/8ABzgABzgAP/4AP/4AP/4AD3AAD3AADnAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAcAAAcAAA+AAD/gAH/wAH/wAHj4AHwAAH+AAH/gAB/4A"
    "Af4APD4APj4AP/4AH/wAD/gAAeAAAcAAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAABgOAH4eAH48A"
    "O54AO94AP7wAH/gAH/YAAP+AAf/AA93AB53AD53ADx/AHh+AAAYAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAA+AAB/AAD/gAD3gAD3gAD/gAD/AAD+cAH+cAH/8AHv8APn4AH/4AH/8AD/+AAcAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPAAAPAAAHAAAHAAAHAAAHAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPAAAfAAAfAAA+AAA8AAA4AA"
    "B4AAB4AAB4AAB4AAB4AAB4AAB4AAB4AAA8AAA8AAA/AAAfAAAPAAAHAAAAAAAAAAAAAAAAAAAAAA"
    "B4AAB8AAB+AAA+AAAeAAAPAAAPAAAPAAAPAAAPAAAPAAAPAAAPAAAPAAAPAAAeAAB+AAB+AAB8AA"
    "BwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAABwAAH8AAH8AAP+AAH8AAH8AAH8AABQAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAcAAAcAA"
    "AcAAAcAAP/wAP/wAP/wAA8AAAcAAAcAAAcAAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAPAAAPAAAOAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH+AAH+AAH+AAH+AAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgA"
    "APAAAPAAAPAAAeAAAeAAA8AAA8AAB4AAB4AAB4AADwAADwAAHgAAHgAAHgAAPAAAPAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAA+AAD/gAH/wAH/wAHn4APv4APv4AP/4AP/4AP74AH74AH3wAH/wA"
    "D/wAD/gAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAeAAA+AAD+AAH+AAH+AAH+AADeAA"
    "AeAAAeAAAeAAAeAAAeAAH/4AH/4AH/4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA+AA"
    "D/gAD/wAH/wAHjwAHjwAAHwAAPwAAfgAB/AAD+AAH8AAH/4AH/4AH/4AAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAH/wAH/wAH/wAH/wAAPgAA/AAA/AAB/wAB/wAAH4AHD4APj4AP/wAH/wA"
    "D/gAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPgAAPgAAfgAA/gAB/gAB/gAD3gAH3gA"
    "PngAP/4AP/4AP/4AP/4AAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAD/wAD/wA"
    "D/wAD/wAHgAAH+AAH/gAH/wAH/wAAD4APj4APj4AH/wAH/wAD/gAAcAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAPAAAfAAA/AAA+AAB8AAD/AAH/wAH/wAH34APj4APh4AHz4AH/wAH/wAB/gA"
    "AcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/wAH/wAH/wAH/wAAHwAAHgAAPgAAPgAAfAA"
    "AfAAA+AAA+AAA8AAB8AAB4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA+AAD/gAH/wA"
    "H/wAHjwAHjwAH/wAD/gAH/wAH34APj4APj4AH/4AH/wAD/gAAcAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAA+AAD/gAH/wAH/wAPj4APj4APj4AH/wAH/wAD/gAA/gAAfAAA+AAB8AAB8AAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAHgAAAAAAAAAA"
    "AAAAHgAAHgAAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "HgAAHgAAHgAAHgAAAAAAAAAAAAAAHgAAHgAAHgAAHAAAPAAAPAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAHAAAPAAA/AAB+AAH8AAP4AAPgAAPwAAH8AAB+AAA/AAAfAAAHAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/gAH/gAH/gAAAAAAAAAH/gA"
    "H/gAH/gAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAGAAAHAAAHwAA"
    "H4AAD+AAA/AAAfAAA/AAD+AAH8AAHwAAHgAAGAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAB+AAD/gAH/gAP/wAPnwAPHgAAPgAAfAAA/AAA+AAA8AAA8AAA8AAA8AAA8AAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAf4AB/8AD/+AHwPAHv3AHf3AHf3gG5zgG5zgG97gHf/A"
    "Hf/AHveAHwPAD//AB/8AAf4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAeAAA/AAA/AAA/gAB/gAB/gA"
    "B/wADzwADzwAH/4AH/4AH/8AP/8APA8APA+AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "H/AAH/wAH/4AH/4AHh4AHh4AH/4AH/wAH/4AHj4AHh8AHh8AH/4AH/4AH/wAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAfAAB/wAD/4AH/4AHx8AHh8AHgAAHgAAHgAAHg4AHh8AHx8AH/4A"
    "D/4AB/wAAOAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH+AAH/wAH/4AH/4AHj4AHh8AHh8A"
    "Hg8AHg8AHh8AHh8AHj4AH/4AH/4AH/gAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/wA"
    "H/wAH/wAH/wAHgAAHgAAH/wAH/wAH/wAH/gAHgAAHgAAH/wAH/wAH/wAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAH/wAH/wAH/wAH/wAHgAAHgAAH/gAH/wAH/wAH/wAHgAAHgAAHgAAHgAA"
    "HgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAfAAB/wAH/4AH/8AHx8AHg8AHn8AHn8A"
    "Hn8AHn8AHh8AHx8AH/4AD/4AB/wAAOAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHg8AHg8A"
    "Hg8AHg8AHg8AHg8AH/8AH/8AH/8AH/8AHg8AHg8AHg8AHg8AHg8AAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/wAH/4AH/4AH/4AAD4AAD4AAD4AAD4AAD4A"
    "AD4APjwAPnwAP/wAH/gAD/AAA8AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHh4AHj4AHnwA"
    "HvwAH/gAH/AAH+AAH8AAH+AAH/AAH/gAHvgAHvwAHn4AHj4AAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAH/wAH/wAH/wAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgOAHgfAHwfAH4/AH4/AH9/AH//AH//AH//AHvvA"
    "HvvAHnPAHgPAHgPAHgPAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHg4AHh4AHx4AH54A"
    "H54AH94AH/4AH/4AH/4AHv4AHv4AHn4AHj4AHj4AHh4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAfAAB/wAD/4AH/4AHx4AHh8AHh8AHh8AHh8AHh8AHh8AHz4AH/4AD/4AB/gAAOAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH+AAH/wAH/4AH/4AHh4AHh4AHj4AH/4AH/4AH/gAHgAA"
    "HgAAHgAAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAfAAB/wAD/4AH/4AHx4A"
    "Hh8AHh8AHh8AHh8AHh8AHh8AHz4AH/4AD/4AB/4AAP8AAA8AAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAH+AAH/wAH/4AH/4AHh4AHh4AHj4AH/4AH/wAH/gAHnwAHnwAHj4AHj4AHh8AAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAA+AAD/gAH/wAH/wAHj4AHwAAH+AAH/gAB/4AAf4APD4APj4A"
    "P/4AH/wAD/gAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAP/wAP/4AP/4AP/4AA8AAA8AA"
    "A8AAA8AAA8AAA8AAA8AAA8AAA8AAA8AAA8AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "Hg8AHg8AHh8AHh8AHh8AHh8AHh8AHh8AHh8AHh8AHx8AHz4AH/4AD/4AB/wAAOAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAPA8APB8APh8AHh4AHj4AHz4ADzwAD3wAD/wAB/gAB/gAB/gAA/AA"
    "A/AAA/AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPAHAPAPAPgPAHnPAHvPAHv/AHv/A"
    "H/+AH/+AD/+AD9+AD9+AD5+AD48AB48AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPB4A"
    "Ph8AHz4AH/wAD/wAB/gAB/AAA/AAA/AAB/gAD/wAD/wAH34APj8APh8AAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAPA8APh8APh4AHz4AH3wAD/wAB/gAB/gAA/AAA+AAAeAAAeAAAeAAAeAA"
    "AeAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/wAP/wAP/wAP/wAAPwAAfgAAfAAA/AA"
    "B+AAD8AAH4AAHwAAP/4AP/4AP/4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH4AAH4AAH4AA"
    "HgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAH4AAH4AAH4AAH4AAAAAAAAAA"
    "AAAAAAAAAAAAPAAAPAAAHgAAHgAAHgAADwAADwAAB4AAB4AAA8AAA8AAA8AAAeAAAeAAAPAAAPAA"
    "APAAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAP4AAP4AAP4AAB4AAB4AAB4AAB4AAB4AAB4AAB4AA"
    "B4AAB4AAB4AAB4AAB4AAB4AAP4AAP4AAP4AAP4AAAAAAAAAAAAAAAAAAAAAAAAAAD4AAH8AAH+AA"
    "GMAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/8AP/8AP/8A"
    "H/8AAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAAHwAAD4AAB4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "B+AAH/AAH/gAHngAA/gAH/gAH/gAPHgAP/gAP/gAH/gABwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAHgAAHgAAHgAAHgAAH/AAH/gAH/wAH3wAHjwAHjwAHjwAHjwAH/wAH/wAH/gAAOAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAB+AAD/gAH/gAHnwAPngAPgAAPgAA"
    "HnwAH/gAH/gAD/AAAcAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAADwAADwAADwAADwAD/wA"
    "H/wAH/wAHnwAPjwAPjwAPjwAPnwAH/wAH/wAD/wAA4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAB+AAD/AAH/gAHngAP/gAP/wAP/wAHjgAH/gAH/gAD/AAA8AAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAOAAB+AAD+AAD+AADwAAP+AAP+AAP+AADwAADwAADwAADwAADwAA"
    "DwAADwAADwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAD/wAH/wA"
    "H/wAHnwAPjwAPjwAPjwAHnwAH/wAH/wAD/wAHjwAHnwAH/gAD/AAB+AAAAAAAAAAAAAAAAAAAAAA"
    "HgAAHgAAHgAAHgAAH/AAH/gAH/wAH3wAHjwAHjwAHjwAHjwAHjwAHjwAHjwAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAAAAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAA"
    "HgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAAAAAHgAAHgAAHgAA"
    "HgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAfgAAfgAAfAAAAAAAAAAAAAAAAAAAAAAAAAAAHgAA"
    "HgAAHgAAHgAAHngAHvgAH/AAH+AAH8AAH8AAH+AAH/AAH/gAHvgAHnwAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAAHgAA"
    "HgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/fAH//gH//gH33w"
    "HnjwHnjwHnjwHnjwHnjwHnjwHnjwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAH/AAH/gAH/wAH3wAHjwAHjwAHjwAHjwAHjwAHjwAHjwAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAB/AAD/gAH/gAHnwAPnwAPjwAPjwAHnwAH/gAH/gAD/AA"
    "AYAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAH/AAH/gAH/wAH3wAHjwA"
    "HjwAHjwAHjwAH/wAH/wAH/gAHuAAHgAAHgAAHgAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAD/wAH/wAH/wAHnwAPjwAPjwAPjwAPnwAH/wAH/wAD/wAA7wAADwAADwAADwAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAH+AAH+AAH+AAH+AAHgAAHgAAHgAAHgAAHgAAHgAAHgAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAD+AAH/AAH/AAPnAAH8AAH/AA"
    "D/gAAfgAPvgAP/AAH/AAA4AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAADwAADwAADwAADwAA"
    "P+AAP+AAP+AADwAADwAADwAADwAADwAAD+AAD+AAB+AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAHjwAHjwAHjwAHjwAHjwAHjwAHjwAHnwAH/wAH/wAD/wAA4AAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPDwAPDwAPngAHngAHvgAD/AAD/AA"
    "D+AAB+AAB+AAA8AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPHHg"
    "PPHgPPvAHvvAH/vAH/+AD/+AD9+AD9+AB58AB48AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAPHwAPngAH/gAD/AAD+AAB+AAD+AAD/AAH/gAPvgAPHwAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAPDwAPDwAPnwAHngAH/gAD/AAD/AAB+AA"
    "B+AAB+AAA8AAB8AAB4AAD4AADwAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAP/AAP/AA"
    "P/AAAfAAA+AAB8AAD4AAH4AAP/gAP/gAP/gAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA8AA"
    "B8AAD8AAD4AADwAADwAADwAAHgAAPgAAPgAAPgAAHgAAHgAADwAADwAADwAAD8AAB8AAB8AAAMAA"
    "AAAAAAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAAHAAA"
    "HAAAHAAAHAAAHAAAHAAAHAAAHAAAAAAAAAAAAAAAAAAAPAAAPgAAPwAADwAADwAAB4AAB4AAB4AA"
    "B8AAA+AAB+AAB8AAB4AAB4AAB4AADwAAPwAAPwAAPgAAOAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
    "AAAAAAAAAAAAAAAAAAAAAAAAH/gAH/gAH/gAG/AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"
)
_FONT_ADVANCE = (
    5, 5, 8, 13, 13, 16, 14, 4, 13, 13, 9, 12, 5, 9, 5, 10, 13, 13, 13, 13, 13, 13, 13, 13,
    13, 13, 5, 5, 10, 11, 10, 11, 17, 14, 14, 14, 14, 12, 12, 14, 14, 6, 13, 13, 11, 16, 14, 14,
    13, 14, 13, 13, 12, 14, 13, 16, 13, 13, 12, 7, 10, 7, 9, 15, 7, 11, 12, 11, 12, 11, 8, 12,
    12, 5, 5, 11, 5, 18, 12, 12, 12, 12, 8, 11, 9, 12, 11, 16, 11, 11, 11, 8, 5, 8, 11,
)

TEXT_ORIGIN = (8, 24)  # cv2.putText's org in add_text_to_video: x, baseline y


def _font() -> np.ndarray:
    bits = np.frombuffer(base64.b64decode("".join(_FONT_BITS)), np.uint8)
    return np.unpackbits(bits.reshape(95, FONT_ROWS, FONT_COLS // 8), axis=-1).astype(bool)


def read_tfevent(log_dir: str, tags: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Scalars from the newest tfevents file -> {tag: (N, 2) [step, value]}
    (reference evaluation_helpers.py:28-67). Needs the tensorboard package:
    raises ImportError naming it where it is not installed."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError as e:
        raise ImportError(f"read_tfevent needs the tensorboard package ({e})") from e

    files = sorted(glob(os.path.join(log_dir, "events.out.tfevents.*")))
    if not files:
        return {}
    acc = EventAccumulator(files[-1])
    acc.Reload()
    out = {}
    for tag in tags or acc.Tags().get("scalars", []):
        try:
            events = acc.Scalars(tag)
        except KeyError:
            continue
        out[tag] = np.array([[e.step, e.value] for e in events], np.float64)
    return out


def read_eval_result(log_dir: str, metric: str = "psnr") -> np.ndarray:
    """Parse the tab-separated psnr/ssim txt appends -> (N, 2) [step, value]
    (reference evaluation_helpers.py:69-110; write side cli/run_nerf.py)."""
    path = os.path.join(log_dir, f"{metric}.txt")
    rows = []
    if not os.path.exists(path):
        return np.zeros((0, 2))
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 1:
                rows.append([len(rows), float(parts[0])])
            elif len(parts) >= 2:
                rows.append([float(parts[0]), float(parts[1])])
    return np.asarray(rows, np.float64)


def best_value_and_step(scalars: np.ndarray, maximum: bool = True) -> tuple:
    """(best value, its step) from an (N, 2) [step, value] scalar track
    (reference get_best_values_n_steps, evaluation_helpers.py:109-119)."""
    if scalars.shape[0] == 0:
        return float("nan"), -1
    idx = int(np.argmax(scalars[:, 1]) if maximum else np.argmin(scalars[:, 1]))
    return float(scalars[idx, 1]), int(scalars[idx, 0])


def find_step_videos(log_dirs: Sequence[str], steps: Sequence[int],
                     keyword: str = "_{:06d}", postfix: str = "rgb.gif") -> list:
    """Per run, the video written at a given step (reference
    retrieve_best_vid_files, evaluation_helpers.py:121-138). Missing or
    ambiguous matches raise FileNotFoundError."""
    names = []
    for log_dir, step in zip(log_dirs, steps):
        pattern = os.path.join(log_dir, f"*{keyword.format(step)}*{postfix}")
        matches = [f for f in glob(pattern) if "text_" not in f]
        if len(matches) != 1:
            raise FileNotFoundError(f"{pattern}: expected exactly one video, found {matches}")
        names.append(matches[0])
    return names


def concat_video_grid(videos: Sequence[np.ndarray], n_cols: int = 2, pad: int = 2) -> np.ndarray:
    """Stack (T, H, W, 3) videos into a grid video
    (reference concat_vid, evaluation_helpers.py:140-190)."""
    T = min(v.shape[0] for v in videos)
    H = max(v.shape[1] for v in videos)
    W = max(v.shape[2] for v in videos)
    n_rows = (len(videos) + n_cols - 1) // n_cols
    grid = np.zeros((T, n_rows * (H + pad), n_cols * (W + pad), 3), videos[0].dtype)
    for i, v in enumerate(videos):
        r, c = divmod(i, n_cols)
        grid[:, r * (H + pad):r * (H + pad) + v.shape[1],
             c * (W + pad):c * (W + pad) + v.shape[2]] = v[:T]
    return grid


def _stamp_mask(h: int, w: int, text: str) -> np.ndarray:
    """(h, w) bool: the pixels the label covers (module docstring)."""
    font = _font()
    mask = np.zeros((h, w), bool)
    pen = TEXT_ORIGIN[0]
    top = TEXT_ORIGIN[1] - FONT_ASCENT
    for ch in text:
        code = ord(ch) - 32 if 32 <= ord(ch) < 127 else ord("?") - 32
        g = font[code]
        left = pen - FONT_PEN
        y0, x0 = max(top, 0), max(left, 0)
        y1, x1 = min(top + g.shape[0], h), min(left + g.shape[1], w)
        if y0 < y1 and x0 < x1:
            mask[y0:y1, x0:x1] |= g[y0 - top:y1 - top, x0 - left:x1 - left]
        pen += _FONT_ADVANCE[code]
    return mask


def add_text_to_video(frames: np.ndarray, text: str) -> np.ndarray:
    """Stamp a white label on every frame -> uint8 frames (reference
    add_text_to_vid, evaluation_helpers.py:192-219); float frames are
    clipped to [0, 1] and scaled to uint8 first, as JAX does."""
    out = []
    mask = None
    for f in frames:
        img = np.array((np.clip(f, 0, 1) * 255).astype(np.uint8) if f.dtype != np.uint8 else f)
        if mask is None:
            mask = _stamp_mask(img.shape[0], img.shape[1], text)
        img[mask] = 255
        out.append(img)
    return np.stack(out)


def save_video(path: str, frames: np.ndarray, fps: int = 14, **kwargs) -> Optional[str]:
    """Write frames (uint8, or float clipped to [0, 1]) -> path. A `.gif`
    path goes through `utils/gif.write_gif` (kwargs: its `loop`); any other
    path through imageio, imported here lazily (kwargs go to
    imageio.mimwrite), which returns None where imageio or its writer for
    the format is unavailable, as JAX's does."""
    u8 = (frames if frames.dtype == np.uint8
          else (np.clip(frames, 0, 1) * 255).astype(np.uint8))
    if path.lower().endswith(".gif"):
        return write_gif(path, u8, fps=fps, **kwargs)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(path, list(u8), fps=fps, **kwargs)
        return path
    except Exception:
        return None
