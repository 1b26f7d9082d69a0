"""Print the bitmap font table of `posegen_tpu_torch/utils/experiment.py`.

    python tests/data/font/make_font.py

Each printable ASCII character (32-126) is drawn with OpenCV's Hershey
simplex font at scale 0.7, thickness 2 (cv2.putText's in the JAX package's
add_text_to_video), 8-connected (cv2.LINE_8), into a cell of FONT_ROWS x
FONT_COLS bits: the baseline FONT_ASCENT rows from the top, the pen
FONT_PEN columns from the left. Its advance is measured over a run of 40
copies, in whole pixels. The table is printed as the module's literals.
"""

import base64

import cv2
import numpy as np

FONT = cv2.FONT_HERSHEY_SIMPLEX
ROWS, COLS, ASCENT, PEN = 25, 24, 20, 2


def glyph(c: str) -> np.ndarray:
    img = np.zeros((ROWS, COLS), np.uint8)
    cv2.putText(img, c, (PEN, ASCENT), FONT, 0.7, 255, 2, cv2.LINE_8)
    return (img > 0).astype(np.uint8)


def advance(c: str) -> int:
    w = lambda n: cv2.getTextSize(c * n, FONT, 0.7, 2)[0][0]  # noqa: E731
    return int(round((w(40) - w(20)) / 20))


if __name__ == "__main__":
    chars = [chr(i) for i in range(32, 127)]
    bits = np.packbits(np.stack([glyph(c) for c in chars]), axis=-1)  # (95, ROWS, COLS // 8)
    text = base64.b64encode(bits.tobytes()).decode()
    print(f"FONT_ROWS, FONT_COLS, FONT_ASCENT, FONT_PEN = {ROWS}, {COLS}, {ASCENT}, {PEN}")
    print("_FONT_BITS = (")
    for i in range(0, len(text), 76):
        print(f'    "{text[i:i + 76]}"')
    print(")")
    adv = [str(advance(c)) for c in chars]
    print("_FONT_ADVANCE = (")
    for i in range(0, len(adv), 24):
        print("    " + ", ".join(adv[i:i + 24]) + ",")
    print(")")
