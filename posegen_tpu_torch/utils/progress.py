"""Terminal progress bar with ETA (port of posegen_tpu/utils/progress.py).

Capability parity with the reference's vendored `progress` package
(progress/bar.py:22 `Bar`, used by the GAN loop run_gan.py:1984): a
suffix-templated bar with elapsed/ETA, plus an `avg`-tracking meter
(the reference's AverageMeter, run_gan.py:601-617).
"""

from __future__ import annotations

import sys
import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _fmt_td(seconds: float) -> str:
    seconds = int(max(seconds, 0))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    return f"{h}:{m:02d}:{s:02d}" if h else f"{m}:{s:02d}"


class Bar:
    """`bar = Bar('Train', max=N); ...; bar.next(); bar.finish()`."""

    def __init__(self, message: str = "", max: int = 100, width: int = 24, stream=None):
        self.message = message
        self.max = max
        self.width = width
        self.index = 0
        self.start = time.time()
        self.suffix = ""
        self.stream = stream or sys.stderr

    @property
    def elapsed(self) -> float:
        return time.time() - self.start

    @property
    def elapsed_td(self) -> str:
        return _fmt_td(self.elapsed)

    @property
    def eta(self) -> float:
        if self.index == 0:
            return 0.0
        return self.elapsed / self.index * (self.max - self.index)

    @property
    def eta_td(self) -> str:
        return _fmt_td(self.eta)

    def _render(self):
        frac = self.index / max(self.max, 1)
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        line = f"\r{self.message} |{bar}| {self.index}/{self.max}"
        if self.suffix:
            line += f" {self.suffix}"
        self.stream.write(line)
        self.stream.flush()

    def next(self, n: int = 1):
        self.index = min(self.index + n, self.max)
        self._render()

    def finish(self):
        self._render()
        self.stream.write("\n")
        self.stream.flush()
