"""The default-device rule of the port: CUDA, or an explicit device.

Entry points take ``device="cuda"`` by default. Without a card that raises
here, with a message naming the way out; nothing switches to the CPU on its
own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device; raises RuntimeError for a CUDA device on a host
    without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "posegen_tpu_torch: no CUDA device is available (torch "
            f"{torch.__version__}); pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    return dev
