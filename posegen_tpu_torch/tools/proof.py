"""What the purpose experiments share (exp_bf16_delta, exp_poseopt,
exp_mining, exp_capstone_ft and flagship_demo): their default paths, the
device they run on, and the TF32 setting they write into their results.

The JAX tools write to fixed paths under the repository. The port's tools
take each directory as an argument; a path under the checkout is its
default only when the package sits in a checkout of the repository (its
`configs/` beside the package), and outside one the argument is required.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from posegen_tpu_torch.device import resolve_device

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checkout_root() -> Optional[str]:
    """The repository's root when this package sits in a checkout (its
    configs beside the package), else None."""
    root = os.path.dirname(_PACKAGE)
    return root if os.path.isfile(os.path.join(root, "configs", "synthetic", "demo.txt")) else None


def checkout_path(*parts: str) -> Optional[str]:
    """A path under the checkout, or None outside one."""
    root = checkout_root()
    return None if root is None else os.path.join(root, *parts)


def required(path: Optional[str], flag: str) -> str:
    """`path`, or exit naming the flag that must give it (no checkout)."""
    if not path:
        raise SystemExit(f"{flag}: no default outside a checkout of the repository; pass it")
    return path


def config_path(rel: str) -> str:
    """A config the JAX tool names relative to the repository's root: under
    the checkout when there is one, else as given (relative to the working
    directory)."""
    return checkout_path(rel) or rel


def tool_device(device, cpu_flag: bool) -> torch.device:
    """The device a tool runs on: CUDA unless the caller passed
    device='cpu' or the tool's --cpu flag; no card raises (device.py)."""
    return resolve_device("cpu" if cpu_flag else device)


def set_tf32(enabled: bool = False) -> Dict[str, bool]:
    """Set PyTorch's two TF32 switches (matmul and cuDNN), off by default as
    the port's parity rules run them -> the setting, for a summary JSON."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    return {"matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32)}
