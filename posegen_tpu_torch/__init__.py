"""posegen_tpu_torch: the PyTorch + CUDA (Hopper) port of posegen_tpu.

The layout mirrors `posegen_tpu` module for module (skeleton/, ops/,
models/, kernels/, render/, train/, utils/). Plain tensor code is PyTorch;
the fused field evaluation and its training pair run in hand-written CUDA
kernels for sm_90a (`kernels/csrc/field.cu`, `field_grad.cu`), built with
nvcc on first CUDA use.

This package imports torch, numpy and the standard library only. Entry
points default to the CUDA device and raise when none is present; pass
``device="cpu"`` to run the plain PyTorch versions on the host.
"""

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.skeleton.skeleton", (
        "Skeleton",
        "SMPL_SKELETON",
        "SMPL_REST_POSE",
    )),
)
__all__ = ["resolve_device", *_EXPORTS]
__getattr__, __dir__ = exports(__name__, _EXPORTS)
