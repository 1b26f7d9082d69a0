"""Evaluation metrics (port of posegen_tpu/evals/): image metrics, pose
metrics, and the SPIN evaluation harness (`evals/harness.py`)."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.evals.image", (
        "psnr",
        "ssim",
        "ms_ssim",
        "evaluate_metric",
    )),
    ("posegen_tpu_torch.evals.pose", (
        "mpjpe",
        "pa_mpjpe",
        "procrustes_align",
        "pck",
        "auc",
        "similarity_transform",
    )),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
