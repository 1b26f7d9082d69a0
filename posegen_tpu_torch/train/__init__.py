"""Training: losses and the weights-only NeRF train step."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.train.trainer", (
        "TrainConfig",
        "TrainState",
        "create_train_state",
        "make_train_step",
        "nerf_optimizer",
        "pose_lr",
        "pose_update",
    )),
    ("posegen_tpu_torch.train.losses", ("losses",)),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
