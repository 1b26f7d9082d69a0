"""Pose refinement: per-frame pose parameters, their regularizers and the
NeRF / pose flip-flop schedule."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.pose.opt", (
        "PoseOptConfig",
        "init_pose_params",
        "pose_apply",
        "kp_reg_loss",
        "get_kp_reg_loss",
        "mpjpc_stat",
        "temporal_loss",
        "pose_params_to_pose_data",
    )),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
