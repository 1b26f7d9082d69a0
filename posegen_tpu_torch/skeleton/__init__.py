"""Skeleton tables, rotations, forward kinematics and bounding geometry."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.skeleton.skeleton", (
        "Skeleton",
        "SMPL_SKELETON",
        "SMPL_SKELETON_EXTENDED",
        "CANONICAL_SKELETON",
        "MPI_3DHP_SKELETON",
        "SMPL_REST_POSE",
        "topological_levels",
    )),
    ("posegen_tpu_torch.skeleton.rotations", ("rotations",)),
    ("posegen_tpu_torch.skeleton.kinematics", ("kinematics",)),
    ("posegen_tpu_torch.skeleton.geometry", ("geometry",)),
    ("posegen_tpu_torch.skeleton.cameras", ("cameras",)),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
