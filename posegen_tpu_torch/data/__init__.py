"""Datasets and their builders (port of posegen_tpu/data/)."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.data.h5dataset", (
        "H5RayDataset",
        "RayBatchLoader",
    )),
    ("posegen_tpu_torch.data.writer", ("write_pose_h5",)),
    ("posegen_tpu_torch.data.catalog", (
        "DATASET_CATALOG",
        "load_data",
    )),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
