"""Encoders, cutoff positional embedding and ray sampling."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.ops.embedding", ("embedding",)),
    ("posegen_tpu_torch.ops.encoders", ("encoders",)),
    ("posegen_tpu_torch.ops.sampling", ("sampling",)),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
