"""Functional NN layers shared by the pose GAN and HMR (port of posegen_tpu/nn/)."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.nn.layers", (
        "init_linear",
        "linear",
        "init_batchnorm",
        "batchnorm",
        "init_conv",
        "conv2d",
        "max_pool",
        "leaky_relu",
    )),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
