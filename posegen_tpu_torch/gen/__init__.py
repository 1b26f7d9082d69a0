"""The pose GAN, HMR / SPIN and the feedback loop (port of posegen_tpu/gen/)."""

from posegen_tpu_torch.lazy import exports, table

_EXPORTS = table(
    ("posegen_tpu_torch.gen.generators", (
        "GenConfig",
        "init_pose_generator",
        "pose_generator_apply",
    )),
    ("posegen_tpu_torch.gen.discriminators", (
        "init_pos3d_discriminator",
        "pos3d_discriminator_apply",
        "init_pos2d_discriminator",
        "pos2d_discriminator_apply",
    )),
)
__all__ = list(_EXPORTS)
__getattr__, __dir__ = exports(__name__, _EXPORTS)
