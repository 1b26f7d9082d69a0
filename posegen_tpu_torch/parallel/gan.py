"""Data-parallel GAN and SPIN fine-tuning over the ranks (port of
posegen_tpu/parallel/gan.py).

The reference's GAN loop (run_gan.py:1956-2135) and SPIN fine-tune
(:1849-1952) are single-GPU. The port scales both as the NeRF trainer does
(parallel/mesh.py): parameters and optimiser state replicated on every
rank, the batches split along dim 0, the gradients and stats summed over
the ranks. The step factories of gen/gan.py and gen/spin_train.py carry the
cross-rank math (sync-BN, global-denominator losses, the global noises
sliced per rank, the gathered poses for the SPIN-feedback selection), so
with equal shards every parallel step below reproduces its single-device
twin on the concatenated batch, unlike torch nn.DataParallel, whose
per-replica BatchNorm diverges.

Each parallel step takes the single-device step's arguments, the GLOBAL
batches included (every rank holds them: each runs the same host code),
and keeps its rank's rows.
"""

from __future__ import annotations

from posegen_tpu_torch.gen.gan import make_discriminator_step, make_generator_step
from posegen_tpu_torch.gen.spin_train import make_ski_finetune_step, make_spin_finetune_step
from posegen_tpu_torch.parallel.mesh import Mesh, all_gather_rows, fold_generator, local_rows


def _check_divisible(what: str, n: int, mesh: Mesh) -> None:
    if n % mesh.size != 0:
        raise ValueError(f"{what} ({n}) must divide evenly over the {mesh.size}-device mesh — "
                         "pad or trim the batch")


def make_parallel_generator_step(mesh: Mesh, fk_fn, cfg=None, **kwargs):
    """make_generator_step over the mesh -> (opt, step), the single-device
    signature: real_pose and the noises are the global batch's, everything
    else replicated; the generated poses come back gathered (every rank
    holds the global `out`)."""
    from posegen_tpu_torch.gen.generators import GenConfig

    opt, base = make_generator_step(fk_fn, cfg or GenConfig(), mesh=mesh, **kwargs)

    def step(g_params, g_state, g_opt_state, d_params, noises, real_pose, spin_pred, spin_sel,
             spin_active):
        _check_divisible("generator pose batch", real_pose.shape[0], mesh)
        g_params, new_state, g_opt_state, out, stats = base(
            g_params, g_state, g_opt_state, d_params, noises, local_rows(mesh, real_pose),
            spin_pred, spin_sel, spin_active)
        out = {k: all_gather_rows(mesh, v) for k, v in out.items()}
        return g_params, new_state, g_opt_state, out, stats

    return opt, step


def make_parallel_discriminator_step(mesh: Mesh, **kwargs):
    """make_discriminator_step over the mesh -> (opt, step): the real and
    fake pose batches split over the ranks."""
    opt, base = make_discriminator_step(mesh=mesh, **kwargs)

    def step(d_params, d_opt_state, real_kp3d, fake_kp3d):
        _check_divisible("discriminator real batch", real_kp3d.shape[0], mesh)
        _check_divisible("discriminator fake batch", fake_kp3d.shape[0], mesh)
        return base(d_params, d_opt_state, local_rows(mesh, real_kp3d),
                    local_rows(mesh, fake_kp3d))

    return opt, step


def _parallel_finetune(mesh: Mesh, opt, base):
    def step(params, bn_state, opt_state, images, gt, key):
        """key: a torch.Generator for the dropout masks, or None (no
        dropout). The masks are drawn for the rank's rows from a generator
        folded by rank (a shared generator would draw the same rows' masks
        on every rank); None stays exactly comparable to the single-device
        step."""
        from posegen_tpu_torch.gen.hmr import dropout_masks

        _check_divisible("SPIN fine-tune batch", images.shape[0], mesh)
        images, gt = local_rows(mesh, images), local_rows(mesh, gt)
        masks = None
        if key is not None:
            masks = dropout_masks(fold_generator(key, mesh), images.shape[0])
        params, opt_state, stats = base(params, bn_state, opt_state, images, gt, masks)
        stats["per_sample"] = all_gather_rows(mesh, stats["per_sample"])
        return params, opt_state, stats

    return opt, step


def make_parallel_spin_finetune_step(mesh: Mesh, **kwargs):
    """make_spin_finetune_step over the mesh: the ResNet-50 forward and
    backward on each rank's images; BN is frozen (reference set_bn_eval),
    so no moment syncs; the summed gradient is the single-device one (the
    hinge's kept count summed over the ranks inside spin_pose_loss)."""
    opt, base = make_spin_finetune_step(mesh=mesh, **kwargs)
    return _parallel_finetune(mesh, opt, base)


def make_parallel_ski_finetune_step(mesh: Mesh, smpl, J_regressor, **kwargs):
    """make_ski_finetune_step over the mesh (the SPIN step's contract)."""
    opt, base = make_ski_finetune_step(smpl, J_regressor, mesh=mesh, **kwargs)
    return _parallel_finetune(mesh, opt, base)
