"""SPIN fine-tuning on generated (image, pose) data (port of
posegen_tpu/gen/spin_train.py).

The reference's `train_spin` (run_gan.py:1849-1952): BN-frozen training
(running stats fixed, weights trained), loss = the scale-normalised,
root-centred 14-joint position error x 0.1, and the hinge keeping the
samples whose 0.1-scaled error is under 0.02 (the reference's `rows1 =
spin_loss < 0.0200`, run_gan.py:1906-1908), divided by the kept count.
`train_ski`'s mesh-regressed loss (render_3dpw_testset.py:2659-2775) is the
same step with `ski_pose_loss`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from posegen_tpu_torch.gen.gan import TreeAdam, _summed_over, j14_index, tree_grads
from posegen_tpu_torch.gen.hmr import hmr_apply
from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws_from_rots

# the rows of the H36M-17 joints regressed from the mesh that SKI's 14 GT
# joints take (posegen_tpu/evals/harness.py:100, reference EVAL_JOINTS,
# render_3dpw_testset.py:2700)
SKI_PRED_J14 = (1, 4, 2, 5, 3, 6, 8, 10, 11, 14, 12, 15, 13, 16)
MEAN_PARAM_BUFFERS = ("init_pose", "init_shape", "init_cam")


def spin_pose_loss(
    pred_rotmat: torch.Tensor,
    gt_joints: torch.Tensor,
    pose_scale: float = 0.4,
    hinge: Optional[float] = 0.02,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, per-sample errors). gt_joints: (B, 24, 3) world joints. With a
    hinge, the loss is the mean over the kept samples (0 when none is
    kept). mesh: one rank's loss on its rows, the local sum over the GLOBAL
    count (the kept count summed over the ranks, or the batch times the
    rank count), so that the sum over the ranks is the single-device loss
    on the concatenated batch (JAX's axis_name,
    posegen_tpu/gen/spin_train.py:57-63)."""
    j14 = j14_index(pred_rotmat.device)
    pose = smpl_l2ws_from_rots(pred_rotmat, scale=pose_scale)[..., :3, 3]
    pose = (pose - pose[:, :1]).index_select(1, j14)
    gt = (gt_joints - gt_joints[:, :1]).index_select(1, j14)
    # scale-normalise the prediction to the GT's norm (reference :1903-1906)
    s_pred = torch.linalg.norm(pose, dim=(-2, -1), keepdim=True)
    s_gt = torch.linalg.norm(gt, dim=(-2, -1), keepdim=True)
    pose = pose / torch.clamp(s_pred, min=1e-8) * s_gt
    # eps-safe norm (NaN-free gradients when pred == gt exactly)
    per_sample = torch.sqrt(((pose - gt) ** 2).sum(-1) + 1e-12).mean(-1) * 0.1
    if hinge is None:
        return per_sample.sum() / _count(per_sample.shape[0], mesh), per_sample
    keep = (per_sample < hinge).to(per_sample.dtype)
    den = keep.sum()
    if mesh is not None:
        from posegen_tpu_torch.parallel.mesh import all_reduce_sum

        (den,) = all_reduce_sum(mesh, [den])
    return (per_sample * keep).sum() / torch.clamp(den, min=1.0), per_sample


def _count(n: int, mesh) -> int:
    """The global batch of n rows a rank."""
    return n * (1 if mesh is None else mesh.size)


def bn_frozen_adam(lr: float, freeze_init_buffers: bool = True) -> TreeAdam:
    """Adam over the HMR weights, the init_pose / shape / cam mean-param
    buffers excluded (they are torch BUFFERS in the reference); the BN
    running stats are frozen separately, by hmr_apply's bn_train=False
    (reference set_bn_eval, run_gan.py:1860-1869)."""
    return TreeAdam(lr, frozen=MEAN_PARAM_BUFFERS if freeze_init_buffers else ())


def _finetune_step(opt: TreeAdam, loss_fn: Callable, mesh=None):
    def step(params, bn_state, opt_state, images, gt, masks):
        with torch.enable_grad():
            rotmat, betas, _, _ = hmr_apply(params, bn_state, images, train=True,
                                            bn_train=False, masks=masks)
            loss, per_sample = loss_fn(rotmat, betas, gt)
            grads = tree_grads(loss, params)
        # the summed gradients are the single-device ones (the losses'
        # global denominators, JAX spin_train.py:124-126 and :198-200)
        grads, stats = _summed_over(mesh, grads, {"spin_loss": loss.detach()})
        opt.update(opt_state, params, grads)
        return params, opt_state, {**stats, "per_sample": per_sample.detach()}

    return step


def make_spin_finetune_step(
    lr: float = 5e-5,  # reference --lr_spin default (run_gan.py:79)
    pose_scale: float = 0.4,
    hinge: Optional[float] = 0.02,
    freeze_init_buffers: bool = True,
    mesh=None,
):
    """-> (optimizer, step). step(params, bn_state, opt_state, images,
    gt_joints, masks) -> (params, opt_state, {'spin_loss', 'per_sample'}),
    params and opt_state updated in place, the BN running stats frozen.
    masks: the regressor's dropout masks (`hmr.dropout_masks`; the JAX
    step's dropout key), or None for no dropout. mesh: one rank's step on
    its rows (`parallel.gan` wraps it): global denominators, the gradients
    and the loss summed over the ranks; per_sample holds the rank's rows."""
    opt = bn_frozen_adam(lr, freeze_init_buffers)
    return opt, _finetune_step(
        opt, lambda rotmat, betas, gt: spin_pose_loss(rotmat, gt, pose_scale, hinge, mesh), mesh)


def ski_pose_loss(
    pred_rotmat: torch.Tensor,
    pred_betas: torch.Tensor,
    gt_joints14: torch.Tensor,
    smpl,
    J_reg: torch.Tensor,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SKI fine-tune loss (reference train_ski, render_3dpw_testset.py:
    2690-2714): 14 joints regressed from the predicted MESH (H36M-17 rows
    SKI_PRED_J14), pelvis-centred by regressed joint 0 (the GT stays in its
    dataset frame, as the reference leaves it), scales matched by the
    [6] - [0] joint distance, then plain MPJPE. Returns (loss, per-sample
    errors). smpl: a callable (betas, body_pose, global_orient, pose2rot)
    -> {'vertices': (B, V, 3)}. mesh: the local sum over the global count
    (JAX spin_train.py:167-169)."""
    pred = smpl(betas=pred_betas, body_pose=pred_rotmat[:, 1:],
                global_orient=pred_rotmat[:, :1], pose2rot=False)
    j17 = torch.einsum("jv,bvc->bjc", J_reg, pred["vertices"])
    p14 = j17[:, list(SKI_PRED_J14)] - j17[:, :1]
    s_pred = torch.linalg.norm(p14[:, 6:7] - p14[:, :1], dim=-1, keepdim=True)
    s_gt = torch.linalg.norm(gt_joints14[:, 6:7] - gt_joints14[:, :1], dim=-1, keepdim=True)
    p14 = p14 * s_gt / torch.clamp(s_pred, min=1e-8)
    per_sample = torch.sqrt(((p14 - gt_joints14) ** 2).sum(-1) + 1e-12).mean(-1)
    return per_sample.sum() / _count(per_sample.shape[0], mesh), per_sample


def make_ski_finetune_step(
    smpl,
    J_regressor,
    lr: float = 5e-5,
    freeze_init_buffers: bool = True,
    mesh=None,
):
    """-> (optimizer, step) fine-tuning SPIN on SKI 3D-joint GT with the
    mesh-regressed loss above; BN stats frozen as in make_spin_finetune_step,
    and the same step signature (gt: the (B, 14, 3) joints) and mesh rule."""
    opt = bn_frozen_adam(lr, freeze_init_buffers)
    J_reg = torch.as_tensor(J_regressor, dtype=torch.float32)

    def loss_fn(rotmat, betas, gt):
        return ski_pose_loss(rotmat, betas, gt, smpl, J_reg.to(rotmat.device), mesh)

    return opt, _finetune_step(opt, loss_fn, mesh)
