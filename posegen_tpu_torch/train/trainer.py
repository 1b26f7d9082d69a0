"""The NeRF train step, with pose refinement (port of
posegen_tpu/train/trainer.py).

One call of the step renders a batch of rays with the coarse and fine nets,
composites the background, computes the photometric losses, backpropagates
into both nets (through the trainable kernel pair of kernels/field_grad.py
on CUDA), zeroes frozen layers, and takes one Adam step with the
reference's exponential learning-rate decay. The embedder schedules (tau,
BARF alpha) are recomputed from the step counter before the render.

With `opt_pose`, the batch's poses come from per-frame pose parameters
(pose/opt.py: gather, FK, skts), the field runs in the "full" mode whose
backward carries the photometric cotangents into the pose rows, the pose
regularizer and the temporal loss join the total, and a second Adam (with
optax.MultiSteps' gradient accumulation when opt_pose_step > 1) updates the
pose parameters inside the warmup / stop window.

Unlike the JAX step, which is a pure function of its state, this one
updates the parameter tensors and the optimizer in place and returns the
state with the step counter and embed schedules advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from posegen_tpu_torch.kernels.field import fused_config_disqualification, net_layout
from posegen_tpu_torch.kernels.field_grad import train_refusal
from posegen_tpu_torch.ops import embedding as emb_mod
from posegen_tpu_torch.pose.opt import (
    PoseOptConfig, _canon_bones, kp_reg_loss, mpjpc_stat, pose_apply, temporal_loss,
)
from posegen_tpu_torch.render.raycast import PoseCtx, RaycastConfig, render_rays
from posegen_tpu_torch.skeleton.skeleton import SMPL_SKELETON, Skeleton
from posegen_tpu_torch.train import losses as L


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyper-parameters (reference run_nerf.py flags); the
    fields of the JAX TrainConfig."""

    lrate: float = 5e-4
    lrate_decay: int = 500  # in `decay_unit` steps (reference convention)
    lrate_decay_rate: float = 0.1
    decay_unit: int = 1000
    weight_decay: Optional[float] = None  # L2-to-grad, torch Adam semantics
    loss_fn: str = "MSE"
    loss_beta: float = 0.1  # huber delta (reference --loss_beta)
    use_coarse_loss: bool = True
    coarse_weight: float = 1.0
    use_acc_loss: bool = False
    acc_loss_weight: float = 0.01
    use_background: bool = False  # composite (1-acc)*bg into the prediction
    testopt: bool = False  # test-time pose opt: freeze the NeRF nets
    fix_layer: int = 0  # freeze pts_linears below this layer (finetune)
    # pose optimization
    opt_pose: bool = False
    opt_pose_lrate: float = 5e-4
    opt_pose_lrate_decay: int = 2
    opt_pose_decay_rate: float = 1.0
    opt_pose_decay_unit: int = 400
    opt_pose_step: int = 20
    opt_pose_coef: float = 2.0
    opt_pose_warmup: int = 0
    opt_pose_stop: Optional[int] = None
    use_temp_loss: bool = False
    temp_coef: float = 0.05
    opt_pose_cache: bool = False
    # embedder schedules
    cutoff_step: int = 250
    cutoff_rate: float = 10.0
    freq_schedule_step: int = 5
    # trainable field kernels (kernels/field_grad.py): None = auto (for CUDA
    # tensors, when the config qualifies and rays group evenly per pose)
    fused_train: Optional[bool] = None
    rays_per_image: int = 0  # rays per pose group in a batch (0 = one group)


@dataclasses.dataclass
class PoseOptState:
    """The pose optimizer's state, updated in place: optax.adam's count and
    moments per pose param and, with opt_pose_step > 1, optax.MultiSteps'
    counters and running mean of the gradients."""

    count: int  # applied Adam updates (the learning-rate schedule's step)
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0  # gradients in the current accumulation
    gradient_step: int = 0  # emitted accumulations
    acc_grads: Optional[Dict[str, torch.Tensor]] = None


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]  # trainable NeRF nets {'coarse', 'fine'}: leaves require grad
    embeds: Dict[str, Any]  # embedder buffers {'embed_kp', ...}
    opt_state: Optional[torch.optim.Adam]  # None under testopt
    pose_params: Optional[Dict[str, torch.Tensor]] = None  # leaves require grad
    pose_anchors: Optional[Dict[str, torch.Tensor]] = None
    pose_opt_state: Optional[PoseOptState] = None


def param_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in param_leaves(v)]
    return [tree]


def trainable(tree):
    """The same tree of detached float32 copies that require grad."""
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(trainable(v) for v in tree)
    return tree.detach().float().clone().requires_grad_(True)


def _split_variables(variables: Dict[str, Any]) -> Tuple[Dict, Dict]:
    params = {k: v for k, v in variables.items() if k in ("coarse", "fine")}
    embeds = {k: v for k, v in variables.items() if k.startswith("embed")}
    return params, embeds


def nerf_lr(tcfg: TrainConfig, count: int) -> float:
    """lrate * rate**(count / (decay * decay_unit)) at the optimizer's
    pre-update count: optax exponential_decay (reference trainer.py:175-192)."""
    return tcfg.lrate * tcfg.lrate_decay_rate ** (
        count / float(tcfg.lrate_decay * tcfg.decay_unit))


def nerf_optimizer(tcfg: TrainConfig, params: Dict[str, Any]) -> Optional[torch.optim.Adam]:
    """Adam over the nets' leaves (betas 0.9 / 0.999, eps 1e-8); its lr is
    set from `nerf_lr` before every update. weight_decay adds the L2 term to
    the gradient before the moments (torch Adam; optax add_decayed_weights
    before adam). testopt freezes the NeRF: no optimizer."""
    if tcfg.testopt:
        return None
    return torch.optim.Adam(param_leaves(params), lr=tcfg.lrate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay or 0.0)


def pose_lr(tcfg: TrainConfig, count: int) -> float:
    """opt_pose_lrate * rate**(count / (decay * decay_unit)) at the pose
    Adam's pre-update count: optax exponential_decay (JAX trainer.py:117-126)."""
    steps = max(tcfg.opt_pose_lrate_decay * tcfg.opt_pose_decay_unit, 1)
    return tcfg.opt_pose_lrate * tcfg.opt_pose_decay_rate ** (count / float(steps))


def init_pose_opt_state(tcfg: TrainConfig, pose_params: Dict[str, torch.Tensor]) -> PoseOptState:
    def zeros():
        return {k: torch.zeros_like(v.detach()) for k, v in pose_params.items()}

    return PoseOptState(count=0, mu=zeros(), nu=zeros(),
                        acc_grads=zeros() if tcfg.opt_pose_step > 1 else None)


def pose_update(tcfg: TrainConfig, st: PoseOptState, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor]) -> None:
    """One pose optimizer update in place: Adam (betas 0.9 / 0.999, eps 1e-8,
    the learning rate of `pose_lr` at the pre-update count); with
    opt_pose_step k > 1 optax.MultiSteps around it: the running mean of k
    gradients, the Adam update on the k-th, none in between."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    with torch.no_grad():
        k = tcfg.opt_pose_step
        if k > 1:
            n = st.mini_step
            for name, g in grads.items():
                st.acc_grads[name] += (g - st.acc_grads[name]) / (n + 1)
            st.mini_step = (n + 1) % k
            if n != k - 1:
                return
            st.gradient_step += 1
            grads = {name: a.clone() for name, a in st.acc_grads.items()}
            for a in st.acc_grads.values():
                a.zero_()
        lr = pose_lr(tcfg, st.count)
        st.count += 1
        c1, c2 = 1.0 - b1**st.count, 1.0 - b2**st.count
        for name, g in grads.items():
            mu, nu = st.mu[name], st.nu[name]
            mu.mul_(b1).add_((1.0 - b1) * g)
            nu.mul_(b2).add_((1.0 - b2) * g * g)
            params[name] -= lr * (mu / c1) / (torch.sqrt(nu / c2) + eps)


def create_train_state(variables: Dict[str, Any], tcfg: TrainConfig,
                       pose_params: Optional[Dict[str, torch.Tensor]] = None,
                       pose_anchors: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """A fresh state; with opt_pose, the pose params (from
    pose.opt.init_pose_params) get their optimizer state."""
    params, embeds = _split_variables(variables)
    params = trainable(params)
    pose_opt_state = None
    if tcfg.opt_pose and pose_params is not None:
        pose_opt_state = init_pose_opt_state(tcfg, pose_params)
    return TrainState(step=0, params=params, embeds=embeds,
                      opt_state=nerf_optimizer(tcfg, params), pose_params=pose_params,
                      pose_anchors=pose_anchors, pose_opt_state=pose_opt_state)


def _updated_embeds(cfg: RaycastConfig, tcfg: TrainConfig, embeds: Dict[str, Any],
                    step: int) -> Dict[str, Any]:
    """tau / alpha recomputed from the pre-increment step, each on the
    device of its embed state."""
    out = dict(embeds)
    for name, ecfg in (
        ("embed_kp", cfg.embed_kp_cfg),
        ("embed_bone", cfg.embed_bone_cfg),
        ("embed_view", cfg.embed_view_cfg),
    ):
        if ecfg is None or name not in embeds:
            continue
        st = dict(embeds[name])
        dev = st["tau"].device
        if ecfg.cutoff:
            st["tau"] = emb_mod.update_tau(ecfg, step, tcfg.cutoff_step, tcfg.cutoff_rate,
                                           device=dev)
        if ecfg.freq_schedule:
            st["alpha"] = emb_mod.update_alpha(ecfg, step, tcfg.freq_schedule_step,
                                               float(cfg.multires - 1), device=dev)
        out[name] = st
    return out


def compute_losses(tcfg: TrainConfig, ret: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Photometric + coarse + acc losses (reference trainer.py:321-383);
    use_background composites the batch's background behind both passes'
    predictions before the loss."""
    target = batch["target_s"]
    rgb = ret["rgb_map"]
    if tcfg.use_background and "bgs" in batch:
        rgb = rgb + (1.0 - ret["acc_map"])[..., None] * batch["bgs"]
    loss = L.rgb_loss(tcfg.loss_fn, rgb, target, beta=tcfg.loss_beta)
    stats = {"rgb_loss": loss, "psnr": L.mse2psnr(L.img2mse(rgb, target))}
    total = loss
    if tcfg.use_coarse_loss and tcfg.coarse_weight > 0 and "rgb0" in ret:
        rgb0 = ret["rgb0"]
        if tcfg.use_background and "bgs" in batch:
            rgb0 = rgb0 + (1.0 - ret["acc0"])[..., None] * batch["bgs"]
        loss0 = L.rgb_loss(tcfg.loss_fn, rgb0, target, beta=tcfg.loss_beta)
        stats["rgb0_loss"] = loss0
        total = total + tcfg.coarse_weight * loss0
    if tcfg.use_acc_loss and "fgs" in batch:
        acc_l = L.acc2bce(ret["acc_map"], batch["fgs"][..., 0])
        if "acc0" in ret:
            acc_l = acc_l + L.acc2bce(ret["acc0"], batch["fgs"][..., 0])
        stats["acc_loss"] = acc_l
        total = total + tcfg.acc_loss_weight * acc_l
    return total, stats


def _fused_train_mode(cfg: RaycastConfig, tcfg: TrainConfig, params: Dict,
                      batch: Dict[str, torch.Tensor]):
    """"train" ("full" with opt_pose: input gradients too) when the
    trainable kernels apply, else False: enabled (fused_train, or by default
    CUDA tensors), a config that passes the gate and whose layout the
    training kernels' plans take (`field_grad.train_refusal`; the JAX
    kernels take any, so this is a difference of route), one view layer,
    and rays that divide evenly into the batch's pose groups (kp_idx rows
    with opt_pose, skts rows without; JAX trainer.py:235-270)."""
    enabled = tcfg.fused_train
    if enabled is None:
        enabled = batch["rays_o"].is_cuda
    if not enabled or fused_config_disqualification(cfg) is not None:
        return False
    if train_refusal(net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)) is not None:
        return False
    if len(params["coarse"].get("views_linears", [0])) != 1:
        return False
    groups = batch["kp_idx"] if tcfg.opt_pose else batch["skts"]
    if batch["rays_o"].shape[0] % groups.shape[0]:
        return False
    return "full" if tcfg.opt_pose else "train"


def _fix_layer(tcfg: TrainConfig, params: Dict) -> None:
    """Zero the gradients of pts_linears[:fix_layer] (reference
    freeze_weights for --finetune --fix_layer, raycasters.py:215-217)."""
    for net in ("coarse", "fine"):
        if net in params:
            for layer in params[net]["pts_linears"][:tcfg.fix_layer]:
                for t in layer.values():
                    t.grad.zero_()


def make_train_step(cfg: RaycastConfig, tcfg: TrainConfig,
                    pcfg: Optional[PoseOptConfig] = None, skel: Skeleton = SMPL_SKELETON,
                    rest_pose: Optional[torch.Tensor] = None,
                    kp_map: Optional[torch.Tensor] = None, n_frames: int = 0):
    """-> train_step(state, batch, generator=None) -> (state, stats).

    batch: rays_o, rays_d, target_s (N, 3); cyls (1, G or N, 5); optional
    bgs (N, 3), fgs (N, 1), cam_idxs (N, 1) with framecodes. Without
    opt_pose: kp3d, bones (G, 24, 3) and skts (G, 24, 4, 4), one row per
    pose group with the rays contiguous per group (G = 1 or N allowed). With
    opt_pose: kp_idx (G,) frame indices into state.pose_params (kp3d (G,
    24, 3), the dataset's joints, for the mpjpc stat; temp_val (G,) for the
    temporal loss), with rest_pose (24, 3), kp_map for multiview params and
    n_frames > 1 to turn the temporal loss on. generator draws the
    stratified and density noise when the config perturbs."""
    pcfg = pcfg or PoseOptConfig()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        embeds = _updated_embeds(cfg, tcfg, state.embeds, state.step)
        leaves = param_leaves(state.params)
        opt_pose = tcfg.opt_pose and state.pose_params is not None
        pose_leaves = dict(state.pose_params) if opt_pose else {}
        for p in leaves + list(pose_leaves.values()):
            p.grad = None
        n = batch["rays_o"].shape[0]
        if opt_pose:
            kp_idx = batch["kp_idx"].reshape(-1).long()
            kps, bones, skts, _ = pose_apply(state.pose_params, kp_idx, rest_pose, skel, kp_map)
        else:
            kps, bones, skts = batch["kp3d"], batch["bones"], batch["skts"]
        kps_g, bones_g = kps, bones  # per group, before the per-ray expansion
        g = skts.shape[0]
        cyls = batch["cyls"]
        if cyls.shape[0] not in (1, n):
            cyls = cyls.repeat_interleave(n // cyls.shape[0], dim=0)
        use_fused = _fused_train_mode(cfg, tcfg, state.params, batch)
        if not use_fused and 1 < g < n:  # per-ray pose rows for the plain path
            rep = n // g
            kps = kps.repeat_interleave(rep, dim=0)
            bones = bones.repeat_interleave(rep, dim=0)
            skts = skts.repeat_interleave(rep, dim=0)
        ctx = PoseCtx(kps=kps, skts=skts, bones=bones, cyls=cyls,
                      cam_idxs=batch.get("cam_idxs"))
        ret = render_rays(cfg, {**state.params, **embeds}, batch["rays_o"], batch["rays_d"],
                          ctx, generator=generator, use_fused=use_fused)
        total, stats = compute_losses(tcfg, ret, batch)
        if opt_pose:
            if state.pose_anchors is not None:
                # the reference loop's regularizer, logged after its coefficient
                kp_l = tcfg.opt_pose_coef * kp_reg_loss(pcfg, state.pose_params,
                                                        state.pose_anchors, kp_idx, kp_map)
                stats["kp_loss"] = kp_l
                total = total + kp_l
                if "kp3d" in batch:
                    stats["mpjpc"] = mpjpc_stat(pcfg, kps_g, batch["kp3d"])
            if tcfg.use_temp_loss and n_frames > 1:
                temp_val = batch.get("temp_val")
                if temp_val is None:
                    temp_val = torch.ones(kp_idx.shape, device=kp_idx.device)
                temp_l = tcfg.temp_coef * temporal_loss(
                    state.pose_params, kp_idx, temp_val.float(), rest_pose, kps_g,
                    _canon_bones(bones_g), skel, kp_map)
                stats["temp_loss"] = temp_l
                total = total + temp_l
        total.backward()
        for p in leaves + list(pose_leaves.values()):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _fix_layer(tcfg, state.params)
        with torch.no_grad():
            stats["total_loss"] = total
            stats["grad_norm"] = torch.sqrt(sum(p.grad.square().sum() for p in leaves))
            if opt_pose:
                stats["pose_grad_norm"] = torch.sqrt(
                    sum(p.grad.square().sum() for p in pose_leaves.values()))
            if state.opt_state is not None:
                for group in state.opt_state.param_groups:
                    group["lr"] = nerf_lr(tcfg, state.step)
                state.opt_state.step()
            # the warmup / stop window skips the whole pose update: no
            # moment, count or accumulation advances while gated
            active = ((tcfg.opt_pose_warmup <= 0 or state.step >= tcfg.opt_pose_warmup)
                      and (tcfg.opt_pose_stop is None or state.step < tcfg.opt_pose_stop))
            if opt_pose and active:
                pose_update(tcfg, state.pose_opt_state, state.pose_params,
                            {k: p.grad for k, p in pose_leaves.items()})
        stats = {k: v.detach() for k, v in stats.items()}
        return state._replace(step=state.step + 1, embeds=embeds), stats

    return train_step
