"""The weights-only NeRF train step (port of posegen_tpu/train/trainer.py:
40-431, without pose refinement).

One call of the step renders a batch of rays with the coarse and fine nets,
composites the background, computes the photometric losses, backpropagates
into both nets (through the trainable kernel pair of kernels/field_grad.py
on CUDA), zeroes frozen layers, and takes one Adam step with the
reference's exponential learning-rate decay. The embedder schedules (tau,
BARF alpha) are recomputed from the step counter before the render.

Unlike the JAX step, which is a pure function of its state, this one
updates the parameter tensors and the optimizer in place and returns the
state with the step counter and embed schedules advanced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from posegen_tpu_torch.kernels.field import fused_config_disqualification
from posegen_tpu_torch.ops import embedding as emb_mod
from posegen_tpu_torch.render.raycast import PoseCtx, RaycastConfig, render_rays
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
    # pose optimization: not ported yet (ROADMAP Queue 1 item 8)
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

    def __post_init__(self):
        if self.opt_pose:
            raise NotImplementedError(
                "opt_pose: pose refinement is not ported yet (ROADMAP Queue 1 item 8)"
            )


class TrainState(NamedTuple):
    step: int
    params: Dict[str, Any]  # trainable NeRF nets {'coarse', 'fine'}: leaves require grad
    embeds: Dict[str, Any]  # embedder buffers {'embed_kp', ...}
    opt_state: Optional[torch.optim.Adam]  # None under testopt


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


def create_train_state(variables: Dict[str, Any], tcfg: TrainConfig) -> TrainState:
    params, embeds = _split_variables(variables)
    params = trainable(params)
    return TrainState(step=0, params=params, embeds=embeds,
                      opt_state=nerf_optimizer(tcfg, params))


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
    """"train" when the trainable kernels apply, else False: enabled
    (fused_train, or by default CUDA tensors), a config that passes the gate,
    one view layer, and rays that divide evenly into the batch's pose
    groups (JAX trainer.py:235-270)."""
    enabled = tcfg.fused_train
    if enabled is None:
        enabled = batch["rays_o"].is_cuda
    if not enabled or fused_config_disqualification(cfg) is not None:
        return False
    if len(params["coarse"].get("views_linears", [0])) != 1:
        return False
    if batch["rays_o"].shape[0] % batch["skts"].shape[0]:
        return False
    return "train"


def _fix_layer(tcfg: TrainConfig, params: Dict) -> None:
    """Zero the gradients of pts_linears[:fix_layer] (reference
    freeze_weights for --finetune --fix_layer, raycasters.py:215-217)."""
    for net in ("coarse", "fine"):
        if net in params:
            for layer in params[net]["pts_linears"][:tcfg.fix_layer]:
                for t in layer.values():
                    t.grad.zero_()


def make_train_step(cfg: RaycastConfig, tcfg: TrainConfig):
    """-> train_step(state, batch, generator=None) -> (state, stats).

    batch: rays_o, rays_d, target_s (N, 3); kp3d, bones (G, 24, 3) and skts
    (G, 24, 4, 4), one row per pose group with the rays contiguous per group
    (G = 1 or N allowed); cyls (1, G or N, 5); optional bgs (N, 3), fgs
    (N, 1), cam_idxs (N, 1) with framecodes. generator draws the stratified
    and density noise when the config perturbs."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        embeds = _updated_embeds(cfg, tcfg, state.embeds, state.step)
        leaves = param_leaves(state.params)
        for p in leaves:
            p.grad = None
        n = batch["rays_o"].shape[0]
        kps, bones, skts = batch["kp3d"], batch["bones"], batch["skts"]
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
        total.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        _fix_layer(tcfg, state.params)
        with torch.no_grad():
            stats["total_loss"] = total
            stats["grad_norm"] = torch.sqrt(sum(p.grad.square().sum() for p in leaves))
            if state.opt_state is not None:
                for group in state.opt_state.param_groups:
                    group["lr"] = nerf_lr(tcfg, state.step)
                state.opt_state.step()
        stats = {k: v.detach() for k, v in stats.items()}
        return state._replace(step=state.step + 1, embeds=embeds), stats

    return train_step

