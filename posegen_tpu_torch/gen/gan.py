"""GAN machinery: LSGAN losses, the fake-replay pool, projection, and the
generator and discriminator steps (port of posegen_tpu/gen/gan.py).

The reference's GAN plumbing (run_gan.py:578-600 `Sample_from_Pool`,
732-759 `project_to_2d`, 1117-1141 `get_adv_loss`, 1143-1178 `train_dis`,
1956-2135 `train_gan`). The LSGAN criterion is MSE on logits.

The optimiser is the JAX package's optax.chain(clip_by_global_norm(1.0),
adam(lambda_lr)), written out (`TreeAdam`): the gradients are scaled by
max / norm only when their global norm exceeds max (torch's
clip_grad_norm_ divides by norm + 1e-6 whenever it is called), and the
learning rate is the schedule at Adam's count before the update. Its state
keeps optax's count, mu and nu trees, so a checkpoint holds them under
optax's key paths (`gen/loop.py`).

Unlike the JAX steps, which are pure, these update the params and the
optimiser state in place and return them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from posegen_tpu_torch.gen.discriminators import pos3d_discriminator_apply
from posegen_tpu_torch.gen.generators import GenConfig, pose_generator_apply
from posegen_tpu_torch.train.trainer import param_leaves, tree_map


def lsgan_loss(logits: torch.Tensor, target: float) -> torch.Tensor:
    return ((logits - target) ** 2).mean()


def discriminator_accuracy(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Fraction of logits within 0.5 of the target label (reference
    get_discriminator_accuracy, run_gan.py:584-598)."""
    return ((logits - target).abs() <= 0.5).float().mean()


def project_to_2d(kps: torch.Tensor, exts: torch.Tensor, H: float, W: float,
                  focals: Tuple[float, float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Perspective projection (reference run_gan.py:732-759). kps (B, J, 3)
    world; exts (B, 4, 4) or (4, 4) extrinsics. Returns (kp2d (B, J, 2)
    pixels, kp3d_cam (B, J, 3))."""
    exts = torch.as_tensor(exts, dtype=kps.dtype, device=kps.device)
    if exts.dim() == 2:
        exts = exts.expand(kps.shape[0], 4, 4)
    hom = torch.cat([kps, torch.ones_like(kps[..., :1])], dim=-1)
    # broadcast-sum, as the skeleton code's small products: never TF32
    cam = (exts[:, None] * hom[:, :, None, :]).sum(-1)[..., :3]
    z = cam[..., 2:3]
    focal = torch.tensor(focals, dtype=kps.dtype, device=kps.device)
    xy = cam[..., :2] * focal / torch.where(z == 0, torch.ones_like(z), z)
    xy = torch.where(torch.isfinite(xy), xy, torch.zeros_like(xy))
    return xy + torch.tensor([W * 0.5, H * 0.5], dtype=kps.dtype, device=kps.device), cam


def normalize_screen_coordinates(x: torch.Tensor, w: float, h: float) -> torch.Tensor:
    """[0, w] x [0, h] pixels -> [-1, 1], aspect kept (run_gan.py:761-765)."""
    return x / w * 2.0 - torch.tensor([1.0, h / w], dtype=x.dtype, device=x.device)


class FakePool:
    """Replay buffer of generated poses for discriminator training
    (reference Sample_from_Pool, run_gan.py:578-600). Host-side numpy; a
    seed gives the JAX package's sequence."""

    def __init__(self, max_elements: int = 4096, seed: int = 0):
        self.max_elements = max_elements
        self.items: list = []
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        out = []
        for item in np.asarray(batch):
            if len(self.items) < self.max_elements:
                self.items.append(item)
                out.append(item)
            elif self.rng.random() > 0.5:
                idx = self.rng.integers(0, self.max_elements)
                out.append(self.items[idx].copy())
                self.items[idx] = item
            else:
                out.append(item)
        return np.stack(out)


def lambda_lr(base_lr: float, n_epochs: int, steps_per_epoch: int) -> Callable[[int], float]:
    """The reference's 'lambda' policy: linear decay to 0 over training
    (run_gan.py get_scheduler), as a function of the optimiser's count."""

    def sched(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * max(0.0, 1.0 - epoch / max(n_epochs, 1))

    return sched


# 14-joint eval subset used by the SPIN feedback reward
# (reference run_gan.py:2096-2097)
SPIN_J14 = (1, 2, 4, 5, 7, 8, 12, 15, 16, 17, 18, 19, 20, 21)


@functools.lru_cache(maxsize=None)
def j14_index(device: torch.device) -> torch.Tensor:
    """SPIN_J14 as an index tensor on `device`, made once."""
    return torch.tensor(SPIN_J14, device=device)


# ---------------------------------------------------------------------------
# the optimiser
# ---------------------------------------------------------------------------

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the number of updates applied and the
    moments, trees shaped like the trained params."""

    count: int
    mu: Any
    nu: Any


class TreeAdam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) over a params tree, updated in
    place, optionally after optax.clip_by_global_norm(clip). lr: a float, or
    a schedule of the count before the update (optax's scale_by_schedule).
    frozen: top-level keys of the params tree that no update touches and
    that hold no moments (optax.multi_transform with set_to_zero)."""

    def __init__(self, lr: Union[float, Callable[[int], float]], clip: Optional[float] = None,
                 frozen: Tuple[str, ...] = ()):
        self.lr, self.clip, self.frozen = lr, clip, frozen

    def trained(self, tree):
        """The part of a params-shaped tree that the optimiser trains."""
        if not self.frozen:
            return tree
        return {k: v for k, v in tree.items() if k not in self.frozen}

    def init(self, params) -> AdamState:
        zeros = lambda: tree_map(lambda t: torch.zeros_like(t.detach()),  # noqa: E731
                                 self.trained(params))
        return AdamState(count=0, mu=zeros(), nu=zeros())

    def update(self, state: AdamState, params, grads) -> None:
        """One update of `params` and `state` in place. grads: a tree shaped
        like the trained params; a None leaf is a zero gradient."""
        rows = [(p, g, m, v) for p, g, m, v in zip(
            param_leaves(self.trained(params)), param_leaves(self.trained(grads)),
            param_leaves(state.mu), param_leaves(state.nu), strict=True) if g is not None]
        ps, gs, ms, vs = (list(c) for c in zip(*rows))
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count += 1
        c1, c2 = 1.0 - ADAM_B1 ** state.count, 1.0 - ADAM_B2 ** state.count
        with torch.no_grad():
            if self.clip is not None:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))
                scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
                gs = torch._foreach_mul(gs, scale)
            torch._foreach_mul_(ms, ADAM_B1)
            torch._foreach_add_(ms, gs, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(vs, ADAM_B2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - ADAM_B2)
            denom = torch._foreach_div(vs, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            step = torch._foreach_div(ms, c1)
            torch._foreach_div_(step, denom)
            torch._foreach_add_(ps, step, alpha=-lr)


def tree_grads(loss: torch.Tensor, params):
    """d loss / d params as a tree shaped like params (None where the loss
    does not depend on a leaf)."""
    leaves = param_leaves(params)
    flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return _rebuild(params, flat)


def _rebuild(tree, flat):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat) for v in tree)
    return next(flat)


def _detached(tree):
    return tree_map(lambda t: t.detach(), tree)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _summed_over(mesh, grads, stats):
    """(grads, stats) summed over the ranks of `mesh` in one collective
    (JAX's psum of both); None gradient leaves stay None."""
    if mesh is None:
        return grads, stats
    from posegen_tpu_torch.parallel.mesh import all_reduce_sum

    leaves = param_leaves(grads)
    red = iter(all_reduce_sum(mesh, [g for g in leaves if g is not None] + list(stats.values())))
    grads = _rebuild(grads, iter([None if g is None else next(red) for g in leaves]))
    return grads, {k: next(red) for k in stats}


def make_generator_step(
    fk_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: GenConfig = GenConfig(),
    lr: float = 1e-4,
    n_epochs: int = 50,
    steps_per_epoch: int = 1000,
    spin_coef: float = 0.1,
    grad_clip: float = 1.0,
    mesh=None,
):
    """Generator update (reference run_gan.py:2014-2107) -> (opt, step).

    The 3-D discriminator judges the generated axis-angle pose itself.
    fk_fn: bones (B, J, 3) -> joints (B, J, 3), differentiable. The SPIN term
    is `1 - mpjpe(spin_pred, joints[sel])` on root-centred 14-joint subsets:
    `spin_pred` is a constant (SPIN ran on rendered images), so the reward
    pushes the generator's joints away from what SPIN predicted.

    step(g_params, g_state, g_opt_state, d_params, noises, real_pose,
    spin_pred (K, 14, 3), spin_sel (K,) int64, spin_active 0 or 1) ->
    (g_params, new_state, g_opt_state, out, stats); the params and the
    optimiser state are updated in place. noises: the generator's {'ba',
    'r', 'eps', 't'} (the JAX step's PRNG key).

    mesh: the data-parallel step of one rank (JAX's axis_name,
    posegen_tpu/gen/gan.py:138-204; `parallel.gan` wraps it), on its rows of
    `real_pose` with everything else replicated: `noises` are the GLOBAL
    batch's (drawn from the replicated generator) and the rank takes its
    rows, BN runs synced, the generated poses are gathered so that
    `spin_sel` indexes the global batch (FK is per row: gathering the bones
    before FK of the selection gives the gathered joints' selection), and
    the losses are local sums over global counts (the gathered SPIN term
    divided by the rank count), so the gradients and stats summed over the
    ranks are the single-device step's on the concatenated batch; `out`
    holds the rank's rows."""
    opt = TreeAdam(lambda_lr(lr, n_epochs, steps_per_epoch), clip=grad_clip)
    n_dev = 1 if mesh is None else mesh.size

    def step(g_params, g_state, g_opt_state: AdamState, d_params, noises, real_pose,
             spin_pred, spin_sel, spin_active):
        if mesh is not None:
            b = real_pose.shape[0]
            noises = {k: v[mesh.rank * b:(mesh.rank + 1) * b] for k, v in noises.items()}
        with torch.enable_grad():
            out, new_state = pose_generator_apply(g_params, g_state, None, real_pose, cfg,
                                                  noises=noises, mesh=mesh)
            # only pose_ba enters the loss, as in the reference's default
            # train_gan: its feedback render uses a fixed extrinsic and its
            # adv / spin terms touch outputs_axis_angle only, so the R / T
            # trunks get no gradient (their moments stay 0)
            logits = pos3d_discriminator_apply(d_params, out["pose_ba"])
            adv = ((logits - 1.0) ** 2).sum() * 0.5 / (logits.shape[0] * n_dev)
            bones = out["pose_ba"]
            if mesh is not None:
                from posegen_tpu_torch.parallel.mesh import gather_rows

                bones = gather_rows(mesh, bones)
            # FK of the selected poses only: the same joints as FK of all,
            # then the selection
            joints = fk_fn(bones.index_select(0, spin_sel))
            j_sel = joints.index_select(1, j14_index(joints.device))
            j_sel = j_sel - j_sel[:, :1]
            pred = spin_pred - spin_pred[:, :1]
            # eps-safe norm: the plain norm has a NaN gradient at exactly-zero
            # differences (root joints coincide when feedback is inactive)
            err = torch.sqrt(((pred - j_sel) ** 2).sum(-1) + 1e-12).mean()
            # every rank computes it from the gathered poses: / n_dev keeps
            # the sum over the ranks the global term
            spin_loss = (1.0 - err) * spin_active / n_dev
            total = adv + spin_coef * spin_loss
            grads = tree_grads(total, g_params)
        stats = {"adv_loss": adv.detach(), "spin_loss": spin_loss.detach(),
                 "gen_loss": total.detach()}
        grads, stats = _summed_over(mesh, grads, stats)
        opt.update(g_opt_state, g_params, grads)
        return g_params, _detached(new_state), g_opt_state, _detached(out), stats

    return opt, step


def make_discriminator_step(
    lr: float = 1e-4,
    n_epochs: int = 50,
    steps_per_epoch: int = 1000,
    grad_clip: float = 1.0,
    mesh=None,
):
    """Discriminator update with pooled fakes (reference train_dis,
    run_gan.py:1143-1178) -> (opt, step). step(d_params, d_opt_state,
    real_kp3d, fake_kp3d) -> (d_params, d_opt_state, stats), in place.

    mesh: one rank's step on its rows of both batches (JAX's axis_name,
    posegen_tpu/gen/gan.py:210-251): local sums over global counts, the
    gradients and stats summed over the ranks."""
    opt = TreeAdam(lambda_lr(lr, n_epochs, steps_per_epoch), clip=grad_clip)
    n_dev = 1 if mesh is None else mesh.size

    def step(d_params, d_opt_state: AdamState, real_kp3d, fake_kp3d):
        with torch.enable_grad():
            real_logits = pos3d_discriminator_apply(d_params, real_kp3d)
            fake_logits = pos3d_discriminator_apply(d_params, fake_kp3d.detach())
            loss = 0.5 * (((real_logits - 1.0) ** 2).sum() / (real_logits.shape[0] * n_dev)
                          + (fake_logits ** 2).sum() / (fake_logits.shape[0] * n_dev))
            grads = tree_grads(loss, d_params)
        with torch.no_grad():
            stats = {"dis_loss": loss.detach(),
                     "real_acc": discriminator_accuracy(real_logits, 1.0) / n_dev,
                     "fake_acc": discriminator_accuracy(fake_logits, 0.0) / n_dev}
        grads, stats = _summed_over(mesh, grads, stats)
        opt.update(d_opt_state, d_params, grads)
        return d_params, d_opt_state, stats

    return opt, step
