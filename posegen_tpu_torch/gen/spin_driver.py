"""SPIN fine-tuning drivers: over generated renders (+ optional MPII mix),
and on SKI-Pose (port of posegen_tpu/gen/spin_driver.py).

Capability parity with reference `train_spin` (run_gan.py:1849-1952): epochs
over the NeRF-rendered (image, pose) dataset with the hinge-filtered
scale-normalized joint loss, optional MPII passes (no hinge), periodic 3DPW
evaluation, checkpoints per epoch. The steps are gen/spin_train.py's, on
the device of the SPIN params; the datasets are host code. The dropout
masks come from a torch generator seeded `seed` on that device (the JAX
driver splits a PRNG key). The per-epoch `spin_{epoch:03d}.npz` /
`spin_ski_{epoch:03d}.npz` files are the JAX package's: its keys, its HWIO
conv weights.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from posegen_tpu_torch.gen.datasets import MPIIPoseDataset, RenderedPoseDataset
from posegen_tpu_torch.gen.hmr import dropout_masks
from posegen_tpu_torch.gen.spin_train import make_ski_finetune_step, make_spin_finetune_step
from posegen_tpu_torch.train.checkpoints import _flatten
from posegen_tpu_torch.train.trainer import trainable
from posegen_tpu_torch.utils.convert import hmr_to_numpy


def train_spin(
    spin_params: Dict,
    spin_state: Dict,
    render_dir: str,
    mpii_annot: Optional[str] = None,
    mpii_img_dir: Optional[str] = None,
    epochs: int = 10,
    batch_size: int = 32,
    lr: float = 5e-5,  # reference --lr_spin default (run_gan.py:79)
    pose_scale: float = 0.4,
    crop=(100, 412),
    res: int = 224,
    ckpt_dir: Optional[str] = None,
    evaluator=None,
    hinge: Optional[float] = 0.02,  # reference run_gan.py:1890-1914 filter
    seed: int = 0,
    mesh=None,
):
    """Fine-tune SPIN; returns (params, opt metrics history).

    mesh: data-parallel fine-tuning over a `parallel.mesh.Mesh`
    (parallel/gan.make_parallel_spin_finetune_step): every rank reads the
    same global batches and trains on its rows with dropout masks drawn per
    rank; only rank 0 writes the checkpoints. batch_size must divide over
    the ranks; both datasets yield whole batches only, so JAX's trim of
    each batch to a multiple of the ranks (posegen_tpu/gen/spin_driver.py:
    69-71) has nothing to cut."""
    nerf_ds = RenderedPoseDataset(render_dir, crop=crop, res=res, pose_scale=pose_scale)
    if len(nerf_ds) == 0:
        raise FileNotFoundError(f"no rendered (image, pose) pairs under {render_dir}")
    mpii_ds = (
        MPIIPoseDataset(mpii_annot, mpii_img_dir, res=res, pose_scale=pose_scale)
        if mpii_annot and mpii_img_dir
        else None
    )
    parallel = mesh is not None and mesh.size > 1
    if parallel:
        from posegen_tpu_torch.parallel.gan import make_parallel_spin_finetune_step

        if batch_size % mesh.size != 0:
            raise ValueError(f"batch_size ({batch_size}) must divide over the "
                             f"{mesh.size}-device mesh")
        opt_h, step_hinge = make_parallel_spin_finetune_step(
            mesh, lr=lr, pose_scale=pose_scale, hinge=hinge)
        _, step_plain = make_parallel_spin_finetune_step(
            mesh, lr=lr, pose_scale=pose_scale, hinge=None)
    else:
        opt_h, step_hinge = make_spin_finetune_step(lr=lr, pose_scale=pose_scale, hinge=hinge)
        _, step_plain = make_spin_finetune_step(lr=lr, pose_scale=pose_scale, hinge=None)
    spin_params = trainable(spin_params)
    opt_state = opt_h.init(spin_params)
    dev = spin_params["conv1"]["w"].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step(fn, b):
        nonlocal opt_state
        images = torch.as_tensor(b["image"]).to(dev).permute(0, 3, 1, 2)
        gt = torch.as_tensor(b["pose"]).to(dev)
        key = gen if parallel else dropout_masks(gen, images.shape[0])
        _, opt_state, stats = fn(spin_params, spin_state, opt_state, images, gt, key)
        return float(stats["spin_loss"])

    history = []
    for epoch in range(epochs):
        # NeRF-render passes (hinge filter, reference run_gan.py:1890-1914)
        losses = [step(step_hinge, b) for b in nerf_ds.batches(batch_size, seed=seed + epoch)]
        # MPII mix passes (no hinge, reference :1916-1940)
        if mpii_ds is not None:
            idxs = np.random.default_rng(seed + epoch).permutation(len(mpii_ds))
            for s in range(0, len(idxs) - batch_size + 1, batch_size):
                items = [mpii_ds[int(i)] for i in idxs[s : s + batch_size]]
                losses.append(step(step_plain, {k: np.stack([it[k] for it in items])
                                                for k in items[0]}))

        entry = {"epoch": epoch, "spin_loss": float(np.mean(losses)) if losses else 0.0}
        if evaluator is not None:
            entry["eval"] = evaluator(spin_params, spin_state)
        history.append(entry)
        print(f"spin epoch {epoch}: {entry}")

        if ckpt_dir and (mesh is None or mesh.rank == 0):  # per epoch (reference :1946-1951)
            os.makedirs(ckpt_dir, exist_ok=True)
            # the JAX package's file: its keys, its (HWIO) conv layout
            p_np, s_np = hmr_to_numpy(spin_params, spin_state)
            np.savez(os.path.join(ckpt_dir, f"spin_{epoch:03d}.npz"),
                     **_flatten({"params": p_np, "state": s_np}))
    return spin_params, history


def train_ski(
    spin_params: Dict,
    spin_state: Dict,
    ski_root: str,
    smpl_neutral,
    J_regressor,
    split: str = "train2/train",  # reference's train split path (:2677)
    epochs: int = 1,
    batch_size: int = 32,
    lr: float = 5e-5,
    res: int = 224,
    ckpt_dir: Optional[str] = None,
    evaluator=None,
    seed: int = 0,
):
    """Fine-tune SPIN on SKI-Pose 3D-joint GT (reference train_ski,
    render_3dpw_testset.py:2659-2775): shuffled epochs over the SKI train
    split (numpy's default_rng(seed + epoch) permutation) with the
    mesh-regressed scale-matched MPJPE loss, per-epoch eval hook (the
    reference calls evaluate_ski). smpl_neutral: a port SMPLModel, moved to
    the device of the SPIN params. Returns (params, history)."""
    from posegen_tpu_torch.evals.harness import SkiDataset

    ds = SkiDataset(ski_root, split=split, res=res)
    if len(ds) == 0:
        raise FileNotFoundError(f"no SKI samples under {ski_root}/{split}")
    spin_params = trainable(spin_params)
    dev = spin_params["conv1"]["w"].device
    opt, step = make_ski_finetune_step(smpl_neutral.to(dev), J_regressor, lr=lr)
    opt_state = opt.init(spin_params)
    gen = torch.Generator(device=dev).manual_seed(seed)

    history = []
    for epoch in range(epochs):
        idxs = np.random.default_rng(seed + epoch).permutation(len(ds))
        losses = []
        for s in range(0, len(idxs) - batch_size + 1, batch_size) or [0]:
            items = [ds[int(i)] for i in idxs[s : s + batch_size]]
            images = torch.as_tensor(np.stack([it["image"] for it in items])).to(dev)
            gts = torch.as_tensor(np.stack([it["pose_3d"] for it in items])).to(dev)
            images = images.permute(0, 3, 1, 2)
            _, opt_state, stats = step(spin_params, spin_state, opt_state, images, gts,
                                       dropout_masks(gen, images.shape[0]))
            losses.append(float(stats["spin_loss"]))
        entry = {"epoch": epoch, "ski_loss": float(np.mean(losses)) if losses else 0.0}
        if evaluator is not None:  # reference: evaluate_ski per epoch (:2775)
            entry["eval"] = evaluator(spin_params, spin_state)
        history.append(entry)
        print(f"ski epoch {epoch}: {entry}")
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            p_np, s_np = hmr_to_numpy(spin_params, spin_state)
            np.savez(os.path.join(ckpt_dir, f"spin_ski_{epoch:03d}.npz"),
                     **_flatten({"params": p_np, "state": s_np}))
    return spin_params, history
