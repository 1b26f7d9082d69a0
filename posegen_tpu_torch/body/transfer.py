"""Model-to-model SMPL parameter transfer by optimization (port of
posegen_tpu/body/transfer.py).

Capability parity with the reference's vendored transfer tool
(smplx/transfer_model/transfer_model.py:257-396 `run_fitting` +
losses/losses.py + optimizers/minimize.py): given a source mesh (vertices
on the target model's topology, optionally produced by a deformation-
transfer matrix), recover the target model's parameters (betas, pose,
translation) by minimizing edge + vertex losses.

The JAX package's schedule, step for step: Adam (optax's rule, written out
as `gen/gan.TreeAdam`) on gradients from `torch.autograd`, each stage from
fresh moments, the frozen entries' gradients zeroed so that they stay
where they are: per-joint edge fits (or one joint edge stage), a
translation-only vertex stage, then the full vertex stage with the betas
prior. The CLI, like JAX's, loads its target through `load_smpl_model`, so
it fits SMPL-layout model files.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.body.smpl import SMPLModel
from posegen_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FitConfig:
    edge_steps: int = 300
    vertex_steps: int = 400
    lr: float = 0.05
    betas_weight: float = 1e-3  # shape prior (keep betas near zero)
    # staged schedule mirroring the reference run_fitting
    # (smplx/transfer_model/transfer_model.py:308-380):
    per_part: bool = True  # stage A optimizes one body-pose joint at a time
    part_steps: int = 40  # Adam steps per joint in the per-part stage
    transl_steps: int = 100  # translation-only vertex stage


def apply_deformation_transfer(def_matrix: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Map source-topology vertices onto the target topology
    (reference utils: def_matrix (V_tgt, V_src))."""
    return np.einsum("tv,bvc->btc", def_matrix, vertices)


def _edges_from_faces(faces: np.ndarray) -> np.ndarray:
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def _forward(model: SMPLModel, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    out = model(
        betas=params["betas"],
        body_pose=params["body_pose"],
        global_orient=params["global_orient"],
        transl=params["transl"],
    )
    return out["vertices"]


def init_variables(batch_size: int, model: SMPLModel, n_betas: int = 10) -> Dict:
    """(reference get_variables, transfer_model.py:204-255) float32 zeros on
    the model's device."""
    dev = model.v_template.device
    return {
        "betas": torch.zeros((batch_size, n_betas), device=dev),
        "global_orient": torch.zeros((batch_size, 3), device=dev),
        "body_pose": torch.zeros((batch_size, (model.n_joints - 1) * 3), device=dev),
        "transl": torch.zeros((batch_size, 3), device=dev),
    }


def run_fitting(
    model: SMPLModel,
    target_vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    cfg: FitConfig = FitConfig(),
    def_matrix: Optional[np.ndarray] = None,
    mask_ids: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    """Fit `model` params to target vertices (B, V_tgt, 3) on `device` (CUDA
    by default; raises without a card). The model is moved there
    (`nn.Module.to`).

    Staged schedule mirroring the reference run_fitting
    (smplx/transfer_model/transfer_model.py:257-380):
      A. per-part edge fitting: each body-pose joint's 3 axis-angle params
         are optimized alone (others frozen), one joint after another, for
         part_steps each; or, without per_part, all params for edge_steps;
      B. translation-only vertex fitting;
      C. full vertex fitting over all variables (+ betas prior).

    def_matrix: optional (V_tgt, V_src) mapping when targets come from a
    different topology. mask_ids: optional vertex-id subset; the vertex
    loss sums over it and the edge loss keeps only faces touching it
    (reference f_sel, transfer_model.py:283-290).
    Returns (params as numpy, keys sorted as JAX returns them,
    {'edge_loss', 'vertex_loss'}), each loss the last step's, taken before
    its update.
    """
    from posegen_tpu_torch.gen.gan import TreeAdam

    dev = resolve_device(device)
    model = model.to(dev)
    if def_matrix is not None:
        target_vertices = apply_deformation_transfer(def_matrix, target_vertices)
    target = torch.as_tensor(np.array(target_vertices, np.float32)).to(dev)
    B = target.shape[0]

    faces = faces if faces is not None else model.faces
    if faces is None:
        raise ValueError("need faces for the edge objective")
    faces = np.asarray(faces)
    vmask = None
    if mask_ids is not None:
        sel = np.isin(faces, np.asarray(mask_ids)).any(axis=1)
        faces = faces[sel]
        vm = np.zeros(target.shape[1], np.float32)
        vm[np.asarray(mask_ids)] = 1.0
        vmask = torch.as_tensor(vm).to(dev)[None, :, None]
    edges = torch.as_tensor(_edges_from_faces(faces)).to(dev)
    e0, e1 = edges[:, 0], edges[:, 1]
    gt_edges = target[:, e0] - target[:, e1]

    params = {k: v.requires_grad_(True)
              for k, v in init_variables(B, model, model.shapedirs.shape[-1]).items()}

    def edge_loss_fn(p):
        v = _forward(model, p)
        est = v[:, e0] - v[:, e1]
        return torch.mean(torch.sum((est - gt_edges) ** 2, -1))

    def vertex_loss_fn(p):
        v = _forward(model, p)
        sq = torch.sum((v - target) ** 2, -1, keepdim=True)
        if vmask is not None:
            sq = sq * vmask
        return torch.mean(sq) + cfg.betas_weight * torch.mean(p["betas"] ** 2)

    def masked_steps(loss_fn, mask, n_steps) -> torch.Tensor:
        """Adam from fresh moments on the entries `mask` selects: {key: 1 for
        the whole leaf, or a 0 / 1 tensor}; keys it leaves out are frozen.
        -> the losses, one a step."""
        opt = TreeAdam(cfg.lr)
        state = opt.init(params)
        keys = sorted(mask)
        losses = []
        for _ in range(n_steps):
            loss = loss_fn(params)
            grads = dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys])))
            grads = {k: (grads[k] * mask[k] if k in grads else None) for k in params}
            opt.update(state, params, grads)
            losses.append(loss.detach())
        return torch.stack(losses)

    everything = {k: 1.0 for k in params}
    if cfg.per_part and cfg.part_steps > 0:
        n_pose = params["body_pose"].shape[-1]
        joint_of = torch.arange(n_pose, device=dev) // 3
        e_last = None
        for j in range(n_pose // 3):
            jm = (joint_of == j).to(torch.float32).expand(B, n_pose)
            e_last = masked_steps(edge_loss_fn, {"body_pose": jm}, cfg.part_steps)[-1]
    else:
        e_last = masked_steps(edge_loss_fn, everything, cfg.edge_steps)[-1]
    if cfg.transl_steps > 0:
        masked_steps(vertex_loss_fn, {"transl": 1.0}, cfg.transl_steps)
    v_losses = masked_steps(vertex_loss_fn, everything, cfg.vertex_steps)

    out = {k: params[k].detach().cpu().numpy() for k in sorted(params)}
    return out, {"edge_loss": float(e_last), "vertex_loss": float(v_losses[-1])}


# ---------------------------------------------------------------------------
# CLI: the `python -m transfer_model` analog
# (reference smplx/transfer_model/__main__.py + config_files/*.yaml)
# ---------------------------------------------------------------------------


def _read_mesh_vertices(path: str) -> np.ndarray:
    """Vertices from .obj/.ply(ascii)/.npy/.npz (the reference reads meshes
    with open3d; these cover its transfer-data formats without it)."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    if path.endswith(".npz"):
        d = np.load(path)
        key = "vertices" if "vertices" in d else list(d.keys())[0]
        return np.asarray(d[key], np.float32)
    verts = []
    if path.endswith(".obj"):
        with open(path) as f:
            for line in f:
                if line.startswith("v "):
                    verts.append([float(x) for x in line.split()[1:4]])
        return np.asarray(verts, np.float32)
    if path.endswith(".ply"):
        with open(path, "rb") as f:
            header = []
            while True:
                line = f.readline().decode("ascii", "ignore").strip()
                header.append(line)
                if line == "end_header":
                    break
            n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
            if any("binary" in h for h in header):
                raise ValueError(f"binary ply unsupported: {path}")
            for _ in range(n):
                verts.append([float(x) for x in f.readline().split()[:3]])
        return np.asarray(verts, np.float32)
    raise ValueError(f"unsupported mesh format: {path}")


def _load_def_matrix(path: str) -> np.ndarray:
    import pickle

    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    if path.endswith(".npz"):
        d = np.load(path)
        return np.asarray(d[list(d.keys())[0]], np.float32)
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if hasattr(data, "todense"):
        data = np.asarray(data.todense())
    elif isinstance(data, dict):
        data = data.get("mtx", data.get("def_matrix"))
        if data is None:
            raise KeyError(
                f"{path}: deformation-transfer pickle must carry 'mtx' or 'def_matrix'"
            )
        if hasattr(data, "todense"):
            data = np.asarray(data.todense())
    return np.asarray(data, np.float32)


def main(argv=None, device="cuda") -> None:
    """python -m posegen_tpu_torch.body.transfer --target-model SMPL.pkl
    --mesh-dir meshes/ [--def-matrix def.pkl] --out fits.npz

    Fits the target body model's parameters to each source mesh on `device`
    (reference transfer tool driver, smplx/transfer_model/__main__.py:36);
    the npz holds the params' keys in JAX's order, then mesh_paths."""
    import argparse
    import glob as _glob
    import os

    from posegen_tpu_torch.body.smpl import load_smpl_model

    p = argparse.ArgumentParser("posegen_tpu.body.transfer")
    p.add_argument("--target-model", required=True, help="SMPL-family .pkl/.npz")
    p.add_argument("--mesh-dir", required=True,
                   help="dir of source meshes (.obj/.ply/.npy/.npz)")
    p.add_argument("--def-matrix", default=None,
                   help="deformation-transfer matrix (.pkl/.npy/.npz) mapping "
                        "source topology -> target topology")
    p.add_argument("--out", default="transfer_fits.npz")
    p.add_argument("--edge-steps", type=int, default=300)
    p.add_argument("--vertex-steps", type=int, default=400)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--batch", type=int, default=8)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    model = load_smpl_model(args.target_model, device=dev)
    def_matrix = _load_def_matrix(args.def_matrix) if args.def_matrix else None
    cfg = FitConfig(edge_steps=args.edge_steps, vertex_steps=args.vertex_steps, lr=args.lr)

    paths = sorted(
        q for ext in ("obj", "ply", "npy", "npz")
        for q in _glob.glob(os.path.join(args.mesh_dir, f"*.{ext}"))
    )
    if not paths:
        raise SystemExit(f"no meshes under {args.mesh_dir}")

    all_params, losses = [], []
    for s in range(0, len(paths), args.batch):
        chunk = paths[s:s + args.batch]
        verts = np.stack([_read_mesh_vertices(q) for q in chunk])
        params, info = run_fitting(model, verts, cfg=cfg, def_matrix=def_matrix, device=dev)
        all_params.append(params)
        losses.append(info["vertex_loss"])
        print(f"[{s + len(chunk)}/{len(paths)}] v2v loss {info['vertex_loss']:.6f}")

    out = {k: np.concatenate([pp[k] for pp in all_params]) for k in all_params[0]}
    out["mesh_paths"] = np.asarray(paths)
    np.savez(args.out, **out)
    print(f"wrote {args.out} (mean v2v {np.mean(losses):.6f})")


if __name__ == "__main__":
    main()
