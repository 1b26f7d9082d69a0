"""Checkpointing (port of posegen_tpu/train/checkpoints.py): the native
.npz train states, the reference's PyTorch .tar scheme, and pose files.

Native format: one .npz per step holding the flattened train state (key
path -> array), the JAX package's own format, so a run resumes in either
package from the other's file. A JAX file's keys are the paths of its
TrainState pytree: `step`, `params//coarse//pts_linears//0//w`,
`embeds//embed_kp//tau`, and optax's optimizer states (`_nerf_adam_prefix`,
`_pose_adam_prefix`). The port keeps Adam's moments in a torch.optim.Adam
and in `PoseOptState`, so `_state_flat` and `_state_from_flat` map them to
and from those paths explicitly.

Torch format: the reference saves `torch.save({global_step,
network_fn_state_dict, network_fine_state_dict, embed/embeddirs/
embedbones_state_dict, poseopt_layer_state_dict, ...})` (core/trainer.py:
487-518, key mangling core/raycasters.py:752-766). `import_torch_checkpoint`
maps those tensors onto the render params tree, transposing Linear weights
(torch stores (out, in); the nets apply x @ W), and
`export_torch_checkpoint` writes the inverse.
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.train.trainer import (
    PoseOptState, TrainState, param_leaves, trainable, tree_map,
)
from posegen_tpu_torch.utils.torch_import import t_linear

# ---------------------------------------------------------------------------
# native npz checkpoints
# ---------------------------------------------------------------------------

_SEP = "//"


def _join(prefix: str, key) -> str:
    return f"{prefix}{_SEP}{key}" if prefix else str(key)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Dicts and lists of tensors or arrays -> {key path: host array}; None
    subtrees hold no keys."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, _join(prefix, k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, _join(prefix, i)))
    elif tree is None:
        pass
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach().cpu().numpy()
    else:
        out[prefix] = np.asarray(tree)
    return out


def _get(flat: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"checkpoint missing key {key!r}")
    return flat[key]


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """Rebuild a tree of tensors with the template's structure and the
    npz's values; each leaf keeps the template leaf's dtype and device."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, _join(prefix, k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        seq = [_unflatten_into(v, flat, _join(prefix, i)) for i, v in enumerate(template)]
        return seq if isinstance(template, list) else tuple(seq)
    if template is None:
        return None
    return torch.as_tensor(_get(flat, prefix)).to(device=template.device, dtype=template.dtype)


def _nerf_adam_prefix(opt: Optional[torch.optim.Adam]) -> Optional[str]:
    """Where optax keeps the NeRF Adam's state in a JAX TrainState:
    `nerf_optimizer` builds optax.adam with a schedule, a chain whose state is
    (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)) under
    `opt_state`; with weight decay, add_decayed_weights (no leaves) comes
    first, so the pair moves to `opt_state//1`; testopt's set_to_zero keeps
    no leaves at all (None)."""
    if opt is None:
        return None
    return _join("opt_state", 1) if opt.defaults["weight_decay"] else "opt_state"


def _pose_adam_prefix(st: PoseOptState) -> str:
    """The pose Adam's state path: `pose_opt_state`, or with opt_pose_step >
    1 (optax.MultiSteps; its acc_grads, mini_step and gradient_step beside)
    `pose_opt_state//inner_opt_state`."""
    return "pose_opt_state//inner_opt_state" if st.acc_grads is not None else "pose_opt_state"


def _adam_flat(prefix: str, count: int, mu, nu) -> Dict[str, np.ndarray]:
    n = np.asarray(count, np.int32)
    out = {_join(prefix, "0//count"): n, _join(prefix, "1//count"): n}
    out.update(_flatten(mu, _join(prefix, "0//mu")))
    out.update(_flatten(nu, _join(prefix, "0//nu")))
    return out


def _adam_from_flat(flat, prefix: str, template) -> Tuple[int, Any, Any]:
    return (int(_get(flat, _join(prefix, "0//count"))),
            _unflatten_into(template, flat, _join(prefix, "0//mu")),
            _unflatten_into(template, flat, _join(prefix, "0//nu")))


def _state_flat(state: TrainState) -> Dict[str, np.ndarray]:
    """The port's TrainState -> the JAX TrainState's key paths and dtypes."""
    flat = {"step": np.asarray(state.step, np.int32)}
    flat.update(_flatten(state.params, "params"))
    flat.update(_flatten(state.embeds, "embeds"))
    opt = state.opt_state
    prefix = _nerf_adam_prefix(opt)
    if prefix is not None:
        moment = lambda key: tree_map(  # noqa: E731
            lambda p: opt.state[p][key] if p in opt.state else torch.zeros_like(p), state.params)
        steps = [opt.state[p]["step"] for p in param_leaves(state.params) if p in opt.state]
        count = int(steps[0]) if steps else 0
        flat.update(_adam_flat(prefix, count, moment("exp_avg"), moment("exp_avg_sq")))
    flat.update(_flatten(state.pose_params, "pose_params"))
    flat.update(_flatten(state.pose_anchors, "pose_anchors"))
    st = state.pose_opt_state
    if st is not None:
        flat.update(_adam_flat(_pose_adam_prefix(st), st.count, st.mu, st.nu))
        if st.acc_grads is not None:
            flat["pose_opt_state//mini_step"] = np.asarray(st.mini_step, np.int32)
            flat["pose_opt_state//gradient_step"] = np.asarray(st.gradient_step, np.int32)
            flat.update(_flatten(st.acc_grads, "pose_opt_state//acc_grads"))
    return flat


def _state_from_flat(flat: Dict[str, np.ndarray], template: TrainState) -> TrainState:
    """The inverse of `_state_flat` into a template's structure, devices and
    optimizer settings: the state `utils.convert.train_state_from_numpy`
    builds from the same JAX state."""
    params = trainable(_unflatten_into(template.params, flat, "params"))
    opt = None
    if template.opt_state is not None:
        opt = type(template.opt_state)(param_leaves(params), **template.opt_state.defaults)
        count, mu, nu = _adam_from_flat(flat, _nerf_adam_prefix(opt), template.params)
        for p, m, v in zip(param_leaves(params), param_leaves(mu), param_leaves(nu), strict=True):
            opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
    pose_params = None
    if template.pose_params is not None:
        pose_params = trainable(_unflatten_into(template.pose_params, flat, "pose_params"))
    pose_opt = None
    tst = template.pose_opt_state
    if tst is not None:
        count, mu, nu = _adam_from_flat(flat, _pose_adam_prefix(tst), tst.mu)
        pose_opt = PoseOptState(count=count, mu=mu, nu=nu)
        if tst.acc_grads is not None:
            pose_opt.mini_step = int(_get(flat, "pose_opt_state//mini_step"))
            pose_opt.gradient_step = int(_get(flat, "pose_opt_state//gradient_step"))
            pose_opt.acc_grads = _unflatten_into(tst.acc_grads, flat, "pose_opt_state//acc_grads")
    return TrainState(step=int(_get(flat, "step")), params=params,
                      embeds=_unflatten_into(template.embeds, flat, "embeds"), opt_state=opt,
                      pose_params=pose_params,
                      pose_anchors=_unflatten_into(template.pose_anchors, flat, "pose_anchors"),
                      pose_opt_state=pose_opt)


def save_checkpoint(log_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    """Write logs/{exp}/{step:08d}.ckpt.npz (analog of the reference's
    {i:06d}.tar, trainer.py:487-508), loadable by either package."""
    os.makedirs(log_dir, exist_ok=True)
    if step is None:
        step = int(state.step)
    path = os.path.join(log_dir, f"{step:08d}.ckpt.npz")
    np.savez(path, **_state_flat(state))
    return path


def latest_checkpoint(log_dir: str) -> Optional[str]:
    ckpts = sorted(glob(os.path.join(log_dir, "*.ckpt.npz")))
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a train state (from either package's file) given a template
    of the same configuration, e.g. a freshly built state: its tree, devices
    and optimizers (weight decay, testopt, MultiSteps) say which keys the
    file must hold."""
    return _state_from_flat(dict(np.load(path)), template)


# ---------------------------------------------------------------------------
# PyTorch .tar import
# ---------------------------------------------------------------------------

def _f32(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().to("cpu", torch.float32)


def _import_nerf_net(sd: Dict, dev) -> Dict[str, Any]:
    """One reference NeRF state dict -> the params subtree
    (param names from reference core/networks/nerf.py:46-88)."""
    n_layers = 1 + max(
        int(m.group(1)) for k in sd if (m := re.match(r"pts_linears\.(\d+)\.weight", k))
    )
    params: Dict[str, Any] = {
        "pts_linears": [t_linear(sd, f"pts_linears.{i}", dev) for i in range(n_layers)]
    }
    for name in ("alpha_linear", "feature_linear", "rgb_linear", "output_linear"):
        if f"{name}.weight" in sd:
            params[name] = t_linear(sd, name, dev)
    view_idxs = sorted(
        int(m.group(1)) for k in sd if (m := re.match(r"views_linears\.(\d+)\.weight", k))
    )
    if view_idxs:
        params["views_linears"] = [t_linear(sd, f"views_linears.{i}", dev)
                                   for i in view_idxs]
    if "framecodes.codes.weight" in sd:
        params["framecodes"] = _f32(sd["framecodes.codes.weight"]).to(dev)
    return params


def _import_embed(sd: Dict, dev) -> Dict[str, torch.Tensor]:
    out = {k: _f32(sd[k]).to(dev) for k in ("tau", "cutoff_dist") if k in sd}
    out["alpha"] = _f32(sd.get("sched_alpha", 0.0)).to(dev)
    return out


def import_torch_checkpoint(path: str, device="cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load a reference .tar -> (variables, extras) on `device`.

    variables: {'coarse', 'fine', 'embed_kp', 'embed_view', 'embed_bone'}
    ready for render_rays. extras: {'global_step'}, and with a pose layer
    'pose_params' (and a multiview layer's 'kp_map', 'kp_uidxs')."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)

    variables: Dict[str, Any] = {}
    if "network_fn_state_dict" in ckpt:
        variables["coarse"] = _import_nerf_net(ckpt["network_fn_state_dict"], dev)
    if ckpt.get("network_fine_state_dict"):
        variables["fine"] = _import_nerf_net(ckpt["network_fine_state_dict"], dev)
    for src, dst in (
        ("embed_state_dict", "embed_kp"),
        ("embeddirs_state_dict", "embed_view"),
        ("embedbones_state_dict", "embed_bone"),
    ):
        # empty state dicts still count (a no-cutoff Embedder has no buffers,
        # but render_rays indexes the state unconditionally)
        if ckpt.get(src) is not None:
            variables[dst] = _import_embed(ckpt[src], dev)

    extras: Dict[str, Any] = {"global_step": int(ckpt.get("global_step", 0))}
    popt = ckpt.get("poseopt_layer_state_dict")
    if popt:
        extras["pose_params"] = {k: _f32(popt[k]).to(dev)
                                 for k in ("pelvis", "bones", "root_bones") if k in popt}
        # multiview layers carry their sharing maps as long buffers
        # (reference pose_opt.py:258-260)
        for k in ("kp_map", "kp_uidxs"):
            if k in popt:
                extras[k] = torch.as_tensor(popt[k]).to(dev, torch.int64)
    return variables, extras


# ---------------------------------------------------------------------------
# PyTorch .tar export (the import's inverse: reference tooling can consume
# checkpoints trained here)
# ---------------------------------------------------------------------------

def _export_linear(p: Dict) -> Dict[str, torch.Tensor]:
    """{'w': (in, out), 'b': (out,)} -> torch Linear tensors (out, in) / (out,)."""
    return {"weight": _f32(p["w"]).t().contiguous(), "bias": _f32(p["b"]).clone()}


def _export_nerf_net(params: Dict) -> Dict[str, torch.Tensor]:
    """A params subtree -> the reference NeRF module's state dict
    (param names from reference core/networks/nerf.py:69-88)."""
    sd = {}
    for i, lay in enumerate(params["pts_linears"]):
        for k, v in _export_linear(lay).items():
            sd[f"pts_linears.{i}.{k}"] = v
    for i, lay in enumerate(params.get("views_linears", [])):
        for k, v in _export_linear(lay).items():
            sd[f"views_linears.{i}.{k}"] = v
    for name in ("alpha_linear", "feature_linear", "rgb_linear", "output_linear"):
        if name in params:
            for k, v in _export_linear(params[name]).items():
                sd[f"{name}.{k}"] = v
    if "framecodes" in params:
        sd["framecodes.codes.weight"] = _f32(params["framecodes"]).clone()
    return sd


def _export_embed(state: Optional[Dict], ecfg) -> Dict:
    """An embed state -> the reference CutoffEmbedder's state dict. A
    cutoff-less Embedder has no params or buffers (reference
    cutoff_embedder.py:91-99 registers cutoff_dist / tau only on the cutoff
    class, sched_alpha only under freq_schedule): emit exactly the keys the
    module owns, so the reference's strict load_state_dict accepts them."""
    sd: Dict = {}
    if state is None or ecfg is None or not getattr(ecfg, "cutoff", False):
        return sd
    sd["cutoff_dist"] = _f32(state["cutoff_dist"]).clone()
    sd["tau"] = _f32(state["tau"]).clone()
    if getattr(ecfg, "freq_schedule", False):
        sd["sched_alpha"] = _f32(state["alpha"]).clone()
    return sd


def export_torch_checkpoint(
    path: str,
    variables: Dict[str, Any],
    cfg,
    global_step: int = 0,
    pose_params: Optional[Dict] = None,
    rest_pose=None,
    opt_pose_lrate: float = 5e-4,
    kp_map=None,
    kp_uidxs=None,
) -> str:
    """Write a reference-format .tar (inverse of import_torch_checkpoint).

    Key scheme = reference Trainer.save_nerf (core/trainer.py:487-508) +
    RayCaster.state_dict mangling (core/raycasters.py:752-766):
    network_fn/network_fine/embed/embeddirs/embedbones _state_dict entries,
    global_step, and, when pose_params is given, poseopt_layer_state_dict
    (pelvis/bones + the rest_pose buffer the strict load expects,
    pose_opt.py:279-295) with a fresh pose_optimizer_state_dict
    (pose_opt.py:54-55 loads it unconditionally). optimizer_state_dict is
    omitted: the reference treats it as optional (run_nerf_helpers.py:14-15)
    and resumes with a fresh Adam.

    variables: the render params tree, tensors on any device; cfg: the
    RaycastConfig (each embedder's cutoff / freq_schedule says which buffers
    the reference module owns)."""
    ckpt: Dict[str, Any] = {
        "global_step": int(global_step),
        "network_fn_state_dict": _export_nerf_net(variables["coarse"]),
    }
    if "fine" in variables:
        ckpt["network_fine_state_dict"] = _export_nerf_net(variables["fine"])
    for src, dst, ecfg in (
        ("embed_kp", "embed_state_dict", cfg.embed_kp_cfg),
        ("embed_view", "embeddirs_state_dict", cfg.embed_view_cfg),
        ("embed_bone", "embedbones_state_dict", cfg.embed_bone_cfg),
    ):
        if src in variables:
            ckpt[dst] = _export_embed(variables[src], ecfg)
    if pose_params is not None:
        if rest_pose is None:
            raise ValueError(
                "pose export needs rest_pose: the reference PoseOptLayer's "
                "strict load expects its rest_pose buffer in the state dict"
            )
        popt_sd = {k: _f32(v).clone() for k, v in pose_params.items()}
        # the reference layer registers rest_pose as (1, J, 3)
        # (pose_opt.py:249); a (J, 3) buffer fails its strict load
        rp = _f32(rest_pose).clone()
        popt_sd["rest_pose"] = rp[None] if rp.dim() == 2 else rp
        if "root_bones" in pose_params:
            # multiview layout: the reference PoseOptLayer registers kp_map /
            # kp_uidxs as long buffers (pose_opt.py:258-260) and its strict
            # load (pose_opt.py:222-226) requires them
            if kp_map is None or kp_uidxs is None:
                raise ValueError(
                    "multiview pose export (root_bones present) needs "
                    "kp_map and kp_uidxs: the reference PoseOptLayer "
                    "stores them as buffers in its state dict"
                )
            popt_sd["kp_map"] = torch.as_tensor(kp_map).detach().to("cpu", torch.int64)
            popt_sd["kp_uidxs"] = torch.as_tensor(kp_uidxs).detach().to("cpu", torch.int64)
        ckpt["poseopt_layer_state_dict"] = popt_sd
        # a fresh Adam over the layer's parameter list, exactly as
        # create_popt builds it (pose_opt.py:43-46)
        dummy = [torch.nn.Parameter(_f32(pose_params[k]).clone()) for k in pose_params]
        ckpt["pose_optimizer_state_dict"] = torch.optim.Adam(
            dummy, lr=opt_pose_lrate, betas=(0.9, 0.999)
        ).state_dict()
    torch.save(ckpt, path)
    return path


def load_pose_params(path: str, device="cuda") -> Dict[str, torch.Tensor]:
    """Pose params from a pose / full checkpoint, native .npz or torch .tar
    (reference --init_poseopt / load_poseopt_from_state_dict,
    pose_opt.py:212), on `device`."""
    dev = resolve_device(device)
    if path.endswith(".tar"):
        _, extras = import_torch_checkpoint(path, dev)
        if "pose_params" not in extras:
            raise KeyError(f"{path} carries no poseopt state")
        return extras["pose_params"]
    flat = dict(np.load(path))
    out = {k.split(_SEP, 1)[1]: torch.as_tensor(v).to(dev)
           for k, v in flat.items() if k.startswith("pose_params" + _SEP)}
    if not out:
        raise KeyError(f"{path} carries no pose_params")
    return out


def save_pose_checkpoint(log_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    """Pose-only checkpoint (reference save_popt, trainer.py:510-518:
    poseopt layer + anchors saved separately every i_pose_weights)."""
    os.makedirs(log_dir, exist_ok=True)
    if step is None:
        step = int(state.step)
    path = os.path.join(log_dir, f"{step:08d}.pose.npz")
    flat = {}
    flat.update(_flatten(state.pose_params, "pose_params"))
    flat.update(_flatten(state.pose_anchors, "pose_anchors"))
    flat["global_step"] = np.asarray(step)
    np.savez(path, **flat)
    return path
