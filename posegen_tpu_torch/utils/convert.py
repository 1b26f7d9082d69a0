"""The weight bridge: a posegen_tpu parameter tree, as nested dicts and lists
of numpy arrays, -> the port's parameters.

Both packages keep the same tree layout ({"coarse": {"pts_linears":
[{"w", "b"}, ...], "alpha_linear", ...}, "fine": ..., "embed_kp": {"tau",
"alpha", "cutoff_dist"}, ...}) and linear weights stored (in, out), so the
bridge converts leaves only; the two then compute the same function.
`train_state_from_numpy` carries a whole JAX train state over, the Adam
moments included, and with pose refinement the pose params, their anchors
and the pose optimizer's state (optax.MultiSteps' counters and
accumulated gradients too), so a JAX run resumes in the port mid-way
through an accumulation.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts / lists / tuples of array-likes -> the same structure of
    tensors on `device` (floats as float32, integers as int64)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a).to(device)


def _adam_state(opt_state):
    """The node of an optax state tree that holds Adam's count / mu / nu
    (optax.adam alone, or chained after add_decayed_weights)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (list, tuple)):
        for node in opt_state:
            found = _adam_state(node)
            if found is not None:
                return found
    return None


def _pose_opt_state(state, device):
    """An optax pose optimizer state (adam, or MultiSteps around it) with
    numpy leaves -> the port's PoseOptState."""
    from posegen_tpu_torch.train.trainer import PoseOptState

    multi = hasattr(state, "mini_step")
    adam = _adam_state(state.inner_opt_state if multi else state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the pose optimizer state")
    st = PoseOptState(count=int(np.asarray(adam.count)), mu=params_from_numpy(adam.mu, device),
                      nu=params_from_numpy(adam.nu, device))
    if multi:
        st.mini_step = int(np.asarray(state.mini_step))
        st.gradient_step = int(np.asarray(state.gradient_step))
        st.acc_grads = params_from_numpy(state.acc_grads, device)
    return st


def train_state_from_numpy(state, tcfg, device):
    """A posegen_tpu TrainState with numpy leaves (step, params, embeds and
    optax's Adam state: count, mu, nu; with pose refinement the pose params,
    anchors and pose optimizer state) -> the port's TrainState on `device`,
    its torch Adam carrying the same moments and count."""
    from posegen_tpu_torch.train.trainer import (
        TrainState, nerf_optimizer, param_leaves, trainable,
    )

    params = trainable(params_from_numpy(state.params, device))
    opt = nerf_optimizer(tcfg, params)
    if opt is not None:
        adam = _adam_state(state.opt_state)
        if adam is None:
            raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
        count = float(np.asarray(adam.count))
        mu = param_leaves(params_from_numpy(adam.mu, device))
        nu = param_leaves(params_from_numpy(adam.nu, device))
        for p, m, v in zip(param_leaves(params), mu, nu, strict=True):
            opt.state[p] = {"step": torch.tensor(count), "exp_avg": m, "exp_avg_sq": v}
    pose_params = pose_anchors = pose_opt = None
    if getattr(state, "pose_params", None) is not None:
        pose_params = trainable(params_from_numpy(state.pose_params, device))
    if getattr(state, "pose_anchors", None) is not None:
        pose_anchors = params_from_numpy(state.pose_anchors, device)
    if getattr(state, "pose_opt_state", None) is not None:
        pose_opt = _pose_opt_state(state.pose_opt_state, device)
    return TrainState(step=int(np.asarray(state.step)), params=params,
                      embeds=params_from_numpy(state.embeds, device), opt_state=opt,
                      pose_params=pose_params, pose_anchors=pose_anchors,
                      pose_opt_state=pose_opt)


# ---------------------------------------------------------------------------
# the pose GAN and HMR (gen/)
# ---------------------------------------------------------------------------

def generator_from_numpy(params, state, device):
    """A posegen_tpu pose generator's (params, bn_state) -> the port's: the
    same trees (linear weights (in, out)), the params trainable."""
    from posegen_tpu_torch.train.trainer import trainable

    return trainable(params_from_numpy(params, device)), params_from_numpy(state, device)


def discriminator_from_numpy(params, device):
    """A posegen_tpu discriminator's params -> the port's, trainable."""
    from posegen_tpu_torch.train.trainer import trainable

    return trainable(params_from_numpy(params, device))


def hmr_from_numpy(params, state, device):
    """A posegen_tpu HMR's (params, bn_state) -> the port's: the conv
    weights from JAX's HWIO to PyTorch's OIHW (the only 4-D leaves), the
    params trainable."""
    from posegen_tpu_torch.train.trainer import trainable, tree_map

    def leaf(a):
        a = np.asarray(a)
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    return (trainable(params_from_numpy(tree_map(leaf, params), device)),
            params_from_numpy(state, device))


def hmr_to_numpy(params, state):
    """The port's HMR (params, bn_state) -> posegen_tpu's layout as host
    arrays: the conv weights from OIHW to HWIO, the inverse of
    `hmr_from_numpy` (the SPIN `.npz` files are the JAX package's)."""
    from posegen_tpu_torch.train.trainer import tree_map

    def leaf(t):
        a = t.detach().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    return tree_map(leaf, params), tree_map(leaf, state)


# ---------------------------------------------------------------------------
# body models (body/)
# ---------------------------------------------------------------------------

def smpl_from_numpy(model, device):
    """A posegen_tpu SMPLModel (its leaves as arrays) -> the port's
    `body.smpl.SMPLModel` on `device`, the same constants, parents and
    faces."""
    from posegen_tpu_torch.body.smpl import SMPLModel

    extra = getattr(model, "extra_joint_regressor", None)
    return SMPLModel(
        v_template=np.asarray(model.v_template), shapedirs=np.asarray(model.shapedirs),
        posedirs=np.asarray(model.posedirs), J_regressor=np.asarray(model.J_regressor),
        parents=np.asarray(model.parents), lbs_weights=np.asarray(model.lbs_weights),
        faces=model.faces, extra_joint_regressor=None if extra is None else np.asarray(extra),
    ).to(device)


# ---------------------------------------------------------------------------
# the DeepLab-v3 person segmenter (data/segmenter.py)
# ---------------------------------------------------------------------------

def deeplab_from_numpy(params, state, device):
    """A posegen_tpu DeepLab-v3's (params, bn_state) -> the port's on
    `device`: the conv weights from JAX's HWIO to PyTorch's OIHW (the only
    4-D leaves); inference only, so nothing is made trainable."""
    from posegen_tpu_torch.train.trainer import tree_map

    def leaf(a):
        a = np.asarray(a)
        return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a

    return params_from_numpy(tree_map(leaf, params), device), params_from_numpy(state, device)


def body_model_from_numpy(kind: str, fields, device="cuda"):
    """A posegen_tpu SMPL-X, MANO or FLAME model's fields -> the port's
    `body.models` module of `kind` ("smplx", "mano" or "flame") on `device`
    (CUDA by default; raises without a card).
    fields: {name: value} over the JAX dataclass's fields (e.g.
    `{f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}`),
    arrays as numpy; an absent field is None or np.asarray(None)."""
    from posegen_tpu_torch.body.models import FLAMEModel, MANOModel, SMPLXModel
    from posegen_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cls = {"smplx": SMPLXModel, "mano": MANOModel, "flame": FLAMEModel}[kind]

    def value(v):
        a = np.asarray(v) if v is not None else None
        if a is None or (a.dtype == object and a.ndim == 0 and a.item() is None):
            return None
        return a

    kw = {k: value(v) for k, v in fields.items()}
    if "use_face_contour" in kw:
        kw["use_face_contour"] = bool(kw["use_face_contour"])
    return cls(**kw).to(dev)
