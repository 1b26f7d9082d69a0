"""The scenarios of tests/test_torch_parallel.py, each a function of (mesh,
inputs): on a rank of a 2-rank gloo world with a `parallel.mesh.Mesh`, or
with mesh None in the test process for the single-process result on the
concatenated batch. The spawned ranks import this module, so it imports
torch, numpy and the port only; the inputs are numpy, made by the test.
"""

import os
import pickle

import numpy as np
import torch

from posegen_tpu_torch.parallel import mesh as pmesh


def to_numpy(tree):
    """A tree of tensors -> numpy copies (a CPU tensor's .numpy() shares its
    memory, and the steps update the params in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return tree


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# the NeRF train step
# ---------------------------------------------------------------------------

def train(mesh, inp):
    """Two steps from a fresh state at perturb 0 (fold_key_per_device
    False) -> each step's stats and the state after them."""
    from posegen_tpu_torch.render import raycast as tr
    from posegen_tpu_torch.train import trainer as tt
    from posegen_tpu_torch.pose.opt import PoseOptConfig
    from posegen_tpu_torch.utils.convert import params_from_numpy

    cfg, tcfg = tr.RaycastConfig(**inp["rkw"]), tt.TrainConfig(**inp["tkw"])
    pose = pose_anchors = pcfg = rest = None
    if tcfg.opt_pose:
        pose = {k: _t(v).float().requires_grad_(True) for k, v in inp["pose_params"].items()}
        pose_anchors = {k: _t(v).float() for k, v in inp["pose_anchors"].items()}
        pcfg, rest = PoseOptConfig(**inp["pkw"]), _t(inp["rest_pose"])
    state = tt.create_train_state(params_from_numpy(inp["variables"], "cpu"), tcfg, pose,
                                  pose_anchors)
    kw = dict(rest_pose=rest, n_frames=inp["n_frames"])
    if mesh is None:
        step, batch = tt.make_train_step(cfg, tcfg, pcfg, **kw), inp["batch"]
        batch = {k: _t(v) for k, v in batch.items()}
    else:
        state = pmesh.replicate(state, mesh)
        step = pmesh.make_shardmap_train_step(cfg, tcfg, pcfg, mesh=mesh,
                                              fold_key_per_device=False, **kw)
        batch = pmesh.shard_batch(inp["batch"], mesh)
    stats, params = [], []
    for _ in range(2):
        state, st = step(state, batch)
        stats.append({k: float(v) for k, v in st.items()})
        params.append(to_numpy(state.params))
    out = {"stats": stats, "params": params[-1], "params_1": params[0],
           "embeds": to_numpy(state.embeds), "step": state.step}
    if pose is not None:
        st = state.pose_opt_state
        out.update(pose_params=to_numpy(state.pose_params), pose_acc=to_numpy(st.acc_grads),
                   pose_mini_step=st.mini_step)
    return out


# ---------------------------------------------------------------------------
# the GAN steps and the SPIN losses
# ---------------------------------------------------------------------------

def gan_steps(mesh, inp):
    """Two G steps (feedback active) and two D steps -> stats, params,
    BN state, Adam moments, the generated poses."""
    from posegen_tpu_torch.gen import gan as tgan
    from posegen_tpu_torch.gen import loop as tloop
    from posegen_tpu_torch.gen.generators import GenConfig
    from posegen_tpu_torch.parallel import gan as pgan
    from posegen_tpu_torch.utils.convert import discriminator_from_numpy, generator_from_numpy

    cfg = GenConfig(**inp["gen_cfg"])
    fk = lambda b: tloop.fk_joints(b, 0.4)  # noqa: E731
    if mesh is None:
        g_opt, g_step = tgan.make_generator_step(fk, cfg, **inp["step_kw"])
        d_opt, d_step = tgan.make_discriminator_step(**inp["step_kw"])
    else:
        g_opt, g_step = pgan.make_parallel_generator_step(mesh, fk, cfg, **inp["step_kw"])
        d_opt, d_step = pgan.make_parallel_discriminator_step(mesh, **inp["step_kw"])
    p, s = generator_from_numpy(inp["g_params"], inp["g_state"], "cpu")
    d = discriminator_from_numpy(inp["d_params"], "cpu")
    g_st, d_st = g_opt.init(p), d_opt.init(d)
    g_stats, d_stats = [], []
    for i in range(2):
        noises = {k: _t(v) for k, v in inp["noises"][i].items()}
        p, s, g_st, out, st = g_step(p, s, g_st, d, noises, _t(inp["real"]),
                                     _t(inp["spin_pred"]), _t(inp["sel"], torch.long), 1.0)
        g_stats.append({k: float(v) for k, v in st.items()})
        d, d_st, st = d_step(d, d_st, _t(inp["real"]), _t(inp["fake"] + 0.1 * i))
        d_stats.append({k: float(v) for k, v in st.items()})
    return {"g_stats": g_stats, "d_stats": d_stats, "g_params": to_numpy(p),
            "g_state": to_numpy(s), "g_mu": to_numpy(g_st.mu), "g_nu": to_numpy(g_st.nu),
            "out": to_numpy(out), "d_params": to_numpy(d), "d_mu": to_numpy(d_st.mu),
            "d_nu": to_numpy(d_st.nu)}


def spin_hinge(mesh, inp):
    """spin_pose_loss with the hinge on a mixed batch: the loss summed over
    the ranks and d loss / d rotmat of all rows."""
    from posegen_tpu_torch.gen import spin_train as tst

    rot, gt = _t(inp["rot"]), _t(inp["gt"])
    if mesh is not None:
        rot, gt = pmesh.local_rows(mesh, rot), pmesh.local_rows(mesh, gt)
    rot.requires_grad_(True)
    loss, per_sample = tst.spin_pose_loss(rot, gt, 0.4, 0.02, mesh=mesh)
    (grad,) = torch.autograd.grad(loss, rot)
    if mesh is not None:
        (loss,) = pmesh.all_reduce_sum(mesh, [loss.detach()])
        grad = pmesh.all_gather_rows(mesh, grad)
        per_sample = pmesh.all_gather_rows(mesh, per_sample)
    return {"loss": float(loss.detach()), "grad": to_numpy(grad),
            "per_sample": to_numpy(per_sample)}


def mock_smpl():
    """tests/test_torch_gan.py's stand-in body model (torch side)."""
    rng = np.random.default_rng(4)
    A = _t((rng.standard_normal((216, 60)) * 0.05).astype(np.float32))
    Bm = _t((rng.standard_normal((10, 60)) * 0.05).astype(np.float32))

    def smpl(betas, body_pose, global_orient, pose2rot):
        assert pose2rot is False
        rots = torch.cat([global_orient, body_pose], 1).reshape(betas.shape[0], 216)
        return {"vertices": (rots @ A + betas @ Bm).reshape(-1, 20, 3)}

    return smpl


def finetune(mesh, inp, shared):
    """One BN-frozen SPIN or SKI fine-tune step without dropout -> stats,
    and the params and Adam's first moment flattened (rank 0's; the other
    ranks return their hash, `flat_hash`)."""
    from posegen_tpu_torch.gen import spin_train as tst
    from posegen_tpu_torch.parallel import gan as pgan
    from posegen_tpu_torch.train.trainer import param_leaves
    from posegen_tpu_torch.utils.convert import hmr_from_numpy

    kw = dict(lr=1e-4)
    if inp["kind"] == "spin":
        kw["hinge"] = None
        make = (tst.make_spin_finetune_step if mesh is None
                else lambda **k: pgan.make_parallel_spin_finetune_step(mesh, **k))
    else:
        kw.update(smpl=mock_smpl(), J_regressor=inp["j_reg"])
        make = (tst.make_ski_finetune_step if mesh is None
                else lambda **k: pgan.make_parallel_ski_finetune_step(mesh, **k))
    opt, step = make(**kw)
    p, s = hmr_from_numpy(*shared["hmr"], "cpu")
    st = opt.init(p)
    p, st, stats = step(p, s, st, _t(inp["x"]), _t(inp["gt"]), None)
    flat_p = torch.cat([t.detach().reshape(-1) for t in param_leaves(p)])
    flat_mu = torch.cat([t.reshape(-1) for t in param_leaves(st.mu)])
    out = {"spin_loss": float(stats["spin_loss"]),
           "per_sample": to_numpy(stats["per_sample"]), "count": st.count,
           "hash": flat_hash([flat_p, flat_mu])}
    if mesh is None or mesh.rank == 0:
        out.update(params=flat_p.numpy(), mu=flat_mu.numpy())
    return out


def flat_hash(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the renders and the loop
# ---------------------------------------------------------------------------

def _renderer(inp):
    from posegen_tpu_torch.gen import loop as tloop
    from posegen_tpu_torch.render import raycast as tr
    from posegen_tpu_torch.utils.convert import params_from_numpy

    return tloop.NeRFRenderer(tr.RaycastConfig(**inp["nerf_cfg"]),
                              params_from_numpy(inp["nerf"], "cpu"), hw=inp["hw"],
                              focal=inp["focal"], chunk=inp["chunk"])


def render(mesh, inp):
    """The feedback frames of two poses in the window: through the
    renderer (f16 readback; over the world, auto_render_fn's cam render),
    and through render_images_pipelined with the renderer's pose contexts
    at f32 readback on make_shardmap_render_cam."""
    from posegen_tpu_torch.render.image import render_images_pipelined
    from posegen_tpu_torch.render.raycast import PoseCtx, render_rays
    from posegen_tpu_torch.skeleton.cameras import get_rays_np
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws

    ren = _renderer(inp)
    bones, c2ws, window = _t(inp["bones"]), inp["c2ws"], inp["window"]
    with torch.no_grad():
        half = ren.render_poses(bones, c2ws, window=window)
        l2ws = smpl_l2ws(bones, scale=ren.pose_scale)
        kps, skts = l2ws[..., :3, 3], invert_rigid(l2ws)
        cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001).float()
        ctxs = [PoseCtx(kps=kps[k:k + 1], skts=skts[k:k + 1], bones=bones[k:k + 1],
                        cyls=cyls[k:k + 1]) for k in range(len(bones))]
        fn = None if mesh is None else pmesh.make_shardmap_render_cam(ren.cfg, mesh, ren.chunk)
        full = render_images_pipelined(ren.cfg, ren.params, ren.hw, ren.hw, ren.focal, c2ws,
                                       ctxs, cyls.numpy(), chunk=ren.chunk, render_fn=fn,
                                       window=window)
        # host rays through make_shardmap_render: 255 of the window's rays
        # (a count the ranks do not divide: the last ray is repeated)
        lo, hi = window
        o, d = (_t(a[lo:hi, lo:hi].reshape(-1, 3)[:255])
                for a in get_rays_np(ren.hw, ren.hw, ren.focal, c2ws[0]))
        if mesh is None:
            ret = render_rays(ren.cfg, ren.params, o, d, ctxs[0], perturb=0.0, raw_noise_std=0.0,
                              eval_mean_code=True, coarse_rgb=False)
            maps = {k: ret[k] for k in ("rgb_map", "acc_map", "disp_map")}
        else:
            maps = pmesh.make_shardmap_render(ren.cfg, mesh)(ren.params, o, d, ctxs[0])
    return {"half": half, "f32": full, "chunk": ren.chunk, "rays": to_numpy(maps),
            "cam_render": getattr(ren._render_fn, "takes_cam", False)}


def gan_epoch(mesh, inp, shared):
    """GanTrainer over one epoch with feedback (the sink in inp["sink"]
    written by rank 0), then train_spin on that sink."""
    from posegen_tpu_torch.gen import loop as tloop
    from posegen_tpu_torch.gen.generators import GenConfig
    from posegen_tpu_torch.gen.spin_driver import train_spin
    from posegen_tpu_torch.train.trainer import param_leaves
    from posegen_tpu_torch.utils.convert import hmr_from_numpy

    sink = inp["sink"] + ("_single" if mesh is None else "_mesh")
    sp, ss = hmr_from_numpy(*shared["hmr"], "cpu")
    trainer = tloop.GanTrainer(tloop.GanLoopConfig(output_dir=sink, **inp["loop_cfg"]),
                               _renderer(inp), sp, ss, gen_cfg=GenConfig(**inp["gen_cfg"]),
                               steps_per_epoch=2, mesh=mesh, device="cpu")
    steps, real_step = [], trainer.train_step
    trainer.train_step = lambda b: steps.append(real_step(b)) or steps[-1]
    epoch = trainer.train_epoch(inp["poses"])
    trainer.flush_sink()
    if mesh is not None:
        torch.distributed.barrier(group=mesh.group)
    files = sorted(os.listdir(os.path.join(sink, "image")))
    _, history = train_spin(sp, ss, sink, epochs=1, batch_size=4, crop=inp["window"],
                            res=32, ckpt_dir=os.path.join(sink, "spin_ckpts"), mesh=mesh)
    out = {"steps": steps, "epoch": epoch, "files": files, "spin_history": history,
           "spin_hash": flat_hash([t.detach() for t in param_leaves(sp)])}
    for name in ("g_params", "g_state", "d_params"):
        out[name] = to_numpy(getattr(trainer, name))
    out["g_mu"] = to_numpy(trainer.g_opt_state.mu)
    out["last_bones"] = trainer._last_bones
    out["pool"] = np.stack(trainer.fake_pool.items)
    return out


SCENARIOS = ("train", "train_pose", "gan_steps", "spin_hinge", "finetune_spin",
             "finetune_ski", "render", "gan_epoch")
FUNCTIONS = {"train": train, "train_pose": train, "gan_steps": gan_steps,
             "spin_hinge": spin_hinge, "finetune_spin": finetune, "finetune_ski": finetune,
             "render": render, "gan_epoch": gan_epoch}


def run(name, mesh, inputs):
    """Scenario `name` on inputs[name] (the HMR weights: inputs["hmr"])."""
    fn = FUNCTIONS[name]
    if name.startswith("finetune") or name == "gan_epoch":
        return fn(mesh, inputs[name], inputs)
    return fn(mesh, inputs[name])


def rank_main(mesh, inputs_path, out_dir, name=None):
    """Every scenario on this rank of a world (mesh None: in one process)
    -> out_dir/{name or rank<r>}.pkl. One intra-op thread: the test
    process and the other ranks share the cores."""
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    res = {scenario: run(scenario, mesh, inputs) for scenario in SCENARIOS}
    with open(os.path.join(out_dir, f"{name or f'rank{mesh.rank}'}.pkl"), "wb") as f:
        pickle.dump(res, f)
