"""Render CLI (port of posegen_tpu/cli/run_render.py):

    python -m posegen_tpu_torch.cli.run_render --nerf_args logs/exp/args.txt \
        --ckptpath logs/exp/XXXXXXXX.ckpt.npz --render_type val ...

Capability parity with reference run_render.py run_render() (:993-1056):
re-parse a trained run's args.txt, load the checkpoint (native .npz or a
reference torch .tar), build the requested camera/pose sequence (val /
bullet / interpolate / mesh / retarget / animate / poserot / selected /
bubble / correction), render, evaluate PSNR/SSIM against stored images,
save PNGs + scores. The flags are the JAX package's; the device is a keyword
argument, `run_render(argv, device="cpu")`, and CUDA by default (raising
without a card).

On one device there is no `auto_render_fn`: frames go through
`render/image.render_path` at `--chunk` (65536 by default), one dual and
one field kernel launch per chunk on the card; where the gate refuses the
kernels the chunk is clamped to 8192 with the gate's reason, as JAX's
`auto_render_fn` clamps it (posegen_tpu/parallel/mesh.py:206-219).

Every PNG goes through the port's own codec (`utils/png.write_png`). The
`render_rgb` video goes through `utils/experiment.save_video`: an mp4
through imageio where it and its ffmpeg writer are installed, else JAX's
GIF fallback, which goes through the port's own GIF writer
(`utils/gif.write_gif`), with one line saying that the mp4 was not
written. JAX stops with ImportError before its first PNG where imageio is
missing (the card's machine has none), because it writes its PNGs through
imageio too.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.render.image import _bullet_c2ws
from posegen_tpu_torch.utils.png import write_png


def render_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("posegen_tpu.run_render")
    p.add_argument("--nerf_args", type=str, required=True, help="trained args.txt")
    p.add_argument("--ckptpath", type=str, required=True, help=".ckpt.npz or .tar")
    p.add_argument("--outputdir", type=str, default="render_output")
    p.add_argument("--runname", type=str, default="render")
    p.add_argument("--render_type", type=str, default="val",
                   choices=["val", "bullet", "interpolate", "mesh", "retarget",
                            "animate", "poserot", "selected", "bubble",
                            "correction"])
    p.add_argument("--selected_idxs", type=int, nargs="+", default=None)
    p.add_argument("--dataset", type=str, default=None,
                   help="override the trained run's dataset family "
                        "(reference --dataset, run_render.py:44)")
    p.add_argument("--entry", type=str, default=None,
                   help="catalog entry/subject to render "
                        "(reference --entry, run_render.py:46)")
    p.add_argument("--fps", type=int, default=14,
                   help="fps for the render_rgb video (reference :53)")
    p.add_argument("--save_gt", action="store_true",
                   help="save GT frames next to renders (reference :51)")
    p.add_argument("--no_save", action="store_true",
                   help="skip image/video writing, keep eval (reference :79)")
    p.add_argument("--render_refined", action="store_true",
                   help="render from refined poses: --refined_ckpt, the "
                        "trained run's load_refined, or the checkpoint's own "
                        "poseopt state (reference :136-152)")
    p.add_argument("--selected_framecode", type=int, default=None,
                   help="force every view's framecode index (reference "
                        ":275-276)")
    p.add_argument("--subject_idx", type=int, default=0,
                   help="subject to render for multi-subject models "
                        "(reference :282-284)")
    p.add_argument("--bullet_n", type=int, default=12)
    p.add_argument("--interp_n", type=int, default=5)
    p.add_argument("--n_step", type=int, default=5,
                   help="sub-frames per view for bubble/correction")
    p.add_argument("--x_deg", type=float, default=15.0)
    p.add_argument("--y_deg", type=float, default=25.0)
    p.add_argument("--z_t", type=float, default=0.1)
    p.add_argument("--refined_ckpt", type=str, default=None,
                   help="pose checkpoint with refined poses (correction mode)")
    p.add_argument("--save_extras", action="store_true",
                   help="also write acc/disp maps and skeleton overlays")
    p.add_argument("--chunk", type=int, default=65536)
    p.add_argument("--render_res", type=int, nargs=2, default=None)
    p.add_argument("--white_bkgd", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--mesh_res", type=int, default=64)
    p.add_argument("--mesh_thres", type=float, default=10.0)
    p.add_argument("--retarget_bones", type=str, default=None,
                   help="npy of (N, 24, 3) axis-angle poses to render")
    return p


def _detached(variables):
    from posegen_tpu_torch.train.trainer import tree_map

    return tree_map(lambda t: t.detach(), variables)


def load_trained(nerf_args_path: str, ckpt_path: str, device="cuda"):
    """Rebuild (targs, cfg, variables) from a dumped args.txt + checkpoint
    (reference load_nerf, run_render.py:84-113), the variables on `device`
    without gradients. The framecode count is the checkpoint's (0 without
    framecodes)."""
    from posegen_tpu_torch.cli.config import (
        args_to_raycast_config, args_to_train_config, nerf_config_parser,
        parse_config_file, txt_to_argstring, validate_args,
    )

    dev = resolve_device(device)
    argv = txt_to_argstring(nerf_args_path)
    parser = nerf_config_parser()
    known = {a.dest for a in parser._actions}
    unknown = [k for k in parse_config_file(nerf_args_path) if k not in known and k != "config"]
    if unknown:
        # a semantic key we don't know would otherwise be dropped silently
        raise SystemExit(
            f"args.txt {nerf_args_path} contains unknown keys {unknown}; "
            "refusing to render with silently dropped settings"
        )
    targs = parser.parse_args(argv)
    validate_args(targs)

    if ckpt_path.endswith(".tar"):
        from posegen_tpu_torch.train.checkpoints import import_torch_checkpoint

        variables, _ = import_torch_checkpoint(ckpt_path, dev)
        codes = variables.get("coarse", {}).get("framecodes")
        n_framecodes = 0 if codes is None else codes.shape[0]
        return targs, args_to_raycast_config(targs, n_framecodes=n_framecodes), \
            _detached(variables)
    # native checkpoint: restore into a freshly-built template
    from posegen_tpu_torch.render.raycast import init_raycaster
    from posegen_tpu_torch.train.checkpoints import load_checkpoint
    from posegen_tpu_torch.train.trainer import create_train_state

    flat = dict(np.load(ckpt_path))
    fc_keys = [k for k in flat if k.endswith("framecodes")]
    n_framecodes = flat[fc_keys[0]].shape[0] if fc_keys else 0
    cfg = args_to_raycast_config(targs, n_framecodes=n_framecodes)
    pose_params = anchors = None
    if any(k.startswith("pose_params") for k in flat):
        pose_params = {k: torch.as_tensor(flat[f"pose_params//{k}"]).to(dev)
                       for k in ("pelvis", "bones")}
        anchors = {k: v.clone() for k, v in pose_params.items()}
    template = create_train_state(init_raycaster(cfg, device=dev), args_to_train_config(targs),
                                  pose_params, anchors)
    state = load_checkpoint(ckpt_path, template)
    return targs, cfg, _detached({**state.params, **state.embeds})


def _l2ws(bones: np.ndarray, rest_pose=None, scale: float = 1.0) -> np.ndarray:
    """FK of (N, 24, 3) axis-angles on the host -> (N, 24, 4, 4) float32."""
    from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws

    rest = None if rest_pose is None else torch.as_tensor(np.asarray(rest_pose, np.float32))
    return smpl_l2ws(torch.as_tensor(np.asarray(bones, np.float32)), rest_pose=rest,
                     scale=scale).numpy()


def _pose_rows(l2ws: np.ndarray):
    """(N, 24, 4, 4) -> kps, skts, cyls (ext_scale 0.001), host float32."""
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.kinematics import invert_rigid

    t = torch.as_tensor(np.asarray(l2ws, np.float32))
    kps = t[..., :3, 3]
    cyls = get_kp_bounding_cylinder(kps, ext_scale=0.001).float()
    return kps.numpy(), invert_rigid(t).numpy(), cyls.numpy()


def run_render(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    """Render a trained run as `argv` asks on `device` -> the output dir."""
    from posegen_tpu_torch.cli.config import _scalar, args_to_data_config, parse_with_config
    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.render.image import render_path
    from posegen_tpu_torch.render.raycast import PoseCtx

    args = parse_with_config(render_parser(), argv)
    dev = resolve_device(device)
    targs, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=dev)

    dcfg = args_to_data_config(targs)
    if args.dataset:  # render a different catalog entry than the trained one
        dcfg.dataset = args.dataset
    if args.entry:
        dcfg.subject = args.entry
    dcfg.subject_idx = args.subject_idx
    if args.render_type in ("animate",):
        dcfg.num_val_images = 10**9  # all frames (load_data clips to dataset size)
    else:
        dcfg.num_val_images = max(len(args.selected_idxs or [2, 2]), 2)
    loader, render_data, attrs = load_data(dcfg)
    loader.close()
    rest_pose = attrs["rest_pose"]

    if args.render_refined:
        # swap the H5 poses for refined ones before any branch reads them
        # (reference load_render_data, run_render.py:136-152); sources in
        # priority order: explicit ckpt, the trained run's load_refined,
        # the model checkpoint's own poseopt state
        from posegen_tpu_torch.pose.opt import pose_params_to_pose_data
        from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
        from posegen_tpu_torch.train.checkpoints import load_pose_params

        ckpt = args.refined_ckpt or targs.load_refined or args.ckptpath
        try:
            pose_params = load_pose_params(ckpt, device="cpu")
        except KeyError:
            raise SystemExit(
                f"--render_refined: {ckpt} carries no poseopt state; pass "
                "--refined_ckpt pointing at a pose checkpoint"
            )
        kp_map = attrs.get("kp_map")
        refined = pose_params_to_pose_data(
            pose_params, torch.as_tensor(rest_pose),
            kp_map=torch.as_tensor(kp_map, dtype=torch.long) if kp_map is not None else None,
        )
        rows = np.asarray(render_data["kp_idxs"])
        n_rows = refined["kp3d"].shape[0]
        if rows.max() >= n_rows:
            raise SystemExit(
                f"--render_refined: pose ckpt has {n_rows} pose rows but the "
                f"dataset needs row {rows.max()} — wrong checkpoint?"
            )
        for k in ("kp3d", "bones", "skts"):
            render_data[k] = refined[k][rows]
        render_data["cyls"] = get_kp_bounding_cylinder(
            torch.as_tensor(render_data["kp3d"])).numpy().astype(np.float32)

    out_dir = os.path.join(args.outputdir, args.runname)
    os.makedirs(out_dir, exist_ok=True)

    H, W, _ = render_data["hwf"]
    if args.render_res:
        H, W = args.render_res
    focal = float(np.ravel(render_data["focals"])[0])

    def code_row(i: Optional[int]) -> Optional[torch.Tensor]:
        """Framecode index for a source view (reference cam_idxs flow,
        run_render.py:275-276): --selected_framecode wins; i = None -> mean
        code (the reference's idx = -1 eval convention)."""
        if not cfg.opt_framecode:
            return None
        if args.selected_framecode is not None:
            i_code = args.selected_framecode
        elif i is None:
            return None
        else:
            i_code = int(render_data["cam_idxs"][i])
        return torch.tensor([[i_code]], dtype=torch.int32, device=dev)

    def ctx_of(kps, skts, bones, cyls, cam_idxs) -> PoseCtx:
        up = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dev)  # noqa: E731
        return PoseCtx(kps=up(kps), skts=up(skts), bones=up(bones), cyls=up(cyls),
                       cam_idxs=cam_idxs)

    def ctx_for(i, code_i="same"):
        return ctx_of(render_data["kp3d"][i:i + 1], render_data["skts"][i:i + 1],
                      render_data["bones"][i:i + 1], render_data["cyls"][i:i + 1],
                      code_row(i if code_i == "same" else code_i))

    def fk_ctxs(kps, skts, bones, cyls, code):
        return [ctx_of(kps[i:i + 1], skts[i:i + 1], bones[i:i + 1], cyls[i:i + 1], code(i))
                for i in range(len(kps))]

    if args.render_type == "mesh":
        from posegen_tpu_torch.render.mesh import extract_mesh, save_ply

        with torch.no_grad():
            verts, faces = extract_mesh(cfg, variables, ctx_for(0), res=args.mesh_res,
                                        threshold=args.mesh_thres)
        path = save_ply(os.path.join(out_dir, "mesh.ply"), verts, faces)
        print(f"wrote {path} ({len(verts)} verts, {len(faces)} faces)")
        return out_dir

    if args.render_type == "retarget" and args.retarget_bones:
        # poses from an external source (reference load_retarget intent,
        # run_gan.py:437-451), rendered with the mean code
        bones = np.load(args.retarget_bones)
        kps, skts, cyls = _pose_rows(_l2ws(bones, scale=0.4))
        ctxs = fk_ctxs(kps, skts, bones, cyls, lambda i: code_row(None))
        c2ws = _bullet_c2ws(kps[0, 0], 2.5, len(bones))
    elif args.render_type == "bullet":
        # frozen pose, orbiting camera (reference load_bullettime)
        ctxs = [ctx_for(0)]
        c2ws = _bullet_c2ws(np.asarray(render_data["kp3d"])[0, 0], 2.5, args.bullet_n)
    elif args.render_type == "interpolate":
        # pose interpolation between consecutive val poses, in view 0's code
        b0, b1 = render_data["bones"][0], render_data["bones"][1]
        ts = np.linspace(0, 1, args.interp_n)
        bones = np.stack([(1 - t) * b0 + t * b1 for t in ts]).astype(np.float32)
        kps, skts, cyls = _pose_rows(_l2ws(bones, rest_pose))
        ctxs = fk_ctxs(kps, skts, bones, cyls, lambda i: code_row(0))
        c2ws = np.broadcast_to(render_data["c2ws"][0], (len(bones), 4, 4))
    elif args.render_type == "poserot":
        # fixed body pose, root-bone rotation sweep
        # (reference load_poserotate, run_render.py:700-760)
        from posegen_tpu_torch.skeleton.rotations import axisang_to_rot, rot_to_axisang

        base = np.asarray(render_data["bones"][0])
        n = args.bullet_n
        bones = np.tile(base[None], (n, 1, 1)).astype(np.float32)
        root_rot = axisang_to_rot(torch.as_tensor(base[0], dtype=torch.float32))
        for i, t in enumerate(np.linspace(0, 2 * np.pi, n, endpoint=False)):
            rot_y = axisang_to_rot(torch.tensor([0.0, t, 0.0], dtype=torch.float32))
            bones[i, 0] = rot_to_axisang(rot_y @ root_rot).numpy()
        kps, skts, cyls = _pose_rows(_l2ws(bones, rest_pose))
        ctxs = fk_ctxs(kps, skts, bones, cyls, lambda i: code_row(0))
        c2ws = np.broadcast_to(render_data["c2ws"][0], (n, 4, 4))
    elif args.render_type == "bubble":
        # per-view camera wobble around a root-centered subject
        # (reference load_bubble, run_render.py:805-870)
        from posegen_tpu_torch.skeleton.cameras import rotate_x, rotate_y

        idxs = np.asarray(args.selected_idxs or [0])
        n_step = args.n_step
        x_rad = args.x_deg * np.pi / 180.0
        y_rad = args.y_deg * np.pi / 180.0
        base_c2ws = np.array(render_data["c2ws"])[idxs]
        base_c2ws[..., :2, -1] = 0.0  # center the camera on the subject
        z_t = args.z_t * base_c2ws[0, 2, -1]
        motions = np.linspace(0.0, 2 * np.pi, n_step, endpoint=True)
        cam_motions = [rotate_x((np.cos(m) - 1.0) * x_rad) @ rotate_y(np.sin(m) * y_rad)
                       for m in motions]
        z_trans = (np.sin(motions) + 1.0) * z_t
        # root-centered poses (kps -= root), rebuilt through FK
        bones = np.array(render_data["bones"])[idxs]
        kps, skts, cyls = _pose_rows(_l2ws(bones, rest_pose))
        ctxs, c2w_list = [], []
        for vi in range(len(idxs)):
            for cam_motion, z_tran in zip(cam_motions, z_trans):
                c = base_c2ws[vi].copy()
                c[2, -1] += z_tran
                c2w_list.append(cam_motion @ c)
                ctxs.append(ctx_of(kps[vi:vi + 1], skts[vi:vi + 1], bones[vi:vi + 1],
                                   cyls[vi:vi + 1], code_row(int(idxs[vi]))))
        c2ws = np.asarray(c2w_list, np.float32)
    elif args.render_type == "correction":
        # morph each view from its INITIAL pose to its REFINED pose
        # (reference load_correction, run_render.py:484-515)
        from posegen_tpu_torch.pose.opt import pose_params_to_pose_data
        from posegen_tpu_torch.train.checkpoints import load_pose_params

        ckpt = args.refined_ckpt or targs.load_refined
        if not ckpt:
            raise SystemExit("correction mode needs --refined_ckpt (or a "
                             "load_refined path in the trained args.txt)")
        refined = pose_params_to_pose_data(load_pose_params(ckpt, device="cpu"),
                                           torch.as_tensor(rest_pose))
        idxs = np.asarray(args.selected_idxs or [0])
        kp_all = render_data.get("kp_idxs")
        kp_rows = np.asarray(kp_all)[idxs] if kp_all is not None else idxs
        n_step = args.n_step
        w = np.linspace(0, 1.0, n_step, endpoint=False).reshape(-1, 1, 1)
        init_bones = np.array(render_data["bones"])[idxs]
        ref_bones = np.asarray(refined["bones"])[kp_rows]
        ref_kps = np.asarray(refined["kp3d"])[kp_rows]
        interp = np.concatenate(
            [ib[None] * (1 - w) + rb[None] * w for ib, rb in zip(init_bones, ref_bones)], axis=0
        ).astype(np.float32)
        l2ws = _l2ws(interp, rest_pose).reshape(len(idxs), n_step, 24, 4, 4)
        l2ws[..., :3, -1] += ref_kps[:, None, :1, :]
        kps, skts, cyls = _pose_rows(l2ws.reshape(-1, 24, 4, 4))
        ctxs = fk_ctxs(kps, skts, interp, cyls, lambda i: code_row(int(idxs[i // n_step])))
        c2ws = np.repeat(np.array(render_data["c2ws"])[idxs], n_step, axis=0)
    elif args.render_type in ("animate", "selected"):
        # dataset pose sequence (animate: fixed cam; selected: chosen idxs
        # with their own cams — reference load_selected/animate)
        n_all = render_data["imgs"].shape[0]
        idxs = ([i for i in args.selected_idxs if i < n_all] if args.selected_idxs
                else list(range(n_all)))
        ctxs = [ctx_for(i) for i in idxs]
        if args.render_type == "animate":
            c2ws = np.broadcast_to(render_data["c2ws"][0], (len(idxs), 4, 4))
        else:
            c2ws = render_data["c2ws"][idxs]
    else:  # val
        n = render_data["imgs"].shape[0]
        # non-surreal val renders with the mean code (reference sets
        # cam_idxs = -1, run_render.py:235-237); surreal keeps real codes
        is_surreal = _scalar(targs.dataset_type) == "surreal"
        ctxs = [ctx_for(i, code_i=i if is_surreal else None) for i in range(n)]
        c2ws = render_data["c2ws"]

    from posegen_tpu_torch.parallel.mesh import auto_render_fn

    # u8 PNG outputs: f16 readback halves the device-to-host copy; --eval
    # keeps f32. On a world of ranks each chunk's rays split over them (the
    # reference DataParallel's render role, core/raycasters.py:157)
    half_readback = not args.eval
    render_fn, chunk = auto_render_fn(cfg, args.chunk, half_readback=half_readback)
    with torch.no_grad():
        out = render_path(cfg, variables, c2ws, (H, W, focal), ctxs, chunk=chunk,
                          white_bkgd=args.white_bkgd, render_fn=render_fn,
                          half_readback=half_readback)

    if args.eval and args.render_type == "val":
        from posegen_tpu_torch.evals.image import evaluate_metric

        gts = np.asarray(render_data["imgs"] * render_data["masks"])
        metrics = evaluate_metric(out["rgbs"], gts, bboxes=out["bboxes"], device=dev)
        means = {k: float(np.mean(v)) for k, v in metrics.items()}
        print("eval:", means)
        with open(os.path.join(out_dir, "psnr.txt"), "a") as f:
            f.write(f"{means['psnr']:.4f}\n")
        with open(os.path.join(out_dir, "ssim.txt"), "a") as f:
            f.write(f"{means['ssim']:.4f}\n")
        np.save(os.path.join(out_dir, "scores.npy"), metrics)

    u8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    if args.save_gt and args.render_type in ("val", "animate", "selected"):
        # GT frames for the rendered source views (reference run_render.py:
        # 1026-1030; the H5 pixels are the GT)
        gt_dir = os.path.join(out_dir, "gt")
        os.makedirs(gt_dir, exist_ok=True)
        n_all = render_data["imgs"].shape[0]
        gt_idxs = (list(range(n_all)) if args.render_type == "val"
                   else [i for i in (args.selected_idxs or range(n_all)) if i < n_all])
        for j, i in enumerate(gt_idxs):
            write_png(os.path.join(gt_dir, f"{j:05d}.png"), u8(render_data["imgs"][i]))

    if args.no_save:  # eval/GT only (reference :1032-1033)
        print(f"rendered {len(out['rgbs'])} frames (not saved: --no_save)")
        return out_dir

    img_dir = os.path.join(out_dir, "image")
    os.makedirs(img_dir, exist_ok=True)
    for i, rgb in enumerate(out["rgbs"]):
        write_png(os.path.join(img_dir, f"{i:05d}.png"), u8(rgb))
    np.save(os.path.join(out_dir, "bboxes.npy"), out["bboxes"])

    # render_rgb video (reference :1050 mp4); gif fallback without ffmpeg
    from posegen_tpu_torch.utils.experiment import save_video

    if save_video(os.path.join(out_dir, "render_rgb.mp4"), out["rgbs"], fps=args.fps) is None:
        print("render_rgb.mp4 not written (imageio with an ffmpeg writer is not installed); "
              "render_rgb.gif is written")
        save_video(os.path.join(out_dir, "render_rgb.gif"), out["rgbs"], fps=args.fps, loop=0)

    if args.save_extras:
        # acc / disp maps + skeleton overlays
        # (reference render_path outputs, run_nerf.py:28-147)
        from posegen_tpu_torch.skeleton.cameras import nerf_c2w_to_extrinsic, world_to_cam
        from posegen_tpu_torch.utils.visualization import draw_skeleton2d

        for name in ("acc", "disp", "skel"):
            os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        dmax = max(float(np.asarray(out["disps"]).max()), 1e-8)
        for i, (rgb, acc, disp) in enumerate(zip(out["rgbs"], out["accs"], out["disps"])):
            write_png(os.path.join(out_dir, "acc", f"{i:05d}.png"), u8(acc))
            write_png(os.path.join(out_dir, "disp", f"{i:05d}.png"), u8(disp / dmax))
            ctx = ctxs[i % len(ctxs)]
            kp2d = world_to_cam(ctx.kps[0].cpu().numpy(), nerf_c2w_to_extrinsic(c2ws[i]), H, W,
                                focal)
            write_png(os.path.join(out_dir, "skel", f"{i:05d}.png"),
                      draw_skeleton2d(u8(rgb), kp2d))

    print(f"wrote {len(out['rgbs'])} renders to {img_dir}")
    return out_dir


if __name__ == "__main__":
    run_render()
