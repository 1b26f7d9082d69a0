"""Config system (port of posegen_tpu/cli/config.py): argparse +
reference-style text config files.

Capability parity with the reference's configargparse usage
(run_nerf.py:186-490 config_parser; configs/*/*.txt with `key = value`
lines; the dumped-args round trip `txt_to_argstring`,
evaluation_helpers.py:221-255). Implemented on stdlib argparse: `--config
FILE` lines become defaults, CLI flags override, and every run dumps
`args.txt` + `config.txt` into its log dir for exact re-parsing by the
render CLIs.

The flag surface is the JAX package's, name for name and default for
default, so that `args.txt` is byte-equal between the packages for the same
argv and either package's render CLI re-parses the other's runs. The device
is not a flag: entry points take it as a keyword argument.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional, Sequence


def parse_config_file(path: str) -> Dict[str, str]:
    """Read `key = value` lines (configargparse text format)."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                out[k.strip()] = v.strip()
    return out


def _coerce(parser: argparse.ArgumentParser, key: str, raw: str):
    for action in parser._actions:
        if action.dest == key:
            if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
                return raw.lower() in ("true", "1", "yes")
            if action.nargs in ("+", "*") or isinstance(action.nargs, int):
                typ = action.type or str
                return [typ(v) for v in raw.split()]
            return (action.type or str)(raw)
    raise KeyError(f"unknown config key {key!r}")


def parse_with_config(
    parser: argparse.ArgumentParser, argv: Optional[Sequence[str]] = None
) -> argparse.Namespace:
    """Two-pass parse: --config file sets defaults, CLI overrides."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    if pre_args.config:
        cfg = parse_config_file(pre_args.config)
        defaults = {k: _coerce(parser, k, v) for k, v in cfg.items()}
        parser.set_defaults(**defaults)
    if not any(a.dest == "config" for a in parser._actions):
        parser.add_argument("--config", type=str, default=None)
    return parser.parse_args(argv)


def dump_args(log_dir: str, args: argparse.Namespace) -> None:
    """Write args.txt (+ copy config.txt) like reference run_nerf.py:504-516."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "args.txt"), "w") as f:
        for k in sorted(vars(args)):
            f.write(f"{k} = {getattr(args, k)}\n")
    if getattr(args, "config", None):
        shutil.copy(args.config, os.path.join(log_dir, "config.txt"))


def txt_to_argstring(path: str, ignore: Sequence[str] = ("config",)) -> List[str]:
    """args.txt -> argv list (reference evaluation_helpers.py:221-255)."""
    argv: List[str] = []
    for k, v in parse_config_file(path).items():
        if k in ignore or v == "None":
            continue
        if v in ("True", "False"):
            if v == "True":
                argv.append(f"--{k}")
            continue
        if v.startswith("[") and v.endswith("]"):
            items = v[1:-1].replace(",", " ").replace("'", "").split()
            if not items:
                continue
            argv.append(f"--{k}")
            argv.extend(items)
            continue
        argv.extend([f"--{k}", v])
    return argv


def nerf_config_parser() -> argparse.ArgumentParser:
    """The FULL training flag surface (reference run_nerf.py:186-490, all 131
    flags, names and defaults kept identical) plus the rebuild's extras
    (data_root/seed/n_devices), exactly the JAX package's. Flags whose non-default values select
    reference behaviors the rebuild does not implement are still parsed —
    `validate_args` rejects them loudly instead of silently ignoring them.
    """
    p = argparse.ArgumentParser("posegen_tpu_torch.run_nerf", add_help=True)
    arg = p.add_argument
    # experiment
    arg("--expname", type=str, default="exp")
    arg("--basedir", type=str, default="./logs")
    arg("--datadir", type=str, default=None, help="alias of --data_root")
    arg("--seed", type=int, default=0)
    # network architecture
    arg("--netdepth", type=int, default=8)
    arg("--netwidth", type=int, default=256)
    arg("--netdepth_fine", type=int, default=8)
    arg("--netwidth_fine", type=int, default=256)
    arg("--single_net", action="store_true")
    arg("--nerf_type", type=str, default="nerf")
    arg("--use_viewdirs", action="store_true")
    arg("--density_type", type=str, default="relu")
    arg("--density_scale", type=float, default=1.0)
    arg("--softplus_shift", type=float, default=1.0)
    arg("--use_uncertainty", action="store_true")
    arg("--fix_layer", type=int, default=0)
    # positional encodings
    arg("--i_embed", type=int, default=0)
    arg("--multires", type=int, default=10)
    arg("--multires_pts", type=int, default=5)
    arg("--multires_views", type=int, default=4)
    arg("--multires_bones", type=int, default=0)
    # cutoff embedder
    arg("--use_cutoff", action="store_true")
    arg("--normalize_cutoff", action="store_true")
    arg("--cutoff_mm", type=float, default=500.0)
    arg("--cutoff_inputs", action="store_true")
    arg("--cut_to_dist", action="store_true")
    arg("--cutoff_shift", action="store_true")
    arg("--cutoff_viewdir", action="store_true")
    arg("--opt_cutoff", action="store_true")
    arg("--cutoff_step", type=int, default=250)
    arg("--cutoff_rate", type=float, default=10.0)
    arg("--cutoff_bones", action="store_true")
    arg("--cutoff_ancestors", type=int, default=5)
    arg("--freq_schedule", action="store_true")
    arg("--freq_schedule_step", type=int, default=5)
    arg("--init_freq", type=float, default=0.0)
    # conditioning encoders
    arg("--kp_dist_type", type=str, default="reldist")
    arg("--view_type", type=str, default="relray")
    arg("--bone_type", type=str, default="reldir")
    arg("--pts_tr_type", type=str, default="local")
    # per-frame codes
    arg("--opt_framecode", action="store_true")
    arg("--n_framecodes", type=int, default=None)
    arg("--framecode_size", type=int, default=16)
    arg("--opt_posecode", action="store_true")
    # sampling / rendering
    arg("--N_samples", type=int, default=64)
    arg("--N_importance", type=int, default=0)
    arg("--perturb", type=float, default=1.0)
    arg("--P_nms", type=float, default=0.0)
    arg("--lindisp", action="store_true")
    arg("--raw_noise_std", type=float, default=0.0)
    arg("--ray_noise_std", type=float, default=0.0)
    arg("--render_factor", type=int, default=0)
    arg("--save_image", action="store_true")
    arg("--precrop_iters", type=int, default=0)
    arg("--precrop_frac", type=float, default=0.5)
    arg("--chunk", type=int, default=1024 * 32)
    arg("--netchunk", type=int, default=1024 * 64)
    # optimization
    arg("--N_rand", type=int, default=32 * 32 * 4)
    arg("--lrate", type=float, default=5e-4)
    arg("--lrate_decay", type=int, default=250)
    arg("--lrate_decay_rate", type=float, default=0.1)
    arg("--decay_unit", type=int, default=1000)
    arg("--weight_decay", type=float, default=None)
    arg("--coarse_weight", type=float, default=1.0)
    arg("--n_iters", type=int, default=200000)
    arg("--loss_fn", type=str, default="MSE")
    arg("--loss_beta", type=float, default=0.1)
    arg("--reg_fn", type=str, default=None)
    arg("--reg_coef", type=float, default=0.1)
    arg("--use_yuv", action="store_true")
    arg("--use_temp_loss", action="store_true")
    arg("--temp_coef", type=float, default=0.05)
    arg("--no_reload", action="store_true")
    arg("--ft_path", type=str, default=None)
    arg("--finetune", action="store_true")
    # pose optimization
    arg("--opt_pose", action="store_true")
    arg("--opt_rot6d", action="store_true")
    arg("--init_poseopt", type=str, default=None)
    arg("--no_poseopt_reload", action="store_true")
    arg("--opt_pose_stop", type=int, default=None)
    arg("--opt_pose_coef", type=float, default=0.0)
    arg("--opt_pose_tol", type=float, default=0.0)
    arg("--opt_pose_type", type=str, default="B")
    arg("--opt_pose_step", type=int, default=1)
    arg("--opt_pose_lrate", type=float, default=5e-4)
    arg("--opt_pose_lrate_decay", type=int, default=250)
    arg("--opt_pose_decay_rate", type=float, default=1.0)
    arg("--opt_pose_warmup", type=int, default=0)
    arg("--opt_pose_decay_unit", type=int, default=400)
    arg("--opt_pose_cache", action="store_true")
    arg("--opt_pose_joint", action="store_true")
    arg("--testopt", action="store_true")
    arg("--use_ckpt_anchor", action="store_true")
    # background / LBS networks (reference experimental branches)
    arg("--use_bgnet", action="store_true")
    arg("--bgnet_stop", type=int, default=500000)
    arg("--bgnet_reg", type=float, default=0.01)
    arg("--use_bgfill", action="store_true")
    arg("--lbsnet_type", type=str, default="default")
    arg("--use_lbsnet", action="store_true")
    arg("--n_lbs", type=int, default=1)
    arg("--multires_lbs", type=int, default=10)
    arg("--multires_lbsviews", type=int, default=4)
    # data
    arg("--dataset_type", type=str, nargs="+", default=["synthetic"])
    arg("--subject", type=str, nargs="+", default=["demo"])
    arg("--data_root", type=str, default="data")
    arg("--n_subjects", type=int, default=2)
    arg("--camera", type=int, default=None)
    arg("--use_val", action="store_true")
    arg("--white_bkgd", action="store_true")
    arg("--ext_scale", type=float, default=0.001)
    arg("--use_background", action="store_true")
    arg("--fg_ratio", type=float, default=None)
    arg("--train_skip", type=int, default=1)
    arg("--view_skip", type=int, default=1)
    arg("--N_cams", type=int, default=None)
    arg("--multiview", action="store_true")
    arg("--training_res", type=float, default=1.0)
    arg("--val_seq", nargs="+", type=int, default=[6, 18])
    arg("--rand_train_kps", type=str, default=None)
    arg("--N_sample_images", type=int, default=8)
    arg("--image_batching", action="store_true")
    arg("--mask_image", action="store_true")
    arg("--patch_size", type=int, default=1)
    arg("--load_refined", type=str, default=None,
        help="path to a refined-pose checkpoint (the reference uses a bool + "
             "hard-coded path; here the path is explicit)")
    arg("--num_workers", type=int, default=16)
    # logging / checkpoints
    arg("--i_print", type=int, default=100)
    arg("--i_weights", type=int, default=10000)
    arg("--i_pose_weights", type=int, default=2000)
    arg("--i_testset", type=int, default=50000)
    arg("--i_video", type=int, default=10000)
    arg("--debug", action="store_true")
    # the rebuild's extras
    arg("--n_devices", type=int, default=0, help="0 = all")
    return p


# Flags whose NON-DEFAULT values select reference behaviors this rebuild does
# not implement. They parse (so reference args.txt round-trips), but
# validate_args raises — never a silent semantic drop (the reference failure
# mode this guards against: a config with e.g. use_bgnet=True "working" while
# rendering something else entirely).
UNSUPPORTED_NONDEFAULT = {
    "use_yuv": False,          # setting it CRASHES the reference too:
                               # rgb_to_yuv is called but never defined
                               # (core/trainer.py:13)
    "pts_tr_type": "local",    # non-'local' raises NotImplementedError in
                               # the reference too (raycasters.py:244-247)
}

# Flags the REFERENCE parses but never reads — accepted here with the same
# no-op semantics (verified by grep over the reference):
#   precrop_iters/precrop_frac  argparse-only (no consumer in run_nerf.py)
#   opt_posecode                argparse-only (run_nerf.py:322)
#   opt_cutoff                  stored on CutoffEmbedder but cutoff_dist is
#                               always requires_grad=False and the flag is
#                               never read again (cutoff_embedder.py:83-91)
#   nerf_type                   passed into render_kwargs and never read
#                               (raycasters.py:167; NeRF(**kwargs) is built
#                               unconditionally, :96)
#   use_uncertainty/use_bgnet/  argparse-only across the whole reference
#   use_bgfill/use_lbsnet       (grep: no consumer outside run_nerf argparse)
#   val_seq/train_skip/         argparse-only (no args.<flag> consumer
#   view_skip/training_res/     anywhere in the reference)
#   cutoff_ancestors
#   opt_pose_joint              only read by PoseOptFlipFlop, which the
#                               reference never instantiates — its live
#                               train loop ALWAYS optimizes NeRF and pose
#                               jointly (trainer.py:453-485), which is
#                               exactly this rebuild's behavior, so the six
#                               flagship configs setting it run identically
REFERENCE_DEAD_FLAGS = (
    "precrop_iters", "opt_posecode", "opt_cutoff", "nerf_type",
    "use_uncertainty", "use_bgnet", "use_bgfill", "use_lbsnet",
    "val_seq", "train_skip", "view_skip", "training_res",
    "cutoff_ancestors", "opt_pose_joint",
)

# Flags that parse and may diverge from their reference default without
# changing this rebuild's output semantics (dissolved memory tiling, loader
# internals, output-artifact cadence). Changing them never corrupts a run.
INERT_FLAGS = (
    "chunk", "netchunk", "save_image",
    "debug", "n_subjects", "ext_scale",
    "image_batching", "multires_pts",
    "bgnet_stop", "bgnet_reg", "lbsnet_type", "n_lbs", "multires_lbs",
    "multires_lbsviews", "loss_beta",
)

# Flags honored approximately: accepted with a loud warning describing the
# divergence (data-selection knobs the H5 loader resolves differently).
WARN_DIVERGENT: Dict[str, str] = {}


def validate_args(args: argparse.Namespace, strict: bool = True) -> List[str]:
    """Reject unsupported non-default flags; warn on approximate ones.

    Returns the warning list (also printed). Raises SystemExit when an
    unsupported behavior was requested and strict is True.
    """
    errors = []
    for key, default in UNSUPPORTED_NONDEFAULT.items():
        val = getattr(args, key, default)
        if val != default:
            errors.append(
                f"--{key}={val!r}: this reference behavior is not implemented "
                f"in the TPU rebuild (supported value: {default!r})"
            )
    warnings: List[str] = []
    defaults = nerf_config_parser().parse_args([])
    for key in REFERENCE_DEAD_FLAGS:
        if getattr(args, key, None) != getattr(defaults, key, None):
            warnings.append(
                f"--{key}: parsed but runtime-inert — exactly as in the "
                "reference, where this flag has no consumer"
            )
    for key, msg in WARN_DIVERGENT.items():
        if getattr(args, key, None) != getattr(defaults, key, None):
            warnings.append(f"--{key}: {msg}")
    if args.reg_fn not in (None, "BCE"):
        # L1/MSE reg CRASH the reference too: with reduction='off' they return
        # the unreduced per-pixel tensor (core/trainer.py:25,41), total_loss
        # becomes non-scalar, and loss.backward() raises "grad can be
        # implicitly created only for scalar outputs" (verified empirically).
        errors.append(
            f"--reg_fn={args.reg_fn!r}: only BCE (or none) runs — L1/MSE "
            "crash the reference's backward (non-scalar total_loss)"
        )
    # opt_pose_type: accept the whole reference family (B/BE/RD/RDE, with an
    # optional 'L1' substring). It is runtime-inert here EXACTLY as in the
    # reference: the train loop's _compute_kp_loss never reads it, and
    # get_kp_reg_loss (the consumer) is uncalled there — see pose/opt.py.
    opt = getattr(args, "opt_pose_type", "B")
    if not (opt.startswith("B") or opt.startswith("RD")):
        errors.append(
            f"--opt_pose_type={opt!r}: regularization target un-specified "
            "(reference core/pose_opt.py:165 raises the same way)"
        )
    for w in warnings:
        print(f"[config warning] {w}")
    if errors and strict:
        raise SystemExit(
            "unsupported config flags (refusing to run with silently changed "
            "semantics):\n  " + "\n  ".join(errors)
        )
    return warnings


def _scalar(v):
    """dataset_type/subject parse as nargs='+' lists (reference convention);
    most of the stack wants the first entry."""
    if isinstance(v, (list, tuple)):
        return v[0]
    return v


def args_to_raycast_config(args, n_framecodes: int = 0):
    from posegen_tpu_torch.render.raycast import RaycastConfig

    if getattr(args, "n_framecodes", None):
        n_framecodes = args.n_framecodes  # explicit override (reference flag)
    return RaycastConfig(
        i_embed=args.i_embed,
        kp_dist_type=args.kp_dist_type,
        view_type=args.view_type,
        bone_type=args.bone_type,
        multires=args.multires,
        multires_views=args.multires_views,
        multires_bones=args.multires_bones,
        use_viewdirs=args.use_viewdirs,
        use_cutoff=args.use_cutoff,
        cutoff_viewdir=args.cutoff_viewdir,
        cutoff_bones=args.cutoff_bones,
        cutoff_inputs=args.cutoff_inputs,
        cut_to_dist=args.cut_to_dist,
        cutoff_shift=args.cutoff_shift,
        normalize_cutoff=args.normalize_cutoff,
        freq_schedule=args.freq_schedule,
        init_freq=args.init_freq,
        opt_framecode=args.opt_framecode,
        framecode_ch=args.framecode_size,
        n_framecodes=n_framecodes,
        netdepth=args.netdepth,
        netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine,
        netwidth_fine=args.netwidth_fine,
        N_samples=args.N_samples,
        N_importance=args.N_importance,
        single_net=args.single_net,
        perturb=args.perturb,
        raw_noise_std=args.raw_noise_std,
        ray_noise_std=args.ray_noise_std,
        lindisp=args.lindisp,
        density_type=args.density_type,
        density_scale=args.density_scale,
        softplus_shift=args.softplus_shift,
    )


def args_to_train_config(args):
    from posegen_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(
        lrate=args.lrate,
        lrate_decay=args.lrate_decay,
        lrate_decay_rate=args.lrate_decay_rate,
        decay_unit=args.decay_unit,
        weight_decay=args.weight_decay,
        loss_fn=args.loss_fn,
        loss_beta=args.loss_beta,
        coarse_weight=args.coarse_weight,
        use_acc_loss=args.reg_fn == "BCE",
        acc_loss_weight=args.reg_coef,
        use_background=args.use_background,
        testopt=args.testopt,
        fix_layer=args.fix_layer if args.finetune else 0,
        rays_per_image=max(args.N_rand // max(args.N_sample_images, 1), 1),
        opt_pose=args.opt_pose,
        opt_pose_lrate=args.opt_pose_lrate,
        opt_pose_lrate_decay=args.opt_pose_lrate_decay,
        opt_pose_decay_rate=args.opt_pose_decay_rate,
        opt_pose_decay_unit=args.opt_pose_decay_unit,
        opt_pose_step=args.opt_pose_step,
        opt_pose_coef=args.opt_pose_coef,
        opt_pose_warmup=args.opt_pose_warmup,
        opt_pose_stop=args.opt_pose_stop,
        opt_pose_cache=args.opt_pose_cache,
        use_temp_loss=args.use_temp_loss,
        temp_coef=args.temp_coef,
        cutoff_step=args.cutoff_step,
        cutoff_rate=args.cutoff_rate,
        freq_schedule_step=args.freq_schedule_step,
    )


def args_to_data_config(args):
    from posegen_tpu_torch.data.catalog import DataConfig

    subjects = args.subject if isinstance(args.subject, (list, tuple)) else [args.subject]
    rays_per_image = max(args.N_rand // max(args.N_sample_images, 1), 1)

    def _resolve_data_root(args) -> str:
        """Map the reference's `datadir` onto our data_root.

        The reference IGNORES --datadir for training data — its
        DATASET_CATALOG hardcodes 'data/<family>/...' paths
        (core/load_data.py:22-43). Its configs set datadir to the family
        dir ('./data/h36m/'); pointing our data_root there would double the
        family component, so when datadir's last component matches the
        catalog rel-path's first component we use its parent."""
        import os as _os

        datadir = args.datadir
        if not datadir:
            return args.data_root
        from posegen_tpu_torch.data.catalog import DATASET_CATALOG

        family = DATASET_CATALOG.get(_scalar(args.dataset_type), {})
        rel = next(iter(family.values()), "")
        head = rel.split("/", 1)[0]
        norm = _os.path.normpath(datadir)
        if head and _os.path.basename(norm) == head:
            return _os.path.dirname(norm) or "."
        return datadir
    # out-of-mask sampling budget: --P_nms fraction, or 1 - fg_ratio
    # (reference dataset.py:324-344 "nms" samples / --fg_ratio floor)
    box_frac = args.P_nms or 0.0
    if args.fg_ratio is not None:
        box_frac = max(box_frac, 1.0 - args.fg_ratio)
    def _resolve_rand_kps(args):
        """--rand_train_kps: train on a precomputed kp-index subset
        (reference SurrealDataset N_rand_kps, load_surreal.py:320-364 loads
        side .npy files of kp ids). Accepts a path or a name resolved under
        <data_root>/<dataset>/<name>.npy; missing files error loudly."""
        import os as _os

        val = getattr(args, "rand_train_kps", None)
        if not val:
            return None
        if _os.path.exists(val):
            return val
        cand = _os.path.join(
            _resolve_data_root(args), _scalar(args.dataset_type), f"{val}.npy"
        )
        if _os.path.exists(cand):
            return cand
        raise SystemExit(
            f"--rand_train_kps={val!r}: no such kp-subset file ({val} or {cand})"
        )

    return DataConfig(
        dataset=_scalar(args.dataset_type),
        subject=subjects[0],
        multi_subjects=subjects if len(subjects) > 1 else None,
        data_root=_resolve_data_root(args),
        n_rand=args.N_rand,
        n_sample_images=args.N_sample_images,
        patch_size=args.patch_size,
        n_box_rays=int(round(box_frac * rays_per_image)),
        mask_image=args.mask_image,
        white_bkgd=args.white_bkgd,
        load_refined=args.load_refined,
        camera=args.camera,
        n_cams=args.N_cams,
        use_val=args.use_val,
        multiview=args.multiview,
        subset_kps=_resolve_rand_kps(args),
        num_workers=args.num_workers,
        seed=args.seed,
    )
