"""Export a native checkpoint to the reference's PyTorch .tar format (port
of posegen_tpu/cli/export_tar.py).

`python -m posegen_tpu_torch.cli.export_tar --nerf_args logs/exp/args.txt \
    --ckptpath logs/exp/00060000.ckpt.npz --out h36m_060000.tar`

The inverse of the .tar import: a checkpoint trained here becomes loadable
by the reference's own `load_ckpt_from_path` / `RayCaster.load_state_dict`
and by the JAX package's `import_torch_checkpoint`. Pose-opt state
(pelvis/bones) rides along when present; pass --rest_pose_h5 to take the
PoseOptLayer's rest_pose buffer from the training H5 (read by the port's
own HDF5 reader; defaults to the canonical SMPL rest pose). The device is
a keyword argument, `main(argv, device="cpu")`, CUDA by default.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nerf_args", type=str, required=True, help="trained args.txt")
    p.add_argument("--ckptpath", type=str, required=True, help="native .ckpt.npz")
    p.add_argument("--out", type=str, required=True, help="output .tar path")
    p.add_argument(
        "--rest_pose_h5", type=str, default=None,
        help="training H5 whose rest_pose seeds the PoseOptLayer buffer",
    )
    args = p.parse_args(argv)

    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.data.hdf5 import H5File
    from posegen_tpu_torch.train.checkpoints import export_torch_checkpoint

    targs, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=device)

    flat = dict(np.load(args.ckptpath))
    step = int(flat.get("step", 0))
    pose_params = rest_pose = kp_map = kp_uidxs = None
    pp = {k.split("//", 1)[1]: flat[k] for k in flat if k.startswith("pose_params//")}
    if pp:
        pose_params = pp
        if args.rest_pose_h5:
            with H5File(args.rest_pose_h5) as f:
                rest_pose = np.asarray(f.read("rest_pose"), np.float32)
        else:
            from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE

            rest_pose = np.asarray(SMPL_REST_POSE, np.float32)
        if "root_bones" in pose_params:
            # multiview training (--multiview): the reference layer stores
            # kp_map/kp_uidxs buffers; recompute them from the training H5's
            # img_paths exactly as the dataset did at train time
            if not args.rest_pose_h5:
                raise SystemExit(
                    "multiview checkpoint: pass --rest_pose_h5 (the training "
                    "H5) so kp_map/kp_uidxs can be rebuilt from img_paths"
                )
            from posegen_tpu_torch.data.multiview import create_kp_mapping, find_motion_set

            with H5File(args.rest_pose_h5) as f:
                img_paths = list(np.asarray(f.read("img_paths")))
            kp_map, kp_uidxs = create_kp_mapping(*find_motion_set(img_paths))

    path = export_torch_checkpoint(
        args.out, variables, cfg, global_step=step,
        pose_params=pose_params, rest_pose=rest_pose,
        opt_pose_lrate=getattr(targs, "opt_pose_lrate", 5e-4),
        kp_map=kp_map, kp_uidxs=kp_uidxs,
    )
    print(f"exported {path}")
    return path


if __name__ == "__main__":
    main()
