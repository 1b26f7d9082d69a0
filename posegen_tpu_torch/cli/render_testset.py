"""3DPW-testset renderer: real-pose-driven dataset generation (port of
posegen_tpu/cli/render_testset.py).

Capability parity with reference render_3dpw_testset.py:3386-3586 (the
variant of the GAN loop whose poses come from the 3DPW test annotations
instead of the generator): FK the annotation SMPL thetas, render each pose
with the trained (resident) NeRF from the fixed feedback camera, write the
(image, pose) pairs. The frames go through `gen/loop.NeRFRenderer` (on the
card, one dual and one field launch per chunk), the PNGs through the port's
own codec. The device is a keyword argument, `main(argv, device="cpu")`,
CUDA by default.

`python -m posegen_tpu_torch.cli.render_testset --nerf_args ... --ckptpath ...
 --annot_dir data/3DPW --outputdir render_output --runname 3dpw`
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> str:
    p = argparse.ArgumentParser("posegen_tpu.render_testset")
    p.add_argument("--nerf_args", type=str, required=True)
    p.add_argument("--ckptpath", type=str, required=True)
    p.add_argument("--annot_dir", type=str, required=True,
                   help="dir of 3DPW-style npz annotations (pose key)")
    p.add_argument("--outputdir", type=str, default="render_output")
    p.add_argument("--runname", type=str, default="3dpw_testset")
    p.add_argument("--render_hw", type=int, default=512)
    p.add_argument("--max_poses", type=int, default=100)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--pose_scale", type=float, default=0.4)
    args = p.parse_args(argv)

    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.gen.loop import FEEDBACK_EXTRINSIC, NeRFRenderer, fk_joints
    from posegen_tpu_torch.skeleton.cameras import nerf_extrinsic_to_c2w
    from posegen_tpu_torch.utils.png import write_png
    from posegen_tpu_torch.utils.progress import Bar

    _, cfg, variables = load_trained(args.nerf_args, args.ckptpath, device=device)
    renderer = NeRFRenderer(cfg, variables, hw=args.render_hw, pose_scale=args.pose_scale)

    # collect thetas from every annotation file (reference PW3D loading)
    thetas = []
    for f in sorted(os.listdir(args.annot_dir)):
        if not f.endswith(".npz"):
            continue
        d = np.load(os.path.join(args.annot_dir, f), allow_pickle=True)
        if "pose" in d:
            thetas.append(np.asarray(d["pose"], np.float32))
    if not thetas:
        raise FileNotFoundError(f"no npz annotations under {args.annot_dir}")
    bones = np.concatenate(thetas)[:: args.stride][: args.max_poses]
    bones = bones.reshape(len(bones), 24, 3)

    c2w = nerf_extrinsic_to_c2w(FEEDBACK_EXTRINSIC)
    out_dir = os.path.join(args.outputdir, args.runname)
    img_dir = os.path.join(out_dir, "image")
    os.makedirs(img_dir, exist_ok=True)

    bar = Bar("render", max=len(bones))
    chunk_sz = 10
    with torch.no_grad():
        for s in range(0, len(bones), chunk_sz):
            blk = bones[s : s + chunk_sz]
            imgs = renderer.render_poses(blk, np.broadcast_to(c2w, (len(blk), 4, 4)))
            for i, img in enumerate(imgs):
                write_png(os.path.join(img_dir, f"{s + i:05d}.png"),
                          (np.clip(img, 0, 1) * 255).astype(np.uint8))
                bar.next()
    bar.finish()

    joints = fk_joints(torch.as_tensor(bones), args.pose_scale).numpy()
    np.save(os.path.join(out_dir, "poses.npy"), joints)
    np.save(os.path.join(out_dir, "poses_axis_angles0.npy"), bones)
    print(f"rendered {len(bones)} testset poses to {img_dir}")
    return out_dir


if __name__ == "__main__":
    main()
