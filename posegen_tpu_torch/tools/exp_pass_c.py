"""What bounds the backward's input-gradient pass (c) (csrc/field_grad.cu):
scratch builds of field_grad.cu with one part of its two kernels changed,
timed by the profiler at the pose step's coarse shape; and, with
--conditioning, how far its input gradients sit from the plain pipeline's
at a deep octave ladder.

    python -m posegen_tpu_torch.tools.exp_pass_c [--conditioning]

On a machine with one NVIDIA GPU and nvcc. Builds under
build/exp_pass_c/ (each variant's field_grad.cu in its own nvcc, all at
once, the other sources once), then, in two rounds of turns, times pass (c)'s
kernels in one field_backward(..., inputs=...) on 256 pose groups x 12 rays
x 64 samples (196,608 points, the SURREAL net at multires 7 / 4, random
weights from seed 1), and checks that a variant that computes the input
gradients gives the base build's bit for bit. Variants:

  base       the committed source
  no_stores  input_sm90_kernel without its TMA stores (staging writes kept)
  no_mma     input_sm90_kernel without its wgmma (its loads and stores kept)
  chain_2    input_chain_kernel at 2 blocks an SM (base: 4)
  chain_3    input_chain_kernel at 3 blocks an SM

--conditioning builds nothing but the library: at multires 15 / 4, on 4 and
16 pose groups x 12 rays x 64 samples and several draws of the output
cotangent and view bias, it prints the relative L2 of d_pts, d_dirs and
d_poses of one launch against field_bwd_plain + encode_bwd_plain (chip_smoke
phase 7's reference), against the same with the launch's own encoding
cotangents on the points whose pass (a) ReLU masks differ from the plain
version's, and against encode_bwd_plain on the plain products of the
launch's own cotangents (pass (c) alone).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch

from posegen_tpu_torch.kernels import build
from posegen_tpu_torch.kernels import field as F
from posegen_tpu_torch.kernels import field_grad as FG

OUT = build.BUILD_DIR.parent / "exp_pass_c"
CHAIN_BOUNDS = "__launch_bounds__(kThreads, 4)\n    input_chain_kernel"
TMA_STORE = "sm90::tma_store_2d(map, stage_s + b * kOutBuf, n0 + 32 * q, row);"
MMA_LOOP = "for (int kk = 0; kk < 4; ++kk) {"
# name -> ((file, text, replacement) edits, whether it computes the gradients)
VARIANTS = {
    "base": ((), True),
    "no_stores": ((("field_grad.cu", TMA_STORE, ""),), False),
    "no_mma": ((("sm90_tile.cuh", MMA_LOOP, "for (int kk = 0; kk < 0; ++kk) {"),), False),
    "chain_2": ((("field_grad.cu", CHAIN_BOUNDS, CHAIN_BOUNDS.replace("4)", "2)")),), True),
    "chain_3": ((("field_grad.cu", CHAIN_BOUNDS, CHAIN_BOUNDS.replace("4)", "3)")),), True),
}
PASS_C = ("input_sm90_kernel", "input_chain_kernel", "pose_reduce_kernel", "ray_sum_kernel")


def build_variants() -> dict:
    """Every variant's library -> {name: path}."""
    shutil.rmtree(OUT, ignore_errors=True)
    nvcc, flags = build._nvcc(), list(build.NVCC_FLAGS)
    common = OUT / "common"
    common.mkdir(parents=True)
    jobs = {}
    for src in ("field.cu", "field_variants.cu"):
        jobs[common / f"{src}.o"] = build.CSRC / src
    for name, (edits, _) in VARIANTS.items():
        d = OUT / name
        d.mkdir()
        for f in build.HEADERS + ("field_grad.cu",):
            text = (build.CSRC / f).read_text()
            for file, old, new in edits:
                if file == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"{name}: {old!r} not found once in {f}")
                    text = text.replace(old, new)
            (d / f).write_text(text)
        jobs[d / "field_grad.o"] = d / "field_grad.cu"
    for h in build.HEADERS:
        shutil.copy(build.CSRC / h, common)
    procs = [(obj, subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
             for obj, src in jobs.items()]
    for obj, p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {obj}:\n{err[-3000:]}")
    libs = {}
    for name in VARIANTS:
        lib = OUT / name / "lib.so"
        subprocess.run([nvcc, *flags[:2], "-shared", "-o", str(lib), str(OUT / name / "field_grad.o"),
                        str(common / "field.cu.o"), str(common / "field_variants.cu.o")],
                       check=True, capture_output=True)
        libs[name] = lib
    return libs


def use(lib: Path) -> None:
    """Make `build.load` load this library from now on."""
    build._LIB = None
    build.build = lambda: lib


def problem(device="cuda", groups: int = 256, multires: int = 7, multires_views: int = 4,
            draw: int = 0):
    """groups pose groups x 12 rays x 64 samples (the pose step's coarse
    shape at 256), the SURREAL net at this multires with seed-1 weights, a
    view-bias row per group and the output cotangent drawn from `draw` ->
    (g, e_pts, e_view, net, view bias, inputs)."""
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx, make_rays

    cfg = RaycastConfig(multires=multires, multires_views=multires_views)
    rpg, n_s = 12, cfg.N_samples
    ctx = make_pose_ctx(1, n_poses=groups, device=device)
    rays_o, rays_d = make_rays(groups * rpg, 2, device=device)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(1), device=device)
    L = F.net_layout(cfg.netdepth, multires, multires_views)
    gen = torch.Generator().manual_seed(1 + draw)
    with torch.no_grad():
        near, far = samp.get_near_far_in_cylinder(
            rays_o, rays_d, ctx.cyls.repeat_interleave(rpg, 0), near=cfg.near, far=cfg.far)
        z = samp.sample_from_lineseg(near, far, n_s)
        pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3).contiguous()
        poses = F.pack_poses(ctx.skts, variables["embed_kp"], multires, multires_views)
        net = F.pack_net_f32(variables["fine"], L)
        bview = F.group_view_bias(variables["fine"], L)
        bview = (bview + 0.1 * torch.randn((groups, F.VIEW_WIDTH), generator=gen).to(device))
        g = torch.randn((pts.shape[0], 4), generator=gen).to(device)
        _, e_pts, e_view = FG.fused_field_stash(pts, rays_d, n_s, poses, net, bview.contiguous())
    return g, e_pts, e_view, net, bview.contiguous(), FG.FieldInputs(pts, rays_d, n_s, poses)


def conditioning(groups: int, draw: int) -> str:
    """One launch at multires 15 / 4 against the plain pipeline, three ways
    (see the module's note) -> a line of relative L2s."""
    bf16 = torch.bfloat16
    g, e_pts, e_view, net, bview, ins = problem(groups=groups, multires=15, multires_views=4,
                                                draw=draw)
    L, P = net.layout, ins.pts.shape[0]
    ws = FG.bwd_workspace(P, L, groups, P // groups, "cuda")
    with torch.no_grad():
        got = FG.field_backward(g, e_pts, e_view, net, bview, ins, workspace=ws)[3:]
        *_, g_ep, g_ev = FG.field_bwd_plain(e_pts, e_view, g, net, bview, mm_dtype=bf16,
                                            input_grads=True)
        ws_p = FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview, mm_dtype=bf16)
        layers, _, _, (wv, _), _ = F._unpack(net)
        gz = ws.regions["gz"].float()
        own_ep = (gz[0] @ layers[0][0].to(bf16).float()
                  + gz[L.skip + 1] @ layers[L.skip + 1][0][:, :L.pc].to(bf16).float())
        own_ev = ws.regions["gzv"].float() @ wv[:, F.WIDTH:F.WIDTH + L.vc].to(bf16).float()
        flip = (((ws.regions["hs"] > 0) != (ws_p["hs"] > 0)).any(-1).any(0)
                | ((ws.regions["hv"] > 0) != (ws_p["hv"] > 0)).any(-1))[:, None]
        refs = {"plain": (g_ep, g_ev),
                "knife-edge points excused": (torch.where(flip, own_ep, g_ep),
                                              torch.where(flip, own_ev, g_ev)),
                "pass (c) alone": (own_ep, own_ev)}
        out = []
        for name, (ep, ev) in refs.items():
            ref = FG.encode_bwd_plain(ins.pts, ins.dirs, ins.spr, ins.poses, ep, ev, L.nf_kp,
                                      L.nf_view)
            rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, ref)]
            out.append(f"{name} " + " / ".join(f"{r:.3e}" for r in rel))
    return (f"multires 15 / 4, {groups} groups ({P} points), draw {draw}, {int(flip.sum())} "
            "knife-edge points: d_pts / d_dirs / d_poses relative L2 vs " + "; ".join(out))


def pass_c_ms(fn, n: int = 5) -> dict:
    """torch.profiler over n calls -> device ms per call of each pass (c) kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ms = {k: 0.0 for k in PASS_C}
    for e in prof.key_averages():
        for k in PASS_C:
            if e.device_type == DeviceType.CUDA and k in e.key:
                ms[k] += e.self_device_time_total / 1e3 / n
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_pass_c: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--conditioning" in sys.argv[1:]:
        for groups, draws in ((4, 4), (16, 3)):
            for draw in range(draws):
                print(conditioning(groups, draw), flush=True)
        return 0
    libs = build_variants()
    use(libs["base"])
    g, e_pts, e_view, net, bview, ins = problem()
    ws = FG.bwd_workspace(ins.pts.shape[0], net.layout, 256, ins.pts.shape[0] // 256, "cuda")
    run = lambda: FG.field_backward(g, e_pts, e_view, net, bview, ins, workspace=ws)  # noqa: E731
    ref = [t.clone() for t in run()[3:]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"pass (c) on {ins.pts.shape[0]} points [{card}]")
    for rnd in range(2):
        for name, lib in libs.items():
            use(lib)
            same = all(torch.equal(a, b) for a, b in zip(ref, run()[3:]))
            ms = pass_c_ms(run)
            check = ("bit-identical to base" if same else "DIFFERS from base") if VARIANTS[name][1] \
                else "gradients not computed"
            print(f"round {rnd} {name:10s} pass (c) {sum(ms.values()):.3f} ms: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f"; {check}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
