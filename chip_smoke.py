#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (posegen_tpu_torch) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, on a machine with one NVIDIA card, nvcc
and PyTorch built for CUDA. Phases, each of which fails the run:

  1. build    compile the kernels from posegen_tpu_torch/kernels/csrc with
              nvcc (the build's seconds and each kernel's registers and
              spills printed); no kernel spills, the SASS of the eval
              kernel (field.cu, all seven modes: full, density-only, dual,
              the stash, grouped full and density-only, and the ray
              ladder) and of kernel 4's passes (a), (b) and (c)'s
              products holds wgmma (HGMMA) and TMA (UTMALDG; UTMASTG in pass
              (a) and pass (c)'s products) by cuobjdump, as do the A/B
              harness's variants of the eval kernel but its probes, and no
              WMMA variant kernel is left; the library's plans equal their
              Python mirrors: the shared memory of the eval kernels, the
              stash kernel, passes (a) and (c), the eval
              kernels' scratch slot and persistent grid, pass (b)'s split,
              the backward's workspace (its bytes and every region's
              offset, with input gradients and without);
  2. kernels  at the flagship render's shapes (8192 rays, 64 + 16 samples),
              at ragged sizes whose 128-point tiles outnumber the card's
              SMs (131,056 points) and do not (16,016, and one tile of 48),
              on a depth-16 net and on the multires 4 / multires_views 2
              layout of configs/: fused_dual against dual_plain and
              fused_field (full and density_only) against field_plain,
              bf16 operands on both sides, elementwise |kernel - plain| <=
              1e-3 + 2e-2 |plain|, density_only's sigma equal to the full
              kernel's;
  3. render   render_rays on make_problem(RaycastConfig(), 8192 rays) with
              coarse_rgb False (dual + field) and True (field x 2): the
              launch counters prove the kernels ran, rgb_map is finite and
              within 5e-3 of the plain PyTorch pipeline on every ray but
              those (at most 1%) whose opacity flips on a knife edge: the
              fine net's sigma at the ray's far sample must change sign
              between the kernel and the float32 net for each of them;
  4. timing   CUDA-event times of both render variants (30 iterations after
              warm-up) and of each kernel and plain version, beside the
              kernel's bound and the card's name and power limit;
  5. training kernels  at the flagship train step's shapes (128 pose groups
              x 16 rays x 64 and x 80 samples) and at one ragged size (3
              groups, a last tile of 16 points, a view bias per group),
              fused_field_stash against field_stash_plain (raw and both
              stashes, the elementwise rule of phase 2; also at multires
              7 / 7 and 15 / 4, whose kp octaves 8 and up hold to relative
              L2 <= ENC_SUM_TOL (compare_kp_ladder), and on groups smaller
              than a tile, 80 and 8 points, with a view-bias row each; its
              raw bit-identical to fused_field's on one group, the same
              body) and field_backward
              against field_bwd_plain, bf16 operands on both sides, each
              gradient tensor to ||kernel - plain||_2 <= GRAD_TOL ||plain||_2,
              and two backward launches bit-identical; then each pass of
              the backward on its own, from the workspace that the same
              launch left: pass (a)'s regions against
              field_bwd_workspace_plain (hs, feat, hv, ghead by the
              elementwise rule; the cotangents gz, gfeat, gzv by it on every
              point whose ReLU masks agree with the plain version's, at most
              MAX_MASK_FLIP_FRAC of the points not, and each to GRAD_TOL
              relative L2), and the launch's d_w (pass (b)) against
              field_wgrad_plain's products of those regions (elementwise);
  6. train    make_train_step on a flagship batch (N_rand 2048 = 128 groups x
              16 rays, with backgrounds) at perturb 0: the launch counters
              read field_stash 2, field_bwd 2 and no eval kernel, the losses
              are finite, and the step's NeRF gradients hold against the
              same step through the plain float32 pipeline; then 5 steps of
              the config's perturbed, noisy training, every loss finite; the
              eval kernels refuse weights that require grad; and the times
              of a train step (with pass (a)'s and (b)'s device time per
              step) and of each training kernel and plain version, each pass
              of kernel 4 by the profiler beside its share of the backward's
              bound, the two-pass design's floor (its workspace bytes at the
              memory rate) and, for pass (b), one torch.mm (cuBLAS) per
              product of the same workspace;
  7. pose kernels  at the pose-refinement step's shapes (configs/h36m/
              h36m_prot2.txt: 256 pose groups x 12 rays x 64 and x 80
              samples), at one ragged size whose tiles straddle groups
              (3 groups x 7 rays x 80 samples) and, at a small shape (4
              groups x 12 rays x 64 samples), at multires 9 / 4, 7 / 7 and
              15 / 4, the layouts pass (c)'s WMMA plan refused,
              field_backward with its input-gradient branch against
              field_bwd_plain + encode_bwd_plain, bf16 operands on both
              sides: d_pts, d_dirs and d_poses each to relative L2 <=
              GRAD_TOL; its weight gradients bit-identical to a weights-only
              launch, and two launches bit-identical; the encodings'
              cotangents g_e_pts and g_e_view that the launch left in its
              workspace against the plain products of the same workspace's
              cotangents (the elementwise rule of phase 2);
  8. pose     make_train_step with opt_pose on an h36m_prot2 batch (N_rand
              3072 = 256 groups x 12 rays over 512 synthetic frames, rot6d
              pose params, framecodes, L1 loss, backgrounds) at perturb 0:
              the launch counters read field_stash 2, field_bwd 2,
              field_bwd_inputs 2 and no eval kernel, and the NeRF and the
              pose gradients each hold to STEP_GRAD_TOL against the same
              step through the plain float32 pipeline; then 5 perturbed,
              noisy steps at opt_pose_step 50 (finite losses, the pose
              unmoved, 5 gradients accumulated) and one at opt_pose_step 1
              (the pose moves); the step's time (with pass (a)'s and (b)'s
              device time per step), and the input branch's
              device time (the profiler's, of pass (c)'s kernels, each
              kernel's share printed) beside its bound and the two-kernel
              design's floor (its f32 cotangents written and read once);
  9. variants the field kernel's A/B harness (posegen_tpu_torch/tools/
              exp_kernel_variants.py, the port of tools/exp_kernel_variants.py)
              on its problem (8192 rays x 80 samples = 655,360 points, one
              pose) and on a ragged grouped problem (3 groups x 7 rays x 80
              samples; a tile may straddle groups): every case and probe of
              variant_field that the kernel takes, at its 128-point tile,
              against variant_plain with bf16 operands to the elementwise
              rule of phase 2 (the encode probe also to relative L2 <=
              ENC_SUM_TOL); base bit-equal to fused_field and dens_base to
              its density_only call on the harness's problem, both to
              fused_field on the ragged problem's pose table
              (posegen_field_grouped), pipe2 to bf16enc; base and fused_field,
              dens_base and density-only fused_field timed in turns; then
              the harness's sweep from launch counts of 0: every case the
              kernel takes launched chain + 3 times, with its time beside its
              bound, and the probes' share of base's time; and the plain
              version's time;
 10. whole images  the feedback renderer's path on RaycastConfig() with the
              seed-1 weights: a train state through save_checkpoint /
              load_checkpoint and its render variables through
              export_torch_checkpoint / import_torch_checkpoint, each
              bit-equal, the renders below from the restored variables;
              render_images_pipelined of 20 bullet-camera frames at 512 x 512,
              focal 1000, chunk 8192, f16 readback, window (100, 412) (gen/
              loop.py's call): launch counters read one dual and one field
              launch per chunk, its first two frames against the same call
              through the plain pipeline, fewer synchronising operations than
              chunks, and its host-clock time (median of 10 calls, alternating
              with 10 calls whose nets are packed once: the repacking's
              share); one render_image frame (f32 readback) on the kernels'
              route against the plain pipeline (rgb to 5e-3 but on opacity
              flips, each with a far-sigma sign change, as in phase 3, for
              the frames too); psnr / ssim / ms_ssim of the two
              frames on the card against the CPU to 1e-5 with cuDNN's TF32
              on; extract_mesh at res 64 through the density-only kernel
              (one field launch), its sigma grid against render_mesh_density's
              plain route by the elementwise rule of phase 2;
 11. gan      the GAN + SPIN feedback loop at full width (posegen_tpu_torch/
              gen/loop.py): GanTrainer with GenConfig(), the ResNet-50 HMR at
              224 (seed 2) and NeRFRenderer on phase 10's restored variables
              (512 x 512, focal 1000, chunk 8192, window (100, 412)), 20
              renders an iteration, feedback at every iteration, D every 2,
              real-pose batches of 1024 (N(0, 0.2^2) bones, numpy seed 0):
              (a) 4 feedback iterations, each with one dual and one field
              launch per chunk of its 20 windowed frames, SPIN's (20, 14, 3)
              joints and every G / D stat finite, the generator's params
              moved; (b) SPIN's forward on those frames against the CPU's to
              relative L2 <= 1e-4 with cuDNN's TF32 off (with it on, the
              figure printed); (c) one G step with feedback active and one D
              step against the CPU's on the same noises and inputs, losses to
              1e-4 relative, Adam's moments to 1e-3 relative L2; (d) one SPIN
              fine-tune step on 4 rendered crops with fixed dropout masks,
              loss and gradients to 1e-2 relative L2 against the CPU's; (e)
              the trainer's checkpoint round trip bit-equal; (f)
              probe_hardness finite. Times beside the card: host-clock
              iterations with and without feedback (10 of each, in turns),
              the feedback render's frames/s, a feedback iteration's device
              time under the profiler (dual, field, convolutions, the rest,
              idle share) and the fine-tune step at batch 32.
 12. cli      train a NeRF through the CLI from H5 files
              (posegen_tpu_torch/cli/run_nerf.py, data/): (a) make_synthetic_h5
              writes a SURREAL-shaped file (128 images of 512^2, 128 poses,
              one background plate) at DATASET_CATALOG["surreal"]["female"]'s
              path through the port's own HDF5 writer, read_h5 reads every key
              back bit-equal, H5RayDataset takes the memmap fast path and its
              batches come from the native sampler; the write's seconds and
              bytes, the open's ms, make_batch's ms (median of 50) on the
              native and the numpy path, and a pinned batch's upload; (b)
              run_nerf.train on configs/surreal/surreal.txt at full width with
              only the data root, basedir, --n_iters 200, --i_testset 200,
              --i_weights 200, --i_print 50 and --i_video 0 overridden: each
              step launches field_stash 2, field_bwd 2 and no other kernel,
              evaluate_testset one dual and one field launch per chunk of its
              2 val frames, the first of them (chunk 4096) against the same
              render through the plain pipeline by phase 3's flip rule,
              every printed loss finite, psnr.txt and ssim.txt written, the
              checkpoint bit-equal through a fresh state, and a resume for
              one more step starts at step 200; (c) configs/h36m/
              h36m_prot2.txt (opt_pose, render_factor 2) on a synthetic file
              at h36m's S9 path, 256 images cut to 256^2, 30 steps, each with
              pass (c)'s 2 launches besides, finite losses, the first val
              frame (per-frame framecodes) against the plain pipeline by the
              same rule, the background's downsizing and the frame's
              upsizing on the card against the CPU to RESIZE_TOL, the pose
              checkpoint written and loaded back; (d) the CLI's trained
              rays/s by the host clock over steps 51-200 beside phase 6's bare
              step, the seconds per val frame and the profiler's idle share
              over steps 21-40.
 13. mine     render and mine from phase 12's trained surreal run through the
              CLIs at their own chunks: (a) run_render.load_trained of its
              args.txt + step-200 .npz, every tensor bit-equal to the trained
              state; export_tar.main -> load_trained of the .tar, its tensors
              bit-equal; the h36m_prot2 run's .npz (pose params, framecodes)
              likewise; (b) run_render --render_type val --eval at chunk
              65536: one dual and one field launch per chunk, frame 0
              against the same render through the plain pipeline (each
              chunk in slices of 8192 rays with the chunk's near / far) by
              phase 3's flip rule, psnr.txt / ssim.txt written, every PNG
              read back by read_png equal to the u8 of its frame; (c)
              --render_type
              bullet --bullet_n 4 (launches per chunk, 4 PNGs), then mesh at
              res 64 (one density-only launch, mesh.ply); (d)
              render_testset.main on 2 annotation files of 10 poses (numpy
              seed 0): 20 PNGs, poses.npy, launches per chunk; (e)
              run_gan.main at batch 1024 on the seed's pool of 4096 poses (4
              iterations), feedback at every iteration (20 renders, chunk
              32768), probe of 8, train_spin 3 epochs: launches per chunk of
              every feedback render, the first feedback call's frames 0-1
              against the same call through the plain pipeline (slices of
              8192 rays) by phase 3's flip rule, one PNG per pose row, each
              (512, 512, 3) uint8, train_spin's steps at batch 32 with finite
              losses, spin_000.npz and gan_000.npz, a finite probe_mpjpe, and
              a second main to 2 epochs resuming at epoch 1; (f) times:
              run_render's seconds per val frame, write_png (levels 1 and 6)
              and read_png per 512^2 frame, run_gan's epoch beside phase 11's
              iteration, train_spin's warm steps (after the first),
              render_testset's frames/s.
 14. eval     SPIN's evaluation and SKI fine-tune at full width
              (posegen_tpu_torch/evals/harness.py, gen/spin_driver.train_ski,
              body/smpl.py): (a) the port's JPEG decoder on the fixtures of
              tests/data/jpeg, each array's SHA-256 equal to the manifest's
              (imageio's, where the fixtures were written), ms a 1080 x 1920
              4:2:0 frame; (b) make_random_model(6890, 24, 10) and a random
              17 x 6890 regressor, batch 32, vertices and joints card vs CPU
              to 1e-5 relative L2; (c) SpinEvaluator.inference with the
              ResNet-50 HMR at 224 on a 3DPW-schema set of 128 crops of the
              full-size fixture (seeded centres, scales, poses, betas, mixed
              genders; SMPL models of three seeds), no kernel launched,
              every metric card vs CPU to 1e-4 relative with cuDNN TF32 off,
              the shift with TF32 on printed; frames/s of the call by the
              host clock split into decode, crop and device ms a batch; the
              batch's device time and its Procrustes / SVD share by CUDA
              events; (d) inference_joints on a SKI-schema set (64 PNGs of
              256^2, labels.h5 by the port's write_h5) and a 3DHP-schema set
              (32 crops), export_agora_predictions of 8 people whose pickles
              read back; (e) train_ski 2 epochs of the 64 SKI samples at
              batch 32: the first step's loss card vs CPU to 1e-2 (same
              inputs and dropout masks), spin_ski_001.npz equal to the
              trained params, ms a warm step.

 15. ingest   the data front on raw trees at the datasets' own sizes
              (posegen_tpu_torch/data/ingest.py, masks.py, segmenter.py,
              bench_loader.py): (a) a SURREAL render dump (2 sequences x 16
              poses x 4 cameras of 512^2: metadata.pkl, segm .mat by scipy,
              PNGs by write_png) through ingest.main on the card, its H5 key
              for key against ingest_surreal on the CPU (images, masks and
              integer arrays equal, float arrays to 1e-5 relative L2, at most
              1e-4 of the sampling-mask pixels, pruned by the float32
              cylinders, differing), then run_nerf.train with surreal.txt on
              that file for 30 steps (--num_workers 0; field_stash 2,
              field_bwd 2 a step) and
              its val frame (dual = field = chunks) against the plain pipeline
              by phase 3's flip rule; (b) an H36M-shaped tree (4 cameras x 8
              frames of 1000^2 cut from the 1080p fixture, one camera of 1002
              rows, PNGs; the SPIN and mask h5 files by write_h5): DeepLab-v3
              (random weights) over the 32 frames on the card, its logits at
              513^2 card vs CPU (TF32 off) to 1e-4 relative L2 and every
              person-mask pixel that differs within that tolerance of a top-2
              tie, masks_from_background (the mask file's masks), ingest.main,
              an H5RayDataset batch; (c) a ZJU tree (4 views x 4 frames of
              1024^2, k1 -0.2 .. -0.26) through ingest_zju with
              make_random_model(6890, 24, 10) on the card against the CPU by
              (a)'s rule; (d) bench_loader (a subprocess, native and numpy,
              --num_workers 0 and 16) on (a)'s file; the times of each.

 16. tooling  tooling and the SMPL family (posegen_tpu_torch/utils/gif.py,
              render/rasterizer.py, cli/render_mesh.py, body/models.py,
              body/transfer.py, utils/profiling.py): (a) run_nerf's
              save_spiral_video of phase 12's surreal run (10 frames at
              factor 2) with one dual and one field launch per chunk, its
              disparity GIF read back by read_gif equal to its grey frames and
              its rgb GIF to the writer's quantisation of its frames; phase
              13's render_rgb.gif one frame per PNG, each its PNG's
              quantisation; (b) render_mesh.main on phase 13's res-64 mesh.ply
              at its defaults (12 views of 256^2): every PNG equal to its
              frame, view 0 rasterized on the CPU equal to the card's; (c)
              random SMPL-X (10,475 vertices, 55 joints, 20,908 faces, 10 + 10
              shape columns, 12 PCA hand components, face contour), MANO (778,
              16, 1,538) and FLAME (5,023, 5, 9,976, 300 + 100 columns,
              landmark embeddings) files from a seed loaded on the card and on
              the CPU, a batch of 128 poses: vertices, joints and full_pose to
              1e-5 relative L2 (TF32 off); (d) run_fitting on a random SMPL
              (6,890 / 24 / 13,776) with 8 meshes it makes at sigma 0.2 rad: a
              short schedule card vs CPU, its fitted vertices to 1e-4
              relative L2 and its losses to 1e-4 (the params printed beside
              the CPU's own response to a one-ulp move of the targets), the default
              schedule's mean v2v at least 10x under the zero start's, and
              transfer.main on the meshes as .ply writing JAX's npz keys; (e)
              utils/profiling.trace over three phase-4 renders in
              annotate("render"): the Chrome trace names the eval kernels and
              the region; the PhaseTimer's summary of (a)-(d);
              device_memory_stats within the card's memory. Times of each.
 17. grouped  kernel 2's last modes (csrc/field.cu): (a) fused_field on
              grouped poses (a pack_poses table, a view bias per group),
              full and density-only, against field_plain by phase 2's rule
              at surreal.txt's train layout (128 groups x 16 rays x 64 and
              x 80 samples) and h36m_prot2.txt's (256 x 12 x 64), on a
              framecode net with a code per group and on multires 4 / 2;
              h36m_prot2's 80-sample batch (960 points a group) refused by
              fused_run_net's ValueError, as in JAX; (b) one grouped launch
              on 20 groups x 4096 rays x 80 samples equal, bit for bit, to
              the 20 single-pose launches with each group's pose and code;
              (c) render_rays(use_fused=True, coarse_rgb=False) on a
              perturb-0 grouped batch of 128 x 16 rays at RaycastConfig():
              launches field_grouped 2, no other kernel, rgb_map against
              the plain pipeline on the per-ray ctx by phase 3's flip rule;
              (d) fused_run_net(ray_ladder=True) at 8192 rays x 80, 64 and
              16 samples: field_ray_ladder 3 launches, each raw equal, bit
              for bit, to the per-point mode's; density-only, grouped and
              one-sample calls leave it off; the ladder against its plain
              version by phase 2's rule; (e) CUDA-event times of the
              grouped modes, of one grouped launch against the 20
              single-pose launches, and of the ladder against the
              per-point mode, beside the bound and the plain version.

 18. parallel data parallelism over ranks (posegen_tpu_torch/parallel/): a
              2-rank world on the one card (gloo: NCCL takes one rank a
              device), CUDA tensors, spawned by parallel.mesh.launch: (a)
              the flagship train step (128 groups x 16 rays, perturb 0)
              on halves of the batch, 2 steps through
              make_shardmap_train_step: field_stash 4, field_bwd 4 and no
              other launch on each rank, each gradient tensor against this
              process's step on the whole batch to GRAD_TOL relative L2
              (phase 5's), the losses to it relatively, each parameter
              tensor's change over the 2 steps to it too; (b) one render_image frame (512^2, chunk 8192)
              through make_shardmap_render_cam: one dual and one field
              launch per chunk on each rank, every ray whose near / far the
              two chunkings give alike bit-equal to the single frame, the
              rest by phase 3's flip rule; (c) the G, D and SPIN fine-tune
              steps at GenConfig() and the ResNet-50 HMR at 224, batch 32,
              through parallel/gan.py: losses to 1e-4 relative, Adam's
              moments (G, D to 1e-3, SPIN to 1e-2 relative L2), the synced
              BN state and the gathered poses to 1e-4; the ranks' states
              bit-equal; (d) a 1-rank NCCL world: the train step through
              make_mesh equal to the plain step bit for bit; host-clock
              times of each arm (median of 5) beside the single process's.

 19. single   configs/surreal/surreal_single.txt as shipped: an 8192-ray
              render (two posegen_field launches) and two train steps
              through the eval and training kernels, against the plain
              pipeline.

 20. proofs   the purpose experiments of posegen_tpu_torch/tools/, each
              through its entry point at a reduced budget: the flagship
              demo NeRF (flagship_demo, PROOF_FLAGSHIP_ITERS steps of
              run_nerf); exp_bf16_delta at 512^2 (the kernels' frame and
              the plain f32 frame, their PSNR printed); exp_poseopt
              prepare (the JAX tool's 264-image 256^2 scene), soak
              (PROOF_SOAK_ITERS h36m_prot2 steps), evalpose and testopt
              (PROOF_TESTOPT_ITERS iterations at one tol); exp_mining
              (32 pretraining renders, one GAN epoch ON and OFF, 32 mined
              frames); run_gan with the pretrained SPIN, then
              exp_capstone_ft on its sink. Each JSON holds the JAX tool's
              keys, all finite; dual, field, stash, passes (a) / (b) and
              pass (c) each launch at least once across the phase. Then
              the routes, kernels against the plain f32 pipeline:
              exp_bf16_delta's frame by phase 3's flip rule (each flip a
              far-sigma sign change) and to PROOF_FRAME_PSNR off the
              pixels whose opacity differs; testopt's pose params after
              PROOF_K steps to STEP_GRAD_TOL (phase 8's rule); and
              exp_mining's probe within the move that the rgb_map rule's
              allowance gives the plain frames (every pixel shifted by
              RENDER_TOL, MAX_FLIP_FRAC flipped), each arm's launches
              checked.

Before phase 1 it prints whether h5py, imageio, cv2, PIL and tensorboard import
(information only).
The last two lines of standard output are one JSON object of per-kernel
numbers and one JSON object naming the device. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
RTOL, ATOL = 2e-2, 1e-3  # kernel vs plain, both with bf16 operands
RENDER_TOL = 5e-3  # fused render vs the plain pipeline (rgb_map)
RESIZE_TOL = 1e-5  # run_nerf's bilinear resizes, card vs CPU (float32 rounding)
MAX_FLIP_FRAC = 0.01  # rays allowed to flip opacity at a knife edge (see phase 3)
N_RAYS = 8192
N_RAGGED = 1001  # rays of the ragged case: 1001 x 16 points = 250 tiles of 64 + 16
N_ITERS = 30
N_GROUPS, RAYS_PER_GROUP = 128, 16  # the flagship train batch: N_rand 2048
POSE_GROUPS, POSE_RPG = 256, 12  # the h36m_prot2 batch: N_rand 3072 in 256 images
POSE_FRAMES = 512
RAGGED_GROUPS, RAGGED_RPG = 3, 7  # 3 x 7 rays x 80 samples = 26 tiles of 64 + 16
# the kernels of the backward's input-gradient branch, pass (c), by name
PASS_C_KERNELS = ("input_sm90_kernel", "input_chain_kernel", "pose_reduce_kernel",
                  "ray_sum_kernel")
GRAD_TOL = 1e-2  # training kernel vs plain: relative L2 per gradient tensor
STEP_GRAD_TOL = 5e-2  # train step, kernels vs plain f32 pipeline: relative L2, all gradients
TRAIN_ITERS = 20
VARIANT_CHAIN = 10  # launches per timed chain of the harness's sweep (phase 9)
VARIANT_TILE = 128  # the eval kernel's tile, the variants' only one
# the encode probe, kernel vs plain, relative L2 over all points (not the
# elementwise rule: a point's sum of ~1,080 channels may cancel to near 0):
# an ulp between the card's and PyTorch's f32 sin / cos, or the FMA
# contraction of the double-angle recurrence, flips the bf16 rounding of a
# few channels, 2^-8 of one channel each
ENC_SUM_TOL = 1e-3
# the first kp octave whose phase-5 stash channels hold to ENC_SUM_TOL, not
# the elementwise rule (compare_kp_ladder): the flagship's are 0-6
DEEP_OCTAVE = 8
TRAIN_STEPS = 5
# the Hopper kernels (by a part of their mangled names: the eval kernel's
# seven modes, kernel 4's passes (a) and (b) and pass (c)'s products) and the
# instructions their SASS must hold
SM90_KERNELS = {"eval_sm90_kernelILi0ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi1ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi2ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi3ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi4ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi5ELi0EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi6ELi0EE": ("HGMMA", "UTMALDG"),
                # the A/B harness's variants (VAR: bf16enc 1, pipe2 17, mxenc 2)
                "eval_sm90_kernelILi4ELi1EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi4ELi17EE": ("HGMMA", "UTMALDG"),
                "eval_sm90_kernelILi4ELi2EE": ("HGMMA", "UTMALDG", "HMMA"),
                "eval_sm90_kernelILi5ELi2EE": ("HGMMA", "UTMALDG", "HMMA"),
                "field_bwd_sm90_kernel": ("HGMMA", "UTMALDG", "UTMASTG"),
                "wgrad_sm90_kernel": ("HGMMA", "UTMALDG"),
                "input_sm90_kernel": ("HGMMA", "UTMALDG", "UTMASTG")}
# the backward's workspace plan against the library's: (points, view-bias
# groups, points per pose group; 0: no input gradients)
WS_PLANS = ((1, 1, 0), (300, 3, 100), (3072, 4, 768), (196608, 256, 768), (245760, 256, 0),
            (1680, 3, 560))
# the eval kernels' persistent walk against eval_tile_walk: (points, slots);
# 2,097,152 and 4,194,304 points: one dual launch of run_gan's (32768 rays x
# 64 samples) and of run_render's (65536 x 64) default chunk
EVAL_WALKS = ((1, 132), (127, 132), (128, 132), (129, 132), (16016, 132), (131056, 132),
              (524288, 132), (2097152, 132), (4194304, 132), (300, 2))
PASS_A_KERNELS = ("field_bwd_sm90_kernel",)
PASS_B_KERNELS = ("wgrad_sm90_kernel", "wgrad_reduce_kernel")
# pass (a)'s workspace against field_bwd_workspace_plain: the forward's
# regions by the elementwise rule; the cotangents by it on every point whose
# ReLU masks (trunk and view layer) agree with the plain version's, and to
# GRAD_TOL relative L2 over all (a mask on a knife edge, |z| within the
# wgmma-vs-matmul rounding of 0, flips a whole cotangent entry)
WS_FORWARD = ("hs", "feat", "hv", "ghead")
WS_COTANGENTS = ("gz", "gfeat", "gzv")
MAX_MASK_FLIP_FRAC = 0.01  # points allowed a mask that differs from the plain version's
# phase 7 holds d_pts, d_dirs and d_poses to GRAD_TOL against field_bwd_plain
# + encode_bwd_plain up to this many kp octaves. Past it the octave ladder
# multiplies d_pts's dependence on the encodings' cotangents by up to
# 2^(multires - 1), so the points whose pass (a) ReLU masks sit on a knife
# edge (at most MAX_MASK_FLIP_FRAC, as phase 5 allows) carry most of its
# difference from the plain version: at multires 15 / 4 on an H100, 2.8e-3
# to 9.7e-3 relative L2 over seven draws of posegen_tpu_torch/tools/
# exp_pass_c.py --conditioning and 1.053e-2 on this script's case, against
# 7.4e-4 to 1.4e-3 with those points excused. There the inputs' gradients
# are held to GRAD_TOL only with those points' encoding cotangents taken
# from the launch's workspace, which the elementwise rule holds to the
# plain products.
E2E_OCTAVES = 9
# phase 10: the GAN feedback renderer's call (posegen_tpu/gen/loop.py:64-143)
FRAME_HW, FRAME_FOCAL, FRAME_CHUNK, FRAMES = 512, 1000.0, 8192, 20
FRAME_WINDOW = (100, 412)
FRAME_CALLS = 10  # timed calls of each arm (the repacking's A/B), after one warm-up
COMPARE_FRAMES = 2  # the pipelined call's frames held to the plain pipeline
# bullet cameras at this distance from the root fill the window: every
# frame renders its 312 x 312 rays (at 12.0, 300 rows of them)
BULLET_DIST = 10.0
METRIC_TOL = 1e-5  # psnr / ssim / ms_ssim, card vs CPU
MESH_RES, MESH_RADIUS = 64, 2.5  # the probe grid covers the body (radius 2.2)
# phase 11: the GAN + SPIN feedback loop (posegen_tpu/gen/loop.py) at full
# width: RaycastConfig(), the ResNet-50 HMR at 224, GenConfig()
GAN_BATCH = 1024  # run_gan's default --batch_size (posegen_tpu/cli/run_gan.py:48)
GAN_RPI = 20  # renders per feedback iteration (GanLoopConfig.rpi)
GAN_FEEDBACK_ITERS = 4  # checked feedback iterations
GAN_TIMED = 10  # timed iterations of each arm, with and without feedback
SPIN_FT_BATCH = 32  # train_spin's default batch (posegen_tpu/gen/spin_driver.py)
SPIN_FT_CHECK = 4  # crops of the fine-tune step held card vs CPU
SPIN_TOL = 1e-4  # SPIN's joints, card (cuDNN TF32 off) vs CPU: relative L2
GAN_LOSS_TOL = 1e-4  # G / D losses, card vs CPU: relative
GAN_MOMENT_TOL = 1e-3  # G / D Adam moments, card vs CPU: relative L2
SPIN_FT_TOL = 1e-2  # the fine-tune step's loss and gradients, card vs CPU: relative L2
# phase 12: train a NeRF through the CLI (posegen_tpu_torch/cli/run_nerf.py)
# from synthetic H5 files at the catalog's paths
CLI_IMAGES, CLI_HW, CLI_FOCAL = 128, 512, 640.0  # SURREAL-shaped: 128 images of 512^2
CLI_ITERS = 200
CLI_TIMED = (50, 200)  # steps 51-200, timed by the host clock
CLI_PROFILED = (20, 40)  # steps 21-40, under the profiler
BATCH_TIMED = 50  # make_batch calls timed on each sampler path
UPLOADS_TIMED = 20
# the opt_pose run: h36m's S9 file, cut to 256^2 (h36m's crops are 1000^2)
POSE_CLI_IMAGES, POSE_CLI_HW, POSE_CLI_FOCAL, POSE_CLI_ITERS = 256, 256, 320.0, 30
STEP_LAUNCHES = {"field_stash": 2, "field_bwd": 2}  # a train step's, besides zeros
# phase 13: render and mine from phase 12's surreal run, through the CLIs at
# their own chunks (run_render 65536 rays, run_gan 32768)
MINE_BULLET_N, MINE_MESH_RES = 4, 64
MINE_POSES = 20  # render_testset: 2 annotation files of 10 poses, numpy seed 0
MINE_GAN_BATCH, MINE_GAN_CHUNK, MINE_RPI, MINE_PROBE_N = 1024, 32768, 20, 8
MINE_SPIN_BATCH = 32  # train_spin's default batch
MINE_SPIN_EPOCHS = 3  # 80 sink rows: 2 steps an epoch, 5 timed after the first
MINE_GAN_HW, MINE_TESTSET_HW = 512, 512  # run_gan's and render_testset's default frames
PNG_TIMED = 10  # write_png / read_png calls timed per 512^2 frame
# the plain reference of a 65536-ray chunk, in slices of this many rays
# with the chunk's near / far (the float32 pipeline's encodings of a whole
# chunk overflow the card's 80 GB; 8192 is JAX's own clamp for it)
PLAIN_SUB = 8192
# phase 14: SPIN's evaluation on the four benchmark schemas and the SKI
# fine-tune, at full width (posegen_tpu_torch/evals/harness.py,
# gen/spin_driver.train_ski), on the committed JPEG fixtures
FULL_FRAME = "frame_1080x1920_420.jpg"  # tests/data/jpeg's full-size frame
JPEG_TIMED = 10  # decodes of the full-size frame timed
SMPL_BATCH = 32
EVAL_FRAMES, EVAL_BATCH = 128, 32  # 3DPW-schema crops of the full-size frame
SKI_IMAGES, SKI_HW = 64, 256  # SKI-Pose's frames are 256^2 PNGs
HP3D_FRAMES, AGORA_PEOPLE = 32, 8
SKI_EPOCHS, SKI_BATCH = 2, 32  # train_ski on the 64 SKI samples: 2 steps an epoch
SMPL_TOL = 1e-5  # SMPL vertices, card vs CPU: relative L2
EVAL_TOL = 1e-4  # the evaluator's metrics, card (cuDNN TF32 off) vs CPU: relative
SKI_LOSS_TOL = 1e-2  # train_ski's first step loss, card vs CPU: relative
# phase 15: the data front (posegen_tpu_torch/data/ingest.py, masks.py,
# segmenter.py, bench_loader.py) on raw trees at the datasets' own sizes
ING_SEQS, ING_POSES, ING_CAMS, ING_HW, ING_FOCAL = 2, 16, 4, 512, 640.0  # SURREAL: 128 images
ING_ITERS = 30  # run_nerf steps on the ingested SURREAL file
ING_POSE_TOL = 1e-5  # the pose block, card vs CPU: relative L2
ING_SMASK_FRAC = 1e-4  # sampling-mask pixels allowed to differ, card vs CPU (see phase 15a)
H36M_CAMS, H36M_FRAMES, H36M_HW = 4, 8, 1000  # 32 crops of the 1080p fixture, one camera 1002 rows
SEG_HW = 513  # the DeepLab logits' card-vs-CPU frame
SEG_TOL = 1e-4  # DeepLab logits, card (TF32 off) vs CPU: relative L2
ZJU_VIEWS, ZJU_FRAMES, ZJU_HW = 4, 4, 1024
UNDISTORT_TIMED = 3
LOADER_WORKERS = (0, 16)  # bench_loader's --num_workers (the loader caps them at cores - 1)
# phase 16: tooling and the SMPL family (posegen_tpu_torch/utils/gif.py,
# render/rasterizer.py, cli/render_mesh.py, body/models.py, body/transfer.py,
# utils/profiling.py)
SPIRAL_FRAMES = 10  # save_spiral_video's default
BODY_BATCH = 128
BODY_TIMED = 10
BODY_TOL = 1e-5  # SMPL-X / MANO / FLAME vertices, joints, full_pose, card vs CPU: relative L2
FIT_MESHES = 8
FIT_SHORT = dict(part_steps=2, transl_steps=2, vertex_steps=5)
# run_fitting on FIT_SHORT, card vs CPU: the fitted vertices (relative L2) and
# both losses (relative); the params are printed beside the CPU's own
# response to a one-ulp move of the targets (PERF.md section 6)
FIT_TOL = 1e-4
# the npz keys JAX's transfer.main writes, in its order
# (tests/test_torch_body_models.py::test_transfer_cli_matches_jax)
TRANSFER_KEYS = ["betas", "body_pose", "global_orient", "transl", "mesh_paths"]
# phase 17: kernel 2's grouped poses and per-ray view ladder. Grouped
# layouts as (tag, pose groups, rays per group, samples): surreal.txt's
# train batch at both passes' samples, h36m_prot2.txt's at 64 (its 80-sample
# pass has 960 points a group, which the JAX kernel and fused_run_net
# refuse)
GROUP_SHAPES = (("surreal 64", 128, 16, 64), ("surreal 80", 128, 16, 80),
                ("h36m_prot2 64", 256, 12, 64))
SPLIT_SHAPE = (20, 4096, 80)  # one grouped launch against 20 single-pose launches
RENDER_GROUPS = (128, 16)  # the grouped render's batch: groups x rays per group
LADDER_RAYS, LADDER_SAMPLES = 8192, (80, 64, 16)
GROUP_TIMED = 10  # CUDA-event launches timed per kernel
# figures that a later phase reads: phase 6's bare train step
TIMES = {}
DEVICE = "cuda"
# weight seed: with seed 1 the random nets give the 8192-ray render partial
# opacity (mean fine acc ~0.3, coarse ~1), so the render comparison is not
# vacuous (some seeds give zero density everywhere)
SEED = 1


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def module_version(name: str) -> str:
    """A module's version, or why it does not import."""
    import importlib

    try:
        return "imports, version " + str(getattr(importlib.import_module(name), "__version__", "?"))
    except ImportError as e:
        return f"does not import ({e})"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_kernels(torch, fn, n: int):
    """torch.profiler over n calls of fn -> (wall ms per call, every device
    kernel as (name, ms per call, launches per call), most time first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: -e.self_device_time_total)
    return wall, [(e.key, e.self_device_time_total / 1e3 / n, e.count / n) for e in kern]


def profile_calls(torch, fn, n: int):
    """torch.profiler over n calls of fn -> (wall ms per call, device kernel
    ms per call, every kernel as (name, ms per call, launches per call), most
    time first)."""
    wall, kern = profile_kernels(torch, fn, n)
    return wall, sum(k[1] for k in kern), kern


def kernel_ms(kern, names) -> float:
    """Device ms per call of the profiled kernels whose names hold one of
    `names`; fails if one of them recorded no time."""
    found = {n for n in names for k in kern if n in k[0]}
    check(found == set(names), f"profiler: no device time of {sorted(set(names) - found)}")
    return sum(k[1] for k in kern if any(n in k[0] for n in names))


def bwd_flops(L) -> int:
    """FLOP per point of the weights-only backward, as the JAX kernel's cost
    estimate counts it (posegen_tpu/kernels/field_grad.py:673-676): three
    products (recompute, input cotangents, weight gradients) of the trunk,
    feature and view layers."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    macs = (sum(L.layer_in(i) * WIDTH for i in range(L.depth)) + WIDTH * WIDTH
            + (WIDTH + L.vc) * VIEW_WIDTH)
    return 3 * 2 * macs


def ws_bytes(L) -> int:
    """Bytes per point that kernel 4's pass (a) writes: the bf16 workspace
    (hs, gz: depth x 256; feat, gfeat: 256; hv, gzv: 128; ghead: 16), gzv in
    f32 for the view bias sums, and its bias column sums per 64 points."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    bf16_cols = 2 * L.depth * WIDTH + 2 * WIDTH + 2 * VIEW_WIDTH + 16
    return 2 * bf16_cols + 4 * VIEW_WIDTH + 4 * (L.depth * WIDTH + WIDTH + 4) // 64


def wgrad_in_bytes(L) -> int:
    """Bytes per point of pass (b)'s workspace operands, each read once
    (hs, gz, feat, hv, gfeat, gzv, ghead; the stashes come on top)."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    return 2 * (2 * L.depth * WIDTH + 2 * WIDTH + 2 * VIEW_WIDTH + 16)


def bound(flops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rel_l2(got, ref) -> float:
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def compare(name: str, got, ref) -> float:
    import torch

    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()), f"{name}: kernel output not finite")
    bad = err > ATOL + RTOL * ref.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements beyond {ATOL} + {RTOL}|plain| "
          f"(max|diff| {float(err.max()):.3e})")
    return float(err.max())


def compare_kp_ladder(name: str, got, ref, nf_kp: int) -> float:
    """e_pts by the elementwise rule, but for the kp octaves from
    DEEP_OCTAVE up, which hold to relative L2 <= ENC_SUM_TOL over their
    columns: the double-angle recurrence doubles a rounding difference with
    each octave (an ulp of the card's and PyTorch's f32 sin / cos, or an FMA
    contraction, is 2^14 ulp at octave 14 of multires 15), so a deep
    octave's channel near 0 can leave the elementwise rule on any two f32
    evaluations. The channels past the rule are counted and printed."""
    import torch

    deep = slice(24 * (1 + 2 * DEEP_OCTAVE), 24 * (1 + 2 * nf_kp))
    if nf_kp <= DEEP_OCTAVE:
        return compare(name, got, ref)
    keep = torch.ones(got.shape[1], dtype=torch.bool, device=got.device)
    keep[deep] = False
    e = compare(f"{name} (octaves below {DEEP_OCTAVE})", got[:, keep], ref[:, keep])
    g, r = got[:, deep], ref[:, deep]
    check(bool(torch.isfinite(g).all()), f"{name}: kernel output not finite")
    e_l2 = rel_l2(g, r)
    check(e_l2 <= ENC_SUM_TOL, f"{name} octaves {DEEP_OCTAVE}-{nf_kp - 1}: relative L2 "
                               f"{e_l2:.3e} > {ENC_SUM_TOL}")
    bad = ((g - r).abs() > ATOL + RTOL * r.abs()).nonzero()
    octaves = sorted({DEEP_OCTAVE + int(c) // 48 for c in bad[:, 1].tolist()})
    print(f"  {name}: octaves {DEEP_OCTAVE}-{nf_kp - 1} relative L2 {e_l2:.3e}, max|diff| "
          f"{float((g - r).abs().max()):.3e}, {bad.shape[0]} of {g.numel()} channels past the "
          f"elementwise rule (octaves {octaves})")
    return e


def check_build(build) -> None:
    """No kernel spills; the Hopper kernels (SM90_KERNELS) issue wgmma
    (HGMMA) and TMA (UTMALDG, and UTMASTG for pass (a) and pass (c)'s
    products) in their SASS
    (cuobjdump)."""
    import re
    import shutil

    got = build.ptxas_report()
    check(bool(got), "build: no ptxas report")
    for name, (regs, st, ld) in sorted(got.items()):
        print(f"  ptxas: {regs} registers, spills {st} / {ld} bytes: {name}")
    spill = [name for name, (_, st, ld) in got.items() if st or ld]
    check(not spill, f"ptxas: {spill} spill registers")
    wmma = [name for name in got if "field_variant_kernel" in name]
    check(not wmma, f"build: the WMMA variant kernel is still built ({wmma})")
    cob = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cob, "-sass", str(build.library_path())], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[-500:]}")
    sections = {sec.split()[0]: sec for sec in out.stdout.split("Function : ")[1:]}
    for kernel, ops in SM90_KERNELS.items():
        found = [name for name in sections if kernel in name]
        check(len(found) == 1, f"SASS: {kernel} not found once in the library")
        counts = {op: sections[found[0]].count(op) for op in ops}
        check(all(counts.values()), f"SASS: {kernel} lacks {[o for o, n in counts.items() if not n]}")
        regs = [v for k, v in got.items() if kernel in k][0]
        n_instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/", sections[found[0]]))
        print(f"  SASS {kernel}: " + ", ".join(f"{op} x{n}" for op, n in counts.items())
              + f", {n_instr} instructions ({16 * n_instr} bytes); ptxas {regs[0]} registers, "
              f"spills {regs[1]} / {regs[2]} bytes")


def check_plans(lib, F, FG) -> None:
    """The library's plans against their Python mirrors: the shared memory
    of the eval kernels (the same at every layout), the stash kernel and
    passes (a) and (c), the eval kernels' scratch slot, at several depths
    and multires; the eval kernels' persistent grid; the backward's
    workspace (WS_PLANS)."""
    for depth, mr, mv in ((8, 7, 4), (9, 7, 4), (16, 7, 4), (1, 7, 0), (8, 4, 2), (8, 7, 7),
                          (8, 15, 4)):
        L0 = F.net_layout(depth, mr, mv)
        args = F._layout_arg(L0)
        for name, got, want in (
            ("eval shared memory", lib.posegen_field_eval_smem(*args), F.eval_smem_bytes(L0)),
            ("eval slot", lib.posegen_field_eval_slot_bytes(*args), F.eval_slot_bytes(L0)),
            ("stash shared memory", lib.posegen_field_stash_smem(*args), FG.stash_smem_bytes(L0)),
            ("pass (a) shared memory", lib.posegen_field_bwd_smem(*args), FG.bwd_smem_bytes(L0)),
            ("pass (c) shared memory", lib.posegen_field_bwd_input_smem(*args),
             FG.input_smem_bytes()),
        ):
            check(got == want, f"{name} at depth {depth}, multires {mr} / {mv}: library {got}, "
                               f"Python {want}")
    for n_pts, n_slots in EVAL_WALKS:
        grid = lib.posegen_field_eval_grid(n_pts, n_slots)
        check(grid == len(F.eval_tile_walk(n_pts, n_slots)),
              f"eval grid on {n_pts} points, {n_slots} slots: library {grid}, "
              f"field.py {len(F.eval_tile_walk(n_pts, n_slots))}")
    regions = (ctypes.c_longlong * (1 + len(FG.WS_REGIONS)))()
    for mr, mv in ((7, 4), (9, 4), (15, 4)):
        L0 = F.net_layout(8, mr, mv)
        for n_pts, groups, ppg in WS_PLANS:
            n_ws = lib.posegen_field_bwd_workspace(n_pts, *F._layout_arg(L0), groups,
                                                   n_pts // groups, ppg, regions)
            n_py, p_pad, off = FG.bwd_workspace_plan(n_pts, L0, groups, ppg)
            got = (n_ws, regions[0], [r for r in regions[1:] if r >= 0])
            want = (n_py, p_pad, list(off.values()))
            check(got == want, f"workspace of {n_pts} points, {groups} groups, ppg {ppg}, "
                               f"multires {mr} / {mv}: library {got}, Python {want}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "posegen_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(posegen_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    try:
        return run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run(torch) -> int:
    from posegen_tpu_torch.kernels import build
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import (
        RaycastConfig, encode_inputs, init_raycaster, render_rays,
    )
    from posegen_tpu_torch.utils.fixtures import make_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    marks = [("start", time.perf_counter())]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print("modules (information only): " + ", ".join(
        f"{name} {module_version(name)}"
        for name in ("h5py", "imageio", "cv2", "PIL", "tensorboard")))

    # 1. build -------------------------------------------------------------
    from posegen_tpu_torch.data import native

    t0 = time.perf_counter()
    native.get_lib()
    print(f"build: the native sampler {time.perf_counter() - t0:.1f} s "
          f"({native.library_path().name})")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path().name})")
    check_build(build)
    lib = build.load()
    check_plans(lib, F, FG)
    chunk = ctypes.c_int()
    for n_pts in (1, 63, 2047, 2048, 4097, 6000, 131072, 163840, 196608, 245760):
        splits = lib.posegen_field_bwd_splits(n_pts, ctypes.byref(chunk))
        check((splits, chunk.value) == FG.wgrad_split_plan(n_pts),
              f"pass (b)'s split of {n_pts} points: library {(splits, chunk.value)}, "
              f"field_grad.py {FG.wgrad_split_plan(n_pts)}")
    print("  the plans: shared memory of the eval, stash, pass (a) and pass (c) kernels, "
          "the eval kernels' slot and grid, pass (b)'s split, the backward's workspace: "
          "library == Python")

    # 2. kernels against their plain versions, at the render's shapes -------
    cfg = RaycastConfig()
    cfg, params, ctx, rays_o, rays_d = make_problem(cfg, n_rays=N_RAYS, seed=SEED,
                                                    device=DEVICE)
    with torch.no_grad():
        near, far = samp.get_near_far_in_cylinder(
            rays_o, rays_d, ctx.cyls.expand(N_RAYS, 5), near=cfg.near, far=cfg.far)
        L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
        pose = F.pack_pose(ctx.skts[0], params["embed_kp"], cfg.multires, cfg.multires_views)
        net_c = F.prepare_net(params["coarse"], L)
        net_f = F.prepare_net(params["fine"], L)
        shapes = {}
        for tag, n_s in (("coarse", cfg.N_samples), ("importance", cfg.N_importance),
                         ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (rays_o[:, None] + rays_d[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            shapes[tag] = (pts, rays_d, n_s)
        n_s = cfg.N_importance
        imp_pts = shapes["importance"][0]
        # 128-point tiles: 1,024 (the last of 112 points) over the card's
        # SMs; 126 (the last of 16) and one tile of 48 under them
        shapes["ragged_many"] = (imp_pts[:(N_RAYS - 1) * n_s], rays_d[:N_RAYS - 1].contiguous(),
                                 n_s)
        shapes["ragged"] = (imp_pts[:N_RAGGED * n_s], rays_d[:N_RAGGED].contiguous(), n_s)
        shapes["one_tile"] = (imp_pts[:3 * n_s], rays_d[:3].contiguous(), n_s)
        bf16 = torch.bfloat16
        # (tag, points, dirs, samples per ray, pose, coarse net, fine net)
        cases = [(tag, *shapes[tag], pose, net_c, net_f)
                 for tag in ("coarse", "importance", "fine", "ragged_many", "ragged", "one_tile")]
        for tag, kw, n_rays in (("depth16", dict(netdepth=16), 2048),
                                ("multires4_views2", dict(multires=4, multires_views=2), 1000)):
            cfg_x = RaycastConfig(**kw)
            params_x = init_raycaster(cfg_x, torch.Generator().manual_seed(SEED), device=DEVICE)
            L_x = F.net_layout(cfg_x.netdepth, cfg_x.multires, cfg_x.multires_views)
            cases.append((tag, imp_pts[:n_rays * n_s], rays_d[:n_rays].contiguous(), n_s,
                          F.pack_pose(ctx.skts[0], params["embed_kp"], cfg_x.multires,
                                      cfg_x.multires_views),
                          F.prepare_net(params_x["coarse"], L_x),
                          F.prepare_net(params_x["fine"], L_x)))

        err_dual = err_field = 0.0
        for tag, pts, dirs, n_s, pose_t, nc, nf in cases:
            L_t = nf.layout
            kc, kf = F.fused_dual(pts, dirs, n_s, pose_t, nc, nf)
            pc, pf = F.dual_plain(pts, dirs, n_s, pose_t, nc, nf, mm_dtype=bf16)
            kfull = F.fused_field(pts, dirs, n_s, pose_t, nf)
            kden = F.fused_field(pts, dirs, n_s, pose_t, nf, density_only=True)
            pfull = F.field_plain(pts, dirs, n_s, pose_t, nf, mm_dtype=bf16)
            pden = F.field_plain(pts, dirs, n_s, pose_t, nf, density_only=True, mm_dtype=bf16)
            torch.cuda.synchronize()
            e_c, e_f = compare(f"dual coarse {tag}", kc, pc), compare(f"dual fine {tag}", kf, pf)
            check(float(kc[:, :3].abs().max()) == 0.0, f"dual {tag}: coarse rgb rows not zero")
            e_full = compare(f"field {tag}", kfull, pfull)
            e_den = compare(f"field density_only {tag}", kden, pden)
            check(bool(torch.equal(kden[:, 3], kfull[:, 3])),
                  f"field {tag}: density_only sigma differs from the full kernel's")
            check(float(kden[:, :3].abs().max()) == 0.0, f"density_only {tag}: rgb rows not zero")
            err_dual = max(err_dual, e_c, e_f)
            err_field = max(err_field, e_full, e_den)
            print(f"kernels vs plain, {tag} ({pts.shape[0]} points, {-(-pts.shape[0] // 128)} "
                  f"tiles, depth {L_t.depth}, multires {L_t.nf_kp} / {L_t.nf_view}): max|diff| "
                  f"dual coarse {e_c:.3e}, fine {e_f:.3e}; field full {e_full:.3e}, density_only "
                  f"{e_den:.3e} (its sigma == full's)")

    # 3. the main path, through the launch counters -------------------------
    expected = {False: {"dual": 1, "field": 1, "field_grouped": 0, "field_ray_ladder": 0,
                        "field_stash": 0, "field_bwd": 0, "field_bwd_inputs": 0, "variant": 0},
                True: {"dual": 0, "field": 2, "field_grouped": 0, "field_ray_ladder": 0,
                       "field_stash": 0, "field_bwd": 0, "field_bwd_inputs": 0, "variant": 0}}
    launches = {"dual": 0, "field": 0}
    with torch.no_grad():
        # The last sample's interval is 1e10 long, so a ray is opaque iff the
        # fine net's sigma at its far sample is > 0: a ray whose far sigma lies
        # within bf16 rounding of 0 flips between acc 0 and 1 under any bf16
        # kernel. Such a flip is excused only where that sigma changes sign
        # between the kernel and the float32 net; every other ray is held to
        # the JAX package's fused-vs-XLA bound.
        far_pts = (rays_o + rays_d * far).contiguous()
        x_pts, x_views, _ = encode_inputs(cfg, params, far_pts[:, None], rays_d, ctx)
        sig_ref = nerf_apply(cfg.nerf_cfg, params["fine"], x_pts, x_views)[:, 0, 3]
        sig_ker = F.fused_field(far_pts, rays_d, 1, pose, net_f, density_only=True)[:, 3]
        straddles = (sig_ref > 0) != (sig_ker > 0)
        for coarse_rgb in (False, True):
            F.reset_launches()
            out = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                              raw_noise_std=0.0, coarse_rgb=coarse_rgb)
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
            check(got == expected[coarse_rgb],
                  f"render coarse_rgb={coarse_rgb}: launches {got} != {expected[coarse_rgb]}")
            for k in launches:
                launches[k] += got[k]
            rgb = out["rgb_map"]
            check(tuple(rgb.shape) == (N_RAYS, 3), f"rgb_map shape {tuple(rgb.shape)}")
            check(bool(torch.isfinite(rgb).all()), "rgb_map not finite")
            ref = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                              raw_noise_std=0.0, coarse_rgb=coarse_rgb, use_fused=False)
            acc = float(out["acc_map"].mean())
            check(0.0 < acc and float(rgb.abs().max()) > 0.0,
                  f"render coarse_rgb={coarse_rgb}: empty image (mean acc {acc})")
            d_rgb = (rgb - ref["rgb_map"]).abs().amax(-1)
            flipped = (out["acc_map"] - ref["acc_map"]).abs() > 0.5
            n_flip = int(flipped.sum())
            err = float(d_rgb[~flipped].max())
            check(n_flip <= MAX_FLIP_FRAC * N_RAYS,
                  f"render coarse_rgb={coarse_rgb}: {n_flip} rays flipped opacity")
            check(bool(straddles[flipped].all()),
                  f"render coarse_rgb={coarse_rgb}: {int((~straddles[flipped]).sum())} "
                  "rays flipped opacity with no sign change of their far sigma")
            check(err <= RENDER_TOL,
                  f"render coarse_rgb={coarse_rgb}: rgb_map vs plain {err:.3e} > {RENDER_TOL}")
            sig_flip = float(sig_ref[flipped].abs().max()) if n_flip else 0.0
            print(f"render coarse_rgb={coarse_rgb}: launches {got}, rgb_map max|diff| vs "
                  f"plain pipeline {err:.3e} on {N_RAYS - n_flip} rays, {n_flip} rays "
                  f"flipped opacity (max|diff| over all {float(d_rgb.max()):.3e}, mean "
                  f"{float(d_rgb.mean()):.3e}); mean acc {acc:.4f}")
            print(f"  flips: far sigma changes sign on every flipped ray; its float32 "
                  f"|sigma| <= {sig_flip:.3e} there, against a median |sigma| of "
                  f"{float(sig_ref.abs().median()):.3e} over all far samples "
                  f"({int(straddles.sum())} far samples change sign)")

    # 4. timing -------------------------------------------------------------
    with torch.no_grad():
        for coarse_rgb in (False, True):
            ms = cuda_ms(lambda: render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0,
                                             raw_noise_std=0.0, coarse_rgb=coarse_rgb),
                         N_ITERS)
            print(f"timing render coarse_rgb={coarse_rgb}: {ms:.3f} ms per {N_RAYS} rays, "
                  f"{N_RAYS / ms * 1e3:.1f} rays/s [{card}]")
            if not coarse_rgb:
                render_ms = ms

        w_bytes = lambda net: net.w.numel() * 2 + net.b.numel() * 4
        rows = []
        pts_c, _, s_c = shapes["coarse"]
        P = pts_c.shape[0]
        flops = (F.field_flops(L, True) + F.field_flops(L, False)) * P
        nbytes = 12 * P + 12 * N_RAYS + pose.numel() * 4 + w_bytes(net_c) + w_bytes(net_f) + 32 * P
        k_ms = cuda_ms(lambda: F.fused_dual(pts_c, rays_d, s_c, pose, net_c, net_f), 10)
        p_ms = cuda_ms(lambda: F.dual_plain(pts_c, rays_d, s_c, pose, net_c, net_f,
                                            mm_dtype=bf16), 3, warmup=1)
        rows.append(("dual", "coarse", P, k_ms, p_ms, *bound(flops, nbytes)))
        for tag in ("importance", "coarse", "fine"):
            pts, _, n_s = shapes[tag]
            P = pts.shape[0]
            for density_only in (False, True):
                flops = F.field_flops(L, density_only) * P
                nbytes = 12 * P + 12 * N_RAYS + pose.numel() * 4 + w_bytes(net_f) + 16 * P
                k_ms = cuda_ms(lambda: F.fused_field(pts, rays_d, n_s, pose, net_f,
                                                     density_only), 10)
                p_ms = cuda_ms(lambda: F.field_plain(pts, rays_d, n_s, pose, net_f,
                                                     density_only, mm_dtype=bf16), 3, warmup=1)
                name = "field_density_only" if density_only else "field"
                rows.append((name, tag, P, k_ms, p_ms, *bound(flops, nbytes)))
        for name, tag, P, k_ms, p_ms, b_ms, b_by in rows:
            print(f"timing kernel {name} {tag} ({P} points): {k_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms [{card}]")

    marks.append(("1-4", time.perf_counter()))
    train_rows, train_err, train_launches, train_library, train_floors = train_phases(torch, card)
    marks.append(("5-6", time.perf_counter()))
    pose_row, pose_err, pose_launches = pose_phases(torch, card)
    marks.append(("7-8", time.perf_counter()))
    variant_row, variant_err, variant_launches = variant_phases(torch, card)
    marks.append(("9", time.perf_counter()))
    image_launches, variables = image_phases(torch, card, render_ms)
    marks.append(("10", time.perf_counter()))
    for k, n in image_launches.items():
        launches[k] += n
    for k, n in gan_phases(torch, card, variables).items():
        launches[k] += n
    marks.append(("11", time.perf_counter()))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        cli_launches, cli_runs = cli_phases(torch, card, tmp)
        marks.append(("12", time.perf_counter()))
        for k, n in mine_phases(torch, card, cli_runs).items():
            launches[k] += n
        marks.append(("13", time.perf_counter()))
        eval_phases(torch, card, tmp)
        marks.append(("14", time.perf_counter()))
        ingest_launches = ingest_phases(torch, card, tmp)
        marks.append(("15", time.perf_counter()))
        for k, n in tooling_phases(torch, card, cli_runs).items():
            launches[k] += n
        marks.append(("16", time.perf_counter()))
        grouped_rows = grouped_phases(torch, card)
        marks.append(("17", time.perf_counter()))
        par_launches = parallel_phases(torch, card)
        marks.append(("18", time.perf_counter()))
        single_launches, single_err = single_net_phases(torch, card)
        marks.append(("19", time.perf_counter()))
        proof_launches = proof_phases(torch, card, tmp)
        marks.append(("20", time.perf_counter()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in launches:
        launches[k] += cli_launches[k] + ingest_launches[k] + par_launches[k]
    launches["field"] += single_launches["field"]
    for k in ("dual", "field"):
        launches[k] += proof_launches[k]
    err_field = max(err_field, single_err)
    for k in ("field_stash", "field_bwd"):
        train_launches[k] += (cli_launches[k] + ingest_launches[k] + par_launches[k]
                              + single_launches[k] + proof_launches[k])
    pose_launches += cli_launches["field_bwd_inputs"] + proof_launches["field_bwd_inputs"]

    by_name = {(r[0], r[1]): r for r in rows}
    kernels = []
    for name, key, src, replaces, err in (
        ("dual", ("dual", "coarse"), "posegen_tpu_torch/kernels/csrc/field.cu",
         "posegen_tpu/kernels/field.py:735", err_dual),
        ("field", ("field", "importance"), "posegen_tpu_torch/kernels/csrc/field.cu",
         "posegen_tpu/kernels/field.py:473", err_field),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = by_name[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    # kernel 4's weights-only branch is two passes, both launched by each
    # field_backward call (its launch count); their bounds add up to the
    # backward's, and design_floor_ms is the two-pass design's workspace
    # traffic at the memory rate
    for name, counter, src, replaces in (
        ("field_stash", "field_stash", "field.cu", "posegen_tpu/kernels/field_grad.py:252"),
        ("field_bwd_pass_a", "field_bwd", "field_grad.cu", "posegen_tpu/kernels/field_grad.py:340"),
        ("field_bwd_pass_b", "field_bwd", "field_grad.cu", "posegen_tpu/kernels/field_grad.py:340"),
    ):
        _, _, _, k_ms, p_ms, b_ms, b_by = train_rows[(name, "coarse")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"posegen_tpu_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": train_launches[counter], "max_abs_err": train_err[name], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": train_library.get((name, "coarse")),
        })
        if (name, "coarse") in train_floors:
            kernels[-1]["design_floor_ms"] = train_floors[(name, "coarse")]
    # pass (c): its four kernels' device time, the two new kernels' own
    # beside it, and the two-kernel design's floor
    _, _, _, k_ms, p_ms, b_ms, b_by, floor_ms, each = pose_row
    kernels.append({
        "name": "field_bwd_inputs", "route": "cuda",
        "source": "posegen_tpu_torch/kernels/csrc/field_grad.cu",
        "replaces": "posegen_tpu/kernels/field_grad.py:506",
        "launches": pose_launches, "max_abs_err": pose_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "design_floor_ms": floor_ms,
        "input_sm90_ms": each["input_sm90_kernel"], "input_chain_ms": each["input_chain_kernel"],
    })
    k_ms, p_ms, b_ms, b_by, enc_ms, gates_ms = variant_row
    kernels.append({
        "name": "variant_field", "route": "cuda",
        "source": "posegen_tpu_torch/kernels/csrc/field_variants.cu",
        "replaces": "tools/exp_kernel_variants.py:269",
        "launches": variant_launches, "max_abs_err": variant_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "enc_probe_ms": enc_ms, "gates_probe_ms": gates_ms,
    })
    kernels += grouped_rows
    print("timing phases (host clock, s): " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in enumerate(marks[1:])))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_batch(torch, n_groups: int, rpg: int, seed: int):
    """A flagship-style batch: n_groups pose rows, rpg rays per group
    (contiguous), random targets and backgrounds."""
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx, make_rays

    ctx = make_pose_ctx(seed, n_poses=n_groups, device=DEVICE)
    rays_o, rays_d = make_rays(n_groups * rpg, seed + 1, device=DEVICE)
    gen = torch.Generator().manual_seed(seed)
    n = n_groups * rpg
    return {
        "rays_o": rays_o, "rays_d": rays_d,
        "target_s": torch.rand((n, 3), generator=gen).to(DEVICE),
        "bgs": torch.rand((n, 3), generator=gen).to(DEVICE),
        "kp3d": ctx.kps, "skts": ctx.skts, "bones": ctx.bones, "cyls": ctx.cyls,
    }


def grad_tensors(F, d_w, d_b, d_bview, L):
    """(name, tensor) of every gradient: trunk and head weights and biases,
    the view bias per group."""
    layers, (wa, ba), (wf, bf), (wv, _), (wr, br) = F._unpack(F.FieldNet(d_w, d_b, L))
    out = []
    for i, (w, b) in enumerate(layers):
        out += [(f"layer{i}.w", w), (f"layer{i}.b", b)]
    return out + [("alpha.w", wa), ("alpha.b", ba), ("feature.w", wf), ("feature.b", bf),
                  ("view.w", wv), ("view.b", d_bview), ("rgb.w", wr), ("rgb.b", br)]


def train_phases(torch, card: str):
    """Phases 5 (training kernels vs plain) and 6 (the train step) ->
    (timing rows by (kernel, shape), max|diff| by kernel, launches by kernel
    in one flagship train step)."""
    import dataclasses

    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves,
    )

    bf16 = torch.bfloat16
    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0)
    L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    batch = train_batch(torch, N_GROUPS, RAYS_PER_GROUP, SEED)
    rpg = RAYS_PER_GROUP

    # 5. training kernels against their plain versions ---------------------
    err = {"field_stash": 0.0, "field_bwd": 0.0, "field_bwd_pass_a": 0.0, "field_bwd_pass_b": 0.0}
    cases, workspaces = {}, {}
    with torch.no_grad():
        ro, rd = batch["rays_o"], batch["rays_d"]
        near, far = samp.get_near_far_in_cylinder(
            ro, rd, batch["cyls"].repeat_interleave(rpg, 0), near=cfg.near, far=cfg.far)
        poses = F.pack_poses(batch["skts"], variables["embed_kp"], cfg.multires,
                             cfg.multires_views)
        net = F.pack_net_f32(variables["fine"], L)
        bview = F.group_view_bias(variables["fine"], L)
        gen = torch.Generator().manual_seed(SEED)
        for tag, n_s in (("coarse", cfg.N_samples), ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            g = torch.randn((pts.shape[0], 4), generator=gen).to(DEVICE)
            cases[tag] = (pts, rd, n_s, poses, bview, g)
        pts, _, n_s, _, _, _ = cases["fine"]
        n_r = RAGGED_GROUPS * RAGGED_RPG
        bview_r = bview + 0.1 * torch.randn((RAGGED_GROUPS, F.VIEW_WIDTH), generator=gen).to(DEVICE)
        g_r = torch.randn((n_r * n_s, 4), generator=gen).to(DEVICE)
        cases["ragged"] = (pts[:n_r * n_s].contiguous(), rd[:n_r].contiguous(), n_s,
                           poses[:RAGGED_GROUPS].contiguous(), bview_r.contiguous(), g_r)

        stashes = {}
        for tag, (pts, dirs, n_s, poses_t, bview_t, g) in cases.items():
            raw, e_pts, e_view = FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t)
            p_raw, p_ep, p_ev = FG.field_stash_plain(pts, dirs, n_s, poses_t, net, bview_t,
                                                     mm_dtype=bf16)
            torch.cuda.synchronize()
            e = max(compare(f"field_stash raw {tag}", raw, p_raw),
                    compare(f"field_stash e_pts {tag}", e_pts.float(), p_ep.float()),
                    compare(f"field_stash e_view {tag}", e_view.float(), p_ev.float()))
            err["field_stash"] = max(err["field_stash"], e)
            stashes[tag] = (e_pts, e_view)
            ws = FG.bwd_workspace(pts.shape[0], L, bview_t.shape[0], 0, DEVICE)
            d = [FG.field_backward(g, e_pts, e_view, net, bview_t, workspace=ws)
                 for _ in range(2)]
            p = FG.field_bwd_plain(e_pts, e_view, g, net, bview_t, mm_dtype=bf16)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*d)),
                  f"field_bwd {tag}: two launches differ")
            worst = (0.0, "")
            for (name, k), (_, r) in zip(grad_tensors(F, *d[0], L), grad_tensors(F, *p, L)):
                check(bool(torch.isfinite(k).all()), f"field_bwd {tag} {name}: not finite")
                e_l2 = rel_l2(k, r)
                check(e_l2 <= GRAD_TOL, f"field_bwd {tag} {name}: relative L2 {e_l2:.3e} "
                                        f"> {GRAD_TOL}")
                worst = max(worst, (e_l2, name))
                err["field_bwd"] = max(err["field_bwd"], float((k - r).abs().max()))
            print(f"kernel field_stash vs plain, {pts.shape[0]} points, {poses_t.shape[0]} "
                  f"groups: max|diff| {e:.3e}; field_bwd vs plain: worst relative L2 "
                  f"{worst[0]:.3e} ({worst[1]}), two launches bit-identical")
            e_a, e_b = backward_pass_checks(torch, FG, L, tag, g, e_pts, e_view, net, bview_t,
                                            ws, d[1][0])
            workspaces[tag] = ws
            err["field_bwd_pass_a"] = max(err["field_bwd_pass_a"], e_a)
            err["field_bwd_pass_b"] = max(err["field_bwd_pass_b"], e_b)

        for tag, (pts, dirs, n_s, poses_t, bview_t, net_t) in stash_cases(
                torch, F, cases, net, batch["skts"], gen).items():
            raw, e_pts, e_view = FG.fused_field_stash(pts, dirs, n_s, poses_t, net_t, bview_t)
            p_raw, p_ep, p_ev = FG.field_stash_plain(pts, dirs, n_s, poses_t, net_t, bview_t,
                                                     mm_dtype=bf16)
            torch.cuda.synchronize()
            Lt = net_t.layout
            e = max(compare(f"field_stash raw {tag}", raw, p_raw),
                    compare_kp_ladder(f"field_stash e_pts {tag}", e_pts.float(), p_ep.float(),
                                      Lt.nf_kp),
                    compare(f"field_stash e_view {tag}", e_view.float(), p_ev.float()))
            err["field_stash"] = max(err["field_stash"], e)
            print(f"kernel field_stash vs plain, {tag} ({pts.shape[0]} points, "
                  f"{poses_t.shape[0]} groups of {pts.shape[0] // poses_t.shape[0]}, "
                  f"{bview_t.shape[0]} view-bias rows, multires {Lt.nf_kp} / {Lt.nf_view}): "
                  f"max|diff| {e:.3e}")

        # one group: the stash mode and the field kernel's full mode run one
        # body on one function
        pts, dirs, n_s, poses_t, bview_t, _ = cases["coarse"]
        n1 = rpg * n_s
        raw1, _, _ = FG.fused_field_stash(pts[:n1], dirs[:rpg], n_s, poses_t[:1], net, bview_t)
        ref1 = F.fused_field(pts[:n1], dirs[:rpg], n_s, poses_t[0],
                             F.FieldNet(net.w.to(bf16), net.b, L))
        torch.cuda.synchronize()
        check(bool(torch.equal(raw1, ref1)), "field_stash raw vs fused_field on one group: not "
              f"bit-identical (max|diff| {float((raw1 - ref1).abs().max()):.3e})")
        print("kernel field_stash raw vs fused_field raw on one group: bit-identical")

    # 6. the train step -----------------------------------------------------
    tcfg = TrainConfig(rays_per_image=rpg, use_background=True)
    tcfg_plain = dataclasses.replace(tcfg, fused_train=False)
    state_k = create_train_state(variables, tcfg)
    state_p = create_train_state(variables, tcfg_plain)
    F.reset_launches()
    state_k, stats_k = make_train_step(cfg, tcfg)(state_k, batch)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    want = {"field": 0, "field_grouped": 0, "field_ray_ladder": 0, "dual": 0, "field_stash": 2,
            "field_bwd": 2, "field_bwd_inputs": 0, "variant": 0}
    check(launches == want, f"train step: launches {launches} != {want}")
    state_p, stats_p = make_train_step(cfg, tcfg_plain)(state_p, batch)
    torch.cuda.synchronize()
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "grad_norm"):
        check(bool(torch.isfinite(stats_k[k])), f"train step: {k} not finite")
    gk = [p.grad for p in param_leaves(state_k.params)]
    gp = [p.grad for p in param_leaves(state_p.params)]
    all_l2 = rel_l2(torch.cat([a.reshape(-1) for a in gk]), torch.cat([b.reshape(-1) for b in gp]))
    per = sorted(rel_l2(a, b) for a, b in zip(gk, gp))
    check(all_l2 <= STEP_GRAD_TOL, f"train step gradients vs plain f32 pipeline: relative L2 "
                                   f"{all_l2:.3e} > {STEP_GRAD_TOL}")
    print(f"train step: launches {launches}; total_loss {float(stats_k['total_loss']):.6f} "
          f"(plain f32 {float(stats_p['total_loss']):.6f}), grad_norm "
          f"{float(stats_k['grad_norm']):.6e} (plain {float(stats_p['grad_norm']):.6e}); "
          f"gradients vs plain: relative L2 {all_l2:.3e} over all, per tensor median "
          f"{per[len(per) // 2]:.3e}, max {per[-1]:.3e}")

    leaves = state_k.params["fine"]
    try:
        F.fused_field(cases["coarse"][0], cases["coarse"][1], cases["coarse"][2], poses[0],
                      F.prepare_net(leaves, L))
    except RuntimeError as e:
        check("trainable" in str(e), f"fused_field under grad: unexpected error {e}")
    else:
        raise SmokeFailure("fused_field accepted weights that require grad")
    print("fused_field refuses weights that require grad under autograd")

    cfg_t = RaycastConfig(raw_noise_std=1.0)
    state_t = create_train_state(variables, tcfg)
    step_t = make_train_step(cfg_t, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    losses = []
    for _ in range(TRAIN_STEPS):
        state_t, st = step_t(state_t, batch, gen)
        losses.append(float(st["total_loss"]))
    check(all(map(math.isfinite, losses)), f"training: losses {losses}")
    print(f"training, perturb {cfg_t.perturb}, raw_noise_std {cfg_t.raw_noise_std}: "
          f"total_loss per step {losses}")

    n_rays = N_GROUPS * rpg
    ms = cuda_ms(lambda: step_t(state_t, batch, gen), TRAIN_ITERS)
    print(f"timing train step: {ms:.3f} ms per {n_rays} rays, {n_rays / ms * 1e3:.1f} trained "
          f"rays/s [{card}]")
    TIMES["train_step_ms"] = ms
    wall, busy, top = profile_calls(torch, lambda: step_t(state_t, batch, gen), 3)
    if busy > 0.0:
        print(f"profile train step (torch.profiler, 3 steps): {wall:.3f} ms per step, device "
              f"kernels {busy:.3f} ms, idle share {1.0 - busy / wall:.1%}; kernel 4's pass (a) "
              f"{kernel_ms(top, PASS_A_KERNELS):.3f} ms, pass (b) {kernel_ms(top, PASS_B_KERNELS):.3f} "
              f"ms per step [{card}]")
        for name, k_ms, n in top[:8]:
            print(f"  {k_ms:8.3f} ms  x{n:g}  {name[:90]}")
    else:
        print("profile train step: torch.profiler recorded no device time")

    rows, library, floors = {}, {}, {}
    w_bytes = 2 * L.n_w + 4 * L.n_b
    with torch.no_grad():
        for tag in ("coarse", "fine"):
            pts, dirs, n_s, poses_t, bview_t, g = cases[tag]
            P = pts.shape[0]
            e_pts, e_view = stashes[tag]
            io = 12 * P + 12 * dirs.shape[0] + poses_t.numel() * 4 + w_bytes + bview_t.numel() * 4
            stash_b = (L.pc + L.vc) * 2 * P
            for name, flops, nbytes, kern, plain in (
                ("field_stash", F.field_flops(L, False) * P, io + 16 * P + stash_b,
                 lambda: FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t),
                 lambda: FG.field_stash_plain(pts, dirs, n_s, poses_t, net, bview_t,
                                              mm_dtype=bf16)),
                ("field_bwd", bwd_flops(L) * P,
                 16 * P + stash_b + w_bytes + bview_t.numel() * 4 + 4 * (L.n_w + L.n_b),
                 lambda: FG.field_backward(g, e_pts, e_view, net, bview_t),
                 lambda: FG.field_bwd_plain(e_pts, e_view, g, net, bview_t, mm_dtype=bf16)),
            ):
                k_ms = cuda_ms(kern, 10)
                p_ms = cuda_ms(plain, 3, warmup=1)
                rows[(name, tag)] = (name, tag, P, k_ms, p_ms, *bound(flops, nbytes))
            ws = workspaces[tag]  # pass (a)'s regions from the profiled launches below
            _, kern = profile_kernels(torch, lambda: FG.field_backward(g, e_pts, e_view, net,
                                                                       bview_t, workspace=ws), 5)
            a_ms, b_ms = kernel_ms(kern, PASS_A_KERNELS), kernel_ms(kern, PASS_B_KERNELS)
            pa_ms = cuda_ms(lambda: FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview_t,
                                                                 mm_dtype=bf16), 3, warmup=1)
            pb_ms = cuda_ms(lambda: FG.field_wgrad_plain(ws.regions, e_pts, e_view, L), 3,
                            warmup=1)
            lib_ms, lib_note = library_wgrad_ms(torch, FG, ws, e_pts, e_view, L)
            # Each pass's bound is its share of the backward's (the function's):
            # pass (a) two of its three products and the function's inputs read
            # and bias gradients written, pass (b) the weight-gradient product
            # and d_w written. The workspace between the passes is this
            # design's, not the function's: its bytes at the memory rate are
            # the design's floor, printed and kept beside the bound.
            a_flops, b_flops = bwd_flops(L) * P * 2 // 3, bwd_flops(L) * P // 3
            a_bytes = 16 * P + stash_b + w_bytes + bview_t.numel() * 4 + 4 * L.n_b
            ws_b = ws_bytes(L) * P  # pass (a)'s workspace, written once
            b_in = (wgrad_in_bytes(L) + stash_b // P) * P  # pass (b)'s operands, read once
            rows[("field_bwd_pass_a", tag)] = (
                "field_bwd_pass_a", tag, P, a_ms, pa_ms, *bound(a_flops, a_bytes))
            rows[("field_bwd_pass_b", tag)] = (
                "field_bwd_pass_b", tag, P, b_ms, pb_ms, *bound(b_flops, 4 * L.n_w))
            library[("field_bwd_pass_b", tag)] = lib_ms
            floors[("field_bwd_pass_a", tag)] = ws_b / PEAK_BYTES * 1e3
            floors[("field_bwd_pass_b", tag)] = b_in / PEAK_BYTES * 1e3
            print(f"timing kernel 4 pass (a) {tag} ({P} points): {a_ms:.3f} ms (profiler), "
                  f"operation bound {a_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms; the design's floor, "
                  f"its workspace written at {PEAK_BYTES / 1e12:.2f} TB/s, "
                  f"{floors[('field_bwd_pass_a', tag)]:.3f} ms; plain {pa_ms:.3f} ms [{card}]")
            print(f"timing kernel 4 pass (b) {tag} ({P} points): {b_ms:.3f} ms (profiler), "
                  f"operation bound {b_flops / PEAK_BF16_FLOPS * 1e3:.3f} ms; the design's floor, "
                  f"its workspace and stash read, {floors[('field_bwd_pass_b', tag)]:.3f} ms; "
                  f"plain {pb_ms:.3f} ms; library (one torch.mm per product, {lib_note}) "
                  f"{lib_ms:.3f} ms [{card}]")
    for name, tag, P, k_ms, p_ms, b_ms, b_by in rows.values():
        print(f"timing kernel {name} {tag} ({P} points, 2 launches per step): {k_ms:.3f} ms, "
              f"bound {b_ms:.3f} ms ({b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms "
              f"[{card}]")
    return rows, err, launches, library, floors


def stash_cases(torch, F, cases, net, skts, gen):
    """Phase 5's further stash cases -> {tag: (pts, dirs, samples per ray,
    poses, view bias, net)}: the train batch's first 4 groups x 16 rays x 64
    samples on random nets at multires 7 / 7 and 15 / 4, and groups smaller
    than a tile on `net`, the flagship's (12 groups of one ray x 80 samples, and
    40 of one ray x 8), each with its own view-bias row."""
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster

    out = {}
    pts, dirs, n_s, poses, bview, _ = cases["coarse"]
    G = 4
    n_r = G * RAYS_PER_GROUP
    for mr, mv in ((7, 7), (15, 4)):
        cfg = RaycastConfig(multires=mr, multires_views=mv)
        v = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
        L = F.net_layout(cfg.netdepth, mr, mv)
        bv = F.group_view_bias(v["fine"], L)
        bv = bv + 0.1 * torch.randn((G, F.VIEW_WIDTH), generator=gen).to(DEVICE)
        out[f"multires{mr}_views{mv}"] = (
            pts[:n_r * n_s].contiguous(), dirs[:n_r].contiguous(), n_s,
            F.pack_poses(skts[:G], v["embed_kp"], mr, mv), bv.contiguous(),
            F.pack_net_f32(v["fine"], L))
    pts_f, dirs_f, n_f, poses_f, bview_f, _ = cases["fine"]
    for tag, G, spr in (("groups_of_80", 12, n_f), ("groups_of_8", 40, 8)):
        bv = bview_f[:1] + 0.1 * torch.randn((G, F.VIEW_WIDTH), generator=gen).to(DEVICE)
        out[tag] = (pts_f.view(-1, n_f, 3)[:G, :spr].reshape(-1, 3).contiguous(),
                    dirs_f[:G].contiguous(), spr, poses_f[:G].contiguous(), bv.contiguous(), net)
    return out


def backward_pass_checks(torch, FG, L, tag, g, e_pts, e_view, net, bview, ws, d_w):
    """Phase 5's hold on each pass of kernel 4 on its own, from one
    field_backward launch: pass (a)'s regions that it left in its workspace
    `ws` against field_bwd_workspace_plain (see WS_FORWARD, WS_COTANGENTS),
    and its d_w (pass (b)) against field_wgrad_plain's products of those
    regions -> (max|diff| of (a), of (b))."""
    plain = FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview, mm_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    names = WS_FORWARD + WS_COTANGENTS
    k = {n: ws.regions[n].float() for n in names}
    p = {n: plain[n].float() for n in names}
    err_a = max(compare(f"pass (a) {n} {tag}", k[n], p[n]) for n in WS_FORWARD)
    flip = ((k["hs"] > 0) != (p["hs"] > 0)).any(-1).any(0) | ((k["hv"] > 0) != (p["hv"] > 0)).any(-1)
    n_flip, n_pts = int(flip.sum()), flip.numel()
    check(n_flip <= MAX_MASK_FLIP_FRAC * n_pts, f"pass (a) {tag}: {n_flip} of {n_pts} points' "
                                                "ReLU masks differ from the plain version's")
    msg = []
    for n in WS_COTANGENTS:
        e_l2 = rel_l2(k[n], p[n])
        check(e_l2 <= GRAD_TOL, f"pass (a) {n} {tag}: relative L2 {e_l2:.3e} > {GRAD_TOL}")
        ok = ~flip if k[n].dim() == 2 else (~flip)[None].expand(k[n].shape[0], -1)
        err_a = max(err_a, compare(f"pass (a) {n} {tag}, points whose masks agree", k[n][ok],
                                   p[n][ok]))
        msg.append(f"{n} {e_l2:.3e}")
    ref = FG.field_wgrad_plain(ws.regions, e_pts, e_view, L)
    torch.cuda.synchronize()
    err_b = compare(f"pass (b) d_w {tag}", d_w, ref)
    print(f"  pass (a) {tag}: workspace vs field_bwd_workspace_plain max|diff| {err_a:.3e} "
          f"({', '.join(WS_FORWARD)} elementwise; {', '.join(WS_COTANGENTS)} elementwise on the "
          f"{n_pts - n_flip} of {n_pts} points whose ReLU masks agree, relative L2 "
          f"{', '.join(msg)}); pass (b) d_w vs field_wgrad_plain on the kernel's workspace "
          f"max|diff| {err_b:.3e}, relative L2 {rel_l2(d_w, ref):.3e}")
    return err_a, err_b


def library_wgrad_ms(torch, FG, ws, e_pts, e_view, L):
    """Pass (b)'s yardstick, timed and used nowhere in the port: one torch.mm
    (cuBLAS) per product G^T H of the same workspace tensors -> (ms, its
    output type)."""
    prods = FG.wgrad_products(ws.regions, e_pts, e_view, L)
    kw, note = {"out_dtype": torch.float32}, "f32 out"
    try:
        torch.mm(prods[0][1].T, prods[0][2], **kw)
    except (TypeError, RuntimeError):
        kw, note = {}, "bf16 out: this torch.mm takes no out_dtype"
    return cuda_ms(lambda: [torch.mm(gg.T, x, **kw) for _, gg, x, _, _ in prods], 10), note


def input_bwd_flops(L) -> int:
    """FLOP per point of the input-gradient branch's products: g_e_pts from
    layer 0's and the skip consumer's e_pts columns, g_e_view from the view
    layer's e_view columns (not its zero pad columns)."""
    from posegen_tpu_torch.kernels.field import VIEW_WIDTH, WIDTH

    n_pc = 2 if L.skip >= 0 else 1
    return 2 * (n_pc * WIDTH * L.pc + VIEW_WIDTH * L.vc)


def pose_batch(torch, n_groups: int, rpg: int, n_frames: int, seed: int):
    """An h36m_prot2-style pose-refinement problem: rot6d pose params and
    anchors over n_frames synthetic frames (axis-angle estimates, SMPL rest
    pose joints), and a batch of n_groups images x rpg rays, each group at a
    random frame with its framecode, cylinders around the frames' joints,
    random targets and backgrounds."""
    import numpy as np

    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params, pose_apply
    from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
    from posegen_tpu_torch.utils.fixtures import make_rays

    rng = np.random.default_rng(seed)
    bones = (rng.standard_normal((n_frames, 24, 3)) * 0.2).astype(np.float32)
    kp3d = np.tile(SMPL_REST_POSE[None], (n_frames, 1, 1))
    pcfg = PoseOptConfig(use_rot6d=True, opt_pose_tol=0.01, opt_pose_type="BE")
    params, anchors = init_pose_params(pcfg, bones, kp3d, device=DEVICE)
    rest = torch.as_tensor(SMPL_REST_POSE, device=DEVICE)
    kp_idx = torch.as_tensor(rng.integers(0, n_frames, n_groups), device=DEVICE)
    with torch.no_grad():
        kps = pose_apply(params, kp_idx, rest)[0]
    n = n_groups * rpg
    rays_o, rays_d = make_rays(n, seed + 1, device=DEVICE)
    gen = torch.Generator().manual_seed(seed)
    batch = {
        "rays_o": rays_o, "rays_d": rays_d,
        "target_s": torch.rand((n, 3), generator=gen).to(DEVICE),
        "bgs": torch.rand((n, 3), generator=gen).to(DEVICE),
        "cyls": get_kp_bounding_cylinder(kps, ext_scale=0.001), "kp_idx": kp_idx,
        "kp3d": kps + 0.01 * torch.randn(kps.shape, generator=gen).to(DEVICE),
        "cam_idxs": kp_idx.repeat_interleave(rpg)[:, None],
    }
    return pcfg, params, anchors, rest, batch


def input_branch_checks(torch, F, FG, tag, pts, dirs, n_s, poses, bview, g, net, e_pts,
                        e_view) -> float:
    """Phase 7 on one problem: two field_backward launches with inputs (one
    workspace) bit-identical, their weight gradients those of a
    weights-only launch; the encodings' cotangents that the launch left in
    its workspace against the plain products of the same workspace's
    cotangents (elementwise); d_pts / d_dirs / d_poses to relative L2 <=
    GRAD_TOL against field_bwd_plain + encode_bwd_plain (up to E2E_OCTAVES
    kp octaves) and against the same with the launch's encoding cotangents
    on the points whose pass (a) ReLU masks differ from the plain version's
    (at most MAX_MASK_FLIP_FRAC of them) -> max|diff| of the input
    gradients against field_bwd_plain + encode_bwd_plain."""
    bf16 = torch.bfloat16
    L = net.layout
    P, G = pts.shape[0], poses.shape[0]
    ins = FG.FieldInputs(pts, dirs, n_s, poses)
    ws = FG.bwd_workspace(P, L, bview.shape[0], P // G, DEVICE)
    d = [FG.field_backward(g, e_pts, e_view, net, bview, ins, workspace=ws) for _ in range(2)]
    w_only = FG.field_backward(g, e_pts, e_view, net, bview)
    *_, g_ep, g_ev = FG.field_bwd_plain(e_pts, e_view, g, net, bview, mm_dtype=bf16,
                                        input_grads=True)
    plain = FG.encode_bwd_plain(pts, dirs, n_s, poses, g_ep, g_ev, L.nf_kp, L.nf_view)
    layers, _, _, (wv, _), _ = F._unpack(net)
    tn = lambda gg, w: gg.float() @ w.to(bf16).float()  # noqa: E731 (gz is bf16 already)
    gz = ws.regions["gz"]
    ref_ep = tn(gz[0], layers[0][0])
    if L.skip >= 0:
        ref_ep = ref_ep + tn(gz[L.skip + 1], layers[L.skip + 1][0][:, :L.pc])
    ref_ev = tn(ws.regions["gzv"], wv[:, F.WIDTH:F.WIDTH + L.vc])
    ws_p = FG.field_bwd_workspace_plain(e_pts, e_view, g, net, bview, mm_dtype=bf16)
    flip = (((ws.regions["hs"] > 0) != (ws_p["hs"] > 0)).any(-1).any(0)
            | ((ws.regions["hv"] > 0) != (ws_p["hv"] > 0)).any(-1))[:, None]
    excused = FG.encode_bwd_plain(pts, dirs, n_s, poses, torch.where(flip, ref_ep, g_ep),
                                  torch.where(flip, ref_ev, g_ev), L.nf_kp, L.nf_view)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(*d)), f"field_bwd_inputs {tag}: two launches differ")
    check(all(torch.equal(a, b) for a, b in zip(d[0][:3], w_only)),
          f"field_bwd_inputs {tag}: weight gradients differ from a weights-only launch")
    e_reg = max(compare(f"pass (c) g_e_pts {tag}", ws.regions["g_e_pts"], ref_ep),
                compare(f"pass (c) g_e_view {tag}", ws.regions["g_e_view"], ref_ev))
    n_flip = int(flip.sum())
    check(n_flip <= MAX_MASK_FLIP_FRAC * P, f"field_bwd_inputs {tag}: {n_flip} of {P} points' "
                                            "pass (a) ReLU masks differ from the plain version's")
    strict = L.nf_kp <= E2E_OCTAVES
    msg, err = [], 0.0
    for name, k, r, x in zip(("d_pts", "d_dirs", "d_poses"), d[0][3:], plain, excused):
        check(bool(torch.isfinite(k).all()), f"field_bwd_inputs {tag} {name}: not finite")
        e_l2, e_x = rel_l2(k, r), rel_l2(k, x)
        check(e_l2 <= GRAD_TOL or not strict, f"field_bwd_inputs {tag} {name}: relative L2 "
                                               f"{e_l2:.3e} > {GRAD_TOL}")
        check(e_x <= GRAD_TOL, f"field_bwd_inputs {tag} {name}: relative L2 {e_x:.3e} > "
                               f"{GRAD_TOL} with the {n_flip} knife-edge points excused")
        err = max(err, float((k - r).abs().max()))
        msg.append(f"{name} {e_l2:.3e} ({e_x:.3e})")
    check(float(d[0][5][:, F.POSE_FLOATS - 25:].abs().max()) == 0.0,
          f"field_bwd_inputs {tag}: cut / tau / octave slots of d_poses not zero")
    print(f"kernel field_bwd_inputs vs plain, {tag} ({P} points, {G} groups, multires "
          f"{L.nf_kp} / {L.nf_view}): relative L2 {', '.join(msg)} (in brackets: with the "
          f"{n_flip} points whose pass (a) masks differ from the plain version's excused"
          f"{'' if strict else '; held to GRAD_TOL only so, past E2E_OCTAVES'}); weight "
          f"gradients == weights-only launch, two launches bit-identical; g_e_pts, g_e_view vs "
          f"the plain products of the launch's workspace max|diff| {e_reg:.3e}")
    return err


def pose_phases(torch, card: str):
    """Phases 7 (the input-gradient branch vs plain) and 8 (the
    pose-refinement train step) -> (timing row of the input branch at the
    coarse shape, its max|diff| against plain, its launches in one step)."""
    import dataclasses

    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.pose.opt import pose_apply
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves, trainable,
    )

    bf16 = torch.bfloat16
    # configs/h36m/h36m_prot2.txt: the SURREAL architecture with framecodes
    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0, opt_framecode=True,
                        n_framecodes=POSE_FRAMES)
    L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    pcfg, pose0, anchors, rest, batch = pose_batch(torch, POSE_GROUPS, POSE_RPG, POSE_FRAMES,
                                                   SEED)
    rpg = POSE_RPG

    # 7. the input-gradient branch against its plain version ---------------
    err, cases = 0.0, {}
    with torch.no_grad():
        ro, rd = batch["rays_o"], batch["rays_d"]
        skts = pose_apply(pose0, batch["kp_idx"], rest)[2]
        near, far = samp.get_near_far_in_cylinder(
            ro, rd, batch["cyls"].repeat_interleave(rpg, 0), near=cfg.near, far=cfg.far)
        poses = F.pack_poses(skts, variables["embed_kp"], cfg.multires, cfg.multires_views)
        net = F.pack_net_f32(variables["fine"], L)
        codes = variables["fine"]["framecodes"][batch["kp_idx"]]
        bview = F.group_view_bias(variables["fine"], L, codes).contiguous()
        gen = torch.Generator().manual_seed(SEED)
        for tag, n_s in (("coarse", cfg.N_samples), ("fine", cfg.N_samples + cfg.N_importance)):
            z = samp.sample_from_lineseg(near, far, n_s)
            pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3).contiguous()
            g = torch.randn((pts.shape[0], 4), generator=gen).to(DEVICE)
            cases[tag] = (pts, rd, n_s, poses, bview, g)
        pts, _, n_s, _, _, _ = cases["fine"]
        n_r = RAGGED_GROUPS * RAGGED_RPG
        g_r = torch.randn((n_r * n_s, 4), generator=gen).to(DEVICE)
        rows = torch.arange(RAGGED_GROUPS, device=DEVICE) * rpg
        cases["ragged"] = (torch.cat([pts[r * n_s:(r + RAGGED_RPG) * n_s] for r in rows.tolist()]),
                           torch.cat([rd[r:r + RAGGED_RPG] for r in rows.tolist()]), n_s,
                           poses[:RAGGED_GROUPS].contiguous(),
                           bview[:RAGGED_GROUPS].contiguous(), g_r)
        stashes = {}
        for tag, (pts, dirs, n_s, poses_t, bview_t, g) in cases.items():
            _, e_pts, e_view = FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t)
            stashes[tag] = (e_pts, e_view)
            err = max(err, input_branch_checks(torch, F, FG, tag, pts, dirs, n_s, poses_t,
                                               bview_t, g, net, e_pts, e_view))
        # the layouts pass (c)'s WMMA plan refused, at a small shape: 4 groups
        # x 12 rays x 64 samples on random nets, a view-bias row per group
        pts, dirs, n_s, _, _, _ = cases["coarse"]
        G = 4
        for mr, mv in ((9, 4), (7, 7), (15, 4)):
            cfg_x = RaycastConfig(multires=mr, multires_views=mv)
            v = init_raycaster(cfg_x, torch.Generator().manual_seed(SEED), device=DEVICE)
            L_x = F.net_layout(cfg_x.netdepth, mr, mv)
            bv = F.group_view_bias(v["fine"], L_x)
            bv = (bv + 0.1 * torch.randn((G, F.VIEW_WIDTH), generator=gen).to(DEVICE)).contiguous()
            pts_x, dirs_x = pts[:G * rpg * n_s].contiguous(), dirs[:G * rpg].contiguous()
            poses_x = F.pack_poses(skts[:G], v["embed_kp"], mr, mv)
            net_x = F.pack_net_f32(v["fine"], L_x)
            g_x = torch.randn((pts_x.shape[0], 4), generator=gen).to(DEVICE)
            _, e_pts, e_view = FG.fused_field_stash(pts_x, dirs_x, n_s, poses_x, net_x, bv)
            err = max(err, input_branch_checks(torch, F, FG, f"multires{mr}_views{mv}", pts_x,
                                               dirs_x, n_s, poses_x, bv, g_x, net_x, e_pts,
                                               e_view))

    # 8. the pose-refinement train step ------------------------------------
    tcfg = TrainConfig(loss_fn="L1", use_background=True, lrate_decay=500000, decay_unit=1,
                       opt_pose=True, opt_pose_step=50, opt_pose_lrate=5e-4,
                       opt_pose_decay_rate=1.0, opt_pose_lrate_decay=2,
                       opt_pose_decay_unit=1000, opt_pose_coef=2.0, rays_per_image=rpg)
    tcfg_plain = dataclasses.replace(tcfg, fused_train=False)

    def fresh(t):
        return create_train_state(variables, t, trainable(pose0), anchors)

    def step_of(c, t):
        return make_train_step(c, t, pcfg, rest_pose=rest)

    state_k, state_p = fresh(tcfg), fresh(tcfg_plain)
    F.reset_launches()
    state_k, stats_k = step_of(cfg, tcfg)(state_k, batch)
    torch.cuda.synchronize()
    launches = dict(F.LAUNCHES)
    want = {"field": 0, "field_grouped": 0, "field_ray_ladder": 0, "dual": 0, "field_stash": 2,
            "field_bwd": 2, "field_bwd_inputs": 2, "variant": 0}
    check(launches == want, f"pose step: launches {launches} != {want}")
    state_p, stats_p = step_of(cfg, tcfg_plain)(state_p, batch)
    torch.cuda.synchronize()
    for k in ("total_loss", "rgb_loss", "rgb0_loss", "kp_loss", "mpjpc", "grad_norm",
              "pose_grad_norm"):
        check(bool(torch.isfinite(stats_k[k])), f"pose step: {k} not finite")
    check(float(stats_k["pose_grad_norm"]) > 0.0, "pose step: the pose got no gradient")
    out = []
    for what, gk, gp in (
        ("NeRF", [p.grad for p in param_leaves(state_k.params)],
         [p.grad for p in param_leaves(state_p.params)]),
        ("pose", [p.grad for p in state_k.pose_params.values()],
         [p.grad for p in state_p.pose_params.values()]),
    ):
        e_l2 = rel_l2(torch.cat([a.reshape(-1) for a in gk]),
                      torch.cat([b.reshape(-1) for b in gp]))
        check(e_l2 <= STEP_GRAD_TOL, f"pose step {what} gradients vs plain f32 pipeline: "
                                     f"relative L2 {e_l2:.3e} > {STEP_GRAD_TOL}")
        out.append(f"{what} {e_l2:.3e}")
    print(f"pose step: launches {launches}; total_loss {float(stats_k['total_loss']):.6f} (plain "
          f"f32 {float(stats_p['total_loss']):.6f}), pose_grad_norm "
          f"{float(stats_k['pose_grad_norm']):.6e} (plain {float(stats_p['pose_grad_norm']):.6e}); "
          f"gradients vs plain: relative L2 {', '.join(out)}")

    cfg_t = dataclasses.replace(cfg, perturb=1.0, raw_noise_std=1.0)
    state_t = fresh(tcfg)
    step_t = step_of(cfg_t, tcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    before = {k: v.detach().clone() for k, v in state_t.pose_params.items()}
    losses = []
    for _ in range(TRAIN_STEPS):
        state_t, st = step_t(state_t, batch, gen)
        losses.append(float(st["total_loss"]))
    check(all(map(math.isfinite, losses)), f"pose training: losses {losses}")
    check(all(torch.equal(before[k], v) for k, v in state_t.pose_params.items()),
          "pose training: the pose moved inside an accumulation")
    check(state_t.pose_opt_state.mini_step == TRAIN_STEPS,
          f"pose training: {state_t.pose_opt_state.mini_step} gradients accumulated")
    tcfg1 = dataclasses.replace(tcfg, opt_pose_step=1)
    state_1, _ = step_of(cfg_t, tcfg1)(fresh(tcfg1), batch, gen)
    moved = sum(not torch.equal(pose0[k].detach(), v) for k, v in state_1.pose_params.items())
    check(moved == len(pose0), "pose step at opt_pose_step 1: the pose did not move")
    print(f"pose training, perturb {cfg_t.perturb}, raw_noise_std {cfg_t.raw_noise_std}, "
          f"opt_pose_step 50: total_loss per step {losses}, pose unmoved, "
          f"{state_t.pose_opt_state.mini_step} gradients accumulated; opt_pose_step 1 moves it")

    n_rays = POSE_GROUPS * rpg
    ms = cuda_ms(lambda: step_t(state_t, batch, gen), TRAIN_ITERS)
    print(f"timing pose step: {ms:.3f} ms per {n_rays} rays, {n_rays / ms * 1e3:.1f} trained "
          f"rays/s [{card}]")
    wall, busy, top = profile_calls(torch, lambda: step_t(state_t, batch, gen), 3)
    if busy > 0.0:
        print(f"profile pose step (torch.profiler, 3 steps): {wall:.3f} ms per step, device "
              f"kernels {busy:.3f} ms, idle share {1.0 - busy / wall:.1%}; kernel 4's pass (a) "
              f"{kernel_ms(top, PASS_A_KERNELS):.3f} ms, pass (b) {kernel_ms(top, PASS_B_KERNELS):.3f} "
              f"ms per step [{card}]")
        for name, k_ms, n in top[:8]:
            print(f"  {k_ms:8.3f} ms  x{n:g}  {name[:90]}")
    else:
        print("profile pose step: torch.profiler recorded no device time")

    # the input branch's time: the device time of pass (c)'s kernels in a
    # backward with the branch, by the profiler; the plain version's, its
    # three products and encode_bwd_plain on seeded stand-ins for the
    # workspace's cotangents (dense work: its time does not depend on them)
    layers, _, _, (wv, _), _ = F._unpack(net)
    w_ep = [layers[0][0]] + ([layers[L.skip + 1][0][:, :L.pc]] if L.skip >= 0 else [])
    w_ev = wv[:, F.WIDTH:F.WIDTH + L.vc]

    def tn(gg, w):  # field_bwd_plain's input-cotangent product, bf16 operands
        return gg.to(bf16).float() @ w.to(bf16).float()

    rows, gen_gz = {}, torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for tag in ("coarse", "fine"):
            pts, dirs, n_s, poses_t, bview_t, g = cases[tag]
            e_pts, e_view = stashes[tag]
            P, G = pts.shape[0], poses_t.shape[0]
            ins = FG.FieldInputs(pts, dirs, n_s, poses_t)
            _, kern = profile_kernels(
                torch, lambda: FG.field_backward(g, e_pts, e_view, net, bview_t, ins), 5)
            branch = [k for k in kern if any(n in k[0] for n in PASS_C_KERNELS)]
            k_ms = sum(k[1] for k in branch)
            found = {n for n in PASS_C_KERNELS for k in branch if n in k[0]}
            check(k_ms > 0.0 and found == set(PASS_C_KERNELS),
                  f"field_bwd_inputs {tag}: the profiler read no device time of "
                  f"{sorted(set(PASS_C_KERNELS) - found) or PASS_C_KERNELS}")
            gz = [torch.randn((P, F.WIDTH), generator=gen_gz).to(DEVICE, bf16) for _ in w_ep]
            gzv = torch.randn((P, F.VIEW_WIDTH), generator=gen_gz).to(DEVICE, bf16)

            def plain_in():
                g_ep = sum(tn(a, w) for a, w in zip(gz, w_ep))
                return FG.encode_bwd_plain(pts, dirs, n_s, poses_t, g_ep, tn(gzv, w_ev),
                                           L.nf_kp, L.nf_view)

            p_ms = cuda_ms(plain_in, 3, warmup=1)
            # read: three bf16 cotangent rows per point, pts, dirs, pose rows and
            # the weights' input columns; written: d_pts, d_dirs, d_poses
            nbytes = (2 * (2 * F.WIDTH + F.VIEW_WIDTH) * P + 2 * (12 * P + 12 * dirs.shape[0]
                      + 4 * poses_t.numel()) + 2 * (2 * F.WIDTH * L.pc + F.VIEW_WIDTH * L.vc))
            b_ms, b_by = bound(input_bwd_flops(L) * P, nbytes)
            # the two-kernel design's floor: its f32 g_e_pts and g_e_view
            # written once and read once at the memory rate
            floor_ms = 2 * 4 * (L.pc + L.vc) * P / PEAK_BYTES * 1e3
            each = {n: kernel_ms(branch, (n,)) for n in PASS_C_KERNELS}
            rows[tag] = ("field_bwd_inputs", tag, P, k_ms, p_ms, b_ms, b_by, floor_ms, each)
            # the stash kernel at the pose step's shapes (framecodes: a view
            # bias row per group), beside its bound as phase 6 counts it
            s_ms = cuda_ms(lambda: FG.fused_field_stash(pts, dirs, n_s, poses_t, net, bview_t), 10)
            s_bytes = (12 * P + 12 * dirs.shape[0] + 4 * poses_t.numel() + 2 * L.n_w + 4 * L.n_b
                       + 4 * bview_t.numel() + 16 * P + 2 * (L.pc + L.vc) * P)
            s_b, s_by = bound(F.field_flops(L, False) * P, s_bytes)
            print(f"timing kernel field_stash pose {tag} ({P} points, {G} groups, 2 launches per "
                  f"step): {s_ms:.3f} ms, bound {s_b:.3f} ms ({s_by}, {s_b / s_ms:.1%} of it) "
                  f"[{card}]")
            parts = ", ".join(f"{n} {ms:.3f} ({ms / k_ms:.1%})" for n, ms in each.items())
            print(f"timing kernel field_bwd_inputs {tag} ({P} points, {G} groups, 2 launches per "
                  f"step): {k_ms:.3f} ms ({parts}; the whole backward {sum(k[1] for k in kern):.3f}"
                  f" ms of device time), bound {b_ms:.3f} ms ({b_by}, {b_ms / k_ms:.1%} of it); "
                  f"the design's floor, its f32 cotangents written and read at "
                  f"{PEAK_BYTES / 1e12:.2f} TB/s, {floor_ms:.3f} ms; plain {p_ms:.3f} ms [{card}]")
    return rows["coarse"], err, launches["field_bwd_inputs"]



def variant_phases(torch, card: str):
    """Phase 9 (the field kernel's variants vs plain and vs the main path's
    kernel, then the A/B harness's sweep) -> ((ms, plain ms, bound ms, bound
    by, the enc and gates probes' ms) of base at VARIANT_TILE on the
    harness's problem, max|diff| against plain over every case, the sweep's
    launches)."""
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import variants as V
    from posegen_tpu_torch.tools import exp_kernel_variants as H

    bf16 = torch.bfloat16
    prob = H.make_inputs(N_RAYS, DEVICE)
    ragged = H.make_inputs(RAGGED_GROUPS * RAGGED_RPG, DEVICE, n_groups=RAGGED_GROUPS)
    L = prob.net.layout
    cases = H.CASES + H.PROBES
    refused = {name: V.variant_refusal(L, VARIANT_TILE, encode_only=kw.get("encode_only", False),
                                       bf16enc=kw.get("bf16enc", False),
                                       halves=kw.get("halves", 1), mxenc=kw.get("mxenc", False),
                                       density_only=kw.get("density_only", False))
               for name, kw in cases}
    err = 0.0
    outs = {}
    with torch.no_grad():
        for name, kw in cases:
            if refused[name] is not None:
                print(f"kernel variant_field {name}: refused ({refused[name]})")
                continue
            msg = []
            for tag, pr in (("flagship", prob), ("ragged", ragged)):
                p = V.variant_plain(*pr, mm_dtype=bf16, **kw)
                k = outs[(name, tag)] = V.variant_field(*pr, tile=VARIANT_TILE, **kw)
                torch.cuda.synchronize()
                what = f"variant {name} {tag} tile {VARIANT_TILE}"
                if kw.get("encode_only") is True:  # sums that may cancel: relative L2
                    check(bool(torch.isfinite(k).all()), f"{what}: kernel output not finite")
                    e_l2 = rel_l2(k, p)
                    check(e_l2 <= ENC_SUM_TOL, f"{what}: relative L2 {e_l2:.3e} > {ENC_SUM_TOL}")
                    e = float((k - p).abs().max())
                    msg.append(f"{tag} {e:.3e} (relative L2 {e_l2:.3e})")
                else:
                    e = compare(what, k, p)
                    msg.append(f"{tag} {e:.3e}")
                if kw.get("density_only") and not kw.get("encode_only"):
                    check(float(k[:, :3].abs().max()) == 0.0, f"{what}: rgb rows not zero")
                err = max(err, e)
            print(f"kernel variant_field {name} vs variant_plain ({prob.pts.shape[0]} / "
                  f"{ragged.pts.shape[0]} points, {ragged.poses.shape[0]} groups): max|diff| "
                  + ", ".join(msg))

        # base and dens_base are the main path's kernel: on the harness's
        # problem (one direction per ray of S points) fused_field on the one
        # pose, on the ragged problem fused_field on its pose table
        # (posegen_field_grouped), bit for bit; pipe2 is bf16enc's function
        S = prob.pts.shape[0] // N_RAYS
        ray_dirs = prob.dirs[::S].contiguous()
        bview = ragged.net.b[L.b_view:L.b_view + F.VIEW_WIDTH].reshape(1, -1).contiguous()
        field = {dens: (lambda dens=dens: F.fused_field(prob.pts, ray_dirs, S, prob.poses[0],
                                                        prob.net, density_only=dens))
                 for dens in (False, True)}
        for what, got, want in (
            ("base vs fused_field", outs[("base", "flagship")], field[False]()),
            ("dens_base vs fused_field(density_only=True)", outs[("dens_base", "flagship")],
             field[True]()),
            (f"base vs posegen_field_grouped ({RAGGED_GROUPS} groups)", outs[("base", "ragged")],
             F.fused_field(ragged.pts, ragged.dirs, 1, ragged.poses, ragged.net, bview=bview)),
            (f"dens_base vs posegen_field_grouped ({RAGGED_GROUPS} groups)",
             outs[("dens_base", "ragged")],
             F.fused_field(ragged.pts, ragged.dirs, 1, ragged.poses, ragged.net,
                           density_only=True, bview=bview)),
            ("pipe2 vs bf16enc", outs[("pipe2", "flagship")], outs[("bf16enc", "flagship")]),
            (f"pipe2 vs bf16enc ({RAGGED_GROUPS} groups)", outs[("pipe2", "ragged")],
             outs[("bf16enc", "ragged")]),
        ):
            d = float((got - want).abs().max())
            check(torch.equal(got, want), f"variant {what}: not bit-equal (max|diff| {d:.3e})")
            print(f"variant {what}: bit-equal")
        for name, dens in (("base", False), ("dens_base", True)):
            var = lambda dens=dens: V.variant_field(*prob, tile=VARIANT_TILE, density_only=dens)
            turns = [cuda_ms(f, VARIANT_CHAIN) for f in (field[dens], var, var, field[dens])]
            print(f"variant {name} vs fused_field{'(density_only=True)' if dens else ''} on the "
                  f"harness's problem, ms in turns (field, variant, variant, field): "
                  f"{', '.join(f'{t:.3f}' for t in turns)} [{card}]")

        # the harness's sweep: the main path of this phase
        print(f"harness sweep (posegen_tpu_torch.tools.exp_kernel_variants, {N_RAYS} rays x "
              f"{prob.pts.shape[0] // N_RAYS} samples, chain {VARIANT_CHAIN}) [{card}]")
        F.reset_launches()
        rows = H.sweep(prob, V.TILES, VARIANT_CHAIN, log=lambda line: print(f"  {line}"))
        torch.cuda.synchronize()
        launches = dict(F.LAUNCHES)
        want = {k: 0 for k in launches}
        want["variant"] = len(rows) * (VARIANT_CHAIN + 3)
        check(launches == want, f"harness sweep: launches {launches} != {want}")
        ran = {(r["name"], r["tile"]) for r in rows}
        check(ran == {(n, VARIANT_TILE) for n, _ in cases if refused[n] is None},
              f"harness sweep: ran {sorted(ran)}, not every case the kernel takes")
        print(f"harness sweep: {len(rows)} (case, tile) pairs ran, launches {launches}")

        ms = {r["name"]: r["ms"] for r in rows}
        base = next(r for r in rows if r["name"] == "base")
        print(f"probes' share of base at tile {VARIANT_TILE}: enc {ms['enc']:.3f} ms "
              f"({ms['enc'] / ms['base']:.1%}), gates {ms['gates']:.3f} ms "
              f"({ms['gates'] / ms['base']:.1%}) of base's {ms['base']:.3f} ms [{card}]")
        p_ms = cuda_ms(lambda: V.variant_plain(*prob, mm_dtype=bf16), 3, warmup=1)
        P = prob.pts.shape[0]
        b_ms, b_by = base["bound"]
        print(f"timing kernel variant_field base tile {VARIANT_TILE} ({P} points): "
              f"{base['ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}, {b_ms / base['ms']:.1%} of it), "
              f"plain {p_ms:.3f} ms [{card}]")
    return (base["ms"], p_ms, b_ms, b_by, ms["enc"], ms["gates"]), err, launches["variant"]


def check_pipelined_frames(torch, F, IMG, cfg, variables, frames, plain, focal, c2ws, ctxs,
                           cyls, chunk: int, window, tag: str):
    """The first len(plain) frames of a render_images_pipelined call through
    the eval kernels against the same call through the plain pipeline, by
    phase 3's flip rule: each ray in the frame's box to RENDER_TOL, or one of
    at most MAX_FLIP_FRAC whose far sigma changes sign between the
    density-only kernel and the float32 net; the background equal.
    -> (max|diff| of the rays held to RENDER_TOL, rays past it)."""
    import numpy as np

    n_out, err = 0, 0.0
    H, W = frames.shape[1:3]
    for k in range(len(plain)):
        tl, br, idx = IMG.valid_box_for_pose(H, W, focal, c2ws[k], cyls[k], window=window)
        got, want = frames[k].reshape(-1, 3), plain[k].reshape(-1, 3)
        rest = np.ones(H * W, bool)
        rest[idx] = False
        check(np.array_equal(got[rest], want[rest]), f"{tag} frame {k}: background differs")
        d = np.abs(got[idx] - want[idx]).max(-1)
        cam = {key: torch.as_tensor(v).to(DEVICE)
               for key, v in IMG.make_cam(H, W, focal, c2ws[k], tl, br).items()}
        straddles = far_sigma_straddles(torch, F, cfg, variables, ctxs[k], cam, len(idx),
                                        chunk)[0].cpu().numpy()
        out = d > RENDER_TOL
        check(int(out.sum()) <= MAX_FLIP_FRAC * len(idx),
              f"{tag} frame {k}: {int(out.sum())} rays past {RENDER_TOL}")
        check(bool(straddles[out].all()),
              f"{tag} frame {k}: {int((~straddles[out]).sum())} rays past {RENDER_TOL} with "
              "no sign change of their far sigma")
        n_out += int(out.sum())
        err = max(err, float(d[~out].max()))
    return err, n_out


def far_sigma_straddles(torch, F, cfg, variables, ctx, cam, n: int, chunk: int):
    """Per ray of a render_image box: whether the fine net's sigma at the
    ray's far sample changes sign between the density-only kernel and the
    float32 net (phase 3's test of an opacity flip), and that float32 sigma.
    near / far per chunk of the render, as the render repairs the rays that
    miss the cylinder by their chunk's mean."""
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.image import rays_from_box
    from posegen_tpu_torch.render.raycast import encode_inputs

    L = F.net_layout(cfg.netdepth_fine or cfg.netdepth, cfg.multires, cfg.multires_views)
    pose = F.pack_pose(ctx.skts[0], variables["embed_kp"], cfg.multires, cfg.multires_views)
    # sigma reads no framecode: a framecode net takes code 0 in both paths
    codes = variables["fine"].get("framecodes") if cfg.opt_framecode else None
    net_f = F.prepare_net(variables["fine"], L, None if codes is None else codes[0])
    flips, sigmas = [], []
    for i in range(0, n, chunk):
        o, d = rays_from_box(cam, i, min(chunk, n - i))
        _, far = samp.get_near_far_in_cylinder(o, d, ctx.cyls.expand(o.shape[0], 5),
                                               near=cfg.near, far=cfg.far)
        far_pts = (o + d * far).contiguous()
        x_pts, x_views, _ = encode_inputs(cfg, variables, far_pts[:, None], d, ctx)
        frame_idx = (None if codes is None else
                     torch.zeros((o.shape[0], 1, 1), dtype=torch.long, device=o.device))
        sig_ref = nerf_apply(cfg.nerf_cfg, variables["fine"], x_pts, x_views, frame_idx)[:, 0, 3]
        sig_ker = F.fused_field(far_pts, d.contiguous(), 1, pose, net_f, density_only=True)[:, 3]
        flips.append((sig_ref > 0) != (sig_ker > 0))
        sigmas.append(sig_ref)
    return torch.cat(flips), torch.cat(sigmas)


def image_phases(torch, card: str, chunk_ms: float):
    """Phase 10, whole images: checkpoints, the feedback renderer's
    pipelined frames, one frame against the plain pipeline, the metrics on
    the card against the CPU, and the mesh -> (launches of the eval kernels
    on its main path (the pipelined call, the kernel frame and the mesh),
    the render variables restored through both checkpoint formats)."""
    import dataclasses
    import statistics
    import tempfile
    import warnings

    import numpy as np

    from posegen_tpu_torch.evals import image as EV
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render.mesh import extract_mesh, marching_tetrahedra
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster, render_mesh_density
    from posegen_tpu_torch.train import checkpoints as CK
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves,
    )
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx

    cfg = RaycastConfig()
    ctx = make_pose_ctx(SEED, device=DEVICE)
    main_launches = {"dual": 0, "field": 0}

    def launched(what, want):
        torch.cuda.synchronize()
        got = dict(F.LAUNCHES)
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"{what}: launches {got} != {full}")
        for k in main_launches:
            main_launches[k] += got[k]
        return got

    # 10a. checkpoints: the phase's train state after one step, its file
    # round trip, then the render variables through the reference .tar. The
    # step's small learning rate keeps the seed-1 nets' partial opacity in
    # the frames below (one Adam step at the default 5e-4 moves every weight
    # by about 5e-4 and makes each of their rays opaque)
    tcfg = TrainConfig(rays_per_image=RAYS_PER_GROUP, use_background=True, lrate=1e-6)
    state = create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(SEED),
                                              device=DEVICE), tcfg)
    state, _ = make_train_step(dataclasses.replace(cfg, perturb=0.0), tcfg)(
        state, train_batch(torch, 8, RAYS_PER_GROUP, SEED))
    with tempfile.TemporaryDirectory() as tmp:
        path = CK.save_checkpoint(tmp, state)
        check(CK.latest_checkpoint(tmp) == path, "latest_checkpoint does not name the file")
        template = create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(SEED + 1),
                                                     device=DEVICE), tcfg)
        restored = CK.load_checkpoint(path, template)
        pairs = list(zip(param_leaves(restored.params), param_leaves(state.params), strict=True))
        pairs += list(zip(param_leaves(restored.embeds), param_leaves(state.embeds), strict=True))
        for p, q in zip(param_leaves(restored.params), param_leaves(state.params)):
            a, b = restored.opt_state.state[p], state.opt_state.state[q]
            pairs += [(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq")]
        check(restored.step == state.step == 1, f"restored step {restored.step}")
        check(all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs), "load_checkpoint: a tensor differs from the saved state's")
        variables = {**restored.params, **restored.embeds}
        tar = CK.export_torch_checkpoint(os.path.join(tmp, "render.tar"), variables, cfg,
                                         global_step=restored.step)
        imported, extras = CK.import_torch_checkpoint(tar, device=DEVICE)
    # the .tar holds each embedder's buffers only where the reference module
    # owns them (no tau / cutoff_dist without a cutoff): every imported
    # tensor equals its variable, on the card
    got, want = CK._flatten(imported), CK._flatten(variables)
    check(extras["global_step"] == 1 and set(got) <= set(want)
          and all(np.array_equal(got[k], want[k]) for k in got)
          and {k for k in want if k not in got} <= {"embed_bone//tau", "embed_bone//cutoff_dist"}
          and all(t.device == ctx.kps.device for t in param_leaves(imported)),
          "export / import_torch_checkpoint: the variables do not come back bit-equal")
    variables = imported
    print(f"checkpoints: {len(pairs)} tensors of the train state (params, embeds, Adam state at "
          f"step 1) bit-equal after save / load_checkpoint, and {len(got)} render variables "
          f"after export / import_torch_checkpoint, on the card")

    with torch.no_grad():
        # 10b. the feedback renderer's call
        hw = FRAME_HW
        c2ws = IMG._bullet_c2ws(ctx.kps[0, 0].cpu().numpy(), BULLET_DIST, FRAMES)
        cyls = np.repeat(ctx.cyls[:1].cpu().numpy(), FRAMES, 0)
        ctxs = [ctx] * FRAMES
        n_rays = [len(IMG.valid_box_for_pose(hw, hw, FRAME_FOCAL, c, cyl, window=FRAME_WINDOW)[2])
                  for c, cyl in zip(c2ws, cyls)]
        side = FRAME_WINDOW[1] - FRAME_WINDOW[0]
        check(all(n == side * side for n in n_rays), f"rays per frame {n_rays}: the bullet "
              f"cameras at {BULLET_DIST} do not fill the {side} x {side} window")
        chunks = sum(-(-n // FRAME_CHUNK) for n in n_rays)
        call = lambda: IMG.render_images_pipelined(  # noqa: E731
            cfg, variables, hw, hw, FRAME_FOCAL, c2ws, ctxs, cyls, chunk=FRAME_CHUNK,
            half_readback=True, window=FRAME_WINDOW)
        F.reset_launches()
        frames = call()
        launched("render_images_pipelined", {"dual": chunks, "field": chunks})
        check(frames.shape == (FRAMES, hw, hw, 3) and frames.dtype == np.float32
              and bool(np.isfinite(frames).all()), f"frames {frames.shape} {frames.dtype}")
        lo, hi = FRAME_WINDOW
        inside = frames[:, lo:hi, lo:hi]
        outside = frames.copy()
        outside[:, lo:hi, lo:hi] = 0.0
        check(float(np.abs(outside).max()) == 0.0, "frames: pixels outside the window not black")
        check(bool((inside.reshape(FRAMES, -1).max(-1) > 0).all()), "frames: an empty frame")
        # the call's first frames against the plain pipeline on the same
        # cameras, poses and window (the kernel frames read back in f16)
        F.reset_launches()
        plain = IMG.render_images_pipelined(
            cfg, variables, hw, hw, FRAME_FOCAL, c2ws[:COMPARE_FRAMES], ctxs[:COMPARE_FRAMES],
            cyls[:COMPARE_FRAMES], chunk=FRAME_CHUNK, window=FRAME_WINDOW,
            render_fn=IMG._raygen_render_fn(cfg, use_fused=False))
        torch.cuda.synchronize()
        check(all(v == 0 for v in F.LAUNCHES.values()), f"plain frames: launches {F.LAUNCHES}")
        err_pipe, n_out = check_pipelined_frames(
            torch, F, IMG, cfg, variables, frames, plain, FRAME_FOCAL, c2ws, ctxs, cyls,
            FRAME_CHUNK, FRAME_WINDOW, "render_images_pipelined")
        print(f"render_images_pipelined vs the plain pipeline, frames 0-{COMPARE_FRAMES - 1} "
              f"({COMPARE_FRAMES * n_rays[0]} rays; kernel frames in f16, plain in f32): rgb "
              f"max|diff| {err_pipe:.3e}, {n_out} rays past {RENDER_TOL} (each with a far-sigma "
              f"sign change); background equal")

        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        n_sync = sum("synchroniz" in str(w.message) for w in caught)
        check(n_sync < chunks, f"render_images_pipelined: {n_sync} synchronizing operations in "
                               f"a call of {chunks} chunks")
        # the call as it stands against the same call with each net packed
        # once (prepare_net memoised), in alternating order: the repacking's
        # share of a frame
        packed, prepare = {}, F.prepare_net

        def prepare_once(net, layout, code=None):
            if code is not None:
                return prepare(net, layout, code)
            key = (id(net), layout)
            if key not in packed:
                packed[key] = prepare(net, layout)
            return packed[key]

        def timed(memoised):
            F.prepare_net = prepare_once if memoised else prepare
            try:
                t0 = time.perf_counter()
                call()
                return time.perf_counter() - t0
            finally:
                F.prepare_net = prepare

        secs, secs_once = [], []
        for i in range(FRAME_CALLS):
            for memoised in ((False, True) if i % 2 == 0 else (True, False)):
                (secs_once if memoised else secs).append(timed(memoised))
        per_frame = chunks / FRAMES

        def frame_stats(ts):
            ms = sorted(1e3 * t / FRAMES for t in ts)
            return statistics.median(ms), ms[0], ms[-1]

        frame_ms, lo_ms, hi_ms = frame_stats(secs)
        once_ms, once_lo, once_hi = frame_stats(secs_once)
        print(f"render_images_pipelined: {FRAMES} frames of {hw} x {hw}, focal {FRAME_FOCAL}, "
              f"window {FRAME_WINDOW}, chunk {FRAME_CHUNK}: {n_rays[0]} rays a frame, {chunks} "
              f"chunks a call, launches dual {chunks} field {chunks}; {n_sync} synchronizing "
              f"operation(s) a call")
        print(f"timing render_images_pipelined ({FRAME_CALLS} calls, median [min, max]): "
              f"{frame_ms:.3f} [{lo_ms:.3f}, {hi_ms:.3f}] ms per frame, {1e3 / frame_ms:.3f} "
              f"frames/s, {n_rays[0] / frame_ms * 1e3:.1f} rays/s [{card}]")
        glue = frame_ms - per_frame * chunk_ms
        print(f"  glue: {frame_ms:.3f} ms per frame - {per_frame:.2f} chunks x {chunk_ms:.3f} ms "
              f"(phase 4's 8192-ray render) = {glue:.3f} ms per frame [{card}]")
        wins = sum(t_once < t for t, t_once in zip(secs, secs_once))
        print(f"  with each net packed once ({FRAME_CALLS} calls, alternating with the above): "
              f"{once_ms:.3f} [{once_lo:.3f}, {once_hi:.3f}] ms per frame, faster in {wins} of "
              f"{FRAME_CALLS} pairs; the repacking {frame_ms - once_ms:.3f} ms per frame, "
              f"{(frame_ms - once_ms) / per_frame:.3f} ms per chunk (difference of the medians) "
              f"[{card}]")
        wall, dev_ms, kern = profile_calls(torch, call, 1)
        print(f"  under torch.profiler: {wall:.3f} ms a call, device kernels {dev_ms:.3f} ms "
              f"({dev_ms / FRAMES:.3f} ms per frame), idle {1.0 - dev_ms / wall:.1%}; "
              + ", ".join(f"{name[:40]} {ms:.3f} ms x{n:.0f}" for name, ms, n in kern[:8])
              + f" [{card}]")
        L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
        repack_ms = cuda_ms(lambda: [F.prepare_net(variables[n], L) for n in ("coarse", "fine")], 20)
        print(f"  weight repacking alone (prepare_net of both nets, as once per chunk): "
              f"{repack_ms:.3f} ms between CUDA events around back-to-back repacks [{card}]")

        # 10c. one frame: the kernels' route against the plain pipeline
        tl, br, valid_idx = IMG.valid_box_for_pose(hw, hw, FRAME_FOCAL, c2ws[0], cyls[0])
        n_img = len(valid_idx)
        img_chunks = -(-n_img // FRAME_CHUNK)
        kw = dict(chunk=FRAME_CHUNK)
        F.reset_launches()
        out_k = IMG.render_image(cfg, variables, hw, hw, FRAME_FOCAL, c2ws[0], ctx, **kw)
        launched("render_image", {"dual": img_chunks, "field": img_chunks})
        F.reset_launches()
        out_p = IMG.render_image(cfg, variables, hw, hw, FRAME_FOCAL, c2ws[0], ctx,
                                 render_fn=IMG._raygen_render_fn(cfg, use_fused=False), **kw)
        torch.cuda.synchronize()
        check(all(v == 0 for v in F.LAUNCHES.values()), f"plain frame: launches {F.LAUNCHES}")
        rgb_k = out_k["rgb"].reshape(-1, 3)[valid_idx]
        rgb_p = out_p["rgb"].reshape(-1, 3)[valid_idx]
        check(bool(np.isfinite(rgb_k).all()), "kernel frame not finite")
        flipped = np.abs(out_k["acc"].reshape(-1)[valid_idx]
                         - out_p["acc"].reshape(-1)[valid_idx]) > 0.5
        n_flip = int(flipped.sum())
        d_rgb = np.abs(rgb_k - rgb_p).max(-1)
        err = float(d_rgb[~flipped].max())
        cam = {k: torch.as_tensor(v).to(DEVICE)
               for k, v in IMG.make_cam(hw, hw, FRAME_FOCAL, c2ws[0], tl, br).items()}
        straddles, sig_ref = far_sigma_straddles(torch, F, cfg, variables, ctx, cam, n_img,
                                                 FRAME_CHUNK)
        straddles, sig_ref = straddles.cpu().numpy(), sig_ref.cpu().numpy()
        acc_mean = float(out_k["acc"].reshape(-1)[valid_idx].mean())
        check(acc_mean > 0.0, "kernel frame: empty")
        check(n_flip <= MAX_FLIP_FRAC * n_img, f"render_image: {n_flip} rays flipped opacity")
        check(bool(straddles[flipped].all()),
              f"render_image: {int((~straddles[flipped]).sum())} rays flipped opacity with no "
              "sign change of their far sigma")
        check(err <= RENDER_TOL, f"render_image: rgb vs plain {err:.3e} > {RENDER_TOL}")
        print(f"render_image {hw} x {hw} ({n_img} rays, {img_chunks} chunks, launches dual "
              f"{img_chunks} field {img_chunks}) vs the plain pipeline: rgb max|diff| {err:.3e} "
              f"on {n_img - n_flip} rays, {n_flip} flipped opacity (each with a far-sigma sign "
              f"change; float32 |sigma| <= {float(np.abs(sig_ref[flipped]).max()) if n_flip else 0.0:.3e} "
              f"there); mean acc {acc_mean:.4f}")
        fg = (out_p["acc"] > 0.5)[None]
        box = np.array([[tl[0], tl[1], br[0], br[1]]])
        stats = EV.evaluate_metric(out_k["rgb"][None], out_p["rgb"][None], fgs=fg, bboxes=box,
                                   device=DEVICE)
        print("  evaluate_metric(kernel frame, plain frame): "
              + ", ".join(f"{k} {float(v[0]):.4f}" for k, v in sorted(stats.items())))

        # 10d. the metrics on the card against the CPU, with TF32 allowed
        pred, target = torch.as_tensor(out_k["rgb"]), torch.as_tensor(out_p["rgb"])
        torch.backends.cudnn.allow_tf32 = True
        try:
            on_card = {"psnr": EV.psnr(pred.to(DEVICE), target.to(DEVICE)),
                       "ssim": EV.ssim(pred.to(DEVICE), target.to(DEVICE))[0],
                       "ms_ssim": EV.ms_ssim(pred.to(DEVICE), target.to(DEVICE))}
            on_card = {k: float(v) for k, v in on_card.items()}
        finally:
            torch.backends.cudnn.allow_tf32 = False
        on_cpu = {"psnr": float(EV.psnr(pred, target)), "ssim": float(EV.ssim(pred, target)[0]),
                  "ms_ssim": float(EV.ms_ssim(pred, target))}
        for k in on_cpu:
            check(abs(on_card[k] - on_cpu[k]) <= METRIC_TOL,
                  f"{k}: card {on_card[k]!r} vs CPU {on_cpu[k]!r}")
        print("metrics of the two frames, card (cuDNN TF32 allowed) vs CPU: " + ", ".join(
            f"{k} {on_card[k]:.6f} / {on_cpu[k]:.6f} (|diff| {abs(on_card[k] - on_cpu[k]):.2e})"
            for k in on_cpu))

        # 10e. the mesh through the density-only kernel
        F.reset_launches()
        t0 = time.perf_counter()
        verts, faces = extract_mesh(cfg, variables, ctx, radius=MESH_RADIUS, res=MESH_RES,
                                    threshold=0.0)
        mesh_s = time.perf_counter() - t0
        launched("extract_mesh", {"field": 1})
        grid_k = render_mesh_density(cfg, variables, ctx, radius=MESH_RADIUS, res=MESH_RES)
        grid_p = render_mesh_density(cfg, variables, ctx, radius=MESH_RADIUS, res=MESH_RES,
                                     use_fused=False)
        check(tuple(grid_k.shape) == (MESH_RES + 1,) * 3, f"grid {tuple(grid_k.shape)}")
        e_grid = compare("mesh grid sigma", grid_k, grid_p)
        verts_p, faces_p = marching_tetrahedra(grid_p.cpu().numpy(), iso=0.0)
        check(len(faces) > 0 and bool(np.isfinite(verts).all()), "extract_mesh: no surface")
        grid_ms = cuda_ms(lambda: render_mesh_density(cfg, variables, ctx, radius=MESH_RADIUS,
                                                      res=MESH_RES), 10)
        pts = (torch.stack(torch.meshgrid(*[torch.linspace(-MESH_RADIUS, MESH_RADIUS, MESH_RES + 1,
                                                           device=DEVICE)] * 3, indexing="xy"),
                           -1).reshape(-1, 3) + ctx.kps[0, 0]).contiguous()
        pose = F.pack_pose(ctx.skts[0], variables["embed_kp"], cfg.multires, cfg.multires_views)
        net_f = F.prepare_net(variables["fine"], L)
        zeros = torch.zeros_like(pts)
        kern_ms = cuda_ms(lambda: F.fused_field(pts, zeros, 1, pose, net_f, True), 10)
        print(f"extract_mesh res {MESH_RES} ({pts.shape[0]} probe points, launches field 1): "
              f"{len(verts)} vertices / {len(faces)} faces (plain route: {len(verts_p)} / "
              f"{len(faces_p)}); grid sigma vs plain max|diff| {e_grid:.3e}, relative L2 "
              f"{rel_l2(grid_k, grid_p):.3e}; {mesh_s:.3f} s a mesh, grid {grid_ms:.3f} ms, "
              f"density-only kernel {kern_ms:.3f} ms [{card}]")
    return main_launches, variables


def _tree_rel_l2(torch, got, ref) -> float:
    """Relative L2 of two trees of tensors, all leaves together (ref's
    device)."""
    from posegen_tpu_torch.train.trainer import param_leaves

    a = torch.cat([t.detach().reshape(-1).to(ref_t.device) for t, ref_t in
                   zip(param_leaves(got), param_leaves(ref), strict=True)])
    b = torch.cat([t.detach().reshape(-1) for t in param_leaves(ref)])
    return rel_l2(a, b)


def _to(torch, tree, device, grad: bool = False):
    """A copy of a tree of tensors on `device` (trainable leaves when grad)."""
    from posegen_tpu_torch.train.trainer import tree_map

    return tree_map(lambda t: t.detach().to(device).clone().requires_grad_(grad), tree)


def gan_phases(torch, card: str, variables):
    """Phase 11, the GAN + SPIN feedback loop at full width: GanTrainer on
    RaycastConfig()'s restored variables (phase 10), the ResNet-50 HMR at
    224 (seed 2) and GenConfig(), on real-pose batches of GAN_BATCH ->
    launches of the eval kernels on its main path (the checked feedback
    iterations)."""
    import dataclasses
    import statistics
    import tempfile

    import numpy as np

    from posegen_tpu_torch.gen import loop as GL
    from posegen_tpu_torch.gen.gan import FakePool
    from posegen_tpu_torch.gen.generators import GenConfig, draw_noises
    from posegen_tpu_torch.gen.hmr import dropout_masks, init_hmr
    from posegen_tpu_torch.gen.spin_train import make_spin_finetune_step
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render.raycast import RaycastConfig
    from posegen_tpu_torch.train.trainer import param_leaves

    cfg = RaycastConfig()
    renderer = GL.NeRFRenderer(cfg, variables, hw=FRAME_HW, focal=FRAME_FOCAL, chunk=FRAME_CHUNK)
    spin_p, spin_s = init_hmr(torch.Generator().manual_seed(2), device=DEVICE)
    loop_cfg = GL.GanLoopConfig(rpi=GAN_RPI, feedback_every=1, feedback_start_epoch=-1, df=2,
                                crop=FRAME_WINDOW, feedback_crop=True)
    gen_cfg = GenConfig()

    def new_trainer():
        return GL.GanTrainer(loop_cfg, renderer, spin_p, spin_s, gen_cfg=gen_cfg, device=DEVICE)

    trainer = new_trainer()
    real = (np.random.default_rng(0).standard_normal((GAN_BATCH, 24, 3)) * 0.2).astype(
        np.float32)
    # the feedback render's calls: each one's frames and expected chunks, and
    # its host-clock seconds
    renders = []
    pipelined = GL.render_images_pipelined

    def recorded(cfg_, params, H, W, focal, c2ws, ctxs, cyls, chunk, window=None, **kw):
        n = [len(IMG.valid_box_for_pose(H, W, focal, c, cyl, window=window)[2])
             for c, cyl in zip(c2ws, cyls)]
        t0 = time.perf_counter()
        frames = pipelined(cfg_, params, H, W, focal, c2ws, ctxs, cyls, chunk=chunk,
                           window=window, **kw)
        renders.append({"frames": frames, "chunks": sum(-(-k // chunk) for k in n),
                        "rays": sum(n), "s": time.perf_counter() - t0})
        return frames

    spin_preds = []
    feedback = trainer.spin_feedback

    def spin_recorded(bones, sel):
        spin_preds.append((bones[sel], feedback(bones, sel)))
        return spin_preds[-1][1]

    GL.render_images_pipelined = recorded
    trainer.spin_feedback = spin_recorded
    main_launches = {"dual": 0, "field": 0}
    # the port's default precision: PyTorch's (cuDNN may use TF32; plain
    # float32 products do not); the comparisons below turn TF32 off
    torch.backends.cudnn.allow_tf32 = True
    try:
        # 11a. feedback iterations through the launch counters
        g0 = [t.detach().clone() for t in param_leaves(trainer.g_params)]
        for i in range(GAN_FEEDBACK_ITERS):
            F.reset_launches()
            stats = trainer.train_step(real)
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
            chunks = renders[-1]["chunks"]
            want = {k: (chunks if k in ("dual", "field") else 0) for k in got}
            check(got == want, f"GAN feedback iteration {i}: launches {got} != {want}")
            for k in main_launches:
                main_launches[k] += got[k]
            pred = spin_preds[-1][1]
            check(tuple(pred.shape) == (GAN_RPI, 14, 3) and bool(torch.isfinite(pred).all()),
                  f"GAN feedback iteration {i}: spin_pred {tuple(pred.shape)}")
            check(all(math.isfinite(v) for v in stats.values())
                  and {"adv_loss", "spin_loss", "gen_loss"} <= set(stats),
                  f"GAN feedback iteration {i}: stats {stats}")
            check((i % 2 == 0) == ("dis_loss" in stats), f"iteration {i}: D step every 2")
            print(f"gan feedback iteration {i}: {GAN_RPI} frames, {renders[-1]['rays']} rays, "
                  f"{chunks} chunks, launches dual {got['dual']} field {got['field']}; "
                  + ", ".join(f"{k} {v:.5f}" for k, v in sorted(stats.items())))
        moved = max(float((a.detach() - b).abs().max())
                    for a, b in zip(param_leaves(trainer.g_params), g0))
        check(moved > 0.0, "GAN: the generator's params did not move")
        frames = renders[-1]["frames"]
        bones, spin_pred = spin_preds[-1]

        # 11b. SPIN's forward on the last iteration's frames, card vs CPU
        spin_cpu = (_to(torch, spin_p, "cpu"), _to(torch, spin_s, "cpu"))
        ref = GL.spin_forward(*spin_cpu, frames, loop_cfg.crop, loop_cfg.pose_scale)
        on_tf32 = rel_l2(GL.spin_forward(spin_p, spin_s, frames, loop_cfg.crop,
                                         loop_cfg.pose_scale).cpu(), ref)
        torch.backends.cudnn.allow_tf32 = False
        strict = rel_l2(GL.spin_forward(spin_p, spin_s, frames, loop_cfg.crop,
                                        loop_cfg.pose_scale).cpu(), ref)
        check(strict <= SPIN_TOL, f"SPIN forward card vs CPU: {strict:.3e} > {SPIN_TOL}")
        print(f"SPIN forward on the {GAN_RPI} frames, card vs CPU (float32): joints relative L2 "
              f"{strict:.3e} with cuDNN TF32 off (bound {SPIN_TOL}), {on_tf32:.3e} with the "
              f"port's default precision (TF32 allowed) [{card}]")

        # 11c. one G step (feedback active) and one D step, card vs CPU, from
        # the trainer's state, fresh optimiser states (mu = 0.1 x the clipped
        # gradient), the same noises and inputs
        noises = draw_noises(trainer.generator, GAN_BATCH, gen_cfg)
        sel = torch.as_tensor(np.random.default_rng(99).integers(0, GAN_BATCH, (GAN_RPI,)))
        real_t = torch.as_tensor(real)
        fake = torch.as_tensor(FakePool(seed=1)(trainer._last_bones))
        results = {}
        for dev in (DEVICE, "cpu"):
            gp = _to(torch, trainer.g_params, dev, grad=True)
            dp = _to(torch, trainer.d_params, dev, grad=True)
            g_opt, d_opt = trainer.g_opt.init(gp), trainer.d_opt.init(dp)
            gp, _, g_opt, _, g_stats = trainer.g_step(
                gp, _to(torch, trainer.g_state, dev), g_opt, dp, _to(torch, noises, dev),
                real_t.to(dev), spin_pred.to(dev), sel.to(dev), 1.0)
            dp, d_opt, d_stats = trainer.d_step(dp, d_opt, real_t.to(dev), fake.to(dev))
            results[dev] = ({k: float(v) for k, v in {**g_stats, **d_stats}.items()},
                            g_opt, d_opt)
        (card_stats, g_card, d_card), (cpu_stats, g_cpu, d_cpu) = results[DEVICE], results["cpu"]
        for k, v in cpu_stats.items():
            check(abs(card_stats[k] - v) <= GAN_LOSS_TOL * max(abs(v), 1e-30),
                  f"GAN step {k}: card {card_stats[k]!r} vs CPU {v!r}")
        moment_err = max(_tree_rel_l2(torch, getattr(a, m), getattr(b, m))
                         for a, b in ((g_card, g_cpu), (d_card, d_cpu)) for m in ("mu", "nu"))
        check(moment_err <= GAN_MOMENT_TOL,
              f"GAN steps' Adam moments, card vs CPU: {moment_err:.3e} > {GAN_MOMENT_TOL}")
        print("G step (feedback active) and D step, card vs CPU: " + ", ".join(
            f"{k} {card_stats[k]:.6f} / {v:.6f}" for k, v in sorted(cpu_stats.items()))
            + f"; Adam moments relative L2 <= {moment_err:.3e} (bound {GAN_MOMENT_TOL})")

        # 11d. one SPIN fine-tune step on rendered crops, card vs CPU, fixed
        # dropout masks; no hinge (random SPIN weights miss every render by
        # more than the hinge keeps, and a hinged loss of 0 compares nothing)
        ft_opt, ft_step = make_spin_finetune_step(hinge=None)
        gt = GL.fk_joints(torch.as_tensor(bones[:SPIN_FT_CHECK]), loop_cfg.pose_scale)
        imgs = GL.prepare_spin_input(frames[:SPIN_FT_CHECK], loop_cfg.crop, "cpu")
        masks = dropout_masks(torch.Generator().manual_seed(3), SPIN_FT_CHECK)
        ft = {}
        for dev in (DEVICE, "cpu"):
            p = _to(torch, spin_p, dev, grad=True)
            st = ft_opt.init(p)
            _, st, out = ft_step(p, _to(torch, spin_s, dev), st, imgs.to(dev), gt.to(dev),
                                 _to(torch, masks, dev))
            ft[dev] = (float(out["spin_loss"]), st)
        (loss_card, st_card), (loss_cpu, st_cpu) = ft[DEVICE], ft["cpu"]
        loss_err = abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1e-30)
        grad_err = _tree_rel_l2(torch, st_card.mu, st_cpu.mu)
        check(loss_err <= SPIN_FT_TOL and grad_err <= SPIN_FT_TOL,
              f"SPIN fine-tune step, card vs CPU: loss {loss_err:.3e}, gradients {grad_err:.3e} "
              f"> {SPIN_FT_TOL}")
        print(f"SPIN fine-tune step on {SPIN_FT_CHECK} rendered crops, card vs CPU (cuDNN TF32 "
              f"off): loss {loss_card:.6f} / {loss_cpu:.6f} (relative {loss_err:.3e}), gradients "
              f"relative L2 {grad_err:.3e} (bound {SPIN_FT_TOL})")
        torch.backends.cudnn.allow_tf32 = True

        # 11e. the checkpoint round trip, bit-equal on the card
        with tempfile.TemporaryDirectory() as tmp:
            path = trainer.save_checkpoint(os.path.join(tmp, "gan.npz"))
            restored = new_trainer().load_checkpoint(path)
        pairs = [(a, b) for name in ("g_params", "g_state", "d_params")
                 for a, b in zip(param_leaves(getattr(restored, name)),
                                 param_leaves(getattr(trainer, name)), strict=True)]
        for name in ("g_opt_state", "d_opt_state"):
            a, b = getattr(restored, name), getattr(trainer, name)
            check(a.count == b.count, f"checkpoint: {name} count {a.count} != {b.count}")
            pairs += list(zip(param_leaves([a.mu, a.nu]), param_leaves([b.mu, b.nu]), strict=True))
        check(all(a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                  for a, b in pairs)
              and torch.equal(restored.generator.get_state(), trainer.generator.get_state())
              and restored.fake_pool.rng.bit_generator.state
              == trainer.fake_pool.rng.bit_generator.state
              and np.array_equal(np.stack(restored.fake_pool.items),
                                 np.stack(trainer.fake_pool.items))
              and (restored.iter_num, restored.epoch) == (trainer.iter_num, trainer.epoch),
              "GanTrainer checkpoint: the state does not come back bit-equal")
        print(f"GanTrainer checkpoint: {len(pairs)} tensors (G / D params, BN state, both Adam "
              f"states), the fake pool ({len(trainer.fake_pool.items)} poses) and every RNG state "
              "bit-equal after save / load_checkpoint, on the card")

        # 11f. the hardness probe
        probe_noises = draw_noises(torch.Generator(device=DEVICE).manual_seed(7), GAN_RPI,
                                   gen_cfg)
        hardness = GL.probe_hardness(trainer, real[:GAN_RPI], probe_noises)
        check(math.isfinite(hardness), f"probe_hardness {hardness}")
        print(f"probe_hardness on {GAN_RPI} fixed poses and noises: {hardness:.6f}")

        # times: host-clock iterations with and without feedback, in turns
        no_feedback = dataclasses.replace(loop_cfg, feedback_start_epoch=1 << 30)
        with_s, without_s = [], []
        n_renders = len(renders)
        for i in range(GAN_TIMED):
            for fb in ((True, False) if i % 2 == 0 else (False, True)):
                trainer.cfg = loop_cfg if fb else no_feedback
                t0 = time.perf_counter()
                trainer.train_step(real)
                torch.cuda.synchronize()
                (with_s if fb else without_s).append(time.perf_counter() - t0)
        trainer.cfg = loop_cfg
        render_s = [r["s"] for r in renders[n_renders:]]

        def spread(ts):
            ms = sorted(1e3 * t for t in ts)
            return f"{statistics.median(ms):.3f} [{ms[0]:.3f}, {ms[-1]:.3f}]"

        print(f"timing GAN iteration (batch {GAN_BATCH}, {GAN_TIMED} of each, median [min, max] "
              f"ms): without feedback {spread(without_s)}, with feedback {spread(with_s)} "
              f"[{card}]")
        TIMES["gan_feedback_ms"] = 1e3 * statistics.median(with_s)
        print(f"  feedback render ({GAN_RPI} frames of {FRAME_HW}^2, window {FRAME_WINDOW}, "
              f"f16 readback): {spread(render_s)} ms a call, "
              f"{GAN_RPI / statistics.median(render_s):.3f} frames/s [{card}]")
        wall, dev_ms, kern = profile_calls(torch, lambda: trainer.train_step(real), 1)
        # the eval kernel's modes by the profiler's (demangled) name:
        # eval_sm90_kernel<2, 0> the dual, <0, 0> the full field
        mode_ms = lambda m: sum(k[1] for k in kern if re.search(  # noqa: E731
            rf"eval_sm90_kernel(<|ILi){m}(?![0-9])", k[0]))
        dual_ms, field_ms = mode_ms(2), mode_ms(0)
        conv_ms = sum(k[1] for k in kern if any(
            w in k[0].lower() for w in ("conv", "fprop", "cudnn", "winograd", "implicit")))
        check(dual_ms > 0.0 and field_ms > 0.0 and conv_ms > 0.0,
              f"profiler: dual {dual_ms}, field {field_ms}, convolutions {conv_ms} ms among "
              + "; ".join(k[0][:60] for k in kern[:8]))
        print(f"  a feedback iteration under torch.profiler: {wall:.3f} ms, device kernels "
              f"{dev_ms:.3f} ms (dual {dual_ms:.3f}, field {field_ms:.3f}, convolutions "
              f"{conv_ms:.3f}, the rest {dev_ms - dual_ms - field_ms - conv_ms:.3f}), idle "
              f"{1.0 - dev_ms / wall:.1%}; " + ", ".join(
                  f"{name[:40]} {ms:.3f} ms x{n:.0f}" for name, ms, n in kern[:6]) + f" [{card}]")

        # the SPIN fine-tune step at train_spin's batch, on the card
        reps = -(-SPIN_FT_BATCH // len(frames))
        batch = np.concatenate([frames] * reps)[:SPIN_FT_BATCH]
        gt32 = GL.fk_joints(torch.as_tensor(np.concatenate([bones] * reps)[:SPIN_FT_BATCH]),
                            loop_cfg.pose_scale).to(DEVICE)
        x32 = GL.prepare_spin_input(batch, loop_cfg.crop, DEVICE)
        p = _to(torch, spin_p, DEVICE, grad=True)
        st = ft_opt.init(p)
        masks = dropout_masks(torch.Generator(device=DEVICE).manual_seed(4), SPIN_FT_BATCH)
        ft_ms = cuda_ms(lambda: ft_step(p, spin_s, st, x32, gt32, masks), 5)
        print(f"timing SPIN fine-tune step (batch {SPIN_FT_BATCH}, 224^2, BN frozen): "
              f"{ft_ms:.3f} ms [{card}]")
    finally:
        GL.render_images_pipelined = pipelined
        torch.backends.cudnn.allow_tf32 = False
    return main_launches


def _steps_window(torch, F, TR, rec):
    """Wrap trainer.make_train_step so that each step the CLI builds checks
    its launch counts, and the steps in CLI_TIMED / CLI_PROFILED are timed
    by the host clock and profiled."""
    real = TR.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def counted(state, batch, generator=None):
            i = state.step
            rec.setdefault("first", i)
            rec.setdefault("t_first", time.perf_counter())
            if i == CLI_TIMED[0]:
                torch.cuda.synchronize()
                rec["t0"] = time.perf_counter()
            if i == CLI_PROFILED[0] and rec.get("prof") is not None:
                torch.cuda.synchronize()
                rec["prof"].start()
                rec["p0"] = time.perf_counter()
            before = dict(F.LAUNCHES)
            state, stats = step(state, batch, generator)
            got = {k: F.LAUNCHES[k] - before[k] for k in before}
            want = {k: rec["want"].get(k, 0) for k in got}
            check(got == want, f"CLI step {i + 1}: launches {got} != {want}")
            rec["steps"] += 1
            if i + 1 == CLI_PROFILED[1] and rec.get("prof") is not None:
                torch.cuda.synchronize()
                rec["p1"] = time.perf_counter()
                rec["prof"].stop()
            if i + 1 == CLI_TIMED[1]:
                torch.cuda.synchronize()
                rec["t1"] = time.perf_counter()
            return state, stats

        return counted

    return real, make


def _eval_window(torch, F, IMG, RN, rec):
    """Wrap run_nerf.evaluate_testset: each call's frames, chunks (the
    render's calls of image._eval_maps), launches, seconds and frames, and
    its first render_image call (arguments and output)."""
    real_eval, real_maps, real_image = RN.evaluate_testset, IMG._eval_maps, IMG.render_image

    def maps(*args, **kwargs):
        rec["chunks"] += 1
        return real_maps(*args, **kwargs)

    def image(*args, **kwargs):
        out = real_image(*args, **kwargs)
        rec.setdefault("frame", (args, kwargs, out))
        return out

    def evaluate(cfg, state, render_data, *args, **kwargs):
        rec["chunks"] = 0
        rec.pop("frame", None)
        torch.cuda.synchronize()
        before, t0 = dict(F.LAUNCHES), time.perf_counter()
        out = real_eval(cfg, state, render_data, *args, **kwargs)
        torch.cuda.synchronize()
        rec["s"] = time.perf_counter() - t0
        rec["frames"] = render_data["imgs"].shape[0]
        rec["launches"] = {k: F.LAUNCHES[k] - before[k] for k in before}
        rec["calls"] += 1
        rec.update(render_data=render_data, rgbs=out[1],
                   render_factor=kwargs.get("render_factor", 0))
        return out

    IMG._eval_maps, IMG.render_image = maps, image
    return (real_eval, real_maps, real_image), evaluate


def plain_chunk_fn(torch, IMG, cfg, sub: int):
    """A device-raygen render function that renders each chunk through the
    plain pipeline in slices of `sub` rays, every slice with the near / far
    of its whole chunk (a ray that misses the cylinder takes its chunk's
    mean): the plain render of a chunk too large for the float32 pipeline's
    encodings (65536 rays x 80 samples), ray for ray the same function."""
    from posegen_tpu_torch.ops import sampling as samp

    clip = samp.get_near_far_in_cylinder

    def fn(params, cam, start, n, ctx):
        o, d = IMG.rays_from_box(cam, start, n)
        near, far = clip(o, d, ctx.cyls.expand(n, 5), near=cfg.near, far=cfg.far)
        outs = []
        try:
            for s in range(0, n, sub):
                samp.get_near_far_in_cylinder = lambda *a, s=s, **k: (near[s:s + sub],
                                                                      far[s:s + sub])
                outs.append(IMG._eval_maps(cfg, params, o[s:s + sub], d[s:s + sub], ctx, False))
        finally:
            samp.get_near_far_in_cylinder = clip
        return {k: torch.cat([x[k] for x in outs]) for k in outs[0]}

    fn.takes_cam = True
    return fn


def check_val_frame(torch, F, IMG, RN, real_image, ev, tag: str, plain_fn=None) -> str:
    """A CLI run's first val frame as evaluate_testset rendered it through
    the eval kernels, against the same render_image call through the plain
    pipeline (or `plain_fn`, `plain_chunk_fn`'s), by phase 3's flip rule. At
    render_factor > 0, also the background's downsizing and the frame's
    upsizing on the card against the CPU, and the evaluated frame against
    that upsizing. -> a summary."""
    import numpy as np

    args, kw, out_k = ev["frame"]
    cfg, params, RH, RW, focal, c2w, ctx = args
    chunk = kw["chunk"]
    F.reset_launches()
    with torch.no_grad():  # as evaluate_testset renders: the state's leaves want grads
        out_p = real_image(*args, **dict(
            kw, render_fn=plain_fn or IMG._raygen_render_fn(cfg, use_fused=False)))
    torch.cuda.synchronize()
    check(all(v == 0 for v in F.LAUNCHES.values()), f"{tag} plain val frame: launches {F.LAUNCHES}")
    valid_idx = out_k["valid_idx"]
    check(np.array_equal(valid_idx, out_p["valid_idx"]), f"{tag} val frame: boxes differ")
    n_img = len(valid_idx)
    rgb_k = out_k["rgb"].reshape(-1, 3)[valid_idx]
    rgb_p = out_p["rgb"].reshape(-1, 3)[valid_idx]
    check(bool(np.isfinite(rgb_k).all()), f"{tag} val frame not finite")
    acc_k = out_k["acc"].reshape(-1)[valid_idx]
    flipped = np.abs(acc_k - out_p["acc"].reshape(-1)[valid_idx]) > 0.5
    n_flip = int(flipped.sum())
    d_rgb = np.abs(rgb_k - rgb_p).max(-1)
    err = float(d_rgb[~flipped].max())
    tl, br = out_k["bbox"]
    cam = {k: torch.as_tensor(v).to(DEVICE)
           for k, v in IMG.make_cam(RH, RW, focal, c2w, tl, br).items()}
    with torch.no_grad():
        straddles, sig_ref = far_sigma_straddles(torch, F, cfg, params, ctx, cam, n_img, chunk)
    straddles, sig_ref = straddles.cpu().numpy(), sig_ref.cpu().numpy()
    check(n_flip <= MAX_FLIP_FRAC * n_img, f"{tag} val frame: {n_flip} rays flipped opacity")
    check(bool(straddles[flipped].all()),
          f"{tag} val frame: {int((~straddles[flipped]).sum())} rays flipped opacity with no "
          "sign change of their far sigma")
    check(err <= RENDER_TOL, f"{tag} val frame: rgb vs plain {err:.3e} > {RENDER_TOL}")
    codes = "with framecodes" if ctx.cam_idxs is not None else "no framecodes"
    out = (f"val frame 0 ({RH} x {RW}, {n_img} rays, chunk {chunk}, {codes}) vs the plain "
           f"pipeline: rgb max|diff| {err:.3e} on {n_img - n_flip} rays, {n_flip} flipped "
           f"opacity (each with a far-sigma sign change; float32 |sigma| <= "
           f"{float(np.abs(sig_ref[flipped]).max()) if n_flip else 0.0:.3e} there); mean acc "
           f"{float(acc_k.mean()):.4f}")
    if ev["render_factor"] > 0:
        rd = ev["render_data"]
        H, W, _ = rd["hwf"]
        up = {d: RN._resize_bilinear(out_k["rgb"], (H, W), torch.device(d), antialias=False)
              for d in (DEVICE, "cpu")}
        down = {d: RN._resize_bilinear(rd["bkgds"][0], (RH, RW), torch.device(d),
                                       antialias=True) for d in (DEVICE, "cpu")}
        err_up = float(np.abs(up[DEVICE] - up["cpu"]).max())
        err_down = float(np.abs(down[DEVICE] - down["cpu"]).max())
        check(err_up <= RESIZE_TOL and err_down <= RESIZE_TOL,
              f"{tag} val resize, card vs CPU: up {err_up:.3e}, down {err_down:.3e} > "
              f"{RESIZE_TOL}")
        check(np.array_equal(ev["rgbs"][0], up[DEVICE]),
              f"{tag} val frame 0: the evaluated frame is not the kernels' frame upsized")
        check(np.array_equal(kw["bg"], down[DEVICE]),
              f"{tag} val frame 0: the background is not the plate downsized")
        out += (f"; {H} x {W} upsizing card vs CPU {err_up:.3e}, the background's "
                f"antialiased downsizing {err_down:.3e}")
    return out


def _train_cli(torch, RN, argv):
    """run_nerf.train(argv) on the card with its output captured (and
    echoed) -> (log dir, every printed loss)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            log_dir = RN.train(argv, device=DEVICE)
    finally:
        out = buf.getvalue()
        print("\n".join("  | " + line for line in out.splitlines()[-12:]))
    losses = [float(m) for m in re.findall(r"^iter \d+: loss (\S+)", out, re.M)]
    return log_dir, losses, out


def cli_phases(torch, card: str, tmp: str):
    """Phase 12, the CLI: a SURREAL-shaped H5 written and read by the
    port's own HDF5 code (under `tmp`), configs/surreal/surreal.txt trained
    through run_nerf.train for CLI_ITERS steps with its val frames, the
    checkpoint and the resume, then configs/h36m/h36m_prot2.txt's pose
    refinement -> (launches of every kernel on its main path (both runs'
    steps and val renders), the two runs' log dirs and checkpoints)."""
    import statistics

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from posegen_tpu_torch.cli import run_nerf as RN
    from posegen_tpu_torch.cli.config import (
        args_to_raycast_config, args_to_train_config, nerf_config_parser, parse_with_config,
    )
    from posegen_tpu_torch.data import catalog as CAT
    from posegen_tpu_torch.data import h5dataset as H5D
    from posegen_tpu_torch.data import native as NAT
    from posegen_tpu_torch.data import writer as WR
    from posegen_tpu_torch.data.hdf5 import read_h5
    from posegen_tpu_torch.data.synthetic import make_synthetic_h5
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render.raycast import init_raycaster
    from posegen_tpu_torch.train import checkpoints as CK
    from posegen_tpu_torch.train import trainer as TR

    main_launches = {k: 0 for k in F.LAUNCHES}
    steps = {"steps": 0, "want": STEP_LAUNCHES}
    evals = {"calls": 0}
    real_make, counted_make = _steps_window(torch, F, TR, steps)
    (real_eval, real_maps, real_image), counted_eval = _eval_window(torch, F, IMG, RN, evals)
    TR.make_train_step, RN.evaluate_testset = counted_make, counted_eval
    try:
        # 12a. the data: written and read back by the port's HDF5 code ----
        path = CAT.resolve_h5_path(CAT.DataConfig(dataset="surreal", subject="female",
                                                  data_root=tmp))
        os.makedirs(os.path.dirname(path))
        written, real_write = {}, WR.write_h5

        def capture(p, datasets):
            written.update(datasets)
            t0 = time.perf_counter()
            out = real_write(p, datasets)
            written["__s"] = time.perf_counter() - t0
            return out

        WR.write_h5 = capture
        try:
            t0 = time.perf_counter()
            make_synthetic_h5(path, n_images=CLI_IMAGES, H=CLI_HW, W=CLI_HW, focal=CLI_FOCAL)
            build_s = time.perf_counter() - t0
        finally:
            WR.write_h5 = real_write
        write_s, nbytes = written.pop("__s"), os.path.getsize(path)
        back, rows = read_h5(path)
        check(sorted(back) == sorted(written), f"read_h5 keys {sorted(back)} != "
                                               f"{sorted(written)}")
        for k, v in written.items():
            v = np.asarray(v)
            check(back[k].dtype == v.dtype and back[k].shape == v.shape
                  and back[k].tobytes() == v.tobytes(), f"read_h5 {k}: not bit-equal")
        check(sorted(rows) == ["bkgds", "imgs", "masks", "sampling_masks"], f"rows {sorted(rows)}")
        t0 = time.perf_counter()
        ds = H5D.H5RayDataset(path, n_rays_per_image=16)
        open_ms = (time.perf_counter() - t0) * 1e3
        check(ds._row_offs is not None and ds._sidx_off is not None,
              "H5RayDataset did not take the memmap fast path")
        check(ds.sample_batch(np.arange(2), seed=0) is not None, "the native sampler did not run")
        loader = H5D.RayBatchLoader(ds, n_images_per_batch=CLI_IMAGES, seed=0)

        def batch_ms():
            ts = []
            for _ in range(BATCH_TIMED):
                t0 = time.perf_counter()
                loader.make_batch()
                ts.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(ts)

        native_ms = batch_ms()
        real_lib = NAT.get_lib
        NAT.get_lib = lambda: None
        try:
            check(ds.sample_batch(np.arange(2), seed=0) is None, "the numpy path did not run")
            numpy_ms = batch_ms()
        finally:
            NAT.get_lib = real_lib
        pinned = H5D.RayBatchLoader(ds, n_images_per_batch=CLI_IMAGES, seed=0, pin_memory=True)
        host = next(pinned)
        check(all(v.is_pinned() for v in host.values()), "pinned loader: a batch not pinned")
        up = []
        for _ in range(UPLOADS_TIMED):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dev_batch = {k: v.to(DEVICE, non_blocking=True) for k, v in host.items()}
            b.record()
            torch.cuda.synchronize()
            up.append(a.elapsed_time(b))
        batch_bytes = sum(v.numel() * v.element_size() for v in host.values())
        check(all(torch.equal(dev_batch[k].cpu(), host[k]) for k in host), "upload differs")
        print(f"cli data: make_synthetic_h5 {CLI_IMAGES} x {CLI_HW}^2 in {build_s:.3f} s, of "
              f"which write_h5 {write_s:.3f} s for {nbytes} bytes; read_h5 bit-equal on "
              f"{len(written)} keys; H5RayDataset open {open_ms:.3f} ms (memmap fast path, "
              f"native sampler); make_batch ({CLI_IMAGES} images x 16 rays, median of "
              f"{BATCH_TIMED}): native {native_ms:.3f} ms, numpy {numpy_ms:.3f} ms; upload of "
              f"a pinned batch ({batch_bytes} bytes, median of {UPLOADS_TIMED}) "
              f"{statistics.median(up):.4f} ms [{card}]")

        # 12b. the surreal run ------------------------------------------
        logs = os.path.join(tmp, "logs")
        argv = ["--config", "configs/surreal/surreal.txt",
                "--datadir", os.path.join(tmp, "surreal"), "--basedir", logs,
                "--n_iters", str(CLI_ITERS), "--i_testset", str(CLI_ITERS),
                "--i_weights", str(CLI_ITERS), "--i_print", "50", "--i_video", "0"]
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        steps["prof"] = prof
        F.reset_launches()
        log_dir, losses, _ = _train_cli(torch, RN, argv)
        torch.cuda.synchronize()
        for k in main_launches:
            main_launches[k] += F.LAUNCHES[k]
        check(steps["steps"] == CLI_ITERS and steps["first"] == 0,
              f"surreal run: {steps['steps']} steps from {steps.get('first')}")
        check(len(losses) == CLI_ITERS // 50 and all(map(math.isfinite, losses)),
              f"surreal run: printed losses {losses}")
        ev = dict(evals)
        want = {k: 0 for k in F.LAUNCHES}
        want.update(dual=ev["chunks"], field=ev["chunks"])
        check(ev["calls"] == 1 and ev["frames"] == 2 and ev["launches"] == want,
              f"surreal val: {ev['calls']} calls, {ev.get('frames')} frames, launches "
              f"{ev.get('launches')} != {want}")
        for name in ("psnr.txt", "ssim.txt", "args.txt", f"{CLI_ITERS:08d}.ckpt.npz"):
            check(os.path.exists(os.path.join(log_dir, name)), f"surreal run: no {name}")
        psnr = open(os.path.join(log_dir, "psnr.txt")).read().split()
        surreal_frame = check_val_frame(torch, F, IMG, RN, real_image, ev, "surreal")
        args = parse_with_config(nerf_config_parser(), argv)
        cfg, tcfg = args_to_raycast_config(args), args_to_train_config(args)
        ckpt = os.path.join(log_dir, f"{CLI_ITERS:08d}.ckpt.npz")
        fresh = TR.create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(9),
                                                     device=DEVICE), tcfg)
        loaded = CK.load_checkpoint(ckpt, fresh)
        flat, back = dict(np.load(ckpt)), CK._state_flat(loaded)
        check(sorted(flat) == sorted(back) and all(
            flat[k].dtype == back[k].dtype and np.array_equal(flat[k], back[k]) for k in flat),
            "surreal checkpoint: not bit-equal through a fresh state")
        steps.update(steps=0, prof=None)
        steps.pop("first", None)
        F.reset_launches()
        _train_cli(torch, RN, argv[:6] + ["--n_iters", str(CLI_ITERS + 1), "--i_testset", "0",
                                          "--i_weights", "0", "--i_print", "50",
                                          "--i_video", "0"])
        for k in main_launches:
            main_launches[k] += F.LAUNCHES[k]
        check(steps.get("first") == CLI_ITERS and steps["steps"] == 1,
              f"resume: started at step {steps.get('first')}, {steps['steps']} steps")
        rays = (CLI_TIMED[1] - CLI_TIMED[0]) * args.N_rand
        cli_s = steps["t1"] - steps["t0"]
        prof_wall = (steps["p1"] - steps["p0"]) * 1e3
        print(f"cli surreal: {CLI_ITERS} steps, launches per step {STEP_LAUNCHES}, losses "
              f"{losses}; val {ev['frames']} frames of {CLI_HW}^2 in {ev['chunks']} chunks "
              f"(dual = field = chunks), psnr {psnr[-1]}; checkpoint bit-equal through a fresh "
              f"state; the resume started at step {CLI_ITERS}")
        print(f"cli surreal {surreal_frame}")

        # 12c. the opt_pose run -----------------------------------------
        hpath = CAT.resolve_h5_path(CAT.DataConfig(dataset="h36m", subject="S9", data_root=tmp))
        os.makedirs(os.path.dirname(hpath))
        make_synthetic_h5(hpath, n_images=POSE_CLI_IMAGES, H=POSE_CLI_HW, W=POSE_CLI_HW,
                          focal=POSE_CLI_FOCAL)
        hargv = ["--config", "configs/h36m/h36m_prot2.txt",
                 "--datadir", os.path.join(tmp, "h36m"), "--basedir", logs,
                 "--n_iters", str(POSE_CLI_ITERS), "--i_testset", str(POSE_CLI_ITERS),
                 "--i_weights", str(POSE_CLI_ITERS), "--i_pose_weights", str(POSE_CLI_ITERS),
                 "--i_print", "10", "--i_video", "0"]
        steps.update(steps=0, want=dict(STEP_LAUNCHES, field_bwd_inputs=2))
        steps.pop("first", None)
        evals["calls"] = 0
        F.reset_launches()
        hlog, hlosses, _ = _train_cli(torch, RN, hargv)
        torch.cuda.synchronize()
        for k in main_launches:
            main_launches[k] += F.LAUNCHES[k]
        check(steps["steps"] == POSE_CLI_ITERS and steps["first"] == 0,
              f"h36m run: {steps['steps']} steps")
        check(len(hlosses) == POSE_CLI_ITERS // 10 and all(map(math.isfinite, hlosses)),
              f"h36m run: printed losses {hlosses}")
        hev = dict(evals)
        want = {k: 0 for k in F.LAUNCHES}
        want.update(dual=hev["chunks"], field=hev["chunks"])
        check(hev["calls"] == 1 and hev["launches"] == want,
              f"h36m val: launches {hev.get('launches')} != {want}")
        h36m_frame = check_val_frame(torch, F, IMG, RN, real_image, hev, "h36m")
        pose_ckpt = os.path.join(hlog, f"{POSE_CLI_ITERS:08d}.pose.npz")
        check(os.path.exists(pose_ckpt), "h36m run: no pose checkpoint")
        pose = CK.load_pose_params(pose_ckpt, device=DEVICE)
        flat = dict(np.load(pose_ckpt))
        check(sorted(pose) == ["bones", "pelvis"] and all(
            np.array_equal(pose[k].cpu().numpy(), flat[f"pose_params//{k}"]) for k in pose),
            f"h36m pose checkpoint: {sorted(pose)} not equal to its file")
        check(tuple(pose["bones"].shape) == (POSE_CLI_IMAGES, 24, 6), "pose rows")
        print(f"cli h36m_prot2 (opt_pose, {POSE_CLI_IMAGES} images cut to {POSE_CLI_HW}^2): "
              f"{POSE_CLI_ITERS} steps, launches per step {steps['want']}, losses {hlosses}; "
              f"val at render_factor 2 in {hev['chunks']} chunks (dual = field = chunks); "
              f"the pose checkpoint loads back equal to its file")
        print(f"cli h36m_prot2 {h36m_frame}")

        # 12d. times ----------------------------------------------------
        print(f"timing cli surreal: steps {CLI_TIMED[0] + 1}-{CLI_TIMED[1]} in {cli_s:.4f} s "
              f"(host clock, with the loader running): {rays / cli_s:.1f} trained rays/s, "
              f"{cli_s / (CLI_TIMED[1] - CLI_TIMED[0]) * 1e3:.4f} ms a step; the bare step "
              f"(phase 6): {args.N_rand / TIMES['train_step_ms'] * 1e3:.1f} trained rays/s, "
              f"{TIMES['train_step_ms']:.4f} ms [{card}]")
        print(f"timing cli val: {ev['s']:.4f} s for {ev['frames']} frames of {CLI_HW}^2, "
              f"{ev['s'] / ev['frames']:.4f} s a frame [{card}]")
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        wall = prof_wall
        n_prof = CLI_PROFILED[1] - CLI_PROFILED[0]
        if busy > 0.0:
            print(f"profile cli surreal, steps {CLI_PROFILED[0] + 1}-{CLI_PROFILED[1]} "
                  f"(torch.profiler): {wall / n_prof:.4f} ms a step, device kernels "
                  f"{busy / n_prof:.4f} ms a step, idle share {1.0 - busy / wall:.1%} [{card}]")
        else:
            print("profile cli surreal: torch.profiler recorded no device time")
    finally:
        TR.make_train_step, RN.evaluate_testset = real_make, real_eval
        IMG._eval_maps, IMG.render_image = real_maps, real_image
    return main_launches, {"tmp": tmp, "surreal_log": log_dir, "surreal_ckpt": ckpt,
                           "h36m_log": hlog,
                           "h36m_ckpt": os.path.join(hlog, f"{POSE_CLI_ITERS:08d}.ckpt.npz")}



def _counted_chunks(torch, F, IMG, rec):
    """Wrap image._eval_maps, the render of one chunk: each call on the
    kernels' route must launch one dual and one field kernel, each on the
    plain route none. rec counts them."""
    real = IMG._eval_maps

    def maps(cfg, params, rays_o, rays_d, ctx, use_fused):
        before = dict(F.LAUNCHES)
        out = real(cfg, params, rays_o, rays_d, ctx, use_fused)
        got = {k: F.LAUNCHES[k] - before[k] for k in before}
        plain = use_fused is False
        want = {k: (0 if plain else int(k in ("dual", "field"))) for k in got}
        check(got == want, f"a {rays_o.shape[0]}-ray chunk ({'plain' if plain else 'kernels'}): "
                           f"launches {got} != {want}")
        rec["plain" if plain else "chunks"] += 1
        rec["rays_max"] = max(rec["rays_max"], rays_o.shape[0])
        return out

    IMG._eval_maps = maps
    return real


def _quiet(fn, *args, **kwargs):
    """fn's standard output captured; its last lines echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kwargs), buf.getvalue()
    finally:
        print("\n".join("  | " + line for line in buf.getvalue().splitlines()[-6:]))


def mine_phases(torch, card: str, runs):
    """Phase 13, render and mine from phase 12's trained surreal run through
    the CLIs: load_trained + export_tar, run_render (val with --eval, bullet,
    mesh), render_testset, run_gan with train_spin -> the eval kernels'
    launches on these paths."""
    import statistics

    import numpy as np

    from posegen_tpu_torch.cli import export_tar as EX
    from posegen_tpu_torch.cli import render_testset as RT
    from posegen_tpu_torch.cli import run_gan as RG
    from posegen_tpu_torch.cli import run_nerf as RN
    from posegen_tpu_torch.cli import run_render as RR
    from posegen_tpu_torch.gen import loop as GL
    from posegen_tpu_torch.gen import spin_driver as SD
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.train.checkpoints import _flatten
    from posegen_tpu_torch.train.trainer import param_leaves
    from posegen_tpu_torch.utils.png import read_png, write_png

    out_root = os.path.join(runs["tmp"], "mine")
    os.makedirs(out_root)
    main_launches = {"dual": 0, "field": 0}
    rec = {"chunks": 0, "plain": 0, "rays_max": 0}
    real_maps = _counted_chunks(torch, F, IMG, rec)
    real_path, real_image, real_pipelined = IMG.render_path, IMG.render_image, \
        GL.render_images_pipelined
    real_epoch, real_step = GL.GanTrainer.train_epoch, SD.make_spin_finetune_step
    u8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)  # noqa: E731

    def launched():
        torch.cuda.synchronize()
        for k in main_launches:
            main_launches[k] += F.LAUNCHES[k]
        return dict(F.LAUNCHES)

    try:
        # 13a. load_trained of the run, export_tar, and the .tar back ----
        def same_as_file(variables, path, tag, subset=False):
            flat = dict(np.load(path))
            want = {k.split("//", 1)[1]: v for k, v in flat.items()
                    if k.startswith(("params//", "embeds//"))}
            got = _flatten(variables)
            keys_ok = set(got) <= set(want) if subset else sorted(got) == sorted(want)
            check(keys_ok and all(got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
                                  for k in got),
                  f"{tag}: not bit-equal to the trained state ({len(got)} / {len(want)} tensors)")
            check(not any(t.requires_grad for t in param_leaves(variables)), f"{tag}: wants grads")
            return len(got)

        args_txt = os.path.join(runs["surreal_log"], "args.txt")
        t0 = time.perf_counter()
        _, cfg, variables = RR.load_trained(args_txt, runs["surreal_ckpt"], device=DEVICE)
        load_s = time.perf_counter() - t0
        n_npz = same_as_file(variables, runs["surreal_ckpt"], "load_trained (.npz)")
        tar, _ = _quiet(EX.main, ["--nerf_args", args_txt, "--ckptpath", runs["surreal_ckpt"],
                                  "--out", os.path.join(out_root, "surreal.tar")], device=DEVICE)
        _, _, v_tar = RR.load_trained(args_txt, tar, device=DEVICE)
        n_tar = same_as_file(v_tar, runs["surreal_ckpt"], "load_trained (.tar)", subset=True)
        _, hcfg, hvar = RR.load_trained(os.path.join(runs["h36m_log"], "args.txt"),
                                        runs["h36m_ckpt"], device=DEVICE)
        n_h36m = same_as_file(hvar, runs["h36m_ckpt"], "load_trained (h36m, opt_pose)")
        check(hcfg.opt_framecode and hcfg.n_framecodes == POSE_CLI_IMAGES,
              f"h36m: {hcfg.n_framecodes} framecodes")
        print(f"mine load_trained: the surreal run's step-{CLI_ITERS} .npz, {n_npz} tensors "
              f"bit-equal to the trained state ({load_s:.3f} s); export_tar -> load_trained of "
              f"the .tar: its {n_tar} tensors bit-equal; the h36m_prot2 run (pose params, "
              f"{hcfg.n_framecodes} framecodes, the pose optimizer's state in the template): "
              f"{n_h36m} tensors bit-equal")

        # 13b. run_render --render_type val --eval at the default chunk ----
        seen = {}

        def path(*args, **kwargs):
            seen["out"] = real_path(*args, **kwargs)
            return seen["out"]

        def image(*args, **kwargs):
            out = real_image(*args, **kwargs)
            seen.setdefault("frame", (args, kwargs, out))
            seen.setdefault("rays", []).append(len(out["valid_idx"]))
            return out

        IMG.render_path, IMG.render_image = path, image
        F.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        val_dir, _ = _quiet(RR.run_render, ["--nerf_args", args_txt, "--ckptpath",
                                            runs["surreal_ckpt"], "--render_type", "val",
                                            "--eval", "--outputdir", out_root, "--runname",
                                            "val"], device=DEVICE)
        val_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        got = launched()
        IMG.render_image = real_image
        out = seen["out"]
        n_frames = len(out["rgbs"])
        want_chunks = sum(-(-n // 65536) for n in seen["rays"])
        check(n_frames == 2 and got["dual"] == got["field"] == rec["chunks"] == want_chunks
              and rec["rays_max"] == min(65536, max(seen["rays"])),
              f"run_render val: {n_frames} frames of {seen['rays']} rays, launches {got}, "
              f"{rec['chunks']} chunks of at most {rec['rays_max']} rays")
        val_chunks = rec["chunks"]
        for name in ("psnr.txt", "ssim.txt", "scores.npy", "bboxes.npy"):
            check(os.path.exists(os.path.join(val_dir, name)), f"run_render val: no {name}")
        psnr = float(open(os.path.join(val_dir, "psnr.txt")).read())
        for i in range(n_frames):
            back = read_png(os.path.join(val_dir, "image", f"{i:05d}.png"))
            check(back.dtype == np.uint8 and np.array_equal(back, u8(out["rgbs"][i])),
                  f"run_render val: PNG {i} does not read back as the frame")
        ev = {"frame": seen.pop("frame"), "render_factor": 0}
        torch.cuda.empty_cache()
        frame = check_val_frame(torch, F, IMG, RN, real_image, ev, "run_render",
                                plain_fn=plain_chunk_fn(torch, IMG, cfg, PLAIN_SUB))
        print(f"mine run_render val --eval (chunk 65536): {n_frames} frames of "
              f"{out['rgbs'].shape[1]}^2 ({seen['rays']} rays) in {val_chunks} chunks, launches "
              f"dual {got['dual']} field {got['field']} (one each a chunk); psnr {psnr}; every "
              f"PNG reads back equal "
              f"to its frame; the render's peak device memory above the weights "
              f"{peak_gb:.2f} GiB")
        print(f"mine run_render {frame}")

        # 13c. bullet, then the mesh ----------------------------------------
        rec["chunks"] = 0
        F.reset_launches()
        bullet_dir, _ = _quiet(RR.run_render, [
            "--nerf_args", args_txt, "--ckptpath", runs["surreal_ckpt"], "--render_type",
            "bullet", "--bullet_n", str(MINE_BULLET_N), "--outputdir", out_root, "--runname",
            "bullet"], device=DEVICE)
        got = launched()
        pngs = sorted(os.listdir(os.path.join(bullet_dir, "image")))
        check(len(pngs) == MINE_BULLET_N and got["dual"] == got["field"] == rec["chunks"] > 0,
              f"run_render bullet: {len(pngs)} PNGs, launches {got}, {rec['chunks']} chunks")
        for i, f in enumerate(pngs):
            check(np.array_equal(read_png(os.path.join(bullet_dir, "image", f)),
                                 u8(seen["out"]["rgbs"][i])), f"bullet PNG {f}")
        bullet_chunks = rec["chunks"]
        F.reset_launches()
        mesh_dir, _ = _quiet(RR.run_render, [
            "--nerf_args", args_txt, "--ckptpath", runs["surreal_ckpt"], "--render_type",
            "mesh", "--mesh_res", str(MINE_MESH_RES), "--outputdir", out_root, "--runname",
            "mesh"], device=DEVICE)
        got = launched()
        want = {k: int(k == "field") for k in got}
        check(got == want and os.path.exists(os.path.join(mesh_dir, "mesh.ply")),
              f"run_render mesh: launches {got} != {want} (one density-only launch)")
        n_verts = int(next(x for x in open(os.path.join(mesh_dir, "mesh.ply"))
                           if x.startswith("element vertex")).split()[-1])
        runs["val_dir"], runs["mesh_ply"] = val_dir, os.path.join(mesh_dir, "mesh.ply")
        print(f"mine run_render bullet: {MINE_BULLET_N} frames in {bullet_chunks} chunks (dual = "
              f"field = chunks), every PNG equal to its frame; mesh at res {MINE_MESH_RES}: one "
              f"density-only field launch, mesh.ply with {n_verts} vertices")

        # 13d. render_testset on 20 annotated poses ------------------------
        annot = os.path.join(out_root, "annot")
        os.makedirs(annot)
        rng = np.random.default_rng(0)
        for i in range(2):
            np.savez(os.path.join(annot, f"seq{i}.npz"), pose=(
                rng.standard_normal((MINE_POSES // 2, 72)) * 0.2).astype(np.float32))
        pipe = {"chunks": 0}

        def pipelined(cfg_, params, H, W, focal, c2ws, ctxs, cyls, chunk, window=None, **kw):
            n = [len(IMG.valid_box_for_pose(H, W, focal, c, cyl, window=window)[2])
                 for c, cyl in zip(c2ws, cyls)]
            pipe["chunks"] += sum(-(-k // chunk) for k in n)
            pipe["chunk"] = chunk
            return real_pipelined(cfg_, params, H, W, focal, c2ws, ctxs, cyls, chunk=chunk,
                                  window=window, **kw)

        GL.render_images_pipelined = pipelined
        rec["chunks"] = 0
        F.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts_dir, _ = _quiet(RT.main, ["--nerf_args", args_txt, "--ckptpath",
                                     runs["surreal_ckpt"], "--annot_dir", annot, "--outputdir",
                                     out_root, "--runname", "testset", "--render_hw",
                                     str(MINE_TESTSET_HW)], device=DEVICE)
        ts_s = time.perf_counter() - t0
        got = launched()
        pngs = sorted(os.listdir(os.path.join(ts_dir, "image")))
        joints = np.load(os.path.join(ts_dir, "poses.npy"))
        check(len(pngs) == MINE_POSES and joints.shape == (MINE_POSES, 24, 3)
              and np.isfinite(joints).all(), f"render_testset: {len(pngs)} PNGs, {joints.shape}")
        check(got["dual"] == got["field"] == rec["chunks"] == pipe["chunks"] > 0,
              f"render_testset: launches {got}, {rec['chunks']} chunks rendered, "
              f"{pipe['chunks']} in the frames' boxes")
        print(f"mine render_testset: {MINE_POSES} poses, {MINE_POSES} PNGs and poses.npy, "
              f"{pipe['chunks']} chunks of {pipe['chunk']} rays (dual = field = chunks)")

        # 13e. run_gan with train_spin on the PNGs it writes ---------------
        feedback = {"calls": 0, "frames": 0}

        def fb_pipelined(*args, **kwargs):
            before = dict(F.LAUNCHES)
            n0 = pipe["chunks"]
            frames = pipelined(*args, **kwargs)
            got = {k: F.LAUNCHES[k] - before[k] for k in before}
            want = {k: (pipe["chunks"] - n0 if k in ("dual", "field") else 0) for k in got}
            check(got == want and pipe["chunk"] == MINE_GAN_CHUNK,
                  f"run_gan feedback render {feedback['calls']}: launches {got} != {want}")
            feedback.setdefault("first", (args, kwargs, frames))
            feedback["calls"] += 1
            feedback["frames"] += len(frames)
            return frames

        epochs, steps = [], []

        def timed_epoch(self, batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = real_epoch(self, batches)
            torch.cuda.synchronize()
            epochs.append((time.perf_counter() - t0, len(batches)))
            return stats

        def timed_steps(**kw):
            opt, step = real_step(**kw)

            def timed(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*args)
                check(math.isfinite(float(out[2]["spin_loss"])), "train_spin: a loss not finite")
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0, args[3].shape[0]))
                return out

            return opt, timed

        GL.render_images_pipelined = fb_pipelined
        GL.GanTrainer.train_epoch, SD.make_spin_finetune_step = timed_epoch, timed_steps
        gan_argv = ["--nerf_args", args_txt, "--ckptpath", runs["surreal_ckpt"], "--outputdir",
                    out_root, "--runname", "gan", "--batch_size", str(MINE_GAN_BATCH), "--rpi",
                    str(MINE_RPI), "--feedback_every", "1", "--feedback_start_epoch", "-1",
                    "--chunk", str(MINE_GAN_CHUNK), "--probe_n", str(MINE_PROBE_N),
                    "--render_hw", str(MINE_GAN_HW)]
        pipe["chunks"] = rec["chunks"] = 0
        F.reset_launches()
        _, gan_out = _quiet(RG.main, gan_argv + ["--epochs", "1", "--train_spin_epochs",
                                                 str(MINE_SPIN_EPOCHS)], device=DEVICE)
        got = launched()
        run_dir = os.path.join(out_root, "gan")
        pool_iters = -(-4096 // MINE_GAN_BATCH)
        n_rows = sum(len(np.load(p)) for p in _glob(run_dir, "poses_axis_angles*.npy"))
        pngs = _glob(os.path.join(run_dir, "image"), "*.png")
        check(feedback["calls"] == pool_iters + 1 and n_rows == MINE_RPI * pool_iters
              and len(pngs) == n_rows and got["dual"] == got["field"] == pipe["chunks"] > 0,
              f"run_gan: {feedback['calls']} feedback renders, {n_rows} pose rows, {len(pngs)} "
              f"PNGs, launches {got}, {pipe['chunks']} chunks")
        t0 = time.perf_counter()
        for p in pngs:
            img = read_png(p)
            check(img.shape == (MINE_GAN_HW, MINE_GAN_HW, 3) and img.dtype == np.uint8,
                  f"{p}: {img.shape}")
        read_all_s = time.perf_counter() - t0
        spin = os.path.join(run_dir, "spin_ckpts", "spin_000.npz")
        gan0 = os.path.join(run_dir, "gan_ckpts", "gan_000.npz")
        check(os.path.exists(spin) and os.path.exists(gan0), "run_gan: no spin_000 / gan_000")
        check(len(steps) == MINE_SPIN_EPOCHS * (n_rows // MINE_SPIN_BATCH)
              and all(b == MINE_SPIN_BATCH for _, b in steps), f"train_spin: steps {steps}")
        recs = [json.loads(x) for x in open(os.path.join(run_dir, "epochs.jsonl"))]
        check(len(recs) == 1 and math.isfinite(recs[0]["probe_mpjpe"]),
              f"run_gan epochs.jsonl: {recs}")
        gan_chunks, n_feedback = pipe["chunks"], feedback["calls"]
        epoch_s, epoch_iters = epochs[0]
        spin_steps = [t for t, _ in steps[1:]]  # warm steps: the first builds
        # the first feedback call's first frames against the plain pipeline
        # at the same chunk and window (its chunks of 2,097,152 points, the
        # ragged last one of each frame too)
        (fcfg, fparams, H, W, focal, c2ws, ctxs, cyls), fkw, fb_frames = feedback.pop("first")
        n = COMPARE_FRAMES
        rays = [len(IMG.valid_box_for_pose(H, W, focal, c, cyl, window=fkw["window"])[2])
                for c, cyl in zip(c2ws[:n], cyls[:n])]
        F.reset_launches()
        with torch.no_grad():
            plain = real_pipelined(fcfg, fparams, H, W, focal, c2ws[:n], ctxs[:n], cyls[:n],
                                   chunk=fkw["chunk"], white_bkgd=fkw["white_bkgd"],
                                   window=fkw["window"],
                                   render_fn=plain_chunk_fn(torch, IMG, fcfg, PLAIN_SUB))
        torch.cuda.synchronize()
        check(all(v == 0 for v in F.LAUNCHES.values()),
              f"run_gan plain feedback frames: launches {F.LAUNCHES}")
        torch.cuda.empty_cache()
        err_fb, n_out_fb = check_pipelined_frames(
            torch, F, IMG, fcfg, fparams, fb_frames, plain, focal, c2ws, ctxs, cyls,
            fkw["chunk"], fkw["window"], "run_gan feedback")
        print(f"mine run_gan feedback call 0 vs the plain pipeline, frames 0-{n - 1} ({rays} "
              f"rays in chunks of {fkw['chunk']}, the last of each frame "
              f"{[r - (r - 1) // fkw['chunk'] * fkw['chunk'] for r in rays]}; kernel frames in "
              f"f16, plain in f32): rgb max|diff| {err_fb:.3e}, {n_out_fb} rays past "
              f"{RENDER_TOL} (each with a far-sigma sign change); background equal")
        # the resume: a second main to 2 epochs starts at epoch 1
        feedback["calls"] = 0
        F.reset_launches()
        _, resume_out = _quiet(RG.main, gan_argv + ["--epochs", "2"], device=DEVICE)
        launched()
        recs = [json.loads(x) for x in open(os.path.join(run_dir, "epochs.jsonl"))]
        check("resumed from" in resume_out and "(epoch 1)" in resume_out
              and [r["epoch"] for r in recs] == [0, 1] and feedback["calls"] == pool_iters + 1,
              f"run_gan resume: epochs {[r['epoch'] for r in recs]}, {feedback['calls']} renders")
        print(f"mine run_gan (batch {MINE_GAN_BATCH}, {epoch_iters} iterations, feedback every "
              f"iteration, {MINE_RPI} renders, chunk {MINE_GAN_CHUNK}, probe {MINE_PROBE_N}): "
              f"{n_feedback} feedback renders in {gan_chunks} chunks, dual = field = chunks; "
              f"{len(pngs)} PNGs of {MINE_GAN_HW}^2 read back as ({MINE_GAN_HW}, {MINE_GAN_HW}, 3) "
              f"uint8 (one pose row each); "
              f"train_spin {len(steps)} steps of {MINE_SPIN_BATCH}, losses finite, spin_000.npz; "
              f"gan_000.npz; probe_mpjpe {recs[0]['probe_mpjpe']}; the resume trained epoch 1")

        # 13f. times ----------------------------------------------------------
        frame = u8(out["rgbs"][0])
        png = os.path.join(out_root, "timed.png")
        png_ms = {}
        for level in (1, 6):
            ts = []
            for _ in range(PNG_TIMED):
                t0 = time.perf_counter()
                write_png(png, frame, compress_level=level)
                ts.append(1e3 * (time.perf_counter() - t0))
            png_ms[level] = (statistics.median(ts), os.path.getsize(png))
        ts = []
        for _ in range(PNG_TIMED):
            t0 = time.perf_counter()
            read_png(png)
            ts.append(1e3 * (time.perf_counter() - t0))
        print(f"timing run_render val: {val_s:.4f} s for {n_frames} frames of "
              f"{frame.shape[0]}^2 (load, render at chunk 65536 with f32 readback, metrics, "
              f"PNG writes), {val_s / n_frames:.4f} s a frame [{card}]")
        print(f"timing PNG codec ({frame.shape[0]}^2 RGB, median of {PNG_TIMED}, host): write_png "
              f"level 1 {png_ms[1][0]:.3f} ms ({png_ms[1][1]} bytes), level 6 "
              f"{png_ms[6][0]:.3f} ms ({png_ms[6][1]} bytes); read_png {statistics.median(ts):.3f} "
              f"ms; the sink's {len(pngs)} frames read in {read_all_s:.3f} s [{card}]")
        print(f"timing run_gan: epoch 0 {epoch_s:.4f} s for {epoch_iters} iterations "
              f"({epoch_iters / epoch_s:.4f} it/s, {1e3 * epoch_s / epoch_iters:.3f} ms an "
              f"iteration with feedback at chunk {MINE_GAN_CHUNK} and the PNG sink) beside phase "
              f"11's feedback iteration {TIMES.get('gan_feedback_ms', float('nan')):.3f} ms "
              f"(chunk {FRAME_CHUNK}, no sink) [{card}]")
        if spin_steps:
            print(f"timing train_spin: {statistics.median(spin_steps) * 1e3:.3f} ms a step "
                  f"(median of the {len(spin_steps)} steps after the first, batch "
                  f"{MINE_SPIN_BATCH}, 224^2) [{card}]")
        print(f"timing render_testset: {MINE_POSES} frames of {MINE_TESTSET_HW}^2 in {ts_s:.4f} s, "
              f"{MINE_POSES / ts_s:.4f} frames/s (load, render, PNG writes) [{card}]")
    finally:
        IMG._eval_maps, IMG.render_path, IMG.render_image = real_maps, real_path, real_image
        GL.render_images_pipelined = real_pipelined
        GL.GanTrainer.train_epoch, SD.make_spin_finetune_step = real_epoch, real_step
    return main_launches


def eval_phases(torch, card: str, tmp: str):
    """Phase 14, SPIN's evaluation and SKI fine-tune at full width: the JPEG
    fixtures against their manifest, SMPL at its published shapes, the
    SpinEvaluator's three entry points on synthetic sets in each
    benchmark's schema, train_ski. No kernel of the port is on this path;
    its launches are read and must stay 0."""
    import hashlib
    import json
    import pickle
    import statistics

    import numpy as np

    from posegen_tpu_torch.body.smpl import make_random_model
    from posegen_tpu_torch.data.hdf5 import write_h5
    from posegen_tpu_torch.evals import harness as H
    from posegen_tpu_torch.evals.pose import procrustes_align
    from posegen_tpu_torch.gen import spin_driver as SD
    from posegen_tpu_torch.gen.hmr import init_hmr
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.train.checkpoints import _flatten
    from posegen_tpu_torch.train.trainer import trainable
    from posegen_tpu_torch.utils import jpeg
    from posegen_tpu_torch.utils.convert import hmr_to_numpy
    from posegen_tpu_torch.utils.png import write_png

    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
    root = os.path.join(tmp, "eval")
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(14)

    # 14a. the JPEG decoder on the fixtures ----------------------------------
    t0 = time.perf_counter()
    jpeg.get_lib()
    build_s = time.perf_counter() - t0
    with open(os.path.join(fixtures, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        a = jpeg.read_jpeg(os.path.join(fixtures, name))
        check(list(a.shape) == entry["shape"]
              and hashlib.sha256(a.tobytes()).hexdigest() == entry["sha256"],
              f"read_jpeg {name}: {a.shape} or its hash differs from the manifest")
    full = os.path.join(fixtures, FULL_FRAME)
    ts = []
    for _ in range(JPEG_TIMED):
        t0 = time.perf_counter()
        jpeg.read_jpeg(full)
        ts.append(1e3 * (time.perf_counter() - t0))
    decode_ms = statistics.median(ts)
    print(f"eval jpeg: the decoder built in {build_s:.1f} s; {len(manifest)} fixtures decode to "
          f"their manifest's shapes and SHA-256 (imageio's arrays, where the fixtures were written)")
    print(f"timing read_jpeg: {decode_ms:.3f} ms a 1080 x 1920 4:2:0 frame (median of "
          f"{JPEG_TIMED}, min {min(ts):.3f}, host) [{card}]")

    # 14b. SMPL at its published shapes, card vs CPU ------------------------
    models = [make_random_model(6890, 24, 10, seed=s, device=DEVICE) for s in (0, 1, 2)]
    models_cpu = [make_random_model(6890, 24, 10, seed=s, device="cpu") for s in (0, 1, 2)]
    j_reg = rng.uniform(0, 1, (17, 6890)).astype(np.float32)
    j_reg /= j_reg.sum(1, keepdims=True)
    betas = rng.standard_normal((SMPL_BATCH, 10)).astype(np.float32)
    pose = (rng.standard_normal((SMPL_BATCH, 72)) * 0.3).astype(np.float32)
    args = [torch.as_tensor(a) for a in (betas, pose[:, 3:], pose[:, :3])]
    with torch.no_grad():
        got = models[0](*[a.to(DEVICE) for a in args])
        ref = models_cpu[0](*args)
        smpl_err = rel_l2(got["vertices"].cpu(), ref["vertices"])
        joint_err = rel_l2(got["joints"].cpu(), ref["joints"])
        check(smpl_err <= SMPL_TOL and joint_err <= SMPL_TOL,
              f"SMPL card vs CPU: vertices {smpl_err:.3e}, joints {joint_err:.3e} > {SMPL_TOL}")
        dev_args = [a.to(DEVICE) for a in args]
        smpl_ms = cuda_ms(lambda: models[0](*dev_args), 20)
    print(f"eval smpl: make_random_model(6890, 24, 10) (posedirs {tuple(models[0].posedirs.shape)}"
          f"), batch {SMPL_BATCH}, card vs CPU relative L2: vertices {smpl_err:.3e}, joints "
          f"{joint_err:.3e} (bound {SMPL_TOL})")

    # 14c. SpinEvaluator.inference on a 3DPW-schema set ----------------------
    pw = os.path.join(root, "3dpw")
    os.makedirs(pw)
    np.savez(os.path.join(pw, "downtown_walking_00.npz"),
             imgname=np.array([FULL_FRAME] * EVAL_FRAMES),
             center=np.stack([rng.uniform(500, 1400, EVAL_FRAMES),
                              rng.uniform(350, 730, EVAL_FRAMES)], 1).astype(np.float32),
             scale=rng.uniform(1.5, 4.0, EVAL_FRAMES).astype(np.float32),
             pose=(rng.standard_normal((EVAL_FRAMES, 72)) * 0.2).astype(np.float32),
             shape=(rng.standard_normal((EVAL_FRAMES, 10)) * 0.5).astype(np.float32),
             gender=rng.choice(np.array(["m", "f"]), EVAL_FRAMES))
    ds = H.pw3d_dataset(pw, fixtures)
    hmr_p, hmr_s = init_hmr(torch.Generator().manual_seed(3), device=DEVICE)
    ev = H.SpinEvaluator(hmr_p, hmr_s, *models, J_regressor=j_reg)
    timers = {"decode": 0.0, "crop": 0.0, "device": 0.0}
    real_read, real_crop, real_metrics = H.read_image, H.crop, ev._batch_metrics

    def timed(key, fn, sync=False):
        def run(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            timers[key] += time.perf_counter() - t0
            return out
        return run

    batches = []

    def kept(it):
        for b in it:
            batches.append(b)
            yield b

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    real_step = SD.make_ski_finetune_step
    try:
        with torch.inference_mode():  # cuDNN's first calls at these shapes, outside the timing
            real_metrics(torch.zeros(EVAL_BATCH, 3, 224, 224, device=DEVICE),
                         torch.zeros(EVAL_BATCH, 72, device=DEVICE),
                         torch.zeros(EVAL_BATCH, 10, device=DEVICE),
                         torch.zeros(EVAL_BATCH, dtype=torch.int32, device=DEVICE))
        H.read_image, H.crop = timed("decode", real_read), timed("crop", real_crop)
        ev._batch_metrics = timed("device", real_metrics, sync=True)
        F.reset_launches()
        t0 = time.perf_counter()
        res, _ = _quiet(ev.inference, kept(ds.batches(EVAL_BATCH)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(F.LAUNCHES)
        check(not any(launches.values()), f"evaluation launched kernels: {launches}")
        H.read_image, H.crop = real_read, real_crop
        del ev._batch_metrics
        check(all(math.isfinite(v) for v in res.values()), f"inference: {res}")
        ev_cpu = H.SpinEvaluator(_to(torch, hmr_p, "cpu"), _to(torch, hmr_s, "cpu"), *models_cpu,
                                 J_regressor=j_reg)
        res_cpu, _ = _quiet(ev_cpu.inference, batches)
        errs = {k: abs(res[k] - res_cpu[k]) / max(abs(res_cpu[k]), 1e-12) for k in res}
        check(max(errs.values()) <= EVAL_TOL,
              f"inference card vs CPU: {errs} > {EVAL_TOL} (card {res}, CPU {res_cpu})")
        torch.backends.cudnn.allow_tf32 = True
        res_tf32, _ = _quiet(ev.inference, batches)
        torch.backends.cudnn.allow_tf32 = False
        shift = {k: abs(res_tf32[k] - res[k]) / max(abs(res[k]), 1e-12) for k in res}
        n_b = len(batches)
        print(f"eval inference ({EVAL_FRAMES} 3DPW-schema crops of the full-size JPEG, batch "
              f"{EVAL_BATCH}, ResNet-50 HMR at 224, SMPL 6890 x 3 genders): launches {launches}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in res.items()))
        print(f"  card vs CPU with cuDNN TF32 off: max relative {max(errs.values()):.3e} (bound "
              f"{EVAL_TOL}; " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + ")")
        print(f"  with PyTorch's default flags (cuDNN TF32 on): mpjpe moves {shift['mpjpe']:.3e} "
              f"relative ({res_tf32['mpjpe']:.4f} mm), pa_mpjpe {shift['pa_mpjpe']:.3e}, "
              f"posed_mesh_error {shift['posed_mesh_error']:.3e} (a figure, not a check)")

        # the step's device time and the SVD's share of it
        b = batches[0]
        with torch.inference_mode():
            dev_b = (ev._images(b["image"]), ev._upload(b["pose"]), ev._upload(b["betas"]),
                     ev._upload(b["gender"]))
            step_ms = cuda_ms(lambda: ev._batch_metrics(*dev_b), 10)
            pj = torch.randn(EVAL_BATCH, 14, 3, device=DEVICE)
            gj = torch.randn(EVAL_BATCH, 14, 3, device=DEVICE)
            kmat = torch.randn(EVAL_BATCH, 3, 3, device=DEVICE)
            align_ms = cuda_ms(lambda: procrustes_align(pj, gj), 20)
            svd_ms = cuda_ms(lambda: torch.linalg.svd(kmat), 20)
        print(f"timing eval inference: {EVAL_FRAMES / wall:.3f} frames/s ({wall:.3f} s for "
              f"{EVAL_FRAMES} frames, host clock); a batch of {EVAL_BATCH}: decode "
              f"{1e3 * timers['decode'] / n_b:.3f} ms, crop {1e3 * timers['crop'] / n_b:.3f} ms, "
              f"device {1e3 * timers['device'] / n_b:.3f} ms (HMR + 5 SMPL + metrics, "
              f"synchronised), the rest {1e3 * (wall - sum(timers.values())) / n_b:.3f} ms "
              f"(normalise, stack, upload, read-back) [{card}]")
        print(f"timing eval batch on the card (CUDA events, TF32 off): {step_ms:.3f} ms; its "
              f"Procrustes alignment ({EVAL_BATCH} x 14 joints) {align_ms:.3f} ms "
              f"({align_ms / step_ms:.1%}), of which one batched 3 x 3 torch.linalg.svd "
              f"{svd_ms:.3f} ms ({svd_ms / step_ms:.1%} of the batch); SMPL forward "
              f"(batch {SMPL_BATCH}) {smpl_ms:.3f} ms [{card}]")

        # 14d. inference_joints on SKI and 3DHP schemas, the AGORA export ----
        ski_root = os.path.join(root, "ski")
        split = os.path.join(ski_root, "train2", "train")
        seq, cam, frame = (np.arange(SKI_IMAGES) // 16 + 1, (np.arange(SKI_IMAGES) // 4) % 4,
                           np.arange(SKI_IMAGES) % 4)
        yy, xx = np.mgrid[:SKI_HW, :SKI_HW]
        for i in range(SKI_IMAGES):
            d = os.path.join(split, f"seq_{seq[i]:03d}", f"cam_{cam[i]:02d}")
            os.makedirs(d, exist_ok=True)
            img = np.stack([(xx + 7 * i) % 256, (yy + 3 * i) % 256, (xx + yy) // 2 % 256], -1)
            write_png(os.path.join(d, f"image_{frame[i]:06d}.png"), img.astype(np.uint8),
                      compress_level=1)
        write_h5(os.path.join(split, "labels.h5"), {
            "seq": seq.astype(np.int64), "cam": cam.astype(np.int64),
            "frame": frame.astype(np.int64),
            "3D": (rng.standard_normal((SKI_IMAGES, 51)) * 0.3).astype(np.float32),
            "2D": rng.uniform(0, 1, (SKI_IMAGES, 34)).astype(np.float32)})
        t0 = time.perf_counter()
        ski, _ = _quiet(ev.inference_joints,
                        H.SkiDataset(ski_root, "train2/train").batches(EVAL_BATCH),
                        H.SKI_PRED_J14)
        ski_s = time.perf_counter() - t0
        np.savez(os.path.join(root, "mpi_inf_3dhp_valid.npz"),
                 imgname=np.array([FULL_FRAME] * HP3D_FRAMES),
                 center=np.stack([rng.uniform(500, 1400, HP3D_FRAMES),
                                  rng.uniform(350, 730, HP3D_FRAMES)], 1).astype(np.float32),
                 scale=rng.uniform(1.5, 4.0, HP3D_FRAMES).astype(np.float32),
                 S=(rng.standard_normal((HP3D_FRAMES, 24, 4)) * 0.3).astype(np.float32))
        t0 = time.perf_counter()
        hp, _ = _quiet(ev.inference_joints, H.Hp3dDataset(
            os.path.join(root, "mpi_inf_3dhp_valid.npz"), fixtures).batches(EVAL_BATCH),
            H.H36M_TO_J17)
        hp_s = time.perf_counter() - t0
        check(all(math.isfinite(v) for v in (*ski.values(), *hp.values())),
              f"inference_joints: SKI {ski}, 3DHP {hp}")
        ag = os.path.join(root, "agora")
        os.makedirs(ag)
        y, x = np.mgrid[:720, :1280]
        entries = []
        for i in range(AGORA_PEOPLE):
            name = f"ag_{i // 4}.png"
            if i % 4 == 0:
                write_png(os.path.join(ag, name), np.stack(
                    [x * 255 // 1280, y * 255 // 720, (x + 2 * y + 40 * i) % 256], -1
                ).astype(np.uint8), compress_level=1)
            c = rng.uniform([300, 200], [980, 520])
            entries.append({"image_name": name, "2dpose": (c + rng.uniform(-120, 120, (1, 17, 2))
                                                           ).astype(np.float32)})
        with open(os.path.join(root, "dets.pkl"), "wb") as f:
            pickle.dump(entries, f)
        t0 = time.perf_counter()
        n_pkl = ev.export_agora_predictions(H.AgoraDataset(ag, os.path.join(root, "dets.pkl")),
                                            os.path.join(root, "agora_out"))
        ag_s = time.perf_counter() - t0
        pkls = _glob(os.path.join(root, "agora_out"), "*.pkl")
        check(n_pkl == AGORA_PEOPLE == len(pkls), f"AGORA export: {n_pkl} people, {len(pkls)} pkls")
        for path in pkls:
            with open(path, "rb") as f:
                d = pickle.load(f)
            check({k: v.shape for k, v in d.items()} == {"joints": (24, 2), "verts": (6890, 3),
                                                         "allSmplJoints3d": (24, 3)}
                  and all(np.isfinite(v).all() for v in d.values()), f"{path}: {d.keys()}")
        print(f"eval inference_joints: SKI schema ({SKI_IMAGES} PNGs of {SKI_HW}^2, labels.h5 by "
              f"write_h5, INTER_AREA to 224) {ski_s:.3f} s: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ski.items())
              + f"; 3DHP schema ({HP3D_FRAMES} crops of the JPEG) {hp_s:.3f} s: "
              + ", ".join(f"{k} {v:.4f}" for k, v in hp.items()))
        print(f"eval AGORA export: {AGORA_PEOPLE} people in {-(-AGORA_PEOPLE // 4)} PNGs of "
              f"720 x 1280, {len(pkls)} "
              f"pickles read back (joints (24, 2), verts (6890, 3), allSmplJoints3d (24, 3), "
              f"finite) in {ag_s:.3f} s [{card}]")

        # 14e. train_ski ------------------------------------------------------
        steps = []

        def recorded(smpl, J_regressor, **kw):
            opt, step = real_step(smpl, J_regressor, **kw)

            def rec(params, state, opt_state, images, gt, masks):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(params, state, opt_state, images, gt, masks)
                loss = float(out[2]["spin_loss"])
                steps.append({"s": time.perf_counter() - t0, "loss": loss})
                if len(steps) == 1:
                    steps[0]["inputs"] = (images.cpu(), gt.cpu(),
                                          [tuple(m.cpu() for m in pair) for pair in masks])
                return out

            return opt, rec

        SD.make_ski_finetune_step = recorded
        ski_p, ski_s_ = init_hmr(torch.Generator().manual_seed(4), device=DEVICE)
        evals = []
        t0 = time.perf_counter()
        (params, hist), _ = _quiet(SD.train_ski, ski_p, ski_s_, ski_root, models[0], j_reg,
                                   epochs=SKI_EPOCHS, batch_size=SKI_BATCH,
                                   ckpt_dir=os.path.join(root, "ski_ckpt"),
                                   evaluator=lambda p, s: evals.append(1) or {"n": len(evals)})
        ski_train_s = time.perf_counter() - t0
        SD.make_ski_finetune_step = real_step
        n_steps = SKI_EPOCHS * (SKI_IMAGES // SKI_BATCH)
        check(len(steps) == n_steps and len(evals) == SKI_EPOCHS
              and all(math.isfinite(h["ski_loss"]) for h in hist),
              f"train_ski: {len(steps)} steps, {len(evals)} evaluations, history {hist}")
        images, gt, masks = steps[0]["inputs"]
        opt, step = real_step(models_cpu[0], j_reg, lr=5e-5)
        p_cpu = trainable(_to(torch, ski_p, "cpu"))
        _, _, stats = step(p_cpu, _to(torch, ski_s_, "cpu"), opt.init(p_cpu), images, gt, masks)
        loss_cpu = float(stats["spin_loss"])
        loss_err = abs(steps[0]["loss"] - loss_cpu) / max(abs(loss_cpu), 1e-12)
        check(loss_err <= SKI_LOSS_TOL, f"train_ski first step's loss card {steps[0]['loss']} vs "
              f"CPU {loss_cpu}: {loss_err:.3e} > {SKI_LOSS_TOL}")
        ck = dict(np.load(os.path.join(root, "ski_ckpt", f"spin_ski_{SKI_EPOCHS - 1:03d}.npz")))
        p_np, s_np = hmr_to_numpy(params, ski_s_)
        flat = _flatten({"params": p_np, "state": s_np})
        check(sorted(ck) == sorted(flat) and all(np.array_equal(ck[k], flat[k]) for k in flat),
              "spin_ski npz: its arrays differ from the trained params")
        warm = [st["s"] for st in steps[1:]]
        print(f"eval train_ski: {SKI_EPOCHS} epochs of {SKI_IMAGES} SKI samples at batch "
              f"{SKI_BATCH} ({len(steps)} steps, losses "
              + ", ".join(f"{st['loss']:.5f}" for st in steps)
              + f"), the evaluator hook once an epoch; first step's loss card vs CPU "
              f"{loss_err:.3e} (bound {SKI_LOSS_TOL}); spin_ski_{SKI_EPOCHS - 1:03d}.npz reads "
              f"back equal to the trained params ({len(flat)} arrays, JAX's keys)")
        print(f"timing train_ski: {1e3 * statistics.median(warm):.3f} ms a step (median of the "
              f"{len(warm)} after the first, synchronised; the first {1e3 * steps[0]['s']:.3f} "
              f"ms), {ski_train_s:.3f} s for the call with its data [{card}]")
    finally:
        H.read_image, H.crop = real_read, real_crop
        SD.make_ski_finetune_step = real_step
        torch.backends.cudnn.allow_tf32 = tf32


def _same_ingest(tag: str, got, ref) -> str:
    """Two ingests' H5 datasets (read_h5), card against CPU: every image,
    mask and integer array equal, every float array to ING_POSE_TOL relative
    L2. The sampling masks are pruned by the float32 cylinders' radius
    (ingest._prune_sampling_masks_by_cylinder: a pixel whose ray passes
    within rounding of it may flip), so they, and the index lists drawn
    from them, may differ in at most ING_SMASK_FRAC of their pixels ->
    a summary."""
    import numpy as np

    check(sorted(got) == sorted(ref), f"{tag}: keys {sorted(got)} != {sorted(ref)}")
    sm, sm_ref = got["sampling_masks"], ref["sampling_masks"]
    check(sm.shape == sm_ref.shape, f"{tag} sampling_masks: {sm.shape} vs {sm_ref.shape}")
    n_smask = int((sm != sm_ref).sum())
    check(n_smask <= ING_SMASK_FRAC * sm.size,
          f"{tag} sampling_masks: {n_smask} of {sm.size} pixels differ")
    f_err = 0.0
    for k in sorted(ref):
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if k in ("sampling_masks", "sampling_idxs", "sampling_idx_offsets") and n_smask:
            continue  # the index lists follow the masks
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{tag} {k}: {a.dtype} {a.shape} vs the CPU's {b.dtype} {b.shape}")
        if np.issubdtype(b.dtype, np.floating):
            e = float(np.linalg.norm((a - b).astype(np.float64))
                      / max(float(np.linalg.norm(b.astype(np.float64))), 1e-30))
            check(e <= ING_POSE_TOL, f"{tag} {k}: card vs CPU relative L2 {e:.3e} > "
                                     f"{ING_POSE_TOL}")
            f_err = max(f_err, e)
        else:
            check(np.array_equal(a, b), f"{tag} {k}: {int((a != b).sum())} values differ")
    return (f"{len(ref)} keys; images, masks and integer arrays equal, float arrays within "
            f"relative L2 {f_err:.3e} (bound {ING_POSE_TOL}); {n_smask} sampling-mask pixels "
            f"differ")


def ingest_phases(torch, card: str, tmp: str):
    """Phase 15, the data front on raw trees at the datasets' own sizes:
    (a) a SURREAL render dump ingested by the CLI on the card and on the
    CPU, then trained through run_nerf; (b) an H36M-shaped tree segmented by
    DeepLab-v3, background-differenced and ingested; (c) a ZJU tree with
    real-magnitude distortion ingested on the card and on the CPU; (d) the
    loader benchmark. -> launches of every kernel on its main path (the
    training steps and the val render of (a))."""
    import pickle
    import statistics

    import numpy as np
    from scipy.io import savemat

    from posegen_tpu_torch.body.smpl import make_random_model
    from posegen_tpu_torch.cli import run_nerf as RN
    from posegen_tpu_torch.data import catalog as CAT
    from posegen_tpu_torch.data import ingest as ING
    from posegen_tpu_torch.data import masks as MK
    from posegen_tpu_torch.data import segmenter as SG
    from posegen_tpu_torch.data.h5dataset import H5RayDataset, RayBatchLoader
    from posegen_tpu_torch.data.hdf5 import read_h5, write_h5
    from posegen_tpu_torch.data.imutils import undistort_u8
    from posegen_tpu_torch.data.loaders import SURREAL_DATASET_EXT_SCALE, SURREAL_ROT_GLOB
    from posegen_tpu_torch.data.synthetic import _look_at_c2w
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.skeleton.cameras import nerf_c2w_to_extrinsic, world_to_cam
    from posegen_tpu_torch.skeleton.kinematics import smpl_l2ws
    from posegen_tpu_torch.skeleton.rotations import axisang_to_rot
    from posegen_tpu_torch.skeleton.skeleton import SMPL_REST_POSE
    from posegen_tpu_torch.train import trainer as TR
    from posegen_tpu_torch.utils.jpeg import read_jpeg
    from posegen_tpu_torch.utils.png import write_png

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(tmp, "ingest")
    os.makedirs(root)
    rng = np.random.default_rng(15)
    launches = {k: 0 for k in F.LAUNCHES}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    real_make, counted_make = None, None
    try:
        # 15a. SURREAL: a render dump in the real layout ---------------------
        # posed joints and cameras in the ingested (NeRF) world, written in
        # SURREAL's: the ingest scales raw units by s and rotates by SURREAL_ROT_GLOB
        s = SURREAL_DATASET_EXT_SCALE * 0.001
        rot4 = np.eye(4, dtype=np.float32)
        rot4[:3, :3] = SURREAL_ROT_GLOB
        raw = os.path.join(root, "surreal_raw")
        yy, xx = torch.meshgrid(torch.arange(ING_HW, dtype=torch.float32, device=DEVICE),
                                torch.arange(ING_HW, dtype=torch.float32, device=DEVICE),
                                indexing="ij")
        colors = torch.as_tensor(rng.uniform(0.3, 1.0, (24, 1, 1, 3)) * 255, dtype=torch.float32,
                                 device=DEVICE)
        sigma = 2.5 * ING_HW / 64.0
        t0 = time.perf_counter()
        for si in range(ING_SEQS):
            poses = (rng.standard_normal((ING_POSES, 24, 3)) * 0.15).astype(np.float32)
            with torch.no_grad():
                kp = smpl_l2ws(torch.as_tensor(poses),
                               rest_pose=torch.as_tensor(SMPL_REST_POSE * s))[..., :3, 3].numpy()
            centre = kp[:, 0].mean(0)
            thetas = np.linspace(0, 2 * np.pi, ING_CAMS, endpoint=False) + si * np.pi / ING_CAMS
            c2ws = np.stack([_look_at_c2w(centre + np.array([4.5 * np.cos(t), 0.3, 4.5 * np.sin(t)],
                                                            np.float32), centre) for t in thetas])
            cams_raw = rot4[None] @ c2ws
            cams_raw[:, :3, 3] /= s
            seq = os.path.join(raw, f"seq{si:02d}_0")
            sub = os.path.join(seq, "0-1")
            os.makedirs(os.path.join(sub, "imageSequences"))
            segm = np.zeros((ING_CAMS * ING_POSES, ING_HW, ING_HW), np.uint8)
            for c in range(ING_CAMS):
                ext = nerf_c2w_to_extrinsic(c2ws[c])
                for k in range(ING_POSES):
                    pix = torch.as_tensor(world_to_cam(kp[k], ext, ING_HW, ING_HW, ING_FOCAL),
                                          dtype=torch.float32, device=DEVICE)
                    blob = torch.exp(-((yy - pix[:, 1, None, None]) ** 2
                                       + (xx - pix[:, 0, None, None]) ** 2) / (2 * sigma ** 2))
                    img = (blob[..., None] * colors).sum(0).clamp(0, 255).to(torch.uint8)
                    write_png(os.path.join(sub, "imageSequences", f"{c * ING_POSES + k:04d}.png"),
                              img.cpu().numpy(), compress_level=1)
                    segm[c * ING_POSES + k] = (blob.amax(0) > 0.05).cpu().numpy()
            savemat(os.path.join(sub, "001_segm.mat"), {"data": segm})
            with open(os.path.join(seq, "metadata.pkl"), "wb") as f:
                pickle.dump({"focal": ING_FOCAL, "int_scale": 1.0, "render_type": f"ring{si}",
                             "cams": cams_raw, "N_kp": ING_POSES, "N_cams": ING_CAMS,
                             "N_cam_per_subdir": ING_CAMS, "joints3D": (kp @ SURREAL_ROT_GLOB) / s,
                             "poses": poses.reshape(ING_POSES, 72)}, f)
        n_surreal = ING_SEQS * ING_POSES * ING_CAMS
        tree_s = time.perf_counter() - t0
        path = CAT.resolve_h5_path(CAT.DataConfig(dataset="surreal", subject="female",
                                                  data_root=root))
        os.makedirs(os.path.dirname(path))
        t0 = time.perf_counter()
        _quiet(ING.main, ["surreal", raw, path], device=DEVICE)
        torch.cuda.synchronize()
        surreal_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ING.ingest_surreal(raw, os.path.join(root, "surreal_cpu.h5"), device="cpu")
        surreal_cpu_s = time.perf_counter() - t0
        got = read_h5(path)[0]
        check(got["imgs"].shape == (n_surreal, ING_HW, ING_HW, 3)
              and int(got["masks"].sum()) > 0, f"ingested surreal: imgs {got['imgs'].shape}")
        surreal_cmp = _same_ingest("ingest surreal", got,
                                   read_h5(os.path.join(root, "surreal_cpu.h5"))[0])
        print(f"ingest surreal: a render dump of {ING_SEQS} sequences x {ING_POSES} poses x "
              f"{ING_CAMS} cameras of {ING_HW}^2 (metadata.pkl, segm .mat, PNGs; written in "
              f"{tree_s:.1f} s) through ingest.main on the card, against ingest_surreal on the "
              f"CPU: {surreal_cmp}")

        steps = {"steps": 0, "want": STEP_LAUNCHES}
        evals = {"calls": 0}
        real_make, counted_make = _steps_window(torch, F, TR, steps)
        reals, counted_eval = _eval_window(torch, F, IMG, RN, evals)
        TR.make_train_step, RN.evaluate_testset = counted_make, counted_eval
        # the loader in its thread: phase 12 runs the CLI with its 16 workers,
        # whose start costs each call about 50 s (PERF.md section 5)
        argv = ["--config", "configs/surreal/surreal.txt",
                "--datadir", os.path.join(root, "surreal"), "--basedir", os.path.join(root, "logs"),
                "--n_iters", str(ING_ITERS), "--i_testset", str(ING_ITERS),
                "--i_weights", str(ING_ITERS), "--i_print", "10", "--i_video", "0",
                "--num_workers", "0"]
        F.reset_launches()
        t0 = time.perf_counter()
        _, losses, _ = _train_cli(torch, RN, argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        start_s = steps["t_first"] - t0
        for k in launches:
            launches[k] += F.LAUNCHES[k]
        check(steps["steps"] == ING_ITERS and steps.get("first") == 0,
              f"ingested surreal run: {steps['steps']} steps from {steps.get('first')}")
        check(len(losses) == ING_ITERS // 10 and all(map(math.isfinite, losses)),
              f"ingested surreal run: printed losses {losses}")
        ev = dict(evals)
        want = {k: 0 for k in F.LAUNCHES}
        want.update(dual=ev["chunks"], field=ev["chunks"])
        check(ev["calls"] == 1 and ev["launches"] == want,
              f"ingested surreal val: {ev['calls']} calls, launches {ev.get('launches')} != {want}")
        frame = check_val_frame(torch, F, IMG, RN, reals[2], ev, "ingested surreal")
        TR.make_train_step, RN.evaluate_testset = real_make, reals[0]
        IMG._eval_maps, IMG.render_image = reals[1], reals[2]
        real_make = None
        print(f"ingest surreal run: surreal.txt on the ingested file (--num_workers 0), "
              f"{ING_ITERS} steps "
              f"(launches per step {STEP_LAUNCHES}), losses {losses}, val {ev['frames']} frames "
              f"in {ev['chunks']} chunks (dual = field = chunks), {train_s:.1f} s in all, "
              f"{start_s:.1f} s of it from the call to the first step")
        print(f"ingest surreal {frame}")

        # 15b. H36M: DeepLab, background differencing, ingest ------------------
        full = read_jpeg(os.path.join(repo, "tests", "data", "jpeg", FULL_FRAME))
        flipped = np.ascontiguousarray(full[::-1, ::-1])
        hdir = os.path.join(root, "h36m_raw")
        os.makedirs(os.path.join(hdir, "images"))
        offs = [(0, 0), (40, 300), (80, 600), (10, 900)]  # camera 3 has 1002-row frames
        plates, frames, paths = [], [], []
        for c, (y, x) in enumerate(offs[:H36M_CAMS]):
            tall = c == H36M_CAMS - 1
            src = full[y:y + H36M_HW + 2 * tall, x:x + H36M_HW]
            plates.append(src[1:-1] if tall else src)
            for f in range(H36M_FRAMES):  # a 'person': a block of the flipped frame, walking
                img = src.copy()
                py, px = H36M_HW * 3 // 10 + 20 * f, H36M_HW // 10 + H36M_HW * 9 // 100 * f
                ph, pw = H36M_HW * 2 // 5, H36M_HW // 5
                img[py:py + ph, px:px + pw] = flipped[py:py + ph, px:px + pw]
                p = f"images/Walking-{ING.H36M_CAMERAS[c]}_{f:05d}.png"
                write_png(os.path.join(hdir, p), img, compress_level=1)
                paths.append(p)
                frames.append(img[1:-1] if tall else img)
        frames = np.stack(frames)
        plate_of = np.stack([plates[i // H36M_FRAMES] for i in range(len(frames))])
        n_h36m = len(frames)

        segment = SG.deeplab_person_segmenter(device=DEVICE)  # random weights, seed 0
        segment(frames[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        person = np.stack([segment(f) for f in frames])
        seg_s = time.perf_counter() - t0
        pc, sc = SG.init_deeplab(torch.Generator().manual_seed(0), device=DEVICE)
        ph_, sh_ = SG.init_deeplab(torch.Generator().manual_seed(0), device="cpu")
        x = (frames[0][:SEG_HW, :SEG_HW].astype(np.float32) / 255.0 - SG._IMAGENET_MEAN) \
            / SG._IMAGENET_STD
        x = torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))
        with torch.no_grad():
            lg_card = SG.deeplab_logits(pc, sc, x.to(DEVICE)).cpu()
            lg_cpu = SG.deeplab_logits(ph_, sh_, x)
        seg_err = rel_l2(lg_card, lg_cpu)
        check(seg_err <= SEG_TOL, f"DeepLab logits card vs CPU: relative L2 {seg_err:.3e} > "
                                  f"{SEG_TOL}")
        top2 = lg_cpu[0].topk(2, dim=0).values
        knife = (top2[0] - top2[1]) <= SEG_TOL * float(lg_cpu.abs().max())
        person_of = [lg[0].argmax(0) == SG.PERSON_CLASS for lg in (lg_card, lg_cpu)]
        flips = person_of[0] != person_of[1]
        check(not bool((flips & ~knife).any()),
              f"DeepLab person mask card vs CPU: {int((flips & ~knife).sum())} pixels differ "
              "beyond the logits' tolerance")
        t0 = time.perf_counter()
        bg = MK.masks_from_background(frames, plate_of)
        mask_ms = (time.perf_counter() - t0) * 1e3 / n_h36m
        check(all(int(m.sum()) > 0 for m in bg), "masks_from_background: an empty mask")
        # random DeepLab weights mark next to no pixel as a person, so the
        # mask file holds the background-differenced masks
        write_h5(os.path.join(hdir, "S9_mask_deeplab_crop.h5"), {"masks": bg[..., 0]})
        np.save(os.path.join(hdir, "S9_clean_bkgds.npy"), np.stack(plates))
        aa = (rng.standard_normal((n_h36m, 24, 3)) * 0.2).astype(np.float32)
        write_h5(os.path.join(hdir, "S9_SPIN_rect_output-maxmin.h5"), {
            "pred_betas": (rng.standard_normal((n_h36m, 10)) * 0.3).astype(np.float32),
            "pred_rot_mat": axisang_to_rot(torch.from_numpy(aa)).numpy(),
            "bbox_params": np.tile(np.float32([H36M_HW / 2, H36M_HW / 2, H36M_HW * 0.8]),
                                   (n_h36m, 1)),
            "pred_camera": np.stack([np.full(n_h36m, 0.9), rng.uniform(-0.1, 0.1, n_h36m),
                                     np.full(n_h36m, 0.1)], -1).astype(np.float32),
            "joints": (rng.standard_normal((n_h36m, 49, 3)) * 0.3).astype(np.float32),
            "img_path": np.array([p.encode() for p in paths]),
        })
        hout = os.path.join(root, "h36m_S9.h5")
        t0 = time.perf_counter()
        _quiet(ING.main, ["h36m", hdir, hout, "--subject", "S9"], device=DEVICE)
        torch.cuda.synchronize()
        h36m_s = time.perf_counter() - t0
        ds = H5RayDataset(hout, n_rays_per_image=48)
        try:
            check(ds.n_images == n_h36m and (ds.H, ds.W) == (H36M_HW, H36M_HW),
                  f"ingested h36m: {ds.n_images} images of {ds.H} x {ds.W}")
            batch = RayBatchLoader(ds, n_images_per_batch=n_h36m, seed=0).make_batch()
        finally:
            ds.close()
        check(batch["rays_o"].shape == (n_h36m * 48, 3)
              and all(np.isfinite(v).all() for v in batch.values()
                      if np.issubdtype(np.asarray(v).dtype, np.floating)),
              f"ingested h36m batch: rays_o {batch['rays_o'].shape}")
        print(f"ingest h36m: {n_h36m} frames of {H36M_HW}^2 over {H36M_CAMS} cameras (one of "
              f"{H36M_HW + 2} rows, cut by the ingest), crops of {FULL_FRAME} as PNGs, the SPIN "
              f"and mask h5 files by write_h5; DeepLab-v3 (random weights, seed 0) marks "
              f"{float(person.mean()):.2e} of the pixels person, so the mask file holds "
              f"masks_from_background's ({float(bg.mean()):.4f} foreground); logits at "
              f"{SEG_HW}^2 card vs CPU (TF32 off) relative L2 {seg_err:.3e} (bound {SEG_TOL}), "
              f"{int(flips.sum())} person-mask pixels differ, each within the tolerance of a "
              f"top-2 tie; ingest.main on the card, H5RayDataset batch of "
              f"{batch['rays_o'].shape[0]} rays")

        # 15c. ZJU: undistortion and the SMPL conversion ------------------------
        sp = os.path.join(root, "zju_raw", "CoreView_377")
        os.makedirs(os.path.join(sp, "params"))
        Ks, Ds, Rs, Ts, ims = [], [], [], [], []
        for c in range(ZJU_VIEWS):
            f = 1120.0 + 10 * c
            Ks.append(np.array([[f, 0, ZJU_HW / 2 + 3 * c], [0, f * 1.001, ZJU_HW / 2 - 2 * c],
                                [0, 0, 1]]))
            Ds.append(np.array([[-0.2 - 0.02 * c], [0.1], [1e-3], [-1e-3], [0.0]]))
            Rs.append(axisang_to_rot(torch.tensor([0.0, 2 * np.pi * c / ZJU_VIEWS, 0.0],
                                                  dtype=torch.float64)).numpy())
            Ts.append(np.array([[0.0], [0.0], [2800.0]]))
        for fi in range(ZJU_FRAMES):
            frame = []
            for v in range(ZJU_VIEWS):
                p = f"images/Camera_B{v + 1}/{fi:06d}.png"
                os.makedirs(os.path.join(sp, os.path.dirname(p)), exist_ok=True)
                y, x = 8 * fi, min(200 * v + 20 * fi, full.shape[1] - ZJU_HW)
                write_png(os.path.join(sp, p), full[y:y + ZJU_HW, x:x + ZJU_HW],
                          compress_level=1)
                mp = p.replace("images", "mask")
                os.makedirs(os.path.join(sp, os.path.dirname(mp)), exist_ok=True)
                m = np.zeros((ZJU_HW, ZJU_HW), np.uint8)
                m[ZJU_HW // 5:ZJU_HW * 4 // 5, ZJU_HW * 2 // 5:ZJU_HW * 3 // 5] = 255
                write_png(os.path.join(sp, mp), m, compress_level=1)
                frame.append(p)
            ims.append({"ims": frame})
            np.save(os.path.join(sp, "params", f"{fi}.npy"), {
                "poses": (rng.standard_normal((1, 72)) * 0.2).astype(np.float32),
                "shapes": (rng.standard_normal((1, 10)) * 0.5).astype(np.float32),
                "Rh": (rng.standard_normal((1, 3)) * 0.2).astype(np.float32),
                "Th": (rng.standard_normal((1, 3)) * 0.3).astype(np.float32),
            })
        np.save(os.path.join(sp, "annots.npy"),
                {"cams": {"K": Ks, "D": Ds, "R": Rs, "T": Ts}, "ims": ims})
        n_zju = ZJU_VIEWS * ZJU_FRAMES
        zout, zcpu = os.path.join(root, "zju_377.h5"), os.path.join(root, "zju_377_cpu.h5")
        views = tuple(range(ZJU_VIEWS))
        model = make_random_model(6890, 24, 10, seed=0, device=DEVICE)
        t0 = time.perf_counter()
        ING.ingest_zju(os.path.dirname(sp), zout, subject="377", smpl_model=model,
                       training_views=views, device=DEVICE)
        torch.cuda.synchronize()
        zju_s = time.perf_counter() - t0
        ING.ingest_zju(os.path.dirname(sp), zcpu, subject="377",
                       smpl_model=make_random_model(6890, 24, 10, seed=0, device="cpu"),
                       training_views=views, device="cpu")
        zgot = read_h5(zout)[0]
        check(zgot["imgs"].shape == (n_zju, ZJU_HW, ZJU_HW, 3), f"zju imgs {zgot['imgs'].shape}")
        zju_cmp = _same_ingest("ingest zju", zgot, read_h5(zcpu)[0])
        src = full[:ZJU_HW, :ZJU_HW]
        ts = []
        for _ in range(UNDISTORT_TIMED):
            t0 = time.perf_counter()
            undistort_u8(src, Ks[0], Ds[0].reshape(-1))
            ts.append((time.perf_counter() - t0) * 1e3)
        print(f"ingest zju: {ZJU_VIEWS} views x {ZJU_FRAMES} frames of {ZJU_HW}^2 (k1 -0.2 .. "
              f"{-0.2 - 0.02 * (ZJU_VIEWS - 1):.2f}), make_random_model(6890, 24, 10) on the "
              f"card, against the CPU: {zju_cmp}")

        # 15d. the loader benchmark, in a process that initialises no CUDA
        # (its numpy variant's workers must fork) ---------------------------
        loader = []
        for w in LOADER_WORKERS:
            out = subprocess.run(
                [sys.executable, "-m", "posegen_tpu_torch.data.bench_loader", "--h5", path,
                 "--num_workers", str(w)], cwd=repo, capture_output=True, text=True, timeout=600)
            check(out.returncode == 0, f"bench_loader --num_workers {w}: {out.stderr[-2000:]}")
            rows = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
            check([r["variant"] for r in rows] == ["native", "numpy"],
                  f"bench_loader --num_workers {w}: {out.stdout[-2000:]}")
            loader += rows
        for r in loader:
            print(f"timing bench_loader {r['variant']}, --num_workers {r['num_workers']} "
                  f"({r['workers_started']} started): {r['batches_per_s']:.3f} batches/s, "
                  f"{r['rays_per_s']:.1f} rays/s ({r['n_rand']} rays over {r['n_sample_images']} "
                  f"of the ingested {ING_HW}^2 images, host) [{card}]")
        print(f"timing ingest (host clock, per 100 images): surreal "
              f"{surreal_s / n_surreal * 100:.3f} s on the card, {surreal_cpu_s / n_surreal * 100:.3f} s on the CPU; h36m "
              f"{h36m_s / n_h36m * 100:.3f} s; zju {zju_s / n_zju * 100:.3f} s [{card}]")
        print(f"timing segmenter: DeepLab-v3 {n_h36m / seg_s:.3f} frames/s at {H36M_HW}^2 (TF32 "
              f"off, host normalisation and readback included) [{card}]")
        print(f"timing undistort_u8: {statistics.median(ts):.3f} ms a {ZJU_HW}^2 RGB frame "
              f"(median of {UNDISTORT_TIMED}, host); masks_from_background {mask_ms:.3f} ms a "
              f"{H36M_HW}^2 frame (host) [{card}]")
        print(f"timing phase 15: {time.perf_counter() - t_phase:.1f} s [{card}]")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        if real_make is not None:
            TR.make_train_step, RN.evaluate_testset = real_make, reals[0]
            IMG._eval_maps, IMG.render_image = reals[1], reals[2]
    return launches


def _body_file_data(rng, V, J, F, n_shapecols, parents=None):
    """A random body model in the official key layout (float32 arrays; the
    draws of tests/test_body_models.py's files)."""
    import numpy as np

    if parents is None:
        parents = np.zeros(J, np.int64)
        for j in range(1, J):
            parents[j] = rng.integers(0, j)
    kintree = np.stack([parents.astype(np.uint32), np.arange(J, dtype=np.uint32)])
    kintree[0, 0] = np.uint32(4294967295)  # official files store -1 as uint32
    J_reg = rng.random((J, V))
    w = np.exp(rng.standard_normal((V, J)) * 2)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return {
        "v_template": f32(rng.standard_normal((V, 3)) * 0.1),
        "shapedirs": f32(rng.standard_normal((V, 3, n_shapecols)) * 0.01),
        "posedirs": f32(rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001),
        "J_regressor": f32(J_reg / J_reg.sum(1, keepdims=True)),
        "kintree_table": kintree,
        "weights": f32(w / w.sum(1, keepdims=True)),
        "f": rng.integers(0, V, (F, 3)).astype(np.int64),
    }


def _lmk_tables(rng, F, n):
    """(n,) face ids and (n, 3) barycentrics of a landmark embedding."""
    import numpy as np

    b = rng.uniform(0.05, 1.0, (n, 3))
    return rng.integers(0, F, (n,)).astype(np.int64), (b / b.sum(1, keepdims=True)).astype(
        np.float32)


def tooling_phases(torch, card: str, runs):
    """Phase 16, tooling and the SMPL family: (a) the spiral GIFs of phase
    12's run through the eval kernels, read back, and phase 13's
    render_rgb.gif; (b) the turntable of phase 13's mesh through
    render_mesh.main; (c) SMPL-X, MANO and FLAME at their published shapes,
    card vs CPU; (d) the transfer fit, card vs CPU, the default schedule's
    error, and transfer.main; (e) the profiler trace, the phase timer and
    the memory stats. -> the eval kernels' launches (the spiral and the
    traced renders)."""
    import pickle
    import types

    import numpy as np

    from posegen_tpu_torch.body import models as BM
    from posegen_tpu_torch.body import transfer as BT
    from posegen_tpu_torch.body.smpl import make_random_model
    from posegen_tpu_torch.cli import render_mesh as RM
    from posegen_tpu_torch.cli import run_nerf as RN
    from posegen_tpu_torch.cli import run_render as RR
    from posegen_tpu_torch.cli.config import args_to_data_config
    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render import rasterizer as RAST
    from posegen_tpu_torch.render.mesh import save_ply
    from posegen_tpu_torch.render.raycast import RaycastConfig, render_rays
    from posegen_tpu_torch.utils import profiling as PROF
    from posegen_tpu_torch.utils.fixtures import make_problem
    from posegen_tpu_torch.utils.gif import quantized_frames, read_gif, write_gif
    from posegen_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    out_root = os.path.join(runs["tmp"], "tooling")
    os.makedirs(out_root)
    launches = {"dual": 0, "field": 0}
    timer = PROF.PhaseTimer()
    rec = {"chunks": 0, "plain": 0, "rays_max": 0}
    real_maps = _counted_chunks(torch, F, IMG, rec)
    real_path, real_turntable = IMG.render_path, RAST.turntable_render
    u8 = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8)  # noqa: E731
    rel = lambda a, b: float(torch.linalg.vector_norm(a.double().cpu() - b.double().cpu())  # noqa
                             / torch.linalg.vector_norm(b.double().cpu()).clamp_min(1e-30))
    try:
        # 16a. the spiral GIFs through the eval kernels, and render_rgb.gif
        with timer.phase("videos"):
            args_txt = os.path.join(runs["surreal_log"], "args.txt")
            targs, cfg, variables = RR.load_trained(args_txt, runs["surreal_ckpt"],
                                                    device=DEVICE)
            dcfg = args_to_data_config(targs)
            dcfg.num_val_images = 2
            loader, render_data, _ = load_data(dcfg)
            loader.close()
            seen = []

            def path(*args, **kwargs):
                seen.append(real_path(*args, **kwargs))
                return seen[-1]

            IMG.render_path = path
            rec["chunks"] = 0
            F.reset_launches()
            t0 = time.perf_counter()
            rgb_path = RN.save_spiral_video(
                cfg, types.SimpleNamespace(params=variables, embeds={}), render_data, out_root,
                CLI_ITERS, n_frames=SPIRAL_FRAMES, factor=2)
            spiral_s = time.perf_counter() - t0
            IMG.render_path = real_path
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
            for k in launches:
                launches[k] += got[k]
            check(len(seen) == 1 and got["dual"] == got["field"] == rec["chunks"] > 0
                  and sum(got.values()) == 2 * rec["chunks"],
                  f"save_spiral_video: launches {got}, {rec['chunks']} chunks")
            out = seen[0]
            rgb = u8(out["rgbs"])
            disp = u8(out["disps"] / max(float(out["disps"].max()), 1e-8))
            H, W = render_data["hwf"][:2]
            check(rgb.shape[:3] == (SPIRAL_FRAMES, H // 2, W // 2), f"spiral frames {rgb.shape}")
            t0 = time.perf_counter()
            back_rgb = read_gif(rgb_path)
            read_ms = (time.perf_counter() - t0) * 1e3 / len(rgb)
            back_disp = read_gif(os.path.join(out_root, f"spiral_{CLI_ITERS:06d}_disp.gif"))
            check(np.array_equal(back_disp, np.repeat(disp[..., None], 3, -1)),
                  "spiral disparity GIF: not its grey frames")
            check(np.array_equal(back_rgb, quantized_frames(rgb)),
                  "spiral rgb GIF: not the writer's quantisation of its frames")
            n_colours = max(len(np.unique(f.reshape(-1, 3), axis=0)) for f in rgb)
            t0 = time.perf_counter()
            write_gif(os.path.join(out_root, "timed.gif"), rgb, fps=5)
            write_ms = (time.perf_counter() - t0) * 1e3 / len(rgb)
            val_dir = runs["val_dir"]
            pngs = _glob(os.path.join(val_dir, "image"), "*.png")
            frames = read_gif(os.path.join(val_dir, "render_rgb.gif"))
            check(len(frames) == len(pngs) > 0
                  and all(np.array_equal(f, quantized_frames(read_png(p)[None])[0])
                          for f, p in zip(frames, pngs)),
                  f"run_render's render_rgb.gif: {len(frames)} frames for {len(pngs)} PNGs, "
                  "or a frame that is not its PNG's quantisation")
        print(f"tooling spiral (save_spiral_video, {SPIRAL_FRAMES} frames at factor 2, "
              f"{rgb.shape[1]}x{rgb.shape[2]}): {rec['chunks']} chunks, dual = field = chunks; the "
              f"disparity GIF reads back as its grey frames, the rgb GIF (up to {n_colours} colours "
              f"a frame) as the writer's quantisation; run_render val's render_rgb.gif "
              f"({len(frames)} frames of {frames.shape[1]}^2) as its PNGs' quantisation")

        # 16b. the turntable of phase 13's mesh through render_mesh.main -----
        with timer.phase("turntable"):
            views = {}

            def turntable(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                views["frames"] = real_turntable(*args, **kwargs)
                views["s"] = time.perf_counter() - t0
                return views["frames"]

            RAST.turntable_render = turntable
            tt_dir, tt_out = _quiet(RM.main, ["--ply", runs["mesh_ply"], "--outputdir",
                                              os.path.join(out_root, "turntable")], device=DEVICE)
            RAST.turntable_render = real_turntable
            tt = views["frames"]
            pngs = _glob(tt_dir, "*.png")
            check(tt.shape == (12, 256, 256, 3) and len(pngs) == 12
                  and all(np.array_equal(read_png(p), u8(f)) for p, f in zip(pngs, tt)),
                  f"render_mesh: {tt.shape} frames, {len(pngs)} PNGs, or a PNG not its frame")
            check((tt != 1.0).any(axis=-1).mean() > 0.01, "render_mesh: the views are empty")
            verts, faces = RM.load_ply(runs["mesh_ply"])
            t0 = time.perf_counter()
            cpu_view = real_turntable(verts, faces, n_views=1, device="cpu")[0]
            cpu_ms = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(cpu_view, tt[0]), "render_mesh: the CPU's view 0 differs from "
                  f"the card's in {int((cpu_view != tt[0]).any(-1).sum())} pixels")
        mp4 = os.path.exists(os.path.join(tt_dir, "turntable.mp4"))
        check(mp4 or "turntable.mp4 not written" in tt_out,
              "render_mesh: no mp4 and no word of it")
        print(f"tooling turntable (render_mesh.main, phase 13's mesh: {len(verts)} vertices, "
              f"{len(faces)} faces): 12 views of 256^2, every PNG equal to its frame, view 0 "
              f"on the CPU equal to the card's; turntable.mp4 {'written' if mp4 else 'not written, as it said'}")

        # 16c. SMPL-X, MANO and FLAME at their published shapes -------------
        with timer.phase("body models"):
            rng = np.random.default_rng(SEED)
            bdir = os.path.join(out_root, "body")
            os.makedirs(bdir)
            smplx = _body_file_data(rng, 10475, 55, 20908, 20)  # 10 shape + 10 expression
            lmk_idx, lmk_b = _lmk_tables(rng, 20908, 51)
            dyn = [_lmk_tables(rng, 20908, 17) for _ in range(79)]
            smplx.update(
                hands_componentsl=(rng.standard_normal((45, 45)) * 0.5).astype(np.float32),
                hands_componentsr=(rng.standard_normal((45, 45)) * 0.5).astype(np.float32),
                hands_meanl=(rng.standard_normal(45) * 0.1).astype(np.float32),
                hands_meanr=(rng.standard_normal(45) * 0.1).astype(np.float32),
                lmk_faces_idx=lmk_idx, lmk_bary_coords=lmk_b,
                dynamic_lmk_faces_idx=np.stack([d[0] for d in dyn]),
                dynamic_lmk_bary_coords=np.stack([d[1] for d in dyn]))
            np.savez(os.path.join(bdir, "SMPLX_NEUTRAL.npz"), **smplx)
            mano = _body_file_data(rng, 778, 16, 1538, 10)
            mano.update(hands_components=(rng.standard_normal((45, 45)) * 0.5).astype(np.float32),
                        hands_mean=(rng.standard_normal(45) * 0.1).astype(np.float32))
            with open(os.path.join(bdir, "MANO_RIGHT.pkl"), "wb") as f:
                pickle.dump(mano, f)
            flame = _body_file_data(rng, 5023, 5, 9976, 400,  # 300 shape + 100 expression
                                    parents=np.array([0, 0, 1, 1, 1], np.int64))
            with open(os.path.join(bdir, "FLAME_NEUTRAL.pkl"), "wb") as f:
                pickle.dump(flame, f)
            lmk_idx, lmk_b = _lmk_tables(rng, 9976, 51)
            with open(os.path.join(bdir, "flame_static_embedding.pkl"), "wb") as f:
                pickle.dump({"lmk_face_idx": lmk_idx, "lmk_b_coords": lmk_b}, f)
            dyn = [_lmk_tables(rng, 9976, 17) for _ in range(79)]
            np.save(os.path.join(bdir, "flame_dynamic_embedding.npy"),
                    {"lmk_face_idx": np.stack([d[0] for d in dyn]),
                     "lmk_b_coords": np.stack([d[1] for d in dyn])}, allow_pickle=True)
            n = lambda *s, scale=0.3: torch.as_tensor(  # noqa: E731
                (rng.standard_normal(s) * scale).astype(np.float32))
            Bn = BODY_BATCH
            go = n(Bn, 3, scale=0.5)
            # head y rotations over +-69 degrees: the contour's bins, its clip at 39 and 78
            go[:, 1] = torch.as_tensor(np.linspace(-1.2, 1.2, Bn, dtype=np.float32))
            families = {
                "SMPL-X": (lambda dev: BM.load_smplx_model(
                    os.path.join(bdir, "SMPLX_NEUTRAL.npz"), num_pca_comps=12,
                    use_face_contour=True, device=dev),
                    dict(betas=n(Bn, 10, scale=0.5), body_pose=n(Bn, 63), global_orient=go,
                         left_hand_pose=n(Bn, 12), right_hand_pose=n(Bn, 12),
                         jaw_pose=n(Bn, 3, scale=0.1), leye_pose=n(Bn, 3, scale=0.1),
                         reye_pose=n(Bn, 3, scale=0.1), expression=n(Bn, 10, scale=0.5),
                         transl=n(Bn, 3, scale=1.0)), (10475, 144)),
                "MANO": (lambda dev: BM.load_mano_model(
                    os.path.join(bdir, "MANO_RIGHT.pkl"), num_pca_comps=6, device=dev),
                    dict(betas=n(Bn, 10, scale=0.5), hand_pose=n(Bn, 6), global_orient=n(Bn, 3),
                         transl=n(Bn, 3, scale=1.0)), (778, 16)),
                "FLAME": (lambda dev: BM.load_flame_model(
                    os.path.join(bdir, "FLAME_NEUTRAL.pkl"),
                    landmark_path=os.path.join(bdir, "flame_static_embedding.pkl"),
                    contour_path=os.path.join(bdir, "flame_dynamic_embedding.npy"), device=dev),
                    dict(betas=n(Bn, 10, scale=0.5), global_orient=n(Bn, 3, scale=0.4),
                         neck_pose=n(Bn, 3, scale=0.2), jaw_pose=n(Bn, 3, scale=0.1),
                         leye_pose=n(Bn, 3, scale=0.1), reye_pose=n(Bn, 3, scale=0.1),
                         expression=n(Bn, 10, scale=0.5)), (5023, 5 + 51 + 17)),
            }
            body_rows = []
            for name, (load, args, (V, J)) in families.items():
                m_card, m_cpu = load(DEVICE), load("cpu")
                on_card = {k: v.to(DEVICE) for k, v in args.items()}
                with torch.no_grad():
                    got = m_card(**on_card)
                    ref = m_cpu(**args)
                    torch.cuda.synchronize()
                    errs = {k: rel(got[k], ref[k]) for k in ("vertices", "joints", "full_pose")}
                    check(tuple(got["vertices"].shape) == (Bn, V, 3)
                          and tuple(got["joints"].shape) == (Bn, J, 3)
                          and all(torch.isfinite(got[k]).all() for k in got)
                          and max(errs.values()) <= BODY_TOL,
                          f"{name}: {tuple(got['vertices'].shape)}, {tuple(got['joints'].shape)}, "
                          f"card vs CPU {errs} (> {BODY_TOL})")
                    ms = cuda_ms(lambda: m_card(**on_card), BODY_TIMED)
                body_rows.append((name, V, J, errs, ms))
                print(f"tooling {name} (V {V}, {J} joints, batch {Bn}): card vs CPU relative L2 "
                      + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
                del m_card, m_cpu

        # 16d. the transfer fit at SMPL's shapes ----------------------------
        with timer.phase("transfer"):
            frng = np.random.default_rng(SEED + 1)
            model = make_random_model(6890, 24, 10, seed=SEED, device=DEVICE)
            faces = frng.choice(6890, (13776 * 2, 3))
            ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (
                faces[:, 0] != faces[:, 2])
            model.faces = faces[ok][:13776].astype(np.int64)
            pose = torch.as_tensor((frng.standard_normal((FIT_MESHES, 69)) * 0.2).astype(np.float32))
            orient = torch.as_tensor((frng.standard_normal((FIT_MESHES, 3)) * 0.2).astype(
                np.float32))
            with torch.no_grad():
                target = model(torch.zeros(FIT_MESHES, 10, device=DEVICE), pose.to(DEVICE),
                               orient.to(DEVICE))["vertices"].cpu().numpy()
            short = BT.FitConfig(**FIT_SHORT)
            p_card, l_card = BT.run_fitting(model, target, cfg=short, device=DEVICE)
            cpu_model = make_random_model(6890, 24, 10, seed=SEED, device="cpu")
            cpu_model.faces = model.faces
            p_cpu, l_cpu = BT.run_fitting(cpu_model, target, cfg=short, device="cpu")
            # the CPU's own response to the targets moved by one float32 ulp
            p_ulp, _ = BT.run_fitting(cpu_model, np.nextafter(target, np.float32(np.inf)),
                                      cfg=short, device="cpu")

            def fitted(m, p):
                with torch.no_grad():
                    dev = m.v_template.device
                    return m(**{k: torch.as_tensor(x, device=dev) for k, x in p.items()})[
                        "vertices"]

            fit_errs = {"vertices": rel(fitted(model, p_card), fitted(cpu_model, p_cpu))}
            fit_errs.update({k: abs(l_card[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu})
            param_errs = {k: rel(torch.as_tensor(p_card[k]), torch.as_tensor(p_cpu[k]))
                          for k in p_cpu}
            ulp_errs = {k: rel(torch.as_tensor(p_ulp[k]), torch.as_tensor(p_cpu[k]))
                        for k in p_cpu}
            check(list(p_card) == list(p_cpu) and all(np.isfinite(x).all() for x in p_card.values())
                  and max(fit_errs.values()) <= FIT_TOL,
                  f"run_fitting {FIT_SHORT}: card vs CPU {fit_errs} (> {FIT_TOL})")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, losses = BT.run_fitting(model, target, device=DEVICE)
            fit_s = time.perf_counter() - t0
            cfg_d = BT.FitConfig()
            n_steps = 23 * cfg_d.part_steps + cfg_d.transl_steps + cfg_d.vertex_steps

            def v2v(p):
                with torch.no_grad():
                    v = model(**{k: torch.as_tensor(x, device=DEVICE) for k, x in p.items()})
                return float(np.linalg.norm(v["vertices"].cpu().numpy() - target, axis=-1).mean())

            start = {k: np.zeros_like(x) for k, x in params.items()}
            err_fit, err_start = v2v(params), v2v(start)
            check(err_fit * 10 <= err_start, f"run_fitting: v2v {err_fit:.4e} against the zero "
                  f"start's {err_start:.4e}: not 10x lower")
            # the CLI on the same meshes, written as .ply, and the model as a .pkl
            mdir = os.path.join(out_root, "meshes")
            os.makedirs(mdir)
            for i, v in enumerate(target):
                save_ply(os.path.join(mdir, f"m{i}.ply"), v, model.faces)
            m = {k: getattr(model, k).cpu().numpy() for k in
                 ("v_template", "shapedirs", "J_regressor", "lbs_weights")}
            with open(os.path.join(out_root, "smpl.pkl"), "wb") as f:
                pickle.dump({"v_template": m["v_template"], "shapedirs": m["shapedirs"],
                             "posedirs": model.posedirs.cpu().numpy().T.reshape(6890, 3, -1),
                             "J_regressor": m["J_regressor"], "weights": m["lbs_weights"],
                             "kintree_table": np.stack([model.parents, np.arange(24)]),
                             "f": model.faces}, f)
            fits = os.path.join(out_root, "fits.npz")
            _quiet(BT.main, ["--target-model", os.path.join(out_root, "smpl.pkl"), "--mesh-dir",
                             mdir, "--out", fits], device=DEVICE)
            npz = np.load(fits)
            check(npz.files == TRANSFER_KEYS and npz["betas"].shape == (FIT_MESHES, 10)
                  and len(npz["mesh_paths"]) == FIT_MESHES,
                  f"transfer.main: keys {npz.files} (JAX's {TRANSFER_KEYS})")
            err_cli = v2v({k: npz[k] for k in TRANSFER_KEYS[:-1]})
            check(err_cli * 10 <= err_start, f"transfer.main: v2v {err_cli:.4e}")
        print(f"tooling run_fitting (SMPL shapes: 6890 vertices, 24 joints, {len(model.faces)} "
              f"faces; {FIT_MESHES} meshes posed at sigma 0.2 rad): {FIT_SHORT} card vs CPU, "
              "relative: " + ", ".join(f"{k} {e:.3e}" for k, e in fit_errs.items())
              + "; the params (not held: Adam's first steps turn rounding in near-zero "
              "gradients into steps) " + ", ".join(f"{k} {e:.3e}" for k, e in param_errs.items())
              + ", the CPU's own under a one-ulp move of the targets "
              + ", ".join(f"{k} {e:.3e}" for k, e in ulp_errs.items())
              + f"; the default schedule's mean v2v {err_fit:.4e} against the zero start's "
              f"{err_start:.4e}, vertex loss {losses['vertex_loss']:.4e}; transfer.main wrote "
              f"{npz.files}, mean v2v {err_cli:.4e}")

        # 16e. the profiler trace, the phase timer and the memory stats -----
        pcfg, pparams, ctx, rays_o, rays_d = make_problem(RaycastConfig(), n_rays=N_RAYS,
                                                          seed=SEED, device=DEVICE)
        F.reset_launches()
        with torch.no_grad(), PROF.trace(os.path.join(out_root, "trace")) as tr:
            for _ in range(3):
                with PROF.annotate("render"):
                    render_rays(pcfg, pparams, rays_o, rays_d, ctx, perturb=0.0,
                                raw_noise_std=0.0, coarse_rgb=False)
            torch.cuda.synchronize()
        got = dict(F.LAUNCHES)
        check(got["dual"] == got["field"] == 3 and sum(got.values()) == 6,
              f"traced renders: launches {got}")
        for k in launches:
            launches[k] += got[k]
        with open(tr.path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        kern = {k: sorted(x for x in names if f"eval_sm90_kernel<{i}, 0>" in x)
                for k, i in (("dual", 2), ("field", 0))}
        check(all(kern.values()) and "render" in names,
              f"trace {tr.path}: eval kernels {kern}, 'render' {'render' in names}")
        mem = PROF.device_memory_stats()
        total_mb = torch.cuda.get_device_properties(0).total_memory / 2 ** 20
        check(bool(mem) and 0 < mem["mb_in_use"] <= mem["peak_mb_in_use"] <= mem["mb_limit"]
              and mem["mb_limit"] == total_mb, f"device_memory_stats: {mem}, total {total_mb}")
        print(f"tooling trace ({os.path.getsize(tr.path)} bytes of Chrome trace, 3 renders "
              f"of {N_RAYS} rays each in annotate('render')): dual {kern['dual'][:1]}, "
              f"field {kern['field'][:1]}, the 'render' region; device_memory_stats "
              + ", ".join(f"{k} {v:.1f}" for k, v in mem.items()))
        print(f"tooling PhaseTimer: {timer.summary()}")

        print(f"timing GIF codec ({rgb.shape[1]}x{rgb.shape[2]} rgb, host): write_gif "
              f"{write_ms:.3f} ms a frame (quantise + LZW), read_gif {read_ms:.3f} ms a frame; "
              f"save_spiral_video {spiral_s:.3f} s for {SPIRAL_FRAMES} frames [{card}]")
        print(f"timing rasterizer (render_mesh.main's 12 views of 256^2): "
              f"{views['s'] * 1e3 / 12:.3f} ms a view on the card, {cpu_ms:.3f} ms the one "
              f"view on the CPU [{card}]")
        for name, V, J, errs, ms in body_rows:
            print(f"timing {name} forward (V {V}, batch {BODY_BATCH}, CUDA events, TF32 off): "
                  f"{ms:.3f} ms a batch [{card}]")
        print(f"timing run_fitting (default FitConfig, {FIT_MESHES} meshes of 6890 vertices): "
              f"{fit_s:.3f} s a fit, {n_steps} Adam steps, {n_steps / fit_s:.1f} steps/s "
              f"[{card}]")
        print(f"timing phase 16: {time.perf_counter() - t_phase:.1f} s [{card}]")
    finally:
        IMG._eval_maps, IMG.render_path = real_maps, real_path
        RAST.turntable_render = real_turntable
    return launches

def grouped_phases(torch, card: str):
    """Phase 17, kernel 2's grouped poses and per-ray view ladder: (a) the
    grouped modes against their plain versions; (b) one grouped launch
    against the single-pose launches it replaces, bit for bit; (c)
    render_rays(use_fused=True) on a grouped batch, through the launch
    counters, against the plain pipeline; (d) the ray ladder against the
    per-point mode, bit for bit, and where it stays off; (e) times. -> the
    `kernels` rows of field_grouped and field_ray_ladder."""
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import (
        PoseCtx, RaycastConfig, encode_inputs, init_raycaster, render_rays,
    )
    from posegen_tpu_torch.utils.fixtures import make_problem

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED)
    cfg = RaycastConfig()
    params = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    cfg_fc = RaycastConfig(opt_framecode=True, n_framecodes=4)
    params_fc = init_raycaster(cfg_fc, torch.Generator().manual_seed(SEED), device=DEVICE)
    cfg_42 = RaycastConfig(multires=4, multires_views=2)
    params_42 = init_raycaster(cfg_42, torch.Generator().manual_seed(SEED), device=DEVICE)
    layout = lambda c: F.net_layout(c.netdepth, c.multires, c.multires_views)  # noqa: E731

    def grouped_batch(n_groups, rpg, n_s, seed):
        """(ctx with a pose row per group and a cylinder per ray, rays_o,
        rays_d, points (N * n_s, 3)) of a train_batch."""
        b = train_batch(torch, n_groups, rpg, seed)
        ctx = PoseCtx(kps=b["kp3d"], skts=b["skts"], bones=b["bones"],
                      cyls=b["cyls"].repeat_interleave(rpg, 0))
        near, far = samp.get_near_far_in_cylinder(b["rays_o"], b["rays_d"], ctx.cyls,
                                                  near=cfg.near, far=cfg.far)
        z = samp.sample_from_lineseg(near, far, n_s)
        pts = (b["rays_o"][:, None] + b["rays_d"][:, None] * z[..., None]).reshape(-1, 3)
        return ctx, b["rays_o"], b["rays_d"], pts.contiguous()

    def grouped_net(c, v, ctx, codes=None):
        """(pose table, packed net, view-bias rows) of config c's fine net."""
        poses = F.pack_poses(ctx.skts, v["embed_kp"], c.multires, c.multires_views)
        return (poses, *F.prepare_net_grouped(v["fine"], layout(c), codes))

    with torch.no_grad():
        # 17a. the grouped modes against their plain versions ---------------
        err_grouped = 0.0
        for tag, G, rpg, n_s in GROUP_SHAPES:
            ctx, _, rd, pts = grouped_batch(G, rpg, n_s, SEED)
            codes = torch.randn((G, cfg_fc.framecode_ch), generator=gen).to(DEVICE)
            for net_tag, operands in (
                    ("framecode net, a code per group", grouped_net(cfg_fc, params_fc, ctx, codes)),
                    ("multires 4 / 2", grouped_net(cfg_42, params_42, ctx))):
                poses, net, bview = operands
                errs = []
                for density_only in (False, True):
                    k = F.fused_field(pts, rd, n_s, poses, net, density_only, bview=bview)
                    p = F.field_plain(pts, rd, n_s, poses, net, density_only, mm_dtype=bf16,
                                      bview=bview)
                    torch.cuda.synchronize()
                    errs.append(compare(f"grouped {tag} {net_tag} density_only={density_only}",
                                        k, p))
                    if density_only:
                        check(bool(torch.equal(k[:, 3], full[:, 3])),
                              f"grouped {tag} {net_tag}: density_only sigma != the full mode's")
                        check(float(k[:, :3].abs().max()) == 0.0,
                              f"grouped {tag} {net_tag}: density_only rgb rows not zero")
                    full = k
                err_grouped = max(err_grouped, *errs)
                print(f"grouped vs plain, {tag} ({G} groups x {rpg} rays x {n_s} samples, "
                      f"{pts.shape[0]} points), {net_tag}: max|diff| full {errs[0]:.3e}, "
                      f"density_only {errs[1]:.3e} (its sigma == full's)")
        G, rpg = GROUP_SHAPES[2][1:3]
        ctx, _, rd, _ = grouped_batch(G, rpg, 1, SEED)
        try:
            F.fused_run_net(cfg_fc, params_fc["fine"], params_fc["embed_kp"],
                            torch.zeros((G * rpg, 80, 3), device=DEVICE), rd, ctx)
            check(False, "grouped h36m_prot2 80: fused_run_net took 960 points a group")
        except ValueError as e:
            check("not a multiple of any tile" in str(e), f"grouped h36m_prot2 80: {e}")
            print(f"grouped h36m_prot2 80 ({G} x {rpg} x 80): refused, as in JAX: {e}")

        # 17b. one grouped launch against G single-pose launches -----------
        n_split, rpg_s, ns_s = SPLIT_SHAPE
        ctx, _, rd_s, pts_s = grouped_batch(n_split, rpg_s, ns_s, SEED + 3)
        codes = torch.randn((n_split, cfg_fc.framecode_ch), generator=gen).to(DEVICE)
        poses_s, net_s, bview_s = grouped_net(cfg_fc, params_fc, ctx, codes)
        singles = [F.prepare_net(params_fc["fine"], layout(cfg_fc), c) for c in codes]
        n = rpg_s * ns_s

        def split(density_only):
            return [F.fused_field(pts_s[g * n:(g + 1) * n], rd_s[g * rpg_s:(g + 1) * rpg_s],
                                  ns_s, poses_s[g], singles[g], density_only)
                    for g in range(n_split)]

        for density_only in (False, True):
            k = F.fused_field(pts_s, rd_s, ns_s, poses_s, net_s, density_only, bview=bview_s)
            one = torch.cat(split(density_only))
            torch.cuda.synchronize()
            check(bool(torch.isfinite(k).all()), "grouped split case: raw not finite")
            check(bool(torch.equal(k, one)),
                  f"grouped density_only={density_only}: one launch on {n_split} groups != "
                  f"{n_split} single-pose launches (max|diff| {float((k - one).abs().max()):.3e})")
        print(f"grouped vs single-pose: one launch on {n_split} groups x {rpg_s} rays x {ns_s} "
              f"samples ({pts_s.shape[0]} points, a framecode each) == {n_split} posegen_field "
              "launches, bit for bit, full and density_only")

        # 17c. render_rays(use_fused=True) on a grouped batch ---------------
        G, rpg = RENDER_GROUPS
        ctx, ro, rd, _ = grouped_batch(G, rpg, 1, SEED)
        n_rays = G * rpg
        F.reset_launches()
        out = render_rays(cfg, params, ro, rd, ctx, perturb=0.0, raw_noise_std=0.0,
                          use_fused=True, coarse_rgb=False)
        torch.cuda.synchronize()
        render_launches = dict(F.LAUNCHES)
        want = {k: 2 if k == "field_grouped" else 0 for k in render_launches}
        check(render_launches == want, f"grouped render: launches {render_launches} != {want}")
        rep = lambda a: a.repeat_interleave(rpg, 0)  # noqa: E731
        per_ray = ctx._replace(kps=rep(ctx.kps), skts=rep(ctx.skts), bones=rep(ctx.bones))
        ref = render_rays(cfg, params, ro, rd, per_ray, perturb=0.0, raw_noise_std=0.0,
                          use_fused=False, coarse_rgb=False)
        rgb = out["rgb_map"]
        check(tuple(rgb.shape) == (n_rays, 3) and bool(torch.isfinite(rgb).all()),
              f"grouped render: rgb_map {tuple(rgb.shape)} not finite")
        acc = float(out["acc_map"].mean())
        check(0.0 < acc and float(rgb.abs().max()) > 0.0, f"grouped render: empty (acc {acc})")
        # phase 3's flip rule, on each ray's far sample under its group's pose
        _, far = samp.get_near_far_in_cylinder(ro, rd, ctx.cyls, near=cfg.near, far=cfg.far)
        far_pts = (ro + rd * far).contiguous()
        x_pts, x_views, _ = encode_inputs(cfg, params, far_pts[:, None], rd, per_ray)
        sig_ref = nerf_apply(cfg.nerf_cfg, params["fine"], x_pts, x_views)[:, 0, 3]
        poses, net_f, bview_f = grouped_net(cfg, params, ctx)
        sig_ker = F.fused_field(far_pts, rd, 1, poses, net_f, density_only=True,
                                bview=bview_f)[:, 3]
        straddles = (sig_ref > 0) != (sig_ker > 0)
        d_rgb = (rgb - ref["rgb_map"]).abs().amax(-1)
        flipped = (out["acc_map"] - ref["acc_map"]).abs() > 0.5
        n_flip = int(flipped.sum())
        err_render = float(d_rgb[~flipped].max())
        check(n_flip <= MAX_FLIP_FRAC * n_rays, f"grouped render: {n_flip} rays flipped opacity")
        check(bool(straddles[flipped].all()),
              f"grouped render: {int((~straddles[flipped]).sum())} rays flipped opacity with no "
              "sign change of their far sigma")
        check(err_render <= RENDER_TOL,
              f"grouped render: rgb_map vs plain {err_render:.3e} > {RENDER_TOL}")
        print(f"grouped render ({G} groups x {rpg} rays, RaycastConfig(), coarse_rgb=False): "
              f"launches {render_launches}; rgb_map max|diff| vs the plain pipeline on the "
              f"per-ray ctx {err_render:.3e} on {n_rays - n_flip} rays, {n_flip} flipped "
              f"(each a far-sigma sign change); mean acc {acc:.4f}")

        # 17d. the ray ladder ------------------------------------------------
        _, _, ctx1, ro, rd = make_problem(cfg, n_rays=LADDER_RAYS, seed=SEED, device=DEVICE)
        near, far = samp.get_near_far_in_cylinder(ro, rd, ctx1.cyls.expand(LADDER_RAYS, 5),
                                                  near=cfg.near, far=cfg.far)
        ladder_pts = {}
        for n_s in LADDER_SAMPLES:
            z = samp.sample_from_lineseg(near, far, n_s)
            ladder_pts[n_s] = (ro[:, None] + rd[:, None] * z[..., None]).contiguous()
        run = lambda p, c=ctx1, **kw: F.fused_run_net(  # noqa: E731
            cfg, params["fine"], params["embed_kp"], p, rd[:p.shape[0]], c,
            view_embed_state=params.get("embed_view"), **kw)
        F.reset_launches()
        raws = {n_s: run(p, ray_ladder=True) for n_s, p in ladder_pts.items()}
        torch.cuda.synchronize()
        ladder_launches = dict(F.LAUNCHES)
        want = {k: len(LADDER_SAMPLES) if k == "field_ray_ladder" else 0 for k in ladder_launches}
        check(ladder_launches == want, f"ray ladder: launches {ladder_launches} != {want}")
        for n_s, p in ladder_pts.items():
            per_point = run(p, ray_ladder=False)
            check(bool(torch.isfinite(raws[n_s]).all()), f"ray ladder S={n_s}: raw not finite")
            check(bool(torch.equal(raws[n_s], per_point)),
                  f"ray ladder S={n_s}: raw != the per-point mode's (max|diff| "
                  f"{float((raws[n_s] - per_point).abs().max()):.3e})")
        grouped_rd = grouped_batch(*RENDER_GROUPS, 1, SEED)
        for what, call, key in (
                ("density_only", lambda: run(ladder_pts[80], density_only=True, ray_ladder=True),
                 "field"),
                ("grouped", lambda: F.fused_run_net(
                    cfg, params["fine"], params["embed_kp"],
                    ladder_pts[64][:grouped_rd[2].shape[0]], grouped_rd[2], grouped_rd[0],
                    ray_ladder=True), "field_grouped"),
                ("S=1", lambda: run(ladder_pts[16][:, :1].contiguous(), ray_ladder=True), "field")):
            F.reset_launches()
            call()
            got = dict(F.LAUNCHES)
            check(got == {k: int(k == key) for k in got}, f"ray ladder {what}: launches {got}")
        pose = F.pack_pose(ctx1.skts[0], params["embed_kp"], cfg.multires, cfg.multires_views)
        net_1 = F.prepare_net(params["fine"], layout(cfg))
        pts80 = ladder_pts[80].reshape(-1, 3)
        k = F.fused_field(pts80, rd, 80, pose, net_1, ray_ladder=True)
        p = F.field_plain(pts80, rd, 80, pose, net_1, mm_dtype=bf16, ray_ladder=True)
        torch.cuda.synchronize()
        err_ladder = compare("ray ladder S=80", k, p)
        print(f"ray ladder: launches {ladder_launches} (S = {', '.join(map(str, LADDER_SAMPLES))} "
              f"on {LADDER_RAYS} rays), raw == the per-point mode's at each, bit for bit; vs "
              f"its plain version at S=80 max|diff| {err_ladder:.3e}; off for density_only, "
              "grouped and S=1 calls")

        # 17e. times ----------------------------------------------------------
        w_bytes = 2 * net_1.w.numel() + 4 * net_1.b.numel()
        rows = {}
        for tag, G, rpg, n_s in GROUP_SHAPES[:2]:
            ctx, _, rd_g, pts = grouped_batch(G, rpg, n_s, SEED)
            poses, net, bview = grouped_net(cfg, params, ctx)
            P = pts.shape[0]
            for density_only in (False, True):
                k_ms = cuda_ms(lambda: F.fused_field(pts, rd_g, n_s, poses, net, density_only,
                                                     bview=bview), GROUP_TIMED)
                p_ms = cuda_ms(lambda: F.field_plain(pts, rd_g, n_s, poses, net, density_only,
                                                     mm_dtype=bf16, bview=bview), 3, warmup=1)
                b_ms, b_by = bound(F.field_flops(net.layout, density_only) * P,
                                   28 * P + 12 * G * rpg + poses.numel() * 4 + w_bytes)
                rows[(tag, density_only)] = (P, k_ms, p_ms, b_ms, b_by)
                print(f"timing grouped {'density_only' if density_only else 'full'} {tag} "
                      f"({P} points, {G} groups): {k_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}, "
                      f"{b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms [{card}]")
        P = pts_s.shape[0]
        g_ms = cuda_ms(lambda: F.fused_field(pts_s, rd_s, ns_s, poses_s, net_s, bview=bview_s),
                       GROUP_TIMED)
        s_ms = cuda_ms(lambda: split(False), GROUP_TIMED)
        b_ms, b_by = bound(F.field_flops(net_s.layout, False) * P,
                           28 * P + 12 * rd_s.shape[0] + 4 * (poses_s.numel() + bview_s.numel())
                           + w_bytes)
        print(f"timing grouped vs single-pose ({n_split} groups, {P} points): one "
              f"grouped launch {g_ms:.3f} ms, the {n_split} single-pose launches "
              f"{s_ms:.3f} ms together; bound {b_ms:.3f} ms ({b_by}) [{card}]")
        for n_s, pts in ladder_pts.items():
            flat = pts.reshape(-1, 3)
            P = flat.shape[0]
            l_ms = cuda_ms(lambda: F.fused_field(flat, rd, n_s, pose, net_1, ray_ladder=True),
                           GROUP_TIMED)
            pp_ms = cuda_ms(lambda: F.fused_field(flat, rd, n_s, pose, net_1), GROUP_TIMED)
            p_ms = cuda_ms(lambda: F.field_plain(flat, rd, n_s, pose, net_1, mm_dtype=bf16,
                                                 ray_ladder=True), 3, warmup=1)
            b_ms, b_by = bound(F.field_flops(net_1.layout, False) * P,
                               28 * P + 12 * LADDER_RAYS + pose.numel() * 4 + w_bytes)
            rows[("ladder", n_s)] = (P, l_ms, p_ms, b_ms, b_by)
            print(f"timing ray ladder S={n_s} ({P} points): {l_ms:.3f} ms, the per-point mode "
                  f"{pp_ms:.3f} ms ({l_ms / pp_ms - 1:+.1%}); bound {b_ms:.3f} ms ({b_by}, "
                  f"{b_ms / l_ms:.1%} of it), plain {p_ms:.3f} ms [{card}]")
        print(f"timing phase 17: {time.perf_counter() - t_phase:.1f} s [{card}]")

    src = "posegen_tpu_torch/kernels/csrc/field.cu"
    kernels = []
    for name, replaces, key, n, err in (
            ("field_grouped", "posegen_tpu/kernels/field.py:581", ("surreal 80", False),
             render_launches["field_grouped"], err_grouped),
            ("field_ray_ladder", "posegen_tpu/kernels/field.py:436", ("ladder", 80),
             ladder_launches["field_ray_ladder"], err_ladder)):
        _, k_ms, p_ms, b_ms, b_by = rows[key]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": n, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return kernels

# phase 18: data parallelism over ranks (posegen_tpu_torch/parallel/)
PAR_RANKS = 2  # ranks of the gloo world on the one card
PAR_TIMED = 5  # timed steps / renders of each arm, after the compared ones
PAR_BATCH = 32  # the G / D / SPIN batch (train_spin's default), 16 a rank
PAR_LOSS_TOL = 1e-4  # G / D / SPIN losses, 2 ranks vs one process: relative


def _par_time(torch, fn, n: int) -> float:
    """Median host-clock ms of n synchronised calls of fn."""
    import statistics

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _par_hash(torch, tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def parallel_work(torch, mesh):
    """Phase 18's main paths on one rank of `mesh`, or in one process
    (mesh None): the flagship train step, one render_image frame, the G /
    D / SPIN fine-tune steps -> results, CPU tensors and numbers."""
    import numpy as np

    from posegen_tpu_torch.gen import loop as GL
    from posegen_tpu_torch.gen.discriminators import init_pos3d_discriminator
    from posegen_tpu_torch.gen.gan import make_discriminator_step, make_generator_step
    from posegen_tpu_torch.gen.generators import GenConfig, draw_noises, init_pose_generator
    from posegen_tpu_torch.gen.hmr import init_hmr
    from posegen_tpu_torch.gen.spin_train import make_spin_finetune_step
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.parallel import gan as PG
    from posegen_tpu_torch.parallel import mesh as PM
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves, trainable,
    )
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"rank": 0 if mesh is None else mesh.rank}
    cpu = lambda ts: [t.detach().cpu().clone() for t in ts]  # noqa: E731

    # 18a. the flagship train step, 2 compared steps
    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0)
    tcfg = TrainConfig(rays_per_image=RAYS_PER_GROUP, use_background=True)
    state = create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(SEED),
                                              device=DEVICE), tcfg)
    batch = train_batch(torch, N_GROUPS, RAYS_PER_GROUP, SEED)
    if mesh is None:
        step = make_train_step(cfg, tcfg)
    else:
        state = PM.replicate(state, mesh)
        step = PM.make_shardmap_train_step(cfg, tcfg, mesh=mesh, fold_key_per_device=False)
        batch = PM.shard_batch(batch, mesh)
    res["train_params0"] = cpu(param_leaves(state.params))
    F.reset_launches()
    grads, losses = [], []
    for _ in range(2):
        state, st = step(state, batch)
        grads.append(cpu(p.grad for p in param_leaves(state.params)))
        losses.append({k: float(v) for k, v in st.items()})
    torch.cuda.synchronize()
    res["train_launches"] = dict(F.LAUNCHES)
    res.update(train_grads=grads, train_losses=losses,
               train_params=cpu(param_leaves(state.params)),
               train_rows=int(batch["rays_o"].shape[0]))
    res["train_ms"] = _par_time(torch, lambda: step(state, batch), PAR_TIMED)

    # 18b. one render_image frame (the val render's route)
    variables = init_raycaster(RaycastConfig(), torch.Generator().manual_seed(SEED),
                               device=DEVICE)
    ctx = make_pose_ctx(SEED, device=DEVICE)
    c2w = IMG._bullet_c2ws(ctx.kps[0, 0].cpu().numpy(), BULLET_DIST, 1)[0]
    fn = (None if mesh is None
          else PM.make_shardmap_render_cam(RaycastConfig(), mesh, FRAME_CHUNK))
    kw = dict(chunk=FRAME_CHUNK, render_fn=fn)
    with torch.no_grad():
        F.reset_launches()
        out = IMG.render_image(RaycastConfig(), variables, FRAME_HW, FRAME_HW, FRAME_FOCAL,
                               c2w, ctx, **kw)
        torch.cuda.synchronize()
        res["render_launches"] = dict(F.LAUNCHES)
        res.update(render_rgb=out["rgb"], render_acc=out["acc"], render_idx=out["valid_idx"])
        res["render_ms"] = _par_time(torch, lambda: IMG.render_image(
            RaycastConfig(), variables, FRAME_HW, FRAME_HW, FRAME_FOCAL, c2w, ctx, **kw),
            PAR_TIMED)

    # 18c. the G, D and SPIN fine-tune steps at full width, batch 32
    gen_cfg = GenConfig()
    rng = np.random.default_rng(SEED)
    real = torch.as_tensor((rng.standard_normal((PAR_BATCH, 24, 3)) * 0.2).astype(np.float32),
                           device=DEVICE)
    spin_pred = torch.as_tensor((rng.standard_normal((GAN_RPI, 14, 3)) * 0.3).astype(
        np.float32), device=DEVICE)
    sel = torch.as_tensor(rng.integers(0, PAR_BATCH, GAN_RPI), device=DEVICE)
    noises = draw_noises(torch.Generator(device=DEVICE).manual_seed(SEED), PAR_BATCH, gen_cfg)
    g_p, g_s = init_pose_generator(torch.Generator().manual_seed(0), gen_cfg, DEVICE)
    g_p = trainable(g_p)
    d_p = trainable(init_pos3d_discriminator(torch.Generator().manual_seed(1), DEVICE))
    fk = lambda b: GL.fk_joints(b, 0.4)  # noqa: E731
    if mesh is None:
        g_opt, g_step = make_generator_step(fk, gen_cfg)
        d_opt, d_step = make_discriminator_step()
        f_opt, f_step = make_spin_finetune_step()
    else:
        g_opt, g_step = PG.make_parallel_generator_step(mesh, fk, gen_cfg)
        d_opt, d_step = PG.make_parallel_discriminator_step(mesh)
        f_opt, f_step = PG.make_parallel_spin_finetune_step(mesh)
    g_st, d_st = g_opt.init(g_p), d_opt.init(d_p)
    g_call = lambda: g_step(g_p, g_s, g_st, d_p, noises, real, spin_pred, sel, 1.0)  # noqa: E731
    _, g_s2, _, g_out, g_stats = g_call()
    fake = g_out["pose_ba"]
    d_call = lambda: d_step(d_p, d_st, real, fake)  # noqa: E731
    _, _, d_stats = d_call()
    res.update(g_stats={k: float(v) for k, v in g_stats.items()},
               d_stats={k: float(v) for k, v in d_stats.items()},
               g_mu=cpu(param_leaves(g_st.mu)), g_state=cpu(param_leaves(g_s2)),
               d_mu=cpu(param_leaves(d_st.mu)), g_out=fake.detach().cpu())
    spin_p, spin_s = init_hmr(torch.Generator().manual_seed(2), device=DEVICE)
    spin_p = trainable(spin_p)
    images = torch.randn((PAR_BATCH, 3, 224, 224), generator=torch.Generator().manual_seed(SEED))
    images = images.to(DEVICE)
    gt = GL.fk_joints(real, 0.4)
    f_st = f_opt.init(spin_p)
    f_call = lambda: f_step(spin_p, spin_s, f_st, images, gt, None)  # noqa: E731
    _, _, f_stats = f_call()
    mu = torch.cat([t.reshape(-1) for t in param_leaves(f_st.mu)])
    res.update(spin_loss=float(f_stats["spin_loss"]), spin_mu_hash=_par_hash(torch, [mu]))
    if res["rank"] == 0:
        res["spin_mu"] = mu.cpu()
    res["g_ms"] = _par_time(torch, g_call, PAR_TIMED)
    res["d_ms"] = _par_time(torch, d_call, PAR_TIMED)
    res["spin_ms"] = _par_time(torch, f_call, PAR_TIMED)
    return res


def parallel_rank(mesh, out_dir: str) -> None:
    """One rank of phase 18's gloo world -> out_dir/rank{r}.pt."""
    import torch

    torch.save(parallel_work(torch, mesh), os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def parallel_nccl(mesh, out_dir: str) -> None:
    """The 1-rank NCCL world: the flagship train step through make_mesh /
    make_shardmap_train_step and the plain single step from the same state
    -> out_dir/nccl.pt (whether params and gradients are bit-equal)."""
    import torch

    from posegen_tpu_torch.parallel import mesh as PM
    from posegen_tpu_torch.render.raycast import RaycastConfig, init_raycaster
    from posegen_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, param_leaves,
    )

    cfg = RaycastConfig(perturb=0.0, raw_noise_std=0.0)
    tcfg = TrainConfig(rays_per_image=RAYS_PER_GROUP, use_background=True)
    batch = train_batch(torch, N_GROUPS, RAYS_PER_GROUP, SEED)
    out = {"backend": mesh.backend, "size": mesh.size}
    for tag, step, b in (
            ("mesh", PM.make_shardmap_train_step(cfg, tcfg, mesh=mesh), PM.shard_batch(batch, mesh)),
            ("single", make_train_step(cfg, tcfg), batch)):
        state = create_train_state(init_raycaster(cfg, torch.Generator().manual_seed(SEED),
                                                  device=DEVICE), tcfg)
        for _ in range(2):
            state, _ = step(state, b)
        out[tag] = [t.detach().cpu().clone() for t in param_leaves(state.params)]
        out[tag + "_grads"] = [p.grad.detach().cpu().clone() for p in param_leaves(state.params)]
    torch.save(out, os.path.join(out_dir, "nccl.pt"))


def parallel_phases(torch, card: str):
    """Phase 18, data parallelism over ranks (posegen_tpu_torch/parallel/):
    a 2-rank gloo world on the one card (CUDA tensors) runs the flagship
    train step, one render_image frame and the G / D / SPIN fine-tune
    steps at full width on halves of each batch, against this process's
    single runs on the whole batches; then a 1-rank NCCL world's step
    through make_mesh against the plain step, bit for bit -> launches of
    the ranks' main paths by kernel."""
    import tempfile

    import numpy as np

    from posegen_tpu_torch.parallel import mesh as PM

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        t0 = time.perf_counter()
        check(PM.backend_for("cuda", PAR_RANKS) == "gloo" and PM.backend_for("cuda", 1) == "nccl",
              "phase 18: backends")
        PM.launch(parallel_rank, PAR_RANKS, "cuda", args=(tmp,))
        t_world = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(PAR_RANKS)]
        one = parallel_work(torch, None)
        t0 = time.perf_counter()
        PM.launch(parallel_nccl, 1, "cuda", args=(tmp,))
        t_nccl = time.perf_counter() - t0
        nccl = torch.load(os.path.join(tmp, "nccl.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = ranks

    # the ranks end equal, bit for bit
    for key in ("train_params", "g_mu", "g_state", "d_mu"):
        check(all(torch.equal(a, b) for a, b in zip(r0[key], r1[key], strict=True)),
              f"phase 18: the ranks' {key} differ")
    check(r0["spin_mu_hash"] == r1["spin_mu_hash"], "phase 18: the ranks' SPIN moments differ")
    check(all(torch.equal(a, b) for g0, g1 in zip(r0["train_grads"], r1["train_grads"])
              for a, b in zip(g0, g1)), "phase 18: the ranks' train gradients differ")

    # 18a. the train step: launches on each rank, gradients and losses
    want = {k: 0 for k in r0["train_launches"]}
    want.update(field_stash=4, field_bwd=4)
    for r in ranks:
        check(r["train_launches"] == want,
              f"phase 18 rank {r['rank']}: train launches {r['train_launches']} != {want}")
        check(r["train_rows"] == N_GROUPS * RAYS_PER_GROUP // PAR_RANKS,
              f"phase 18: rank {r['rank']} trained on {r['train_rows']} rays")
    errs = [rel_l2(a, b) for g, h in zip(r0["train_grads"], one["train_grads"])
            for a, b in zip(g, h)]
    check(max(errs) <= GRAD_TOL, f"phase 18: train gradients, 2 ranks vs one, relative L2 "
                                 f"{max(errs):.3e} > {GRAD_TOL}")
    for i, (a, b) in enumerate(zip(r0["train_losses"], one["train_losses"])):
        for k in ("total_loss", "rgb_loss", "rgb0_loss"):
            check(abs(a[k] - b[k]) <= GRAD_TOL * abs(b[k]),
                  f"phase 18: step {i} {k} {a[k]} vs one process {b[k]}")
    d_par = max(float((a - b).abs().max()) for a, b in zip(r0["train_params"],
                                                           one["train_params"]))
    # each tensor's change over the 2 steps, relative L2 (an H100 at 700 W
    # read 6.3e-4 at most, max|diff| 5.2e-5 of lr 5e-4: no Adam step turned)
    upd = [rel_l2(a - p0, b - p0) for a, b, p0 in zip(r0["train_params"], one["train_params"],
                                                     one["train_params0"], strict=True)]
    check(max(upd) <= GRAD_TOL, f"phase 18: the params' change over 2 steps, 2 ranks vs one, "
                                f"relative L2 {max(upd):.3e} > {GRAD_TOL}")
    print(f"parallel train step ({PAR_RANKS} gloo ranks on cuda:0, {N_GROUPS} groups x "
          f"{RAYS_PER_GROUP} rays split in halves): launches a rank {r0['train_launches']}; "
          f"gradients vs one process, relative L2 per tensor max {max(errs):.3e}, median "
          f"{sorted(errs)[len(errs) // 2]:.3e}; total_loss {r0['train_losses'][1]['total_loss']:.6f}"
          f" (one process {one['train_losses'][1]['total_loss']:.6f}); params after 2 steps "
          f"max|diff| {d_par:.3e}, their change relative L2 per tensor max {max(upd):.3e}; the "
          f"ranks bit-equal")

    # 18b. the frame
    idx = one["render_idx"]
    chunks = -(-len(idx) // FRAME_CHUNK)
    for r in ranks:
        got = r["render_launches"]
        check(got["dual"] == chunks and got["field"] == chunks
              and sum(got.values()) == 2 * chunks,
              f"phase 18 rank {r['rank']}: render launches {got}, {chunks} chunks")
    rgb_k = r0["render_rgb"].reshape(-1, 3)[idx]
    rgb_1 = one["render_rgb"].reshape(-1, 3)[idx]
    equal = (rgb_k == rgb_1).all(-1)
    flipped = np.abs(r0["render_acc"].reshape(-1)[idx] - one["render_acc"].reshape(-1)[idx]) > 0.5
    d_rgb = np.abs(rgb_k - rgb_1).max(-1)
    err = float(d_rgb[~flipped].max())
    check(int(flipped.sum()) <= MAX_FLIP_FRAC * len(idx),
          f"phase 18: {int(flipped.sum())} rays flipped opacity")
    check(err <= RENDER_TOL, f"phase 18: frame vs one process {err:.3e} > {RENDER_TOL}")
    # a ray that misses the pose cylinder takes its chunk's mean near / far,
    # and a rank's chunk is half the single render's: every ray whose near /
    # far the two chunkings give alike must come out bit-equal
    same = _same_near_far(torch, one, idx)
    check(bool(equal[same].all()), f"phase 18: {int((~equal[same]).sum())} rays with the same "
                                   "samples differ")
    print(f"parallel render_image {FRAME_HW} x {FRAME_HW} ({len(idx)} rays, {chunks} chunks of "
          f"{FRAME_CHUNK}, {FRAME_CHUNK // PAR_RANKS} a rank): launches a rank dual {chunks} "
          f"field {chunks}; {int(equal.sum())} rays bit-equal to one process ({int(same.sum())} "
          f"with the same near / far, all equal), max|diff| {err:.3e} on the rest of "
          f"{len(idx) - int(flipped.sum())}, {int(flipped.sum())} flipped opacity")

    # 18c. G / D / SPIN
    for part, stats in (("g", "g_stats"), ("d", "d_stats")):
        for k, v in one[stats].items():
            check(abs(r0[stats][k] - v) <= PAR_LOSS_TOL * max(abs(v), 1e-6),
                  f"phase 18: {part} {k} {r0[stats][k]} vs one process {v}")
    g_err = rel_l2(torch.cat([t.reshape(-1) for t in r0["g_mu"]]),
                   torch.cat([t.reshape(-1) for t in one["g_mu"]]))
    d_err = rel_l2(torch.cat([t.reshape(-1) for t in r0["d_mu"]]),
                   torch.cat([t.reshape(-1) for t in one["d_mu"]]))
    s_err = rel_l2(r0["spin_mu"], one["spin_mu"])
    bn_err = max(float((a - b).abs().max()) for a, b in zip(r0["g_state"], one["g_state"]))
    out_err = float((r0["g_out"] - one["g_out"]).abs().max())
    check(g_err <= GAN_MOMENT_TOL and d_err <= GAN_MOMENT_TOL,
          f"phase 18: G / D Adam moments vs one process {g_err:.3e} / {d_err:.3e}")
    check(s_err <= SPIN_FT_TOL and abs(r0["spin_loss"] - one["spin_loss"])
          <= PAR_LOSS_TOL * abs(one["spin_loss"]),
          f"phase 18: SPIN step vs one process: moments {s_err:.3e}, loss "
          f"{r0['spin_loss']} vs {one['spin_loss']}")
    check(bn_err <= 1e-4 and out_err <= 1e-4,
          f"phase 18: synced BN state {bn_err:.3e}, generated poses {out_err:.3e}")
    print(f"parallel G / D / SPIN steps (GenConfig(), ResNet-50 HMR at 224, batch {PAR_BATCH}, "
          f"{PAR_BATCH // PAR_RANKS} a rank) vs one process: Adam moments relative L2 G "
          f"{g_err:.3e}, D {d_err:.3e}, SPIN {s_err:.3e}; BN running stats max|diff| "
          f"{bn_err:.3e}; gathered poses {out_err:.3e}; losses G {r0['g_stats']['gen_loss']:.6f}"
          f" ({one['g_stats']['gen_loss']:.6f}), D {r0['d_stats']['dis_loss']:.6f} "
          f"({one['d_stats']['dis_loss']:.6f}), SPIN {r0['spin_loss']:.6f} "
          f"({one['spin_loss']:.6f})")

    # 18d. the 1-rank NCCL world
    check(nccl["backend"] == "nccl" and nccl["size"] == 1, f"phase 18: {nccl['backend']}")
    check(all(torch.equal(a, b) for a, b in zip(nccl["mesh"], nccl["single"], strict=True))
          and all(torch.equal(a, b) for a, b in zip(nccl["mesh_grads"], nccl["single_grads"])),
          "phase 18: the 1-rank NCCL step is not the plain step bit for bit")
    print("parallel 1-rank NCCL world: the train step through make_mesh / "
          "make_shardmap_train_step equals the plain step bit for bit (params and gradients "
          "after 2 steps)")

    for name in ("train", "render", "g", "d", "spin"):
        print(f"timing parallel {name}: {PAR_RANKS} ranks {r0[name + '_ms']:.3f} ms (rank 1 "
              f"{r1[name + '_ms']:.3f}), one process {one[name + '_ms']:.3f} ms, median of "
              f"{PAR_TIMED} by the host clock [{card}]")
    print(f"timing parallel worlds: gloo {t_world:.1f} s with spawn, NCCL {t_nccl:.1f} s "
          f"[{card}]")
    launches = {k: 0 for k in r0["train_launches"]}
    for r in ranks:
        for part in ("train_launches", "render_launches"):
            for k, v in r[part].items():
                launches[k] += v
    return launches


# phase 19: configs/surreal/surreal_single.txt's layout (one net, no view
# octaves, 96 + 48 samples) through the eval and training kernels
SINGLE_CONFIG = os.path.join("configs", "surreal", "surreal_single.txt")
SINGLE_RAYS = 8192  # the eval render's rays
SINGLE_STEPS = 2  # train steps on each route
SINGLE_TIMED = 10  # CUDA-event renders, steps and launches timed


def single_net_phases(torch, card: str):
    """Phase 19 -> (launches by kernel on its main paths, max|diff| of the
    field launches against their plain version)."""
    import dataclasses

    from posegen_tpu_torch.cli.config import (
        args_to_raycast_config, args_to_train_config, nerf_config_parser, parse_with_config,
    )
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.kernels import field_grad as FG
    from posegen_tpu_torch.models.nerf import nerf_apply
    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render.raycast import encode_inputs, init_raycaster, render_rays
    from posegen_tpu_torch.train.trainer import (
        create_train_state, make_train_step, param_leaves, tree_map,
    )
    from posegen_tpu_torch.utils.fixtures import make_problem

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    root = os.path.dirname(os.path.abspath(__file__))
    args = parse_with_config(nerf_config_parser(), ["--config", os.path.join(root, SINGLE_CONFIG)])
    cfg = args_to_raycast_config(args)
    tcfg = args_to_train_config(args)
    check(cfg.single_net and cfg.multires_views == 0
          and (cfg.N_samples, cfg.N_importance) == (96, 48),
          f"phase 19: {SINGLE_CONFIG} is not the single-net layout: {cfg}")
    reason = F.fused_config_disqualification(cfg)
    check(reason is None, f"phase 19: the gate refuses {SINGLE_CONFIG}: {reason}")
    L = F.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    print(f"phase 19: {SINGLE_CONFIG}: single_net, multires {L.nf_kp} / {L.nf_view} (view "
          f"channels {L.vc}, padded to {L.vcp}), {cfg.N_samples} + {cfg.N_importance} samples, "
          f"N_rand {args.N_rand} as {args.N_sample_images} images x {tcfg.rays_per_image} rays")

    # 19a. the eval render: both passes run posegen_field in full mode on the
    # one net, and the importance raws merge by sort order
    cfg, params, ctx, rays_o, rays_d = make_problem(cfg, n_rays=SINGLE_RAYS, seed=SEED,
                                                    device=DEVICE)
    check("fine" not in params, "phase 19: a single-net config built a fine net")
    want = {"dual": 0, "field": 2, "field_grouped": 0, "field_ray_ladder": 0,
            "field_stash": 0, "field_bwd": 0, "field_bwd_inputs": 0, "variant": 0}
    calls, original = [], F.fused_field

    def recorded(*a, **k):
        out = original(*a, **k)
        calls.append((a, k, out))
        return out

    def render(use_fused):
        return render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0, raw_noise_std=0.0,
                           use_fused=use_fused)

    with torch.no_grad():
        near, far = samp.get_near_far_in_cylinder(
            rays_o, rays_d, ctx.cyls.expand(SINGLE_RAYS, 5), near=cfg.near, far=cfg.far)
        pose = F.pack_pose(ctx.skts[0], params["embed_kp"], cfg.multires, cfg.multires_views)
        net = F.prepare_net(params["coarse"], L)
        far_pts = (rays_o + rays_d * far).contiguous()
        x_pts, x_views, _ = encode_inputs(cfg, params, far_pts[:, None], rays_d, ctx)
        sig_ref = nerf_apply(cfg.nerf_cfg, params["coarse"], x_pts, x_views)[:, 0, 3]
        sig_ker = F.fused_field(far_pts, rays_d, 1, pose, net, density_only=True)[:, 3]
        straddles = (sig_ref > 0) != (sig_ker > 0)
        F.fused_field = recorded
        try:
            F.reset_launches()
            out = render(True)
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
        finally:
            F.fused_field = original
        check(got == want, f"phase 19 render: launches {got} != {want}")
        sizes = [a[0].shape[0] for a, _, _ in calls]
        check(sizes == [SINGLE_RAYS * cfg.N_samples, SINGLE_RAYS * cfg.N_importance],
              f"phase 19 render: field launches on {sizes} points")
        err_field, launch_rows = 0.0, []
        for (a, k, raw), tag in zip(calls, ("coarse", "importance")):
            check(not k.get("density_only", a[5] if len(a) > 5 else False),
                  f"phase 19 render: the {tag} launch is density-only")
            pts, dirs, spr, pose_t, net_t = a[:5]
            plain = F.field_plain(pts, dirs, spr, pose_t, net_t, mm_dtype=bf16)
            err_field = max(err_field, compare(f"phase 19 field {tag}", raw, plain))
            launch_rows.append((tag, a[:5]))
        calls.clear()
        rgb = out["rgb_map"]
        check(tuple(rgb.shape) == (SINGLE_RAYS, 3) and bool(torch.isfinite(rgb).all()),
              f"phase 19 render: rgb_map {tuple(rgb.shape)} not finite or misshapen")
        ref = render(False)
        acc = float(out["acc_map"].mean())
        check(0.0 < acc and float(rgb.abs().max()) > 0.0,
              f"phase 19 render: empty image (mean acc {acc})")
        d_rgb = (rgb - ref["rgb_map"]).abs().amax(-1)
        flipped = (out["acc_map"] - ref["acc_map"]).abs() > 0.5
        n_flip = int(flipped.sum())
        err = float(d_rgb[~flipped].max())
        check(n_flip <= MAX_FLIP_FRAC * SINGLE_RAYS, f"phase 19 render: {n_flip} rays flipped")
        check(bool(straddles[flipped].all()),
              f"phase 19 render: {int((~straddles[flipped]).sum())} rays flipped opacity with "
              "no sign change of their far sigma")
        check(err <= RENDER_TOL, f"phase 19 render: rgb_map vs plain {err:.3e} > {RENDER_TOL}")
        print(f"phase 19 render: launches {got}, field on {sizes} points, each raw vs plain "
              f"max|diff| {err_field:.3e}; rgb_map vs plain pipeline {err:.3e} on "
              f"{SINGLE_RAYS - n_flip} rays, {n_flip} flipped opacity (far sigma changes sign "
              f"on each); mean acc {acc:.4f}")

        ms = cuda_ms(lambda: render(True), SINGLE_TIMED)
        print(f"timing phase 19 render: {ms:.3f} ms per {SINGLE_RAYS} rays, "
              f"{SINGLE_RAYS / ms * 1e3:.1f} rays/s [{card}]")
        w_bytes = net.w.numel() * 2 + net.b.numel() * 4
        for tag, (pts, dirs, spr, pose_t, net_t) in launch_rows:
            P = pts.shape[0]
            k_ms = cuda_ms(lambda: F.fused_field(pts, dirs, spr, pose_t, net_t), SINGLE_TIMED)
            p_ms = cuda_ms(lambda: F.field_plain(pts, dirs, spr, pose_t, net_t, mm_dtype=bf16),
                           3, warmup=1)
            b_ms, b_by = bound(F.field_flops(L, False) * P,
                               12 * P + 12 * dirs.shape[0] + pose_t.numel() * 4 + w_bytes + 16 * P)
            print(f"timing phase 19 kernel field {tag} ({P} points): {k_ms:.3f} ms, bound "
                  f"{b_ms:.3f} ms ({b_by}, {b_ms / k_ms:.1%} of it), plain {p_ms:.3f} ms [{card}]")

    # 19b. the train step: the stash and the backward run twice on the one
    # net, and both passes' gradients sum into its weights
    rpg = tcfg.rays_per_image
    n_groups = args.N_rand // rpg
    batch = train_batch(torch, n_groups, rpg, SEED)
    variables = init_raycaster(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
    tcfg_k = dataclasses.replace(tcfg, fused_train=True)
    tcfg_p = dataclasses.replace(tcfg, fused_train=False)
    step_k, step_p = make_train_step(cfg, tcfg_k), make_train_step(cfg, tcfg_p)
    state_k = create_train_state(variables, tcfg_k)
    gen_k = torch.Generator(device=DEVICE).manual_seed(SEED)
    gen_p = torch.Generator(device=DEVICE).manual_seed(SEED)
    want = {"dual": 0, "field": 0, "field_grouped": 0, "field_ray_ladder": 0,
            "field_stash": 2, "field_bwd": 2, "field_bwd_inputs": 0, "variant": 0}
    launches = {"field": got["field"], "field_stash": 0, "field_bwd": 0}
    stash_sizes, stash = [], FG.fused_field_stash

    def stash_recorded(pts, *a, **k):
        stash_sizes.append(pts.shape[0])
        return stash(pts, *a, **k)

    for i in range(SINGLE_STEPS):
        # the plain route's step from the kernel route's parameters and step
        # count, so that both take their gradients at one point
        state_p = create_train_state(
            {**tree_map(lambda t: t.detach().clone(), state_k.params), **state_k.embeds},
            tcfg_p)._replace(step=state_k.step)
        FG.fused_field_stash = stash_recorded
        try:
            F.reset_launches()
            state_k, stats_k = step_k(state_k, batch, gen_k)
            torch.cuda.synchronize()
            got = dict(F.LAUNCHES)
        finally:
            FG.fused_field_stash = stash
        check(got == want, f"phase 19 train step {i}: launches {got} != {want}")
        for k in ("field_stash", "field_bwd"):
            launches[k] += got[k]
        state_p, stats_p = step_p(state_p, batch, gen_p)
        torch.cuda.synchronize()
        for k in ("total_loss", "rgb_loss", "rgb0_loss", "grad_norm"):
            check(bool(torch.isfinite(stats_k[k])), f"phase 19 train step {i}: {k} not finite")
        gk = [p.grad for p in param_leaves(state_k.params)]
        gp = [p.grad for p in param_leaves(state_p.params)]
        check(list(state_k.params) == ["coarse"] and all(g is not None for g in gk),
              f"phase 19 train step {i}: nets {list(state_k.params)}, a gradient missing")
        all_l2 = rel_l2(torch.cat([a.reshape(-1) for a in gk]),
                        torch.cat([b.reshape(-1) for b in gp]))
        per = sorted(rel_l2(a, b) for a, b in zip(gk, gp))
        check(all_l2 <= STEP_GRAD_TOL, f"phase 19 train step {i}: gradients vs plain f32 "
                                       f"pipeline: relative L2 {all_l2:.3e} > {STEP_GRAD_TOL}")
        print(f"phase 19 train step {i}: launches {got}, stash on {stash_sizes} points; "
              f"total_loss {float(stats_k['total_loss']):.6f} (plain f32 "
              f"{float(stats_p['total_loss']):.6f}); gradients vs plain: relative L2 "
              f"{all_l2:.3e} over all {len(gk)} tensors, per tensor median "
              f"{per[len(per) // 2]:.3e}, max {per[-1]:.3e}")
        check(sorted(stash_sizes) == sorted([args.N_rand * cfg.N_samples,
                                             args.N_rand * cfg.N_importance]),
              f"phase 19 train step {i}: stash launches on {stash_sizes} points")
        stash_sizes.clear()

    ms = cuda_ms(lambda: step_k(state_k, batch, gen_k), SINGLE_TIMED)
    print(f"timing phase 19 train step: {ms:.3f} ms per {args.N_rand} rays, "
          f"{args.N_rand / ms * 1e3:.1f} trained rays/s [{card}]")
    print(f"timing phase 19: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches, err_field


def _same_near_far(torch, one, idx):
    """Per ray of the frame: whether its near / far are the same when the
    frame's box is cut into FRAME_CHUNK chunks and into the ranks' halves
    of them (rays that miss the cylinder take their chunk's mean)."""
    import numpy as np

    from posegen_tpu_torch.ops import sampling as samp
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.render.raycast import RaycastConfig
    from posegen_tpu_torch.utils.fixtures import make_pose_ctx

    cfg = RaycastConfig()
    ctx = make_pose_ctx(SEED, device=DEVICE)
    c2w = IMG._bullet_c2ws(ctx.kps[0, 0].cpu().numpy(), BULLET_DIST, 1)[0]
    cyl = ctx.cyls[0].cpu().numpy()
    tl, br, valid = IMG.valid_box_for_pose(FRAME_HW, FRAME_HW, FRAME_FOCAL, c2w, cyl)
    cam = {k: torch.as_tensor(v).to(DEVICE)
           for k, v in IMG.make_cam(FRAME_HW, FRAME_HW, FRAME_FOCAL, c2w, tl, br).items()}
    n = len(valid)

    def near_far(chunk, padded):
        """A rank renders chunk rays at every offset, those past the box
        clamped to its last ray (make_shardmap_render_cam); one process
        renders what is left of the box."""
        out = []
        for i in range(0, n, chunk):
            o, d = IMG.rays_from_box(cam, i, chunk if padded else min(chunk, n - i))
            nr, fr = samp.get_near_far_in_cylinder(o, d, ctx.cyls.expand(o.shape[0], 5),
                                                   near=cfg.near, far=cfg.far)
            out.append(torch.cat([nr, fr], -1)[:min(chunk, n - i)])
        return torch.cat(out)

    with torch.no_grad():
        a, b = near_far(FRAME_CHUNK, False), near_far(FRAME_CHUNK // PAR_RANKS, True)
    return (a == b).all(-1).cpu().numpy()


# phase 20: the purpose experiments (posegen_tpu_torch/tools/) at a reduced
# budget: the flagship demo NeRF, exp_bf16_delta, exp_poseopt, exp_mining,
# and run_gan + exp_capstone_ft, each through its entry point
PROOF_FLAGSHIP_ITERS = 300  # the flagship demo's steps (the JAX run: 1500)
PROOF_HW = 512  # exp_bf16_delta's frame
# exp_bf16_delta's frame, the kernels' against the plain f32 pipeline's, by
# phase 3's flip rule: at most MAX_FLIP_FRAC of the box's pixels have
# opacities more than 0.01 apart, every flip (more than 0.5 apart) is a
# sign change of the ray's far sigma, and the other pixels hold to
# PROOF_FRAME_PSNR dB (read: 74.21 dB on the 1500-step demo NeRF off its 73
# such pixels, RESULTS.md's JAX pair 78.2 dB)
PROOF_FRAME_PSNR = 60.0
PROOF_SCENE = ("264", "256", "320")  # prepare's images, size and focal: the JAX tool's
PROOF_SOAK_ITERS = 100  # h36m_prot2 steps (the JAX tool's soak: 30,000-100,000)
PROOF_SOAK_FLAGS = "--num_workers 0 --i_pose_weights 50"
PROOF_TESTOPT_ITERS = 24  # testopt iterations (the JAX tool's 1500), at one tol
PROOF_TESTOPT_TOL = "0.01"
PROOF_K = 5  # testopt steps held, kernel route against plain
PROOF_MINING = ("--n_pretrain", "32", "--n_eval", "4", "--pretrain_epochs", "2",
                "--finetune_epochs", "1", "--gan_epochs", "1", "--batch_size", "64",
                "--pool_n", "128", "--rpi", "16", "--probe_every", "1", "--probe_n", "4",
                "--ft_n", "32", "--feedback_every", "1", "--pose_std", "0.15")
PROOF_GAN = ("--epochs", "1", "--batch_size", "1024", "--rpi", "8", "--feedback_every", "1",
             "--feedback_start_epoch", "-1")
PROOF_CAPSTONE = ("--ft_n", "32", "--finetune_epochs", "1", "--n_eval", "4", "--n_pretrain",
                  "32", "--pose_std", "0.15")
# the probe route's floor: a float32 mean of 56 joint distances out of
# ResNet-50's float32 reductions resolves about 2^-20 of its value; where
# the rgb_map rule's allowance moves the probe by less (a SPIN of a few
# steps barely reads its frames), the route is held to this
PROBE_F32_FLOOR = 2.0 ** -20
# the JAX tools' JSON keys (tools/exp_poseopt.py, exp_mining.py, exp_capstone_ft.py)
SOAK_KEYS = ("gt_meta", "rows")
TESTOPT_KEYS = ("ckpt", "n_iters", "bone_std", "pelvis_std", "sweeps")
SWEEP_KEYS = ("tol", "mpjpe_before", "mpjpe_after", "mpjpe_rc_before", "mpjpe_rc_after",
              "val_psnr_before", "val_psnr_after", "traj")
MINING_KEYS = ("args", "spin_eval_mpjpe_random_init", "spin_eval_mpjpe_pretrained",
               "probe_curves", "n_mined", "n_ft", "mined_set_mpjpe_pretrained",
               "control_set_mpjpe_pretrained", "pretrained_eval", "finetune_eval_mpjpe")
CAPSTONE_KEYS = ("args", "sink_size", "gan_ckpt", "mined_set_mpjpe_pretrained",
                 "control_set_mpjpe_pretrained", "pretrained_eval", "finetune_eval_mpjpe")
PROOF_KERNELS = ("dual", "field", "field_stash", "field_bwd", "field_bwd_inputs")


def _all_finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_all_finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_all_finite(v) for v in tree)
    return not isinstance(tree, float) or math.isfinite(tree)


def _check_json(tag: str, path: str, keys) -> dict:
    with open(path) as f:
        out = json.load(f)
    missing = [k for k in keys if k not in out]
    check(not missing, f"phase 20 {tag}: {path} lacks the JAX tool's keys {missing}")
    check(_all_finite(out), f"phase 20 {tag}: {path} holds a value that is not finite")
    return out


def proof_phases(torch, card: str, tmp: str):
    """Phase 20 -> launches by kernel on its main paths (every tool's run)."""
    import numpy as np

    from posegen_tpu_torch.cli import run_gan
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.tools import exp_bf16_delta, exp_capstone_ft, exp_mining, exp_poseopt
    from posegen_tpu_torch.tools.flagship_demo import train_flagship

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "proofs")
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter(), dict(F.LAUNCHES)))

    F.reset_launches()
    mark("start")
    # 20a. the flagship demo NeRF, through run_nerf
    (nerf_args, ckpt), _ = _quiet(train_flagship, os.path.join(root, "logs"),
                                  os.path.join(root, "data"), PROOF_FLAGSHIP_ITERS, 0,
                                  device=DEVICE)
    check(ckpt is not None and ckpt.endswith(f"{PROOF_FLAGSHIP_ITERS:08d}.ckpt.npz"),
          f"phase 20 flagship: checkpoint {ckpt}")
    nerf = ["--nerf_args", nerf_args, "--ckptpath", ckpt]
    mark("flagship")
    # 20b. exp_bf16_delta: the kernels' frame and the plain f32 frame
    bf16_out = os.path.join(root, "bf16ab")
    bf16, _ = _quiet(exp_bf16_delta.main, nerf + ["--hw", str(PROOF_HW), "--out", bf16_out],
                     device=DEVICE)
    psnr = bf16["psnr"]["fused|xla32"]
    frame = np.load(os.path.join(bf16_out, "fused.npy"))
    check(frame.shape == (PROOF_HW, PROOF_HW, 3) and bool(np.isfinite(frame).all()),
          f"phase 20 exp_bf16_delta: fused frame {frame.shape}")
    mark("exp_bf16_delta")
    # 20c. exp_poseopt: prepare, soak, evalpose, testopt
    common = ["--data_dir", os.path.join(root, "data_poseopt"), "--out_dir",
              os.path.join(root, "poseopt"), "--basedir", os.path.join(root, "logs")]
    _quiet(exp_poseopt.main, ["prepare", "--n_images", PROOF_SCENE[0], "--hw", PROOF_SCENE[1],
                              "--focal", PROOF_SCENE[2]] + common)
    soak_dir, _ = _quiet(exp_poseopt.main, ["soak", "--n_iters", str(PROOF_SOAK_ITERS),
                                            "--nerf_flags", PROOF_SOAK_FLAGS] + common,
                         device=DEVICE)
    mark("soak")
    soak_json, _ = _quiet(exp_poseopt.main, ["evalpose"] + common)
    soak = _check_json("evalpose", soak_json, SOAK_KEYS)
    check([r["step"] for r in soak["rows"]] == list(range(0, PROOF_SOAK_ITERS + 1, 50)),
          f"phase 20 evalpose: rows at steps {[r['step'] for r in soak['rows']]}")
    _quiet(exp_poseopt.main, ["testopt", "--n_iters", str(PROOF_TESTOPT_ITERS), "--tols",
                              PROOF_TESTOPT_TOL, "--nerf_flags", PROOF_SOAK_FLAGS] + common,
           device=DEVICE)
    testopt = _check_json("testopt", os.path.join(root, "poseopt", "testopt_recovery.json"),
                          TESTOPT_KEYS)
    (sweep,) = testopt["sweeps"]
    check(all(k in sweep for k in SWEEP_KEYS), f"phase 20 testopt: sweep keys {sorted(sweep)}")
    mark("testopt")
    # 20d. exp_mining: splits, HMR pretrain, GAN feedback ON / OFF, fine-tune
    mining_out = os.path.join(root, "mining")
    _quiet(exp_mining.main, nerf + ["--out", mining_out, *PROOF_MINING], device=DEVICE)
    mining = _check_json("exp_mining", os.path.join(mining_out, "summary.json"), MINING_KEYS)
    mark("exp_mining")
    # 20e. run_gan on the demo NeRF with the pretrained SPIN -> its sink ->
    # exp_capstone_ft, reusing exp_mining's splits
    spin_npz = os.path.join(mining_out, "spin_pretrained.npz")
    _quiet(run_gan.main, nerf + ["--spin_ckpt", spin_npz, "--outputdir",
                                 os.path.join(root, "render_output"), "--runname", "capstone",
                                 *PROOF_GAN], device=DEVICE)
    cap_out = os.path.join(root, "capstone_finetune.json")
    _quiet(exp_capstone_ft.main, nerf + [
        "--sink", os.path.join(root, "render_output", "capstone"), "--pretrained", spin_npz,
        "--splits_dir", mining_out, "--out", cap_out, *PROOF_CAPSTONE], device=DEVICE)
    capstone = _check_json("exp_capstone_ft", cap_out, CAPSTONE_KEYS)
    mark("exp_capstone_ft")

    launches = {k: marks[-1][2][k] - marks[0][2][k] for k in marks[0][2]}
    for (name, t0, l0), (tag, t1, l1) in zip(marks, marks[1:]):
        got = {k: l1[k] - l0[k] for k in PROOF_KERNELS if l1[k] - l0[k]}
        print(f"phase 20 {tag}: {t1 - t0:.1f} s, launches {got}")
    for k in PROOF_KERNELS:
        check(launches[k] > 0, f"phase 20: no {k} launch across the purpose experiments")
    print(f"phase 20 results: flagship {PROOF_FLAGSHIP_ITERS} steps; PSNR(fused, xla32) "
          f"{psnr:.2f} dB at {PROOF_HW}^2 ({bf16['diff']['fused|xla32']}); soak "
          f"{PROOF_SOAK_ITERS} steps, MPJPE "
          f"{soak['rows'][0]['mpjpe']:.4f} -> {soak['rows'][-1]['mpjpe']:.4f}; testopt "
          f"tol {sweep['tol']} x {PROOF_TESTOPT_ITERS}: MPJPE {sweep['mpjpe_before']:.4f} -> "
          f"{sweep['mpjpe_after']:.4f}, val PSNR {sweep['val_psnr_before']:.2f} -> "
          f"{sweep['val_psnr_after']:.2f}; mining probe ON "
          f"{[round(v, 4) for _, v in mining['probe_curves']['feedback_on']]}, OFF "
          f"{[round(v, 4) for _, v in mining['probe_curves']['feedback_off']]}, fine-tuned "
          f"{mining['finetune_eval_mpjpe']}; capstone sink {capstone['sink_size']}, fine-tuned "
          f"{capstone['finetune_eval_mpjpe']}")

    # 20f. the kernel route against the plain one (these launches are not
    # the main path's): exp_bf16_delta's frame by the flip rule, testopt's
    # pose params after PROOF_K steps from the soak's checkpoint, and
    # exp_mining's probe on one generator state
    _bf16_frame_rule(torch, nerf_args, ckpt, bf16_out, bf16["diff"]["fused|xla32"])
    _testopt_routes(torch, root, soak_dir)
    _probe_routes(torch, nerf_args, ckpt, spin_npz)
    print(f"timing phase 20: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


def _bf16_frame_rule(torch, nerf_args: str, ckpt: str, out: str, diff: dict) -> None:
    """exp_bf16_delta's two card frames (fused, xla32) by phase 3's flip
    rule, within the frame's box; the background must be equal."""
    import numpy as np

    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.tools.exp_bf16_delta import load_frame

    targs, cfg, variables = load_trained(nerf_args, ckpt, device=DEVICE)
    ctx, c2w, focal, src_h = load_frame(targs, 0, torch.device(DEVICE))
    H = PROOF_HW
    focal = focal * H / src_h
    tl, br, idx = IMG.valid_box_for_pose(H, H, focal, c2w, ctx.cyls[0].cpu().numpy())
    got, want = (np.load(os.path.join(out, f"{t}.npy")).reshape(-1, 3)
                 for t in ("fused", "xla32"))
    acc = [np.load(os.path.join(out, f"{t}_acc.npy")).reshape(-1) for t in ("fused", "xla32")]
    rest = np.ones(H * H, bool)
    rest[idx] = False
    check(np.array_equal(got[rest], want[rest]), "phase 20 exp_bf16_delta: background differs")
    d_acc = np.abs(acc[0] - acc[1])[idx]
    flipped, moved = d_acc > 0.5, d_acc > 0.01
    cam = {k: torch.as_tensor(v).to(DEVICE)
           for k, v in IMG.make_cam(H, H, focal, c2w, tl, br).items()}
    with torch.no_grad():
        straddles = far_sigma_straddles(torch, F, cfg, variables, ctx, cam, len(idx),
                                        32768)[0].cpu().numpy()
    psnr = diff["psnr_opacity_within_0.01"]
    print(f"phase 20 exp_bf16_delta frame: PSNR(fused, xla32) {diff['psnr']:.2f} dB over the "
          f"frame, {psnr:.2f} dB (bound {PROOF_FRAME_PSNR}) off the {int(moved.sum())} of "
          f"{len(idx)} box pixels whose opacities are more than 0.01 apart; {int(flipped.sum())} "
          f"flips, each a far-sigma sign change ({int(straddles.sum())} far samples change "
          "sign)")
    check(int(moved.sum()) <= MAX_FLIP_FRAC * len(idx),
          f"phase 20 exp_bf16_delta: {int(moved.sum())} of {len(idx)} pixels' opacities "
          "more than 0.01 apart")
    check(bool(straddles[flipped].all()),
          f"phase 20 exp_bf16_delta: {int((~straddles[flipped]).sum())} pixels flipped "
          "opacity with no sign change of their far sigma")
    check(psnr >= PROOF_FRAME_PSNR,
          f"phase 20 exp_bf16_delta: PSNR(fused, xla32) {psnr:.2f} dB off the "
          f"{int(moved.sum())} pixels whose opacities differ, < {PROOF_FRAME_PSNR}")


def _testopt_routes(torch, root: str, soak_dir: str) -> None:
    """PROOF_K testopt steps on the same batches through the kernels and
    through the plain f32 pipeline (perturb 0, no raw noise), from one
    fresh state of the soak's checkpoint: the pose params' displacement to
    phase 8's rule (STEP_GRAD_TOL relative L2), each step's pose gradient
    printed beside it."""
    import dataclasses
    import types

    import numpy as np

    from posegen_tpu_torch.cli.config import (
        args_to_data_config, args_to_raycast_config, args_to_train_config,
    )
    from posegen_tpu_torch.data.catalog import load_data
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.pose.opt import PoseOptConfig, init_pose_params
    from posegen_tpu_torch.tools import exp_poseopt as P
    from posegen_tpu_torch.train.checkpoints import latest_checkpoint
    from posegen_tpu_torch.train.trainer import make_train_step

    data_dir = os.path.join(root, "data_poseopt")
    args = types.SimpleNamespace(data_dir=data_dir, basedir=os.path.join(root, "logs"),
                                 nerf_flags=PROOF_SOAK_FLAGS, n_iters=PROOF_K)
    cli, cli_load = P.testopt_cli(args)
    gt = dict(np.load(P.gt_path(data_dir)))
    b_n, kp_n, _, _ = P.perturb(gt["gt_bones"], gt["gt_kp3d"], 7, 0.08, 0.02)
    loader, _, attrs = load_data(args_to_data_config(cli))
    try:
        it = iter(loader)
        batches = [next(it) for _ in range(PROOF_K)]
    finally:
        loader.close()
    cfg = dataclasses.replace(args_to_raycast_config(cli, n_framecodes=attrs["n_framecodes"]),
                              perturb=0.0, raw_noise_std=0.0)
    pcfg = PoseOptConfig(use_rot6d=True, opt_pose_tol=float(PROOF_TESTOPT_TOL))
    rest = torch.as_tensor(attrs["rest_pose"], device=DEVICE)
    ckpt = latest_checkpoint(soak_dir)
    out, grads = {}, {}
    for tag, fused in (("kernels", None), ("plain", False)):
        tcfg = dataclasses.replace(args_to_train_config(cli), fused_train=fused)
        pose, anchors = init_pose_params(pcfg, b_n, kp_n, device=DEVICE)
        state = P.testopt_state(ckpt, cfg, args_to_train_config(cli_load), tcfg, pose, anchors,
                                torch.device(DEVICE))
        step = make_train_step(cfg, tcfg, pcfg, rest_pose=rest, n_frames=attrs["n_kps"])
        grads[tag] = []

        def recorded(state, batch, gen, step=step, tag=tag):
            before = dict(F.LAUNCHES)
            state, stats = step(state, batch, gen)
            got = {k: F.LAUNCHES[k] - before[k] for k in before}
            if tag == "kernels":
                check(got["field_bwd_inputs"] == 2 and got["field_stash"] == 2,
                      f"phase 20 testopt route: launches {got}")
            grads[tag].append(torch.cat([p.grad.reshape(-1)
                                         for p in state.pose_params.values()]).clone())
            return state, stats

        start = {k: v.detach().clone() for k, v in state.pose_params.items()}
        state, _, _ = P.testopt_loop(recorded, state, iter(batches), PROOF_K, gt, DEVICE,
                                     log=None)
        out[tag] = torch.cat([(v.detach() - start[k]).reshape(-1)
                              for k, v in state.pose_params.items()])
    e_move = rel_l2(out["kernels"], out["plain"])
    e_grads = [rel_l2(a, b) for a, b in zip(grads["kernels"], grads["plain"])]
    # Adam's first updates are about lr * sign(g) a component: a component
    # whose gradient lies within the kernels' error of 0 moves the other way
    same = torch.sign(out["kernels"]) == torch.sign(out["plain"])
    e_same = rel_l2(out["kernels"][same], out["plain"][same])
    check(float(out["plain"].norm()) > 0.0, "phase 20 testopt route: the pose did not move")
    check(e_move <= STEP_GRAD_TOL, f"phase 20 testopt route: the pose params' displacement "
                                   f"over {PROOF_K} steps, kernels vs plain f32, relative L2 "
                                   f"{e_move:.3e} > {STEP_GRAD_TOL}")
    print(f"phase 20 testopt route: {PROOF_K} steps, the pose params' displacement kernels vs "
          f"plain f32 relative L2 {e_move:.3e} (bound {STEP_GRAD_TOL}); each step's pose "
          f"gradient {', '.join(f'{e:.3e}' for e in e_grads)}; {int((~same).sum())} of "
          f"{same.numel()} components moved the other way, the rest {e_same:.3e}")


def _probe_routes(torch, nerf_args: str, ckpt: str, spin_npz: str) -> None:
    """exp_mining's probe (fixed inputs and noises, whole frames, the
    pretrained SPIN) on the seed-0 generator, rendered by the eval kernels
    and by the plain f32 pipeline, each arm's launches checked (dual and
    field in the first, none in the second). The bound is the rgb_map rule's
    allowance carried through SPIN, read in the same run: the probe of the
    plain frames with every pixel shifted by RENDER_TOL (a shared shift
    passes the crop's resize and SPIN's convolutions undiminished) and
    MAX_FLIP_FRAC of the pixels, drawn from a seeded generator, flipped to
    1 - v. The kernels' probe must sit within it of the plain probe, or
    within PROBE_F32_FLOOR where the allowance moves it less, and the
    allowance must move the probe at all."""
    import numpy as np

    from posegen_tpu_torch.cli.run_render import load_trained
    from posegen_tpu_torch.gen.generators import GenConfig, draw_noises
    from posegen_tpu_torch.gen.hmr import init_hmr
    from posegen_tpu_torch.gen.loop import GanLoopConfig, GanTrainer, NeRFRenderer
    from posegen_tpu_torch.kernels import field as F
    from posegen_tpu_torch.render import image as IMG
    from posegen_tpu_torch.tools import exp_mining as M

    _, cfg, variables = load_trained(nerf_args, ckpt, device=DEVICE)
    spin_params, spin_state = init_hmr(torch.Generator().manual_seed(2), device=DEVICE)
    spin_params, spin_state = M.load_spin(spin_npz, spin_params, spin_state)
    real = M.draw(300, 4, 0.15)
    noises = draw_noises(torch.Generator(device=DEVICE).manual_seed(777), 4, GenConfig())
    values, launches = {}, {}
    for tag in ("kernels", "plain", "allowance"):
        renderer = NeRFRenderer(cfg, variables, hw=PROOF_HW, chunk=32768)
        if tag != "kernels":
            renderer._render_fn, renderer.chunk = IMG._raygen_render_fn(cfg, False), 8192
        if tag == "allowance":
            plain_frames, rng = renderer.render_poses, np.random.default_rng(SEED)

            def allowed(bones, c2ws, window=None, f=plain_frames, rng=rng):
                imgs = f(bones, c2ws, window) + RENDER_TOL
                flip = rng.random(imgs.shape[:3]) < MAX_FLIP_FRAC
                imgs[flip] = 1.0 - imgs[flip]
                return imgs

            renderer.render_poses = allowed
        trainer = GanTrainer(GanLoopConfig(), renderer, spin_params, spin_state, seed=0,
                             device=DEVICE)
        F.reset_launches()
        values[tag] = M.probe(trainer, real, noises)
        torch.cuda.synchronize()
        launches[tag] = {k: v for k, v in F.LAUNCHES.items() if v}
    moved = {t: abs(values[t] - values["plain"]) for t in ("kernels", "allowance")}
    rel = {t: v / max(abs(values["plain"]), 1e-12) for t, v in moved.items()}
    print(f"phase 20 probe route: exp_mining's probe (4 frames of {PROOF_HW}^2) kernels "
          f"{values['kernels']:.9f} vs plain f32 {values['plain']:.9f}, relative "
          f"{rel['kernels']:.3e}; the bound, the plain frames shifted by {RENDER_TOL} with "
          f"{MAX_FLIP_FRAC:.0%} of pixels flipped: {values['allowance']:.9f}, relative "
          f"{rel['allowance']:.3e}; launches kernels {launches['kernels']}, plain "
          f"{launches['plain']}, allowance {launches['allowance']}")
    check(launches["kernels"].get("dual", 0) > 0 and launches["kernels"].get("field", 0) > 0,
          f"phase 20 probe route: the kernels arm launched {launches['kernels']}")
    for tag in ("plain", "allowance"):
        check(not launches[tag], f"phase 20 probe route: the {tag} arm launched {launches[tag]}")
    check(moved["allowance"] > 0.0, "phase 20 probe route: the rgb_map rule's allowance did "
                                    "not move the probe")
    check(math.isfinite(values["kernels"])
          and rel["kernels"] <= max(rel["allowance"], PROBE_F32_FLOOR),
          f"phase 20 probe route: kernels {values['kernels']:.9f} vs plain "
          f"{values['plain']:.9f}, relative {rel['kernels']:.3e} > the allowance's "
          f"{rel['allowance']:.3e} and the float32 floor {PROBE_F32_FLOOR:.3e}")


def _glob(d: str, pattern: str):
    import glob

    return sorted(glob.glob(os.path.join(d, pattern)))


if __name__ == "__main__":
    sys.exit(main())
