"""The PoseGen dataset-generation loop: G <-> NeRF render <-> SPIN feedback
(port of posegen_tpu/gen/loop.py).

The reference's `train_gan` / `train` / `run_render` (run_gan.py:
1956-2337): the renderer's weights stay on the device for the whole run
(the reference reloads the NeRF inside every render call,
run_gan.py:2308), and the rendered frames go to SPIN without the PNG
write / read (run_gan.py:2054-2081); an optional sink still writes the
(image, pose) pairs as the generated dataset.

The feedback frames take the JAX package's round trip:
`render_images_pipelined` reads them back to the host in float16 (one copy
a call), and `spin_forward` uploads the SPIN crop again. On a card the render runs the
eval kernels (`posegen_dual`, `posegen_field`), one of each a chunk.

Camera: the fixed extrinsic of every feedback render (run_gan.py:
2021-2028) is FEEDBACK_EXTRINSIC.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from posegen_tpu_torch.device import resolve_device
from posegen_tpu_torch.gen.discriminators import init_pos3d_discriminator
from posegen_tpu_torch.gen.gan import (
    SPIN_J14, FakePool, j14_index, make_discriminator_step, make_generator_step,
)
from posegen_tpu_torch.gen.generators import (
    GenConfig, draw_noises, init_pose_generator, pose_generator_apply,
)
from posegen_tpu_torch.gen.hmr import hmr_apply
from posegen_tpu_torch.parallel.mesh import Mesh, auto_render_fn
from posegen_tpu_torch.render.image import _upload, render_images_pipelined
from posegen_tpu_torch.render.raycast import PoseCtx, RaycastConfig
from posegen_tpu_torch.skeleton.cameras import nerf_extrinsic_to_c2w
from posegen_tpu_torch.skeleton.geometry import get_kp_bounding_cylinder
from posegen_tpu_torch.skeleton.kinematics import invert_rigid, smpl_l2ws, smpl_l2ws_from_rots
from posegen_tpu_torch.train.checkpoints import (
    _adam_flat, _adam_from_flat, _flatten, _unflatten_into,
)
from posegen_tpu_torch.train.trainer import param_leaves, trainable
from posegen_tpu_torch.utils.png import write_png

# fixed feedback camera (reference run_gan.py:2021-2028), ~65 deg yaw, 4.29 m out
FEEDBACK_EXTRINSIC = np.array(
    [
        [-5.29919172e-01, -5.56525674e-09, 8.48048140e-01, -1.34771157e-07],
        [1.47262004e-01, 9.84807813e-01, 9.20194958e-02, 1.26640154e-08],
        [-8.35164413e-01, 1.73648166e-01, -5.21868549e-01, 4.28571429e00],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SPIN_RES = 224
# where an optax.chain(clip_by_global_norm, adam(schedule)) state keeps
# Adam's (count, mu, nu) and the schedule's count: the chain's second entry
_CHAIN_ADAM = "1"


@dataclasses.dataclass
class GanLoopConfig:
    """Workload knobs (reference run_gan.py:63-133 argparse defaults)."""

    n_epochs: int = 50
    lr_g: float = 1e-4
    lr_d: float = 1e-4
    df: int = 2  # D update period
    feedback_every: int = 5  # SPIN feedback period (reference :2041)
    feedback_start_epoch: int = 2
    rpi: int = 20  # renders per feedback call
    render_hw: int = 512
    render_focal: float = 1000.0
    crop: Tuple[int, int] = (100, 412)  # center crop (reference :2069)
    pose_scale: float = 0.4
    spin_coef: float = 0.1
    output_dir: Optional[str] = None  # write the (image, pose) dataset when set
    # render the feedback frames only inside the SPIN crop window: every
    # consumer crops to `crop` first (reference run_gan.py:2069), so rays
    # outside it are dead work; the sink's PNGs keep black margins there
    feedback_crop: bool = True


def fk_joints(bones: torch.Tensor, scale: float = 0.4) -> torch.Tensor:
    """Axis-angle (B, 24, 3) -> world joints (B, 24, 3)."""
    return smpl_l2ws(bones, scale=scale)[..., :3, 3]


class NeRFRenderer:
    """The feedback renderer: the NeRF's variables stay on their device, and
    every call renders all its frames through `render_images_pipelined`
    with float16 readback, on the render `parallel.mesh.auto_render_fn`
    picks (JAX loop.py:98-107): on one rank its own device-raygen render
    (the eval kernels), on a world of ranks the cam render over all of them
    (each rank renders its share of every chunk; every rank gets the
    frames)."""

    def __init__(self, cfg: RaycastConfig, params: Dict[str, Any], hw: int = 512,
                 focal: float = 1000.0, pose_scale: float = 0.4, chunk: int = 8192,
                 white_bkgd: bool = False):
        self.cfg = cfg
        self.params = params
        self.hw = hw
        self.focal = focal
        self.pose_scale = pose_scale
        self.white_bkgd = white_bkgd  # reference run_gan --white_bkgd
        self.device = param_leaves(params)[0].device
        self._render_fn, self.chunk = auto_render_fn(cfg, chunk, half_readback=True)

    def render_poses(self, bones, c2ws: np.ndarray, window=None) -> np.ndarray:
        """One image per pose -> (K, H, W, 3) float32 in [0, 1] on the host
        (reference run_render, run_gan.py:2299-2337). bones: (K, 24, 3)
        axis-angle, host or device. The pose prep (FK, rigid inverse,
        cylinders) runs on the render's device; only the (K, 5) cylinder rows
        come to the host, for the 2D box math."""
        bones = torch.as_tensor(bones, dtype=torch.float32).to(self.device)
        l2ws = smpl_l2ws(bones, scale=self.pose_scale)
        kps = l2ws[..., :3, 3]
        skts = invert_rigid(l2ws)
        cyls_dev = get_kp_bounding_cylinder(kps, ext_scale=0.001).float()
        cyls = cyls_dev.cpu().numpy()
        ctxs = [PoseCtx(kps=kps[k:k + 1], skts=skts[k:k + 1], bones=bones[k:k + 1],
                        cyls=cyls_dev[k:k + 1]) for k in range(bones.shape[0])]
        return render_images_pipelined(
            self.cfg, self.params, self.hw, self.hw, self.focal, c2ws, ctxs, cyls,
            chunk=self.chunk, white_bkgd=self.white_bkgd, render_fn=self._render_fn,
            half_readback=True, window=window)


def prepare_spin_input(imgs: np.ndarray, crop: Tuple[int, int] = (100, 412),
                       device="cuda") -> torch.Tensor:
    """Centre-crop, resize to 224, ImageNet-normalise (reference run_gan.py:
    2066-2081): (K, H, W, 3) host frames -> (K, 3, 224, 224) on `device`.
    Only the crop is uploaded. The resize is JAX's `jax.image.resize(...,
    "linear")`, which antialiases when it shrinks (312 -> 224):
    F.interpolate's bilinear with antialias=True."""
    dev = resolve_device(device)
    lo, hi = crop
    x = _upload(np.asarray(imgs[:, lo:hi, lo:hi], np.float32), dev).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(SPIN_RES, SPIN_RES), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.as_tensor(IMAGENET_MEAN).to(dev)[:, None, None]
    std = torch.as_tensor(IMAGENET_STD).to(dev)[:, None, None]
    return (x - mean) / std


def spin_forward(spin_params: Dict, spin_state: Dict, imgs: np.ndarray,
                 crop: Tuple[int, int] = (100, 412), pose_scale: float = 0.4) -> torch.Tensor:
    """SPIN's 14 joints of the rendered frames, (K, 14, 3) on the params'
    device: crop / normalise, HMR in eval mode, FK of the predicted
    rotations (the JAX trainer's `_spin_fwd`). No gradient."""
    dev = spin_params["conv1"]["w"].device
    with torch.no_grad():
        x = prepare_spin_input(imgs, crop, dev)
        rotmat = hmr_apply(spin_params, spin_state, x)[0]
        joints = smpl_l2ws_from_rots(rotmat, scale=pose_scale)[..., :3, 3]
        return joints.index_select(1, j14_index(dev))


def probe_hardness(trainer: "GanTrainer", probe_real: np.ndarray,
                   probe_noises: Dict[str, torch.Tensor]) -> float:
    """Mean root-centred 14-joint SPIN error on poses generated from FIXED
    inputs and noises: the hardness of the generator's current output
    against the current estimator, the quantity the feedback reward pushes
    up, measured at matched inputs so that epochs compare (the JAX package
    takes a fixed PRNG key for the noises)."""
    with torch.no_grad():
        real = torch.as_tensor(probe_real, dtype=torch.float32).to(trainer.device)
        out, _ = pose_generator_apply(trainer.g_params, trainer.g_state, None, real,
                                      trainer.gen_cfg, noises=probe_noises)
        bones = out["pose_ba"]
        c2w = nerf_extrinsic_to_c2w(FEEDBACK_EXTRINSIC)
        imgs = trainer.renderer.render_poses(
            bones, np.broadcast_to(c2w, (len(bones), 4, 4)),
            window=trainer.cfg.crop if trainer.cfg.feedback_crop else None)
        pred = spin_forward(trainer.spin_params, trainer.spin_state, imgs, trainer.cfg.crop,
                            trainer.cfg.pose_scale)
        gt = fk_joints(bones, trainer.cfg.pose_scale).index_select(1, j14_index(bones.device))
        err = (pred - pred[:, :1]) - (gt - gt[:, :1]).to(pred.device)
        return float(torch.linalg.norm(err, dim=-1).mean())


def _host(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalar tensors -> floats, in one device-to-host copy."""
    return dict(zip(stats, torch.stack(list(stats.values())).tolist()))


class GanTrainer:
    """Orchestrates the loop (reference train(), run_gan.py:2259-2297) on
    one device. Randomness: the generator's weights from a CPU generator
    seeded `seed` (the discriminator's `seed + 1`), so a seed gives the same
    weights on every device; the noises from `self.generator` on the
    device; the render selection and the fake pool from numpy, as in the
    JAX package.

    mesh: a `parallel.mesh.Mesh` of more than one rank runs the G and D
    steps data-parallel over it (parallel/gan.py: sync-BN, summed
    gradients; JAX loop.py:210-228), on the mesh's device. Every rank runs
    this same loop on the same global pose batches: the noises, the render
    selection, the fake pool and SPIN on the rendered frames are the same
    on every rank, each rank trains on its rows of the batch, and only rank
    0 writes the dataset sink. The pose batches must divide over the
    ranks."""

    def __init__(
        self,
        loop_cfg: GanLoopConfig,
        renderer: Optional[NeRFRenderer],
        spin_params: Optional[Dict] = None,
        spin_state: Optional[Dict] = None,
        gen_cfg: GenConfig = GenConfig(),
        steps_per_epoch: int = 1000,
        seed: int = 0,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"GanTrainer(mesh=...): a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.rank = 0 if mesh is None else mesh.rank
        self.cfg = loop_cfg
        self.gen_cfg = gen_cfg
        self.renderer = renderer
        self.spin_params = spin_params
        self.spin_state = spin_state
        g_params, self.g_state = init_pose_generator(torch.Generator().manual_seed(seed),
                                                     gen_cfg, self.device)
        self.g_params = trainable(g_params)
        self.d_params = trainable(init_pos3d_discriminator(
            torch.Generator().manual_seed(seed + 1), self.device))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        fk = lambda b: fk_joints(b, loop_cfg.pose_scale)  # noqa: E731
        g_kw = dict(lr=loop_cfg.lr_g, n_epochs=loop_cfg.n_epochs,
                    steps_per_epoch=steps_per_epoch, spin_coef=loop_cfg.spin_coef)
        d_kw = dict(lr=loop_cfg.lr_d, n_epochs=loop_cfg.n_epochs,
                    steps_per_epoch=steps_per_epoch)
        if mesh is not None and mesh.size > 1:
            from posegen_tpu_torch.parallel.gan import (
                make_parallel_discriminator_step, make_parallel_generator_step,
            )

            self.g_opt, self.g_step = make_parallel_generator_step(mesh, fk, gen_cfg, **g_kw)
            self.d_opt, self.d_step = make_parallel_discriminator_step(mesh, **d_kw)
        else:
            self.g_opt, self.g_step = make_generator_step(fk, gen_cfg, **g_kw)
            self.d_opt, self.d_step = make_discriminator_step(**d_kw)
        self.g_opt_state = self.g_opt.init(self.g_params)
        self.d_opt_state = self.d_opt.init(self.d_params)
        self.fake_pool = FakePool(seed=seed)
        self.iter_num = 0
        self.epoch = 0
        self._render_count = 0
        self._last_bones: Optional[np.ndarray] = None
        self._png_pool = None
        self._png_futs: list = []

    def _draw_noises(self, batch: int) -> Dict[str, torch.Tensor]:
        """This iteration's generator noises (the JAX trainer's key split)."""
        return draw_noises(self.generator, batch, self.gen_cfg)

    def spin_feedback(self, bones: np.ndarray, sel: np.ndarray) -> torch.Tensor:
        """Render the selected poses, run SPIN, return its 14-joint sets
        (K, 14, 3): constants for G (reference run_gan.py:2041-2091)."""
        c2w = nerf_extrinsic_to_c2w(FEEDBACK_EXTRINSIC)
        imgs = self.renderer.render_poses(
            bones[sel], np.broadcast_to(c2w, (len(sel), 4, 4)),
            window=self.cfg.crop if self.cfg.feedback_crop else None)
        if self.cfg.output_dir:  # optional dataset sink
            self._save_renders(imgs, bones[sel])
        return spin_forward(self.spin_params, self.spin_state, imgs, self.cfg.crop,
                            self.cfg.pose_scale)

    def _save_renders(self, imgs: np.ndarray, bones: np.ndarray) -> None:
        """(image, pose) dataset export (reference run_gan.py:2049-2059,
        2333-2337: render_output/{run}/image/%05d.png + poses npys), written
        by the port's own PNG codec (utils/png.py). The PNG encodes run on a
        small writer pool (zlib releases the GIL); flush_sink joins it. Under
        a mesh only rank 0 writes; every rank counts the renders."""
        if self.rank != 0:
            self._render_count += len(imgs)
            return
        img_dir = os.path.join(self.cfg.output_dir, "image")
        os.makedirs(img_dir, exist_ok=True)
        if self._png_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._png_pool = ThreadPoolExecutor(max_workers=2)

        u8 = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        for i, img in enumerate(u8):
            path = os.path.join(img_dir, f"{self._render_count + i:05d}.png")
            # compress_level 1: a faster zlib pass; the sink is a training
            # dataset, size is cheaper than host stalls
            self._png_futs.append(self._png_pool.submit(write_png, path, img, 1))
        if len(self._png_futs) > 256:
            self.flush_sink()
        np.save(os.path.join(self.cfg.output_dir,
                             f"poses_axis_angles{self._render_count}.npy"), bones)
        self._render_count += len(imgs)

    def flush_sink(self) -> None:
        """Wait for the queued dataset writes; re-raise the first failure."""
        futs, self._png_futs = self._png_futs, []
        for f in futs:
            f.result()

    def train_step(self, real_pose: np.ndarray) -> Dict[str, float]:
        """One GAN iteration (reference run_gan.py:1993-2120)."""
        real = torch.as_tensor(np.asarray(real_pose, np.float32)).to(self.device)
        use_feedback = (
            self.renderer is not None
            and self.spin_params is not None
            and self.epoch > self.cfg.feedback_start_epoch
            and self.iter_num % self.cfg.feedback_every == 0
        )
        B = real.shape[0]
        rpi = min(self.cfg.rpi, B)
        noises = self._draw_noises(B)
        if use_feedback:
            # the generator's forward with the update's own noises: the
            # rendered, SPIN-judged poses are this iteration's generated
            # poses (reference run_gan.py:2041-2091); its BN state is dropped
            # and the step recomputes it
            with torch.no_grad():
                out_pre, _ = pose_generator_apply(self.g_params, self.g_state, None, real,
                                                  self.gen_cfg, noises=noises)
            bones_now = out_pre["pose_ba"].cpu().numpy()
            sel = np.random.default_rng(self.iter_num).integers(0, B, (rpi,))
            spin_pred = self.spin_feedback(bones_now, sel)
            spin_sel = torch.as_tensor(sel).to(self.device)
            active = 1.0
        else:
            spin_pred = torch.zeros((rpi, len(SPIN_J14), 3), device=self.device)
            spin_sel = torch.zeros((rpi,), dtype=torch.long, device=self.device)
            active = 0.0

        self.g_params, self.g_state, self.g_opt_state, out, g_stats = self.g_step(
            self.g_params, self.g_state, self.g_opt_state, self.d_params, noises, real,
            spin_pred, spin_sel, active)
        self._last_bones = out["pose_ba"].cpu().numpy()
        stats = _host(g_stats)
        if self.iter_num % self.cfg.df == 0:
            pooled = self.fake_pool(self._last_bones)
            self.d_params, self.d_opt_state, d_stats = self.d_step(
                self.d_params, self.d_opt_state, real, torch.as_tensor(pooled).to(self.device))
            stats.update(_host(d_stats))
        self.iter_num += 1
        return stats

    def train_epoch(self, pose_batches) -> Dict[str, float]:
        """Epoch stats are MEANS over the epoch's iterations; `spin_loss` is
        averaged over the feedback iterations only and reported beside their
        count."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for batch in pose_batches:
            for k, v in self.train_step(batch).items():
                if k == "spin_loss" and v == 0.0:
                    continue  # inactive-feedback iterations carry a structural 0
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1
        self.epoch += 1
        out = {k: sums[k] / counts[k] for k in sums}
        out["n_feedback_iters"] = float(counts.get("spin_loss", 0))
        return out

    # -- checkpoint / resume: the JAX package's .npz, key for key (params, BN
    # state, both optimisers at optax's paths, the fake pool with its RNG
    # state, the loop counters), plus the torch generator's state under
    # TORCH_GENERATOR_KEY, which the port's noises continue from. The JAX
    # PRNG `key` (uint32[2], jax.random.PRNGKey's layout) is a hash of that
    # state, so that the JAX package's GanTrainer loads the file and draws
    # its own noises from there --

    TORCH_GENERATOR_KEY = "torch_generator_state"

    def _trees(self) -> Dict[str, Any]:
        return {"g_params": self.g_params, "g_state": self.g_state, "d_params": self.d_params}

    def save_checkpoint(self, path: str) -> str:
        self.flush_sink()  # the checkpoint's render_count must match the disk
        flat = _flatten(self._trees())
        for name, st in (("g_opt_state", self.g_opt_state), ("d_opt_state", self.d_opt_state)):
            flat.update(_adam_flat(f"{name}//{_CHAIN_ADAM}", st.count, st.mu, st.nu))
        flat["iter_num"] = np.asarray(self.iter_num)
        flat["epoch"] = np.asarray(self.epoch)
        flat["render_count"] = np.asarray(self._render_count)
        if self.fake_pool.items:
            flat["pool_items"] = np.stack(self.fake_pool.items)
        flat["pool_rng_state"] = np.frombuffer(
            pickle.dumps(self.fake_pool.rng.bit_generator.state), np.uint8)
        flat[self.TORCH_GENERATOR_KEY] = self.generator.get_state().numpy()
        digest = hashlib.sha256(flat[self.TORCH_GENERATOR_KEY].tobytes()).digest()
        flat["key"] = np.frombuffer(digest[:8], np.uint32).copy()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **flat)
        return path

    def load_checkpoint(self, path: str) -> "GanTrainer":
        """Restore a checkpoint written by this class or by the JAX
        package's GanTrainer (whose PRNG key is ignored, with a warning:
        the noise stream continues from this trainer's generator)."""
        raw = dict(np.load(path))
        trees = _unflatten_into(self._trees(), raw)
        self.g_params, self.g_state = trainable(trees["g_params"]), trees["g_state"]
        self.d_params = trainable(trees["d_params"])
        for name in ("g_opt_state", "d_opt_state"):
            st = getattr(self, name)
            st.count, st.mu, st.nu = _adam_from_flat(raw, f"{name}//{_CHAIN_ADAM}", st.mu)
        self.iter_num = int(raw["iter_num"])
        self.epoch = int(raw["epoch"])
        self._render_count = int(raw["render_count"])
        self.fake_pool.items = list(raw["pool_items"]) if "pool_items" in raw else []
        # numpy's own bit-generator state, pickled by save_checkpoint
        self.fake_pool.rng.bit_generator.state = pickle.loads(raw["pool_rng_state"].tobytes())
        if self.TORCH_GENERATOR_KEY in raw:
            self.generator.set_state(torch.as_tensor(raw[self.TORCH_GENERATOR_KEY]))
        elif "key" in raw:
            warnings.warn(f"{path}: the JAX PRNG key is ignored; the noises continue from "
                          "this trainer's torch generator", stacklevel=2)
        return self
