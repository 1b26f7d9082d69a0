"""Data parallelism over ranks (port of posegen_tpu/parallel/mesh.py).

The JAX package runs one controller over a 1-D mesh of local devices (plus
`jax.distributed` across hosts), with parameters replicated, ray batches
sharded along axis 0 and the whole train step under `shard_map`. PyTorch's
idiom is one process per device, so here:

  * a JAX mesh device is a rank of a `torch.distributed` group, and a JAX
    host (`jax.process_index()`) is a node of the world;
  * every rank runs the same host code with the same seeds, so the
    replicated state stays equal on every rank without being sent around;
    ranks exchange only gradients, statistics, BN moments, gathered joints
    and rendered tiles, through the collectives of this module (one
    flattened buffer per call, not one call per leaf);
  * the steps are functions on dicts of tensors, so the collectives are
    explicit: no `DistributedDataParallel` (it wraps an `nn.Module`) and no
    `nn.SyncBatchNorm` (its variance rule is not the JAX package's). A
    collective on a differentiated path is an autograd Function with its
    backward written out (`sync_sum`, `gather_rows`).

`Mesh(group, rank, size, device, backend)` is what the factories take where
the JAX package takes a `jax.sharding.Mesh`; `launch(fn, n, device)` spawns
n local ranks (the counterpart of JAX's implicit local devices), and
`init_from_env` joins a world that `torchrun` started.

Backends. `nccl` for ranks on CUDA devices, one card each; `gloo` for CPU
ranks (the tests), and for more ranks than cards (two ranks on one card:
NCCL refuses two ranks on one device). gloo takes CUDA tensors in every
collective this module calls (all_reduce, broadcast, all_gather; also
all_gather_into_tensor and reduce_scatter_tensor, float32 and float16, on
an H100 with torch 2.11.0+cu128), so no collective stages through host
memory: each runs on the tensors where they lie, for either backend.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ranks: the process group, this process's rank in it,
    its size, the rank's device and the group's backend. Hashed by
    identity, so factories memoise on it."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str


# the device init_rank chose, and the default group it chose it for
_RANK_DEVICE: Optional[torch.device] = None
_RANK_WORLD: Any = None
_MESHES: Dict[Optional[int], Mesh] = {}


def backend_for(device, n: int) -> str:
    """nccl for n ranks on CUDA with at least n cards, else gloo."""
    dev = torch.device(device)
    if dev.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """cuda:local_rank (modulo the cards, where ranks outnumber them), or
    the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))


def init_rank(init_method: str, rank: int, world: int, device, local_rank: Optional[int] = None,
              backend: Optional[str] = None) -> torch.device:
    """Join the default process group as `rank` of `world` -> this rank's
    device. backend: `backend_for(device, world)` when None."""
    global _RANK_DEVICE, _RANK_WORLD
    local_rank = rank if local_rank is None else local_rank
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(device, world), init_method=init_method,
                            rank=rank, world_size=world)
    _RANK_DEVICE, _RANK_WORLD = dev, dist.group.WORLD
    _MESHES.clear()
    return dev


def init_from_env(device="cuda") -> torch.device:
    """Join the world `torchrun` describes (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT) -> this rank's device."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    return init_rank("env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device,
                     local_rank=local, backend=backend_for(device, local_world))


def node_index_count() -> tuple:
    """(this rank's node, the number of nodes): the JAX package's
    (jax.process_index(), jax.process_count()). From torchrun's GROUP_RANK
    and the world over LOCAL_WORLD_SIZE; (0, 1) outside a world or in one
    `launch` started."""
    if not dist.is_initialized() or "GROUP_RANK" not in os.environ:
        return 0, 1
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return int(os.environ["GROUP_RANK"]), max(dist.get_world_size() // local_world, 1)


def shutdown() -> None:
    """Leave the default process group."""
    global _RANK_DEVICE, _RANK_WORLD
    _RANK_DEVICE = _RANK_WORLD = None
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None) -> Optional[Mesh]:
    """The mesh over the default group's ranks, or over its first
    `n_devices` (JAX make_mesh, posegen_tpu/parallel/mesh.py:35-39). Every
    rank of the world must call it; a rank outside the first n gets None.
    Memoised per n, so the factories' caches see one mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with launch() or "
                           "torchrun")
    world = dist.get_world_size()
    n = world if n_devices in (None, world) else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n_devices} devices, the world has {world}")
    key = None if n == world else n
    if key not in _MESHES:
        group = dist.group.WORLD if key is None else dist.new_group(list(range(n)))
        rank = dist.get_rank()
        _MESHES[key] = Mesh(group, rank, n, _group_device(), dist.get_backend()) if rank < n \
            else None
    return _MESHES[key]


def _group_device() -> torch.device:
    """This rank's device: the one `init_rank` chose, else the current card
    of an NCCL group. A gloo group started some other way does not say
    whether its ranks compute on the CPU or on cards, so it is refused."""
    if _RANK_DEVICE is not None and _RANK_WORLD is dist.group.WORLD:
        return _RANK_DEVICE
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(f"make_mesh: the {dist.get_backend()} process group was not started by "
                       "init_rank / init_from_env / launch, so the rank's device is unknown; "
                       "start it through init_rank(..., device)")


# ---------------------------------------------------------------------------
# launching local ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn, n: int, device, init_method: str, args) -> None:
    init_rank(init_method, rank, n, device)
    try:
        fn(make_mesh(), *args)
    finally:
        shutdown()


def launch(fn: Callable, n: int, device="cuda", args: Sequence = ()) -> None:
    """Run fn(mesh, *args) on n local ranks, one spawned process each, and
    wait for all of them; raises if any rank fails. The ranks meet through
    a `file://` rendezvous in a fresh temporary directory (no TCP port to
    clash with another job). device: "cuda" (one card per rank with NCCL,
    or gloo where ranks outnumber the cards) or "cpu" (gloo). fn must be
    importable by the spawned processes (a module-level function); what it
    returns is dropped, so ranks report through files."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="posegen_rdv_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(_rank_main, args=(fn, n, str(device), init, tuple(args)), nprocs=n,
                           join=True, start_method="spawn")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _all_reduce_flat(mesh: Mesh, flat: torch.Tensor) -> torch.Tensor:
    """Sum of a contiguous 1-D tensor over the ranks, in place."""
    dist.all_reduce(flat, group=mesh.group)
    return flat


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def all_reduce_sum(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sums over the ranks of a list of tensors of one
    dtype, in one collective on one flattened buffer (new tensors, no
    gradient)."""
    tensors = list(tensors)
    if not tensors:
        return []
    return _unflat(_all_reduce_flat(mesh, _flat(tensors)), tensors)


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """JAX's pmean: `all_reduce_sum` over the rank count."""
    return [t / mesh.size for t in all_reduce_sum(mesh, tensors)]


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's x stacked along dim 0 in rank order: JAX's
    all_gather(x, axis, axis=0, tiled=True). No gradient (see
    `gather_rows`)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank `src`'s, in place (one collective per
    dtype, on the mesh's device: tensors elsewhere, such as Adam's step
    counts on the host, go through it)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(mesh.device) for t in group])
        dist.broadcast(flat, src, group=mesh.group)
        with torch.no_grad():
            for t, v in zip(group, _unflat(flat, group)):
                t.copy_(v)


class _SyncSum(torch.autograd.Function):
    """all_reduce(sum) whose backward all-reduces the cotangent: the
    transpose of JAX's psum under shard_map(check_vma=False)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_flat(mesh, x.detach().reshape(-1).clone()).view(x.shape)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_flat(ctx.mesh, g.reshape(-1).clone()).view(g.shape), None


class _GatherRows(torch.autograd.Function):
    """all_gather along dim 0 whose backward all-reduces the cotangent and
    keeps this rank's rows (a reduce-scatter): the transpose of JAX's
    tiled all_gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        full = _all_reduce_flat(ctx.mesh, g.reshape(-1).clone()).view(g.shape)
        lo = ctx.mesh.rank * ctx.rows
        return full[lo:lo + ctx.rows], None


def sync_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the ranks."""
    return _SyncSum.apply(x, mesh)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Differentiable `all_gather_rows`."""
    return _GatherRows.apply(x, mesh)


def local_rows(mesh: Mesh, x, what: str = "batch"):
    """This rank's contiguous rows of a global array (dim 0 divided evenly
    over the ranks)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{what} ({n}) must divide evenly over the {mesh.size}-device mesh — "
                         "pad or trim the batch")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def fold_generator(gen: torch.Generator, mesh: Mesh) -> torch.Generator:
    """A generator for this rank alone, seeded from (a draw of `gen`, rank):
    JAX's fold_in(key, axis_index). `gen` advances by one draw on every
    rank alike."""
    seed = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))
    s = int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=gen.device).manual_seed(s)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nested structure of dicts (keys sorted), lists,
    tuples, dataclasses and optimizers (their per-parameter state), in a
    fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in tree_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    if isinstance(tree, torch.optim.Optimizer):
        return [t for p in (q for g in tree.param_groups for q in g["params"])
                for t in tree_tensors(tree.state.get(p, {}))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tree_tensors(getattr(tree, f.name))]
    return []


def replicate(tree, mesh: Mesh):
    """Rank 0's values in every tensor of `tree`, in place (JAX replicate:
    device_put with a replicated sharding) -> tree. Refuses, with a
    ValueError on every rank, a tree whose tensor count, shapes or dtypes
    differ across the ranks."""
    import hashlib

    leaves = tree_tensors(tree)
    sig = repr([(tuple(t.shape), str(t.dtype)) for t in leaves])
    h = int(np.frombuffer(hashlib.sha256(sig.encode()).digest()[:8], np.int64)[0])
    mine = torch.tensor([[len(leaves), h]], dtype=torch.int64, device=mesh.device)
    every = all_gather_rows(mesh, mine)
    if not bool((every == mine).all()):
        raise ValueError("replicate: the tree's tensors differ in count, shape or dtype across "
                         f"the ranks ({every.tolist()})")
    broadcast_(mesh, leaves)
    return tree


def check_replicated(tree, mesh: Mesh, what: str = "state") -> None:
    """Raise RuntimeError on every rank unless every tensor of `tree` is
    bit-equal across the ranks (a hash of their bytes gathered): ranks whose
    host logic parted ways leave no other trace."""
    import hashlib

    h = hashlib.sha256()
    for t in tree_tensors(tree):
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    mine = torch.tensor([[int(np.frombuffer(h.digest()[:8], np.int64)[0])]], dtype=torch.int64,
                        device=mesh.device)
    every = all_gather_rows(mesh, mine)
    if not bool((every == mine).all()):
        raise RuntimeError(f"the ranks' {what} differ (hashes {every.reshape(-1).tolist()})")


def world_rank() -> int:
    """This process's rank in the default group (0 outside one): rank 0
    alone writes a run's files."""
    return dist.get_rank() if dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def batch_pspecs(batch: Dict[str, Any], n_devices: int,
                 n_rays: Optional[int] = None) -> Dict[str, bool]:
    """Whether each batch leaf splits along dim 0 over the ranks (True) or
    is replicated (False): JAX batch_pspecs (posegen_tpu/parallel/
    mesh.py:48-82).

    Layout contract (RayBatchLoader, data/h5dataset.py): per-ray leaves have
    leading dim N (rays contiguous per image group); per-image-group pose
    rows (skts / kp3d / bones / cyls / ...) have leading dim G with N % G
    == 0; replicated leaves have leading dim 1 (or are scalars). Both N- and
    G-leaves split, so each rank gets whole image groups with exactly their
    rays. Anything else is a ValueError, never a silent replicate."""
    if n_rays is None:
        n_rays = int(batch["rays_o"].shape[0])
    if n_rays % n_devices != 0:
        raise ValueError(f"ray batch ({n_rays}) must divide evenly over {n_devices} devices")
    specs: Dict[str, bool] = {}
    for k, v in batch.items():
        dim0 = v.shape[0] if getattr(v, "ndim", 0) >= 1 else None
        if dim0 is None or dim0 == 1:
            specs[k] = False
        elif dim0 == n_rays or dim0 % n_devices == 0:
            specs[k] = True
        else:
            raise ValueError(
                f"batch leaf {k!r} has leading dim {dim0}, which neither matches the ray count "
                f"({n_rays}) nor divides over {n_devices} devices — pad the image-group count "
                "to a multiple of the mesh size")
    return specs


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch (numpy arrays or tensors), on the
    rank's device: the contiguous rows of every leaf that `batch_pspecs`
    splits, the whole of the rest. A pinned host batch goes up without a
    stream synchronisation."""
    specs = batch_pspecs(batch, mesh.size)
    out = {}
    for k, v in batch.items():
        if specs[k]:
            b = v.shape[0] // mesh.size
            v = v[mesh.rank * b:(mesh.rank + 1) * b]
        out[k] = torch.as_tensor(v).to(mesh.device, non_blocking=True)
    return out


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

def _padded_rows(x: torch.Tensor, size: int) -> torch.Tensor:
    """x with its last row repeated up to a multiple of `size` rows."""
    pad = -x.shape[0] % size
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) if pad else x


def make_parallel_render(render_fn, mesh: Mesh):
    """A `(params, rays_o, rays_d, ctx) -> maps` render with the rays split
    over the ranks and the maps gathered back (DataParallel's scatter /
    gather-on-GPU0). A ray count the mesh does not divide is padded with
    copies of the last ray, and the padding cut from the maps."""

    def render(params, rays_o, rays_d, ctx):
        n = rays_o.shape[0]
        o = local_rows(mesh, _padded_rows(rays_o, mesh.size), "ray batch")
        d = local_rows(mesh, _padded_rows(rays_d, mesh.size), "ray batch")
        out = render_fn(params, o, d, ctx)
        return {k: all_gather_rows(mesh, v)[:n] for k, v in out.items()}

    return render


@functools.lru_cache(maxsize=8)
def make_shardmap_render(cfg, mesh: Mesh, use_fused=None):
    """The eval render with each rank rendering its share of the host rays
    (through the eval kernels on a card) and the maps gathered back. ctx is
    single-pose (leading dim 1), the same on every rank. Memoised, keyed on
    (cfg, mesh, use_fused)."""
    from posegen_tpu_torch.render.raycast import render_rays

    def per_rank(params, rays_o, rays_d, ctx):
        # the mean code iff the ctx carries no frame index (reference
        # render_testset passes cams=cam_idxs when opt_framecode)
        out = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0, raw_noise_std=0.0,
                          eval_mean_code=ctx.cam_idxs is None, use_fused=use_fused,
                          coarse_rgb=False)
        return {k: out[k] for k in ("rgb_map", "acc_map", "disp_map")}

    return make_parallel_render(per_rank, mesh)


@functools.lru_cache(maxsize=8)
def make_shardmap_render_cam(cfg, mesh: Mesh, chunk: int, use_fused=None,
                             half_readback: bool = False):
    """The device-raygen render over the ranks (JAX make_shardmap_render_cam,
    posegen_tpu/parallel/mesh.py:150-195): for a chunk of n <= `chunk` rays
    at box offset `start`, each rank makes its chunk / size rays at `start +
    rank * (chunk / size)` from the cam pack (`render.image.rays_from_box`;
    offsets past the box clamp to its last ray), renders them (the dual and
    field kernels on a card), and the KEEP_MAPS are gathered in rank order
    (float16 with `half_readback`) and cut to n. Tagged `takes_cam` for
    `render_image`. Memoised, keyed on (cfg, mesh, chunk, flags)."""
    from posegen_tpu_torch.render.image import KEEP_MAPS, rays_from_box
    from posegen_tpu_torch.render.raycast import render_rays

    local_n = chunk // mesh.size
    if local_n * mesh.size != chunk:
        raise ValueError(f"chunk {chunk} not divisible by mesh size {mesh.size}")

    def fn(params, cam, start, n, ctx):
        if n > chunk:
            raise ValueError(f"{n} rays in a chunk of {chunk}")
        rays_o, rays_d = rays_from_box(cam, start + mesh.rank * local_n, local_n)
        out = render_rays(cfg, params, rays_o, rays_d, ctx, perturb=0.0, raw_noise_std=0.0,
                          eval_mean_code=ctx.cam_idxs is None, use_fused=use_fused,
                          coarse_rgb=False)
        maps = [out[k].to(torch.float16) if half_readback else out[k] for k in KEEP_MAPS]
        return {k: all_gather_rows(mesh, v)[:n] for k, v in zip(KEEP_MAPS, maps)}

    fn.takes_cam = True
    return fn


def auto_render_fn(cfg, chunk: int, use_fused=None, half_readback: bool = False):
    """(render_fn, chunk) for the current world (JAX auto_render_fn,
    posegen_tpu/parallel/mesh.py:198-236): on a world of one rank (None,
    chunk), so callers keep the single-device device-raygen render;
    otherwise the cam render over every rank with the chunk rounded down to
    a multiple of the world. A config the eval kernels refuse clamps the
    chunk to 8192 with `warn_fused_fallback`: the plain pipeline
    materialises the per-point encodings (the reference's own eval tiling,
    chunk // 8, run_nerf.py:157)."""
    from posegen_tpu_torch.kernels.field import (
        fused_config_disqualification, warn_fused_fallback,
    )

    if use_fused is not False:
        reason = fused_config_disqualification(cfg)
        if reason is not None:
            if chunk > 8192:
                warn_fused_fallback("auto_render_fn", reason,
                                    extra=f" Eval chunk clamped {chunk} -> 8192.")
                chunk = 8192
            else:
                warn_fused_fallback("auto_render_fn", reason)
    if world_size() <= 1:
        return None, chunk
    mesh = make_mesh()
    chunk = chunk - (chunk % mesh.size) or mesh.size
    return make_shardmap_render_cam(cfg, mesh, chunk, use_fused=use_fused,
                                    half_readback=half_readback), chunk


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def make_shardmap_train_step(cfg, tcfg, pcfg=None, *, mesh: Mesh, rest_pose=None, kp_map=None,
                             n_frames: int = 0, fold_key_per_device: bool = True):
    """The full train step (pose refinement, framecodes, embedder schedules,
    both optimisers) data-parallel over the ranks (JAX
    make_shardmap_train_step, posegen_tpu/parallel/mesh.py:239-289): each
    rank runs `make_train_step(..., mesh=mesh)` on its shard of the batch
    (`shard_batch`: whole image groups with their rays) through the
    trainable kernels on its card; gradients and stats are averaged over the
    ranks before the Adam updates, so the replicated state stays equal on
    every rank.

    -> step(state, shard, generator=None) -> (state, stats), the
    single-device step's signature on this rank's shard.
    fold_key_per_device: draw each rank's sampling and density noise from a
    generator seeded from (generator, rank); False keeps one stream, so that
    a run without noise is exactly the single-device step."""
    from posegen_tpu_torch.train.trainer import make_train_step

    base = make_train_step(cfg, tcfg, pcfg, rest_pose=rest_pose, kp_map=kp_map,
                           n_frames=n_frames, mesh=mesh)

    def step(state, shard, generator=None):
        if fold_key_per_device and generator is not None:
            generator = fold_generator(generator, mesh)
        return base(state, shard, generator)

    return step
