"""posegen_tpu_torch kernels/variants.py and tools/exp_kernel_variants.py
against tools/exp_kernel_variants.py (the JAX A/B harness of kernel 2).

`variant_plain` at float32 matmuls is held against the JAX `variant_field`
run in interpret mode at MM_DTYPE = float32, for each case of the harness,
both probes and a two-group problem: make_problem's 4 rays x 32 samples,
one direction per point, the coarse net through params_from_numpy (bf16
weights on both sides). Also: the wrapper contract on the CPU, the
kernel's rules (its tile, halves, the built cases) and the ported
harness's --cpu run. The CUDA kernel itself runs in chip_smoke.py phase 9
on the card.

The JAX tool is imported by path: tools/ is not a package. Its jit does not
key on F.MM_DTYPE, so every call clears its cache before and after.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import posegen_tpu.kernels.field as jfield
from posegen_tpu.render import raycast as jr
from posegen_tpu.utils.fixtures import make_pose_ctx as j_make_pose_ctx
from posegen_tpu.utils.fixtures import make_problem as j_make_problem
from posegen_tpu_torch.kernels import field as tfield
from posegen_tpu_torch.kernels import variants as tvar
from posegen_tpu_torch.tools import exp_kernel_variants as harness
from posegen_tpu_torch.utils.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_exp_kernel_variants", os.path.join(ROOT, "tools", "exp_kernel_variants.py"))
jvar = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jvar)

N_RAYS, N_SAMPLES = 4, 32  # 128 points
F32_TOL = 1e-4  # max|diff|: float32 rounding and the f32 transcendental ulps
# Cases that round to bf16 (bf16act, both, bf16enc, pipe2, pipe4): relative
# L2 of the raw. Where XLA's and torch's float32 sin / cos differ by an ulp,
# a channel can round to the neighbouring bf16 value (2^-8 relative), and
# the net carries that difference to the raw (relative L2 <= 2.2e-5 seen
# here); the rounding these cases model moves the raw about 7x further than
# the bound (test_bf16_tolerance_separates).
BF16_REL_L2 = 2e-4
BF16_CASES = {"bf16act", "both", "bf16enc", "pipe2", "pipe4"}
ALL_CASES = dict(harness.CASES + harness.PROBES)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def _problem(n_groups):
    """(JAX operands, port operands) of the harness's problem at 4 rays x 32
    samples; n_groups == 2: two random poses over two rays each."""
    cfg, params, ctx, ro, rd = j_make_problem(jr.RaycastConfig(), n_rays=N_RAYS)
    z = np.linspace(0.1, 4.0, N_SAMPLES, dtype=np.float32)
    ro, rd = np.asarray(ro), np.asarray(rd)
    pts = (ro[:, None] + rd[:, None] * z[:, None]).reshape(-1, 3).astype(np.float32)
    dirs = np.broadcast_to(rd[:, None], (N_RAYS, N_SAMPLES, 3)).reshape(-1, 3).copy()
    skts = np.array(ctx.skts[:1] if n_groups == 1
                    else j_make_pose_ctx(5, n_poses=n_groups).skts)
    G = skts.shape[0]
    jax_ops = (
        jnp.asarray(pts.T), jnp.asarray(dirs.T),
        jnp.asarray(skts[:, :, :3, :3].reshape(G, 24, 9)),
        jnp.asarray(skts[:, :, :3, 3].reshape(G, 24, 3)),
        params["embed_kp"]["cutoff_dist"][:, None], params["embed_kp"]["tau"].reshape(1, 1),
        jnp.zeros((1, 1), jnp.float32), jfield.prepare_params(params["coarse"], skips=(4,)),
    )
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    L = tfield.net_layout(cfg.netdepth, cfg.multires, cfg.multires_views)
    port = harness.Problem(
        torch.as_tensor(pts), torch.as_tensor(dirs),
        tfield.pack_poses(torch.as_tensor(skts), tp["embed_kp"], cfg.multires,
                          cfg.multires_views),
        tfield.prepare_net(tp["coarse"], L))
    return jax_ops, port


@functools.lru_cache(maxsize=None)
def _jax_out(name, n_groups=1, tile=128):
    """JAX variant_field in interpret mode at MM_DTYPE = float32 -> (P, 4)."""
    ops, _ = _problem(n_groups)
    orig = jfield.MM_DTYPE
    jvar.variant_field.clear_cache()
    jfield.MM_DTYPE = jnp.float32
    try:
        out = jvar.variant_field(*ops, tile=tile, interpret=True, **ALL_CASES[name])
        return np.asarray(out).T
    finally:
        jfield.MM_DTYPE = orig
        jvar.variant_field.clear_cache()


def _refusal(kw, tile=tvar.TILES[0]):
    """variant_refusal for a case's flags at the flagship layout."""
    L = tfield.net_layout(8, 7, 4)
    keys = ("encode_only", "bf16enc", "halves", "mxenc", "density_only")
    return tvar.variant_refusal(L, tile, **{k: kw[k] for k in keys if k in kw})


def _port_out(name, n_groups=1, tile=tvar.TILES[0]):
    """The wrapper's output (on the CPU, the plain version); for a case the
    kernel refuses (pipe4), the plain version's."""
    _, prob = _problem(n_groups)
    kw = ALL_CASES[name]
    with torch.no_grad():
        if _refusal(kw, tile) is not None:
            return tvar.variant_plain(*prob, **kw).numpy()
        return tvar.variant_field(*prob, tile=tile, **kw).numpy()


def _assert_close(name, got, ref):
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0.01  # an output with signal
    if name in BF16_CASES:
        assert _rel_l2(got, ref) <= BF16_REL_L2
    else:
        np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_plain_matches_jax_variant(name):
    ref = _jax_out(name)
    got = _port_out(name)
    _assert_close(name, got, ref)
    kw = ALL_CASES[name]
    if kw.get("density_only"):
        assert np.abs(got[:, :3]).max() == 0.0
    if kw.get("encode_only"):  # a probe fills all four columns with one sum
        assert (got == got[:, :1]).all()


def test_bf16_tolerance_separates():
    """Each bf16 case's rounding moves the raw well past BF16_REL_L2: the
    tolerance does not admit the f32 function."""
    base = _jax_out("base")
    for name in BF16_CASES:
        assert _rel_l2(base, _jax_out(name)) > 5 * BF16_REL_L2, name


@pytest.mark.parametrize("name", ["base", "mxenc", "bf16enc", "gates"])
def test_plain_matches_jax_variant_two_groups(name):
    """Two pose groups of 64 points: each point reads its group's pose."""
    ref = _jax_out(name, n_groups=2, tile=64)
    got = _port_out(name, n_groups=2)
    _assert_close(name, got, ref)
    one_group = _port_out(name, n_groups=1)
    assert np.abs(got - one_group).max() > 1e-3  # the second pose matters


def test_plain_is_tile_independent():
    """The JAX kernel at tiles 32, 64 and 128 computes one function, which
    the port computes at its one tile; the wrapper refuses the JAX tiles it
    does not run, naming its own."""
    refs = [_jax_out("base", tile=t) for t in (32, 64, 128)]
    for r in refs[1:]:
        np.testing.assert_allclose(r, refs[0], atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(_port_out("base"), refs[0], atol=F32_TOL, rtol=0)
    _, prob = _problem(1)
    for tile in (32, 64):
        with pytest.raises(ValueError, match=f"tile={tile}: .* tile of 128 points"):
            tvar.variant_field(*prob, tile=tile)


def test_wrapper_contract_on_cpu():
    """The plain version at float32 on CPU tensors, no launch counted; the
    refusals of the kernel's rules; no operand that requires grad."""
    _, prob = _problem(1)
    tfield.reset_launches()
    with torch.no_grad():
        for name in ("base", "pipe2", "gates"):
            np.testing.assert_array_equal(
                tvar.variant_field(*prob, **ALL_CASES[name]).numpy(),
                tvar.variant_plain(*prob, **ALL_CASES[name]).numpy())
    assert set(tfield.LAUNCHES.values()) == {0} and "variant" in tfield.LAUNCHES
    for kw, match in ((dict(halves=2), "bf16enc"), (dict(halves=2, bf16enc=True, mxenc=True),
                                                    "bf16enc"),
                      (dict(tile=48), "tile=48"), (dict(bf16enc=True, halves=4),
                                                   "wgmma's M is 64 rows"),
                      (dict(encode_only=True, bf16enc=True), "not built"),
                      (dict(density_only=True, bf16enc=True), "not built"),
                      (dict(skips=(2, 4)), "one skip"), (dict(skips=(3,)), "skip is 4"),
                      (dict(encode_only="all"), "encode_only")):
        with pytest.raises(ValueError, match=match):
            tvar.variant_field(*prob, **kw)
    with pytest.raises(ValueError, match="pose groups"):
        tvar.variant_field(prob.pts[:-1], prob.dirs[:-1], prob.poses.repeat(2, 1), prob.net)
    with pytest.raises(ValueError, match="pose"):
        tvar.variant_field(prob.pts, prob.dirs, prob.poses[:, :-1], prob.net)
    pts = prob.pts.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        tvar.variant_field(pts, prob.dirs, prob.poses, prob.net)


def test_smem_bytes_and_fit():
    """The shared-memory rule at the flagship widths: every case and probe
    takes the eval kernels' 201,304 bytes, one block an SM; every case of
    the harness is built but pipe4."""
    L = tfield.net_layout(8, 7, 4)
    assert tfield.eval_smem_bytes(L) == 201_304 <= tfield.SMEM_LIMIT < 2 * 201_304
    assert {name for name, kw in ALL_CASES.items() if _refusal(kw) is not None} == {"pipe4"}
    assert tfield.field_flops(L, False) == 1_723_648
    assert tfield.field_flops(L, True) == 1_360_384


def test_harness_cpu_run(capsys):
    """The ported harness's --cpu run: every case and probe the kernel takes
    at tile 128, which cases share code, tile 64 and pipe4 skipped with
    their reasons."""
    assert harness.main(["--cpu", "--n_rays", "2", "--tiles", "64,128"]) == 0
    out = capsys.readouterr().out
    assert "2 rays x 80 samples = 160 pts" in out
    for name in ALL_CASES:
        assert f"{name:10s} tile=  64: skipped (tile=64: the kernel runs" in out
        if name != "pipe4":
            assert f"{name:10s} tile= 128: max|d|" in out
    assert "pipe4      tile= 128: skipped (tile=128 / halves=4: parts of 32 rows" in out
    assert "same code: base = skipsplit = bf16act = both = viewsplit" in out
    for line in out.splitlines():
        if line.startswith(("skipsplit", "viewsplit")) and "max|d|" in line:
            assert line.endswith("0.00e+00")  # the same function as base
