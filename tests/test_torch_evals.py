"""posegen_tpu_torch.evals.image against posegen_tpu.evals.image on the CPU:
the same seeded numpy images through psnr, ssim, ms_ssim and
evaluate_metric, held to TOL."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.evals import image as jev
from posegen_tpu_torch.evals import image as tev

TOL = 1e-5  # float32 reductions in two orders


@functools.lru_cache(maxsize=None)
def _images(shape, seed=0):
    """A target and a noisy prediction in [0, 1], plus a foreground mask."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    fg = rng.uniform(0, 1, shape[:-1]) > 0.5
    return pred, gt, fg


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_psnr(masked):
    pred, gt, fg = _images((20, 24, 3))
    m = fg if masked else None
    ref = jev.psnr(jnp.asarray(pred), jnp.asarray(gt), None if m is None else jnp.asarray(m))
    got = tev.psnr(torch.as_tensor(pred), torch.as_tensor(gt),
                   None if m is None else torch.as_tensor(m))
    _close(got, ref)


@pytest.mark.parametrize("shape,kw", [
    ((32, 40, 3), {}),
    ((32, 40, 3), {"full_map": True}),
    ((2, 24, 28, 3), {"size_average": False}),
    ((7, 9, 3), {}),  # smaller than the 11-pixel window: the window is clamped
])
def test_ssim(shape, kw):
    pred, gt, _ = _images(shape)
    ref = jev.ssim(jnp.asarray(pred), jnp.asarray(gt), **kw)
    got = tev.ssim(torch.as_tensor(pred), torch.as_tensor(gt), **kw)
    if kw.get("full_map"):
        assert tuple(got.shape) == tuple(ref.shape) == (22, 30, 3)
        _close(got, ref)
    else:
        for g, r in zip(got, ref, strict=True):
            assert tuple(g.shape) == tuple(r.shape)
            _close(g, r)


def test_ms_ssim():
    pred, gt, _ = _images((96, 80, 3), seed=1)
    _close(tev.ms_ssim(torch.as_tensor(pred), torch.as_tensor(gt)),
           jev.ms_ssim(jnp.asarray(pred), jnp.asarray(gt)))


def test_evaluate_metric_with_boxes_and_masks():
    pred, gt, fg = _images((3, 30, 34, 3), seed=2)
    # boxes: one 11x11 or larger (scored), one too thin (skipped), one full
    bboxes = np.array([[2, 3, 20, 25], [5, 5, 12, 30], [0, 0, 34, 30]])
    ref = jev.evaluate_metric(pred, gt, fgs=fg, bboxes=bboxes)
    got = tev.evaluate_metric(pred, gt, fgs=fg, bboxes=bboxes, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        _close(got[k], ref[k])
    assert got["psnr_box"].shape == (2,)
