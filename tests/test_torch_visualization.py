"""posegen_tpu_torch/utils/visualization.py against posegen_tpu's: the
keypoint mask (cv2's thick line and filled circle, written in numpy) and
the projected skeleton overlays bit for bit, and the plotly figures'
traces through a stub of `plotly.graph_objects`."""

import sys
import types

import numpy as np
import pytest

from posegen_tpu.utils import visualization as jviz
from posegen_tpu_torch.utils import visualization as tviz

THICKNESSES = [1, 2, 12, 13]


def _kp_sets():
    """tests/test_viz_raster.py's keypoints (rng seed 0, inside a 64² frame),
    seeded keypoints of which some fall outside it, and a set where a child
    sits on its parent (a zero-length bone beside the root's own)."""
    inside = np.random.default_rng(0).uniform(5, 59, (24, 2)).astype(np.float32)
    outside = np.random.default_rng(3).uniform(-40, 110, (24, 2)).astype(np.float32)
    collapsed = inside.copy()
    collapsed[4] = collapsed[1]  # left_knee on left_hip
    return {"inside": inside, "outside": outside, "collapsed": collapsed}


@pytest.mark.parametrize("thickness", THICKNESSES)
def test_create_kp_mask_matches_cv2(thickness):
    for name, kp2d in _kp_sets().items():
        for H, W in ((64, 64), (48, 80)):
            ref = jviz.create_kp_mask(H, W, kp2d, thickness=thickness)
            got = tviz.create_kp_mask(H, W, kp2d, thickness=thickness)
            assert got.shape == ref.shape == (H, W, 1) and got.dtype == ref.dtype == np.uint8
            assert np.array_equal(got, ref), (name, H, W, int((got != ref).sum()))
            assert got.sum() > 0


def test_thick_line_matches_cv2_far_outside():
    """Segments reaching far outside the frame, whose ends cv2 clips to the
    frame grown by the thickness before it builds the quad."""
    import cv2

    rng = np.random.default_rng(9)
    for _ in range(200):
        t = int(rng.choice(THICKNESSES))
        a, b = (tuple(int(v) for v in rng.integers(-400, 460, 2)) for _ in range(2))
        ref = np.zeros((40, 56), np.uint8)
        cv2.line(ref, a, b, 1, t)
        got = np.zeros((40, 56), np.uint8)
        tviz._thick_line(got, a, b, t, 1)
        assert np.array_equal(got, ref), (t, a, b)


def test_draw_skeletons_3d_matches_jax():
    """tests/test_viz_raster.py's inputs: the fixture's pose seen from a
    look-at camera, one frame of 64²."""
    from posegen_tpu.data.synthetic import _look_at_c2w
    from posegen_tpu.utils.fixtures import make_pose_ctx

    kps = np.asarray(make_pose_ctx().kps)
    c2w = _look_at_c2w(np.array([0, 0.3, 2.5], np.float32), kps[0, 0])
    imgs = np.zeros((1, 64, 64, 3), np.uint8)
    ref = jviz.draw_skeletons_3d(imgs, kps, c2w[None], 64, 64, 60.0)
    got = tviz.draw_skeletons_3d(imgs, kps, c2w[None], 64, 64, 60.0)
    assert got.shape == ref.shape == (1, 64, 64, 3)
    assert np.array_equal(got, ref) and got.sum() > 0
    # two frames with their own focals and centers
    imgs2 = np.random.default_rng(1).uniform(0, 1, (2, 48, 40, 3)).astype(np.float32)
    c2ws = np.stack([c2w, _look_at_c2w(np.array([0.4, 0.1, 2.0], np.float32), kps[0, 0])])
    kps2 = np.concatenate([kps, kps + 0.05])
    args = (imgs2, kps2, c2ws, 48, 40, np.array([50.0, 70.0]), [(20.0, 24.0), (18.5, 25.0)])
    assert np.array_equal(tviz.draw_skeletons_3d(*args), jviz.draw_skeletons_3d(*args))


def _plot_inputs():
    rng = np.random.default_rng(2)
    kp = rng.standard_normal((24, 3)).astype(np.float32)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2ws[:, :3, 3] = rng.standard_normal((2, 3))
    cyl = np.array([0.1, -0.2, 0.5, 1.0, -1.0], np.float32)
    return {"plot_skeleton3d": (kp,), "plot_cameras": (c2ws,), "plot_cylinder": (cyl,)}


@pytest.mark.parametrize("name", list(_plot_inputs()))
def test_plots_without_plotly_are_none(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)  # import plotly raises ImportError
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", None)
    assert getattr(tviz, name)(*_plot_inputs()[name]) is None
    assert getattr(jviz, name)(*_plot_inputs()[name]) is None


class _Figure:
    def __init__(self):
        self.traces = []

    def add_trace(self, trace):
        self.traces.append(trace)


class _Scatter3d:
    def __init__(self, **kwargs):
        self.kwargs = kwargs


@pytest.mark.parametrize("name", list(_plot_inputs()))
def test_plot_traces_match_jax(name, monkeypatch):
    go = types.ModuleType("plotly.graph_objects")
    go.Figure, go.Scatter3d = _Figure, _Scatter3d
    plotly = types.ModuleType("plotly")
    plotly.graph_objects = go
    monkeypatch.setitem(sys.modules, "plotly", plotly)
    monkeypatch.setitem(sys.modules, "plotly.graph_objects", go)
    args = _plot_inputs()[name]
    ref, got = getattr(jviz, name)(*args), getattr(tviz, name)(*args)
    assert isinstance(got, _Figure) and len(got.traces) == len(ref.traces) > 0
    for a, b in zip(got.traces, ref.traces):
        assert a.kwargs.keys() == b.kwargs.keys()
        for k in ("x", "y", "z"):
            np.testing.assert_array_equal(np.asarray(a.kwargs[k]), np.asarray(b.kwargs[k]))
        for k in set(a.kwargs) - {"x", "y", "z"}:
            assert a.kwargs[k] == b.kwargs[k], k
    fig = _Figure()  # drawn into a caller's figure
    assert getattr(tviz, name)(*args, fig=fig) is fig and len(fig.traces) == len(ref.traces)
