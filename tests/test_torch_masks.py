"""posegen_tpu_torch's person masks (`data/masks.py`, `data/segmenter.py`)
against cv2 and posegen_tpu's on the CPU.

The morphology and the connected components are held bit-equal to cv2 on
random masks whose blobs touch the border, at kernels 3, 4 and 7;
`masks_from_background` bit-equal to the JAX package's. DeepLab-v3: JAX's
parameter tree (its layout by `jax.eval_shape(init_deeplab)`, filled with
numpy draws from a seed, BN statistics included) is carried across by
`utils/convert.deeplab_from_numpy`, and the logits at 65 x 49 are held to
JAX's to 1e-4 relative L2 (LOGIT_TOL); a torchvision-keyed state dict of
random numpy values, `aux_classifier.*` included, saved to a `.pth`, goes
through each package's importer and segmenter to the same rule.
"""

import functools

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.data import masks as jmasks
from posegen_tpu.data import segmenter as jseg
from posegen_tpu_torch.data import masks as tmasks
from posegen_tpu_torch.data import segmenter as tseg
from posegen_tpu_torch.utils.convert import deeplab_from_numpy

LOGIT_TOL = 1e-4
H, W = 65, 49  # odd: XLA's "SAME" pads and the final resize's edges differ from even sizes


def _blobs(seed, h=61, w=47):
    """Random rectangles and speckle, some over the border."""
    rng = np.random.default_rng(seed)
    m = (rng.uniform(size=(h, w)) > 0.93).astype(np.uint8)
    for _ in range(6):
        y, x = rng.integers(-5, h), rng.integers(-5, w)
        m[max(y, 0):y + rng.integers(3, 20), max(x, 0):x + rng.integers(3, 20)] = 1
    return m


@pytest.mark.parametrize("k", [3, 4, 7])
@pytest.mark.parametrize("op", ["open", "close"])
def test_morphology_bit_equal_to_cv2(op, k):
    fn = {"open": tmasks.morph_open, "close": tmasks.morph_close}[op]
    cv_op = {"open": cv2.MORPH_OPEN, "close": cv2.MORPH_CLOSE}[op]
    for seed in range(20):
        m = _blobs(seed)
        ref = cv2.morphologyEx(m, cv_op, np.ones((k, k), np.uint8))
        assert np.array_equal(fn(m, k), ref), (seed, int((fn(m, k) != ref).sum()))


@pytest.mark.parametrize("min_area", [1, 9, 40])
def test_components_bit_equal_to_cv2(min_area):
    for seed in range(20):
        m = _blobs(seed)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(m)
        ref = np.zeros_like(m)
        for lab in range(1, n):
            if stats[lab, cv2.CC_STAT_AREA] >= min_area:
                ref[labels == lab] = 1
        assert np.array_equal(tmasks.keep_large_components(m, min_area), ref), seed


@pytest.mark.parametrize("kw", [{}, dict(open_kernel=4, close_kernel=4, min_area=10),
                                dict(threshold=60.0, close_kernel=7, min_area=1)],
                         ids=["defaults", "even_kernels", "threshold"])
def test_masks_from_background_bit_equal_to_jax(kw):
    rng = np.random.default_rng(1)
    bkgd = rng.integers(0, 256, (3, 61, 47, 3), dtype=np.uint8)
    imgs = bkgd.copy()
    for i in range(3):  # a person-sized change, one touching the border, and speckle
        imgs[i, 10 + 5 * i:45, i * 9:30 + i] = 255 - imgs[i, 10 + 5 * i:45, i * 9:30 + i]
        imgs[i] = np.where(rng.uniform(size=(61, 47, 1)) > 0.97, 0, imgs[i])
    for plates in (bkgd[0], bkgd):  # one plate, or one per image
        got = tmasks.masks_from_background(imgs, plates, **kw)
        ref = jmasks.masks_from_background(imgs, plates, **kw)
        assert got.shape == (3, 61, 47, 1) and got.sum() > 0 and np.array_equal(got, ref)


def test_extract_person_masks_dispatch():
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 8, 6, 3), dtype=np.uint8)
    seg = lambda img: (img[..., 0] > 128).astype(np.uint8)  # noqa: E731
    assert np.array_equal(tmasks.extract_person_masks(imgs, segmenter=seg),
                          jmasks.extract_person_masks(imgs, segmenter=seg))
    assert np.array_equal(tmasks.extract_person_masks(imgs, bkgd=imgs[0]),
                          jmasks.extract_person_masks(imgs, bkgd=imgs[0]))
    with pytest.raises(ValueError, match="segmenter"):
        tmasks.extract_person_masks(imgs)


# ---------------------------------------------------------------------------
# DeepLab-v3
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fwd():
    return jax.jit(jseg.deeplab_logits)


def _draw(rng, shape, key):
    """A leaf of JAX's DeepLab tree: conv weights kaiming-uniform over fan
    in (HWIO), BN scale / var near 1, biases and means near 0."""
    if len(shape) == 4:
        bound = np.sqrt(1.0 / np.prod(shape[:3]))
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if key in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return rng.normal(0, 0.1, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(seed=0):
    shapes = jax.eval_shape(jseg.init_deeplab, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _draw(rng, s.shape, getattr(path[-1], "key", None)), shapes)


def _image(seed=3):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), dtype=np.uint8)


def _normalized(img):
    return ((img.astype(np.float32) / 255.0 - jseg._IMAGENET_MEAN) / jseg._IMAGENET_STD)[None]


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def test_deeplab_logits_match_jax():
    p, s = _jax_params()
    x = _normalized(_image())
    ref = np.asarray(_jax_fwd()(p, s, jnp.asarray(x)))
    tp, ts = deeplab_from_numpy(p, s, "cpu")
    with torch.no_grad():
        got = tseg.deeplab_logits(tp, ts, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == (1, H, W, tseg.N_CLASSES)
    assert _rel(got, ref) <= LOGIT_TOL
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        assert _rel(got[edge], ref[edge]) <= LOGIT_TOL  # the resize's border rows and columns


def _torchvision_state_dict(seed=4):
    """Random numpy values under torchvision deeplabv3_resnet50's keys and
    shapes (OIHW), the auxiliary FCN head and BN counters included."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, c_out, c_in, k, bias=False):
        bound = np.sqrt(1.0 / (c_in * k * k))
        sd[f"{name}.weight"] = rng.uniform(-bound, bound, (c_out, c_in, k, k)).astype(np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.normal(0, 0.1, c_out).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("backbone.conv1", 64, 3, 7)
    bn("backbone.bn1", 64)
    c_in = 64
    for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), tseg.RESNET50_LAYERS)):
        for b in range(blocks):
            base = f"backbone.layer{li + 1}.{b}"
            cb = c_in if b == 0 else planes * 4
            for ci, (o, i, k) in enumerate(((planes, cb, 1), (planes, planes, 3),
                                            (planes * 4, planes, 1)), 1):
                conv(f"{base}.conv{ci}", o, i, k)
                bn(f"{base}.bn{ci}", o)
            if b == 0:
                conv(f"{base}.downsample.0", planes * 4, cb, 1)
                bn(f"{base}.downsample.1", planes * 4)
        c_in = planes * 4
    for i in range(4):
        conv(f"classifier.0.convs.{i}.0", 256, 2048, 1 if i == 0 else 3)
        bn(f"classifier.0.convs.{i}.1", 256)
    conv("classifier.0.convs.4.1", 256, 2048, 1)
    bn("classifier.0.convs.4.2", 256)
    conv("classifier.0.project.0", 256, 1280, 1)
    bn("classifier.0.project.1", 256)
    conv("classifier.1", 256, 256, 3)
    bn("classifier.2", 256)
    conv("classifier.4", 21, 256, 1, bias=True)
    conv("aux_classifier.0", 256, 1024, 3)
    bn("aux_classifier.1", 256)
    conv("aux_classifier.4", 21, 256, 1, bias=True)
    return sd


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("deeplab") / "deeplabv3_resnet50.pth"
    torch.save({k: torch.from_numpy(v) for k, v in _torchvision_state_dict().items()}, path)
    return str(path)


def test_import_torch_deeplab_matches_jax(pth):
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    jp, js = jseg.import_torch_deeplab({k: v.numpy() for k, v in sd.items()})
    x = _normalized(_image(5))
    ref = np.asarray(_jax_fwd()(jp, js, jnp.asarray(x)))
    tp, ts = tseg.import_torch_deeplab(sd, device="cpu")
    with torch.no_grad():
        got = tseg.deeplab_logits(tp, ts, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert _rel(got.permute(0, 2, 3, 1).numpy(), ref) <= LOGIT_TOL

    # the person masks of both segmenters: equal wherever the top-2 logit
    # gap exceeds the tolerance
    img = _image(5)
    got_m = tseg.deeplab_person_segmenter(pth, device="cpu")(img)
    ref_m = np.asarray(jseg.deeplab_person_segmenter(pth)(img))
    top2 = np.sort(ref[0], -1)[..., -2:]
    knife = (top2[..., 1] - top2[..., 0]) <= LOGIT_TOL * np.abs(ref).max()
    assert got_m.shape == (H, W) and got_m.dtype == np.uint8
    assert np.array_equal(got_m[~knife], ref_m[~knife])


def test_import_torch_deeplab_refuses_unknown_keys():
    sd = {k: torch.from_numpy(v) for k, v in _torchvision_state_dict(6).items()}
    tseg.import_torch_deeplab(sd, device="cpu")  # aux_classifier.* and counters dropped
    sd["backbone.fc.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="backbone.fc.weight"):
        tseg.import_torch_deeplab(sd, device="cpu")
    del sd["backbone.fc.weight"], sd["classifier.4.bias"]
    with pytest.raises(KeyError, match="classifier.4.bias"):
        tseg.import_torch_deeplab(sd, device="cpu")


def test_segmenter_without_weights_warns_and_runs(capsys):
    run = tseg.deeplab_person_segmenter(device="cpu")
    assert "WARNING: no weights_path" in capsys.readouterr().out
    out = run(_image()[:33, :17])
    assert out.shape == (33, 17) and out.dtype == np.uint8 and set(np.unique(out)) <= {0, 1}


def test_segmenter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tseg.deeplab_person_segmenter()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmasks.deeplab_segmenter()
