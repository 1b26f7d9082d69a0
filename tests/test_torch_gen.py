"""posegen_tpu_torch's functional layers, pose generator, discriminators and
HMR / SPIN against posegen_tpu's on the CPU.

The same numpy inputs go through both packages; the weights are drawn once
and carried across by `utils/convert.py` (`generator_from_numpy`,
`discriminator_from_numpy`, `hmr_from_numpy`: the JAX package's HWIO conv
weights to PyTorch's OIHW). The JAX noises and dropout masks are drawn in
the test with the JAX package's own key splits (generators.py:131,
157-163, 197; hmr.py:161-178) and passed to the port.

Tolerances: float32 on both sides. Convolutions and max-pooling with XLA's
"SAME" padding to 1e-5 (the pool exactly); the generator and the
discriminators to 1e-5; HMR (a ResNet-50 of 53 convolutions, then three
regressor iterations) to 1e-4 relative on its outputs and 1e-4 on its BN
running stats, against JAX's eager call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posegen_tpu.gen import discriminators as jd
from posegen_tpu.gen import generators as jg
from posegen_tpu.gen import hmr as jh
from posegen_tpu.nn import layers as jl
from posegen_tpu_torch.gen import discriminators as td
from posegen_tpu_torch.gen import generators as tg
from posegen_tpu_torch.gen import hmr as th
from posegen_tpu_torch.nn import layers as tl
from posegen_tpu_torch.utils.convert import (
    discriminator_from_numpy, generator_from_numpy, hmr_from_numpy,
)

TOL = 1e-5
HMR_RTOL = 1e-4
SMALL_GEN = tg.GenConfig(width=32, num_stages=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t2n(tree):
    """A port tree -> numpy, for comparisons."""
    if isinstance(tree, dict):
        return {k: t2n(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [t2n(v) for v in tree]
    return tree.detach().cpu().numpy()


def assert_trees(got, want, rtol=TOL, atol=TOL, what=""):
    """Port tree (tensors) against a JAX tree: the same structure, each
    leaf within the tolerance."""
    g = jax.tree_util.tree_flatten_with_path(t2n(got))[0]
    w = jax.tree_util.tree_flatten_with_path(np_tree(want))[0]
    assert [jax.tree_util.keystr(p) for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), np_tree(tree))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [7, 8, 15, 56])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_and_max_pool_same_padding(n, k, stride):
    """XLA's "SAME" padding, asymmetric at stride 2 on even sizes."""
    rng = np.random.default_rng(n * 100 + k * 10 + stride)
    x = rng.standard_normal((2, n, n, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jl.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                                stride=stride))
    xt = torch.as_tensor(x.transpose(0, 3, 1, 2))
    got = tl.conv2d({"w": torch.as_tensor(w.transpose(3, 2, 0, 1)), "b": torch.as_tensor(b)},
                    xt, stride=stride).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    want_p = np.asarray(jl.max_pool(jnp.asarray(x), k, stride))
    got_p = tl.max_pool(xt, k, stride).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got_p, want_p)


@pytest.mark.parametrize("n,k,s,pads", [(224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)),
                                        (112, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
                                        (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1))])
def test_same_pads_are_xla_s(n, k, s, pads):
    assert tl.same_pads(n, k, s) == pads


def test_valid_padding_and_bad_padding():
    x = np.random.default_rng(0).standard_normal((1, 9, 9, 2)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((3, 3, 2, 3)).astype(np.float32)
    want = np.asarray(jl.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=2,
                                padding="VALID"))
    got = tl.conv2d({"w": torch.as_tensor(w.transpose(3, 2, 0, 1))},
                    torch.as_tensor(x.transpose(0, 3, 1, 2)), stride=2, padding="VALID")
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        tl.max_pool(torch.zeros(1, 1, 4, 4), padding="FULL")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("layout", ["BC", "NCHW"])
def test_batchnorm_with_running_state(train, layout):
    rng = np.random.default_rng(3)
    c = 6
    x = (rng.standard_normal((4, 5, 3, c) if layout == "NCHW" else (8, c)) * 2 + 1)
    x = x.astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    y, ns = jl.batchnorm(jax.tree_util.tree_map(jnp.asarray, p),
                         jax.tree_util.tree_map(jnp.asarray, s), jnp.asarray(x), train)
    xt = torch.as_tensor(x.transpose(0, 3, 1, 2) if layout == "NCHW" else x)
    st = {k: torch.as_tensor(v) for k, v in s.items()}
    yt, nst = tl.batchnorm({k: torch.as_tensor(v) for k, v in p.items()}, st, xt, train)
    got = yt.numpy().transpose(0, 2, 3, 1) if layout == "NCHW" else yt.numpy()
    np.testing.assert_allclose(got, np.asarray(y), rtol=TOL, atol=TOL)
    assert_trees(nst, ns)
    # the state passed in is never modified
    for k, v in s.items():
        np.testing.assert_array_equal(st[k].numpy(), v)


def test_linear_and_leaky_relu():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    p = {"w": rng.standard_normal((7, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    want = jl.leaky_relu(jl.linear(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    got = tl.leaky_relu(tl.linear({k: torch.as_tensor(v) for k, v in p.items()},
                                  torch.as_tensor(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_inits_give_the_jax_trees():
    """The port's init functions build the JAX package's trees, shape for
    shape (conv weights OIHW), with PyTorch's default scales."""
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    p, s = tg.init_pose_generator(gen, SMALL_GEN, device="cpu")
    jp, js = jg.init_pose_generator(key, SMALL_GEN)
    assert _shapes(t2n(p)) == _shapes(jp) and _shapes(t2n(s)) == _shapes(js)
    assert _shapes(t2n(td.init_pos3d_discriminator(gen, device="cpu"))) == _shapes(
        jd.init_pos3d_discriminator(key))
    assert _shapes(t2n(td.init_pos2d_discriminator(gen, device="cpu"))) == _shapes(
        jd.init_pos2d_discriminator(key))
    hp, hs = th.init_hmr(gen, device="cpu")
    jhp, jhs = jax.eval_shape(jh.init_hmr, key)
    oihw = lambda a: (a[3], a[2], a[0], a[1]) if len(a) == 4 else a  # noqa: E731
    assert _shapes(t2n(hp)) == jax.tree_util.tree_map(
        lambda a: oihw(tuple(a.shape)), jhp)
    assert _shapes(t2n(hs)) == jax.tree_util.tree_map(lambda a: tuple(a.shape), jhs)
    w = hp["layer2"][0]["conv2"]["w"]
    assert float(w.abs().max()) <= (1.0 / (9 * 128)) ** 0.5
    np.testing.assert_array_equal(hp["init_pose"].numpy(),
                                  np.tile(np.float32([1, 0, 0, 1, 0, 0]), 24)[None])


# ---------------------------------------------------------------------------
# the generator and the discriminators
# ---------------------------------------------------------------------------

def jax_noises(key, batch, cfg):
    """The noises JAX's pose_generator_apply draws from `key`
    (generators.py:131, 157-163, 197)."""
    k_ba, k_rt = jax.random.split(key)
    k1, k2, k3 = jax.random.split(k_rt, 3)
    return {"ba": jax.random.normal(k_ba, (batch, cfg.noise_ch)),
            "r": jax.random.normal(k1, (batch, cfg.rt_noise_ch)),
            "eps": jax.random.normal(k2, (batch, 3)),
            "t": jax.random.normal(k3, (batch, cfg.rt_noise_ch))}


@functools.lru_cache(maxsize=None)
def _gen_weights(cfg=SMALL_GEN):
    """JAX generator weights whose BN running stats are drawn too (the
    eval mode reads them)."""
    p, s = jg.init_pose_generator(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    s = jax.tree_util.tree_map(lambda a: rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32),
                               s)
    return np_tree(p), s


@pytest.mark.parametrize("train", [True, False])
def test_pose_generator(train):
    cfg = SMALL_GEN
    p, s = _gen_weights()
    kp3d = (np.random.default_rng(5).standard_normal((6, 24, 3)) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    out, ns = jg.pose_generator_apply(p, s, key, jnp.asarray(kp3d), cfg, train=train)
    tp, ts = generator_from_numpy(p, s, "cpu")
    noises = {k: torch.as_tensor(np.array(v)) for k, v in jax_noises(key, 6, cfg).items()}
    got, nst = tg.pose_generator_apply(tp, ts, None, torch.as_tensor(kp3d), cfg, train=train,
                                       noises=noises)
    assert_trees(got, out)
    assert_trees(nst, ns)
    if not train:
        assert_trees(nst, s)


def test_ba_and_rt_generators():
    cfg = SMALL_GEN
    p, s = _gen_weights()
    tp, ts = generator_from_numpy(p, s, "cpu")
    kp3d = (np.random.default_rng(6).standard_normal((4, 24, 3)) * 0.3).astype(np.float32)
    nz = jax_noises(jax.random.PRNGKey(2), 4, cfg)
    t = {k: torch.as_tensor(np.array(v)) for k, v in nz.items()}
    ba, ns = jg.ba_generator_apply(p["ba"], s["ba"], None, 4, cfg, noise=nz["ba"])
    got, nst = tg.ba_generator_apply(tp["ba"], ts["ba"], None, 4, cfg, noise=t["ba"])
    assert_trees({"pose": got, "s": nst}, {"pose": ba, "s": ns})
    want = jg.rt_generator_apply(p["r"], p["t"], s["r"], s["t"], None, jnp.asarray(kp3d), cfg,
                                 noise_r=nz["r"], noise_t=nz["t"], eps_axis=nz["eps"])
    got = tg.rt_generator_apply(tp["r"], tp["t"], ts["r"], ts["t"], None, torch.as_tensor(kp3d),
                                cfg, noise_r=t["r"], noise_t=t["t"], eps_axis=t["eps"])
    assert_trees(list(got), list(want))


def test_generator_draws_its_noises_from_the_generator():
    """Without noises the generator draws {'ba', 'r', 'eps', 't'} in
    draw_noises' order from the torch.Generator."""
    p, s = tg.init_pose_generator(torch.Generator().manual_seed(0), SMALL_GEN, device="cpu")
    kp3d = torch.zeros(3, 24, 3)
    a, _ = tg.pose_generator_apply(p, s, torch.Generator().manual_seed(5), kp3d, SMALL_GEN)
    noises = tg.draw_noises(torch.Generator().manual_seed(5), 3, SMALL_GEN)
    b, _ = tg.pose_generator_apply(p, s, None, kp3d, SMALL_GEN, noises=noises)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _torch_sd(tree_map):
    """{name: (out, in) weight} for a synthetic torch state dict."""
    rng = np.random.default_rng(8)
    sd = {}
    for name, (n_in, n_out) in tree_map.items():
        sd[f"{name}.weight"] = rng.standard_normal((n_out, n_in)).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(n_out).astype(np.float32)
    return sd


def test_discriminators_and_their_torch_import():
    rng = np.random.default_rng(9)
    kp3d = rng.standard_normal((5, 24, 3)).astype(np.float32)
    kp2d = rng.standard_normal((5, 24, 2)).astype(np.float32)
    p3 = np_tree(jd.init_pos3d_discriminator(jax.random.PRNGKey(4)))
    p2 = np_tree(jd.init_pos2d_discriminator(jax.random.PRNGKey(5)))
    np.testing.assert_allclose(
        td.pos3d_discriminator_apply(discriminator_from_numpy(p3, "cpu"),
                                     torch.as_tensor(kp3d)).detach().numpy(),
        np.asarray(jd.pos3d_discriminator_apply(p3, jnp.asarray(kp3d))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        td.pos2d_discriminator_apply(discriminator_from_numpy(p2, "cpu"),
                                     torch.as_tensor(kp2d)).detach().numpy(),
        np.asarray(jd.pos2d_discriminator_apply(p2, jnp.asarray(kp2d))), rtol=TOL, atol=TOL)
    dims = (("layer_1", 0), ("layer_2", 1), ("layer_3", 2), ("layer_last", 3),
            ("layer_pred", 4))
    widths = lambda n_in, c, m: (n_in, c, c, c, m, 1)  # noqa: E731
    sd3 = {}
    for name, g in zip(jd._REF_PATH_NAMES, jd.PART_GROUPS):
        w = widths(len(g) * 3, 500, 1000)
        sd3.update(_torch_sd({f"{name}.{n}": (w[i], w[i + 1]) for n, i in dims}))
    w = widths(48, 1000, 100)
    sd2 = _torch_sd({n: (w[i], w[i + 1]) for n, i in dims})
    assert_trees(td.import_torch_pos3d_discriminator(sd3, device="cpu"),
                  jd.import_torch_pos3d_discriminator(sd3), rtol=0, atol=0)
    assert_trees(td.import_torch_pos2d_discriminator(sd2, device="cpu"),
                  jd.import_torch_pos2d_discriminator(sd2), rtol=0, atol=0)


def test_import_torch_pose_generator():
    cfg = jg.GenConfig()
    p, s = jg.init_pose_generator(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(10)
    sd = {}

    def put(prefix, lin=None, bn=None):
        if lin is not None:
            sd[f"{prefix}.weight"] = rng.standard_normal(lin[::-1]).astype(np.float32)
            sd[f"{prefix}.bias"] = rng.standard_normal(lin[1]).astype(np.float32)
        if bn is not None:
            for k in ("weight", "bias", "running_mean", "running_var"):
                sd[f"{prefix}.{k}"] = rng.uniform(0.5, 1.5, bn).astype(np.float32)

    for tag, n_in, out in (("BA", 32, "BAprocess.w2"), ("R", 72, None),
                           ("T", 72, "RTprocess.w2_T")):
        pre = "BAprocess" if tag == "BA" else "RTprocess"
        sfx = "" if tag == "BA" else f"_{tag}"
        put(f"{pre}.w1{sfx}", lin=(n_in, 256))
        put(f"{pre}.batch_norm{1 if tag == 'BA' else sfx}", bn=256)
        for i in range(2):
            base = f"{pre}.linear_stages{sfx}.{i}"
            put(f"{base}.w1", lin=(256, 256))
            put(f"{base}.w2", lin=(256, 256))
            put(f"{base}.batch_norm1", bn=256)
            put(f"{base}.batch_norm2", bn=256)
        if out is not None:
            put(out, lin=(256, 96 if tag == "BA" else 3))
    jp, js = jg.import_torch_pose_generator(sd)
    tp, ts = tg.import_torch_pose_generator(sd, device="cpu")
    assert_trees(tp, jp, rtol=0, atol=0)
    assert_trees(ts, js, rtol=0, atol=0)
    assert _shapes(t2n(tp)) == _shapes(p) and _shapes(t2n(ts)) == _shapes(s)


# ---------------------------------------------------------------------------
# HMR
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def hmr_weights():
    """An HMR's (params, bn_state) in the JAX package's layout (numpy, conv
    weights HWIO): the port's seed-0 init transposed (jax.random's init
    takes 13 s on this CPU), with drawn BN affines and running stats so that
    the eval mode reads real statistics."""
    p, s = th.init_hmr(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)

    def leaf(path, a):
        a = a.detach().numpy()
        name = jax.tree_util.keystr(path)
        if a.ndim == 4:
            return a.transpose(2, 3, 1, 0)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.7, 1.3, a.shape).astype(np.float32)
        if "'mean'" in name or ("'bias'" in name and "init" not in name):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    to_np = lambda t: jax.tree_util.tree_map_with_path(leaf, t)  # noqa: E731
    return to_np(p), to_np(s)


def jax_masks(key, batch, n_iter=3, rate=0.5):
    """The keep masks JAX's hmr_apply draws from its dropout key
    (hmr.py:161-178)."""
    out = []
    for i in range(n_iter):
        kd = jax.random.fold_in(key, i)
        out.append(tuple(np.asarray(jax.random.bernoulli(k, 1.0 - rate, (batch, 1024)))
                         for k in (kd, jax.random.fold_in(kd, 1))))
    return out


@functools.lru_cache(maxsize=None)
def _jax_hmr(res, mode):
    p, s = hmr_weights()
    x = np.random.default_rng(res).standard_normal((2, res, res, 3)).astype(np.float32)
    kw = {"eval": {}, "train": {"train": True},
          "frozen": {"train": True, "bn_train": False,
                     "dropout_key": jax.random.PRNGKey(7)}}[mode]
    rot, betas, cam, ns = jh.hmr_apply(p, s, jnp.asarray(x), **kw)
    return x, (np.asarray(rot), np.asarray(betas), np.asarray(cam)), np_tree(ns)


@pytest.mark.parametrize("res", [64, 224])
@pytest.mark.parametrize("mode", ["eval", "train", "frozen"])
def test_hmr_apply(res, mode):
    """B = 2: eval; train (batch BN, new running stats); BN-frozen train mode
    with JAX's dropout masks."""
    x, want, ns = _jax_hmr(res, mode)
    p, s = hmr_from_numpy(*hmr_weights(), "cpu")
    kw = {"eval": {}, "train": {"train": True},
          "frozen": {"train": True, "bn_train": False,
                     "masks": [tuple(torch.as_tensor(m) for m in pair)
                               for pair in jax_masks(jax.random.PRNGKey(7), 2)]}}[mode]
    with torch.no_grad():
        rot, betas, cam, nst = th.hmr_apply(p, s, torch.as_tensor(x.transpose(0, 3, 1, 2)), **kw)
    for g, w in zip((rot, betas, cam), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=HMR_RTOL, atol=HMR_RTOL)
    assert_trees(nst, ns, rtol=HMR_RTOL, atol=HMR_RTOL)
    if mode != "train":
        assert_trees(nst, hmr_weights()[1], rtol=0, atol=0)


def test_dropout_masks_drive_the_regressor():
    """dropout_masks draws one pair of (B, 1024) keep masks per iteration; a
    train-mode call with them differs from one without (dropout engaged)
    and matches the same masks passed again."""
    p, s = th.init_hmr(torch.Generator().manual_seed(1), device="cpu")
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    masks = th.dropout_masks(torch.Generator().manual_seed(3), 2)
    assert len(masks) == 3 and all(m.shape == (2, 1024) and m.dtype == torch.bool
                                   for pair in masks for m in pair)
    keep = torch.stack([m for pair in masks for m in pair]).float().mean()
    assert 0.45 < float(keep) < 0.55
    with torch.no_grad():
        a = th.hmr_apply(p, s, x, train=True, bn_train=False, masks=masks)[2]
        b = th.hmr_apply(p, s, x, train=True, bn_train=False, masks=masks)[2]
        c = th.hmr_apply(p, s, x, train=True, bn_train=False)[2]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_import_torch_hmr():
    """A torch HMR state dict (OIHW convs, (out, in) linears, running stats,
    the mean-param buffers) overlaid by both packages."""
    p, s = hmr_weights()
    rng = np.random.default_rng(12)
    sd = {"conv1.weight": rng.standard_normal((64, 3, 7, 7)).astype(np.float32)}
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{k}"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        sd[f"layer1.0.downsample.1.{k}"] = rng.uniform(0.5, 1.5, 256).astype(np.float32)
    for ci, shape in (("1", (64, 64, 1, 1)), ("2", (64, 64, 3, 3)), ("3", (256, 64, 1, 1))):
        sd[f"layer1.0.conv{ci}.weight"] = rng.standard_normal(shape).astype(np.float32)
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"layer1.0.bn{ci}.{k}"] = rng.uniform(0.5, 1.5, shape[0]).astype(np.float32)
    sd["layer1.0.downsample.0.weight"] = rng.standard_normal((256, 64, 1, 1)).astype(np.float32)
    sd["decshape.weight"] = rng.standard_normal((10, 1024)).astype(np.float32)
    sd["decshape.bias"] = rng.standard_normal(10).astype(np.float32)
    sd["init_cam"] = np.array([0.8, 0.1, -0.1], np.float32)
    jp, js = jh.import_torch_hmr({k: torch.as_tensor(v) for k, v in sd.items()}, p, s)
    tp, ts = th.import_torch_hmr({k: torch.as_tensor(v) for k, v in sd.items()},
                                 *hmr_from_numpy(p, s, "cpu"))
    want_p, want_s = hmr_from_numpy(np_tree(jp), np_tree(js), "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(t2n(tp)), jax.tree_util.tree_leaves(t2n(want_p))):
        np.testing.assert_array_equal(a, b)
    assert_trees(ts, js, rtol=0, atol=0)


def test_entry_points_default_to_cuda(monkeypatch):
    """The init and import functions take device="cuda" by default and
    raise without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for fn in (lambda: tg.init_pose_generator(gen), lambda: td.init_pos3d_discriminator(gen),
               lambda: td.init_pos2d_discriminator(gen), lambda: th.init_hmr(gen),
               lambda: tg.import_torch_pose_generator({}),
               lambda: td.import_torch_pos3d_discriminator({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
