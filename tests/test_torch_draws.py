"""The random draws of the port's training steps vs the JAX package's, site
by site: each case hands the same key and inputs to one draw site in both
packages. Raw uniform draws (the stratified jitter, the pose swap, the
density points' positions) are equal bit for bit, raw normal draws within
1e-6; sites whose draws feed a computation (the importance depths, the
density noise, G's random noise through the backbone, the render and the
superresolution, D's label noise, the style-mixing cutoff, the ADA pipe at
p = 0.5 with every branch on) are held to the computation's tolerance.
The keys split as the JAX package splits them, so a wrong split order
shows as an O(1) difference."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_eg3d import jax_density_points
from _torch_port import one_torch_thread, t, tiny_gen_cfg, to_np, with_noise_strength  # noqa: F401
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models import dual_discriminator as jdd
from gnerf_tpu.models import superresolution as jsr
from gnerf_tpu.render import importance as jimp
from gnerf_tpu.render import renderer as jrend
from gnerf_tpu.training import augment as JA
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.models import TriPlaneGenerator
from gnerf_tpu_torch.models import dual_discriminator as dd
from gnerf_tpu_torch.models import superresolution as sr
from gnerf_tpu_torch.render import importance as imp
from gnerf_tpu_torch.render import renderer as rend
from gnerf_tpu_torch.training import augment as A
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)
NORMAL = dict(rtol=0, atol=1e-6)
SEEDS = [0, 7]


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def _rays(n=2, r=24, seed=0):
    return np.random.RandomState(seed).randn(n, r, 3).astype(np.float32)


def site_stratified(seed):
    """The jitter: depths i + u (ray_start 0, ray_end S - 1: delta 1)."""
    jk, tk = _keys(seed)
    o = _rays()
    want = jimp.sample_stratified(jk, jnp.asarray(o), 0.0, 11.0, 12)
    got = imp.sample_stratified(tk, t(o), 0.0, 11.0, 12)
    return got, want, "bits"


def site_stratified_auto(seed):
    """The jitter on per-ray limits (the 'auto' ray-box path)."""
    jk, tk = _keys(seed)
    rs = np.random.RandomState(seed)
    lo = rs.uniform(2.0, 2.5, (2, 24, 1)).astype(np.float32)
    hi = lo + rs.uniform(0.5, 1.0, (2, 24, 1)).astype(np.float32)
    o = _rays()
    want = jimp.sample_stratified(jk, jnp.asarray(o), jnp.asarray(lo), jnp.asarray(hi), 6)
    got = imp.sample_stratified(tk, t(o), t(lo), t(hi), 6)
    return got, want, TOL


def site_importance(seed):
    """The importance samples' uniform draws, through the inverse CDF."""
    jk, tk = _keys(seed)
    rs = np.random.RandomState(seed)
    z = np.sort(rs.uniform(2.25, 3.3, (2, 24, 12, 1)), axis=2).astype(np.float32)
    w = rs.rand(2, 24, 11, 1).astype(np.float32)
    want = jimp.sample_importance(jk, jnp.asarray(z), jnp.asarray(w), 12)
    got = imp.sample_importance(tk, t(z), t(w), 12)
    return got, want, TOL


def site_density_noise(seed):
    """sigma + N(0, 1) * density_noise in `run_model`, behind a decoder
    that returns zeros."""
    jk, tk = _keys(seed)
    pts = _rays(1, 40)
    planes = np.zeros((1, 3, 4, 8, 8), np.float32)
    opts = dict(box_warp=1.0, density_noise=0.5)

    def jdec(feats, dirs):
        n, _, m, _ = feats.shape
        return {"rgb": jnp.zeros((n, m, 4)), "sigma": jnp.zeros((n, m, 1))}

    def tdec(feats, dirs):
        n, _, m, _ = feats.shape
        return {"rgb": torch.zeros((n, m, 4)), "sigma": torch.zeros((n, m, 1))}

    want = jrend.run_model(jnp.asarray(planes), jdec, jnp.asarray(pts), jnp.asarray(pts),
                           opts, jk)["sigma"]
    got = rend.run_model(t(planes), tdec, t(pts), t(pts), opts, tk)["sigma"]
    return got, want, NORMAL


@functools.lru_cache(maxsize=None)
def _tiny_g(**rk):
    """(JAX G, its params, the port's G) with noisy layers, made once for
    each set of rendering kwargs (the sites only read them)."""
    cfg = tiny_gen_cfg(depth=4)
    cfg["rendering_kwargs"] = dict(cfg["rendering_kwargs"], **rk)
    jg = JGen(**cfg)
    params = with_noise_strength(jax.tree_util.tree_map(np.asarray,
                                                        jg.init(jax.random.PRNGKey(0))))
    g = TriPlaneGenerator(**cfg, device="meta")
    load_jax_params(g, params, device="cpu")
    return jg, params, g


def _camera(n):
    c = np.zeros((n, 25), np.float32)
    c[:, :16] = np.eye(4, dtype=np.float32).reshape(16)
    c[:, 11] = 2.7
    c[:, 16:25] = [4.26, 0, 0.5, 0, 4.26, 0.5, 0, 0, 1]
    return c


def site_synthesis(seed):
    """G's random noise in every backbone layer, the render's jitter,
    importance samples and density noise: the whole synthesis from one key."""
    jk, tk = _keys(seed)
    jg, params, g = _tiny_g(density_noise=0.5)
    z, c = np.random.RandomState(seed).randn(2, 32).astype(np.float32), _camera(2)
    ws = jg.mapping(params, jnp.asarray(z), jnp.asarray(c))
    want = jg.synthesis(params, ws, jnp.asarray(c), noise_mode="random", rng=jk, pack=False)
    with torch.no_grad():
        got = g.synthesis(g.mapping(t(z), t(c)), t(c), noise_mode="random", rng=tk)
    return (torch.cat([got[k].flatten() for k in sorted(got)]),
            np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)]), TOL)


@functools.lru_cache(maxsize=None)
def _tiny_sr():
    jm = jsr.SuperresolutionHybrid2X(channels=32, img_resolution=128, w_dim=32)
    params = with_noise_strength(jax.tree_util.tree_map(np.asarray,
                                                        jm.init(jax.random.PRNGKey(1))))
    m = sr.SuperresolutionHybrid2X(channels=32, img_resolution=128, w_dim=32)
    load_jax_params(m, params)
    return jm, params, m


def site_superresolution(seed):
    """The SR blocks' random noise (2X at its own 64^2 input)."""
    jk, tk = _keys(seed)
    jm, params, m = _tiny_sr()
    rs = np.random.RandomState(seed)
    x = rs.randn(1, 32, 64, 64).astype(np.float32)
    ws = rs.randn(1, 4, 32).astype(np.float32)
    want, _ = jm.apply(params, jnp.asarray(x[:, :3]), jnp.asarray(x), jnp.asarray(ws),
                       noise_mode="random", rng=jk)
    with torch.no_grad():
        got, _ = m(t(x[:, :3]), t(x), t(ws), noise_mode="random", rng=tk)
    return got, want, TOL


@functools.lru_cache(maxsize=None)
def _tiny_d():
    kw = dict(c_dim=25, img_resolution=16, img_channels=3, channel_base=256, channel_max=32,
              mbstd_group_size=2, disc_c_noise=1.0)
    jd = jdd.DualDiscriminator(**kw)
    params = jd.init(jax.random.PRNGKey(3))
    d = dd.DualDiscriminator(**kw, device="meta")
    load_jax_params(d, params, device="cpu")
    return jd, params, d


def site_label_noise(seed):
    """D's label noise: N(0, 1) * the labels' batch std * disc_c_noise."""
    jk, tk = _keys(seed)
    jd, params, d = _tiny_d()
    rs = np.random.RandomState(seed)
    img = {"image": rs.randn(4, 3, 16, 16).astype(np.float32),
           "image_raw": rs.randn(4, 3, 8, 8).astype(np.float32)}
    c = rs.randn(4, 25).astype(np.float32)
    want = jd.apply(params, {k: jnp.asarray(v) for k, v in img.items()}, jnp.asarray(c), rng=jk)
    with torch.no_grad():
        got = d.apply({k: t(v) for k, v in img.items()}, t(c), rng=tk)
    return got, want, TOL


def site_style_mixing(seed):
    """The cutoff (randint over [1, num_ws)), the coin and z2: ws after
    mixing at prob 0.5."""
    jk, tk = _keys(seed)
    jg, params, g = _tiny_g()
    rs = np.random.RandomState(seed)
    z, c = rs.randn(3, 32).astype(np.float32), rs.randn(3, 25).astype(np.float32)
    jmap = jg.backbone.mapping
    pm = params["backbone"]["mapping"]
    want = JE.apply_style_mixing(jmap.apply, pm, jmap.apply(pm, jnp.asarray(z), jnp.asarray(c)),
                                 32, jnp.asarray(c), jk, 0.5)
    mapping = g.backbone.mapping
    with torch.no_grad():
        got = E.apply_style_mixing(mapping, mapping(t(z), t(c)), 32, t(c), tk, 0.5)
    return got, want, TOL


def site_pose_swap(seed):
    """Each label swapped with its neighbour's with probability 0.5."""
    jk, tk = _keys(seed)
    c = np.random.RandomState(seed).randn(16, 25).astype(np.float32)
    return E.swapped_conditioning(tk, t(c), 0.5), JE.swapped_conditioning(jk, jnp.asarray(c),
                                                                          0.5), "bits"


def site_density_points(seed):
    """The positions (uniform, bit for bit), the nudges and the
    directions (normal)."""
    jk, tk = _keys(seed)
    cfg = E.EG3DLossConfig(density_reg_points=64)
    coords, dirs = E.density_reg_points(2, cfg, tk, "cpu")
    want_c, want_d = jax_density_points(jk, 2, JE.EG3DLossConfig(density_reg_points=64))
    np.testing.assert_array_equal(to_np(coords[:, :64]), to_np(want_c[:, :64]))
    return torch.cat([coords.flatten(), dirs.flatten()]), \
        np.concatenate([to_np(want_c).ravel(), to_np(want_d).ravel()]), NORMAL


SITES = {f.__name__[5:]: f for f in (
    site_stratified, site_stratified_auto, site_importance, site_density_noise, site_synthesis,
    site_superresolution, site_label_noise, site_style_mixing, site_pose_swap,
    site_density_points)}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("site", sorted(SITES))
def test_draw_site_matches_jax(site, seed):
    got, want, tol = SITES[site](seed)
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if tol == "bits":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, **tol)
    # The key matters: another key moves the site.
    got_other = to_np(SITES[site](seed + 1)[0])
    assert not np.array_equal(got_other, got)


# The ADA pipe at p = 0.5 with every branch on: bgc's geometric and colour
# augmentations, read as the matrices its executors receive, then the image
# filter, the additive noise and the cutout, read from the images.
EVERY_BRANCH = dict(E.BGC_SPEC, imgfilter=1.0, noise=1.0, cutout=1.0)


def _record(monkeypatch, cls, name, log):
    orig = getattr(cls, name)

    def spy(self, images, m, *a):
        log.append(np.asarray(to_np(m)))
        return orig(self, images, m, *a)

    monkeypatch.setattr(cls, name, spy)


@pytest.mark.parametrize("seed", SEEDS)
def test_ada_pipe_draws_match_jax(monkeypatch, seed):
    jk, tk = _keys(seed)
    x = np.random.RandomState(seed).rand(16, 6, 16, 16).astype(np.float32) * 2 - 1
    jpipe = JA.AugmentPipe(**EVERY_BRANCH, pad_fraction=0.55)
    pipe = A.AugmentPipe(**EVERY_BRANCH, pad_fraction=0.55)
    jlog, tlog = [], []
    for cls, log in ((JA.AugmentPipe, jlog), (A.AugmentPipe, tlog)):
        _record(monkeypatch, cls, "_execute_geometric", log)
        _record(monkeypatch, cls, "_execute_color", log)
    want = np.asarray(jpipe(jk, jnp.asarray(x), p=0.5))
    got = to_np(pipe(tk, t(x), p=0.5))
    assert len(jlog) == len(tlog) == 2
    for g_mat, j_mat in zip(tlog, jlog):
        np.testing.assert_allclose(g_mat, j_mat, rtol=1e-5, atol=2e-6)
        eye = np.eye(g_mat.shape[-1], dtype=np.float32)
        assert not np.allclose(g_mat, eye, atol=1e-3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # The cutout and the noise fired: zeroed squares and noised samples.
    assert (got == 0).any() and not np.array_equal(got, x)


@pytest.mark.parametrize("name", ["imgfilter", "noise", "cutout"])
def test_ada_pipe_image_space_draws_match_jax(name):
    """Each image-space augmentation alone at p = 0.5: imgfilter's band
    gains from its own key split, the noise's sigma and its normal draws,
    the cutout's gate and centres."""
    jk, tk = _keys(3)
    x = np.random.RandomState(4).rand(16, 3, 16, 16).astype(np.float32) * 2 - 1
    want = np.asarray(JA.AugmentPipe(**{name: 1.0})(jk, jnp.asarray(x), p=0.5))
    got = to_np(A.AugmentPipe(**{name: 1.0})(tk, t(x), p=0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)
    changed = ~np.isclose(got, x, atol=1e-6).all(axis=(1, 2, 3))
    # The filter runs with unit gains where no band's gate fired.
    assert 0 < changed.sum() < len(changed) or name == "imgfilter"
