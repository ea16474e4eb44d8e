"""The port's training losses and metrics vs gnerf_tpu.training.losses /
metrics: SSIM, the VGG16-LPIPS embeddings and distances, the npz weight
loader, the GAN losses and the R1 penalty (fp32, CPU, numpy-seeded inputs,
JAX parameters bridged). Tolerance rtol 1e-4 / atol 1e-5 unless stated."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import Discriminator as JD
from gnerf_tpu.training import losses as JL
from gnerf_tpu.training import metrics as JM
from gnerf_tpu_torch.models import Discriminator
from gnerf_tpu_torch.training import losses as L
from gnerf_tpu_torch.training import metrics as M
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("size,size_average", [(16, False), (16, True), (8, False), (6, True)])
def test_ssim_matches_jax(size, size_average):
    """16^2 takes the 11-tap window; 8^2 and 6^2 shrink it to 7 and 5."""
    rs = np.random.RandomState(size)
    x = rs.rand(2, 3, size, size).astype(np.float32)
    y = np.clip(x + 0.1 * rs.randn(2, 3, size, size), 0, 1).astype(np.float32)
    want = JL.ssim(jnp.asarray(x), jnp.asarray(y), data_range=1.0, size_average=size_average)
    got = L.ssim(t(x), t(y), data_range=1.0, size_average=size_average)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def vgg_pair():
    jvgg = JL.VGG16LPIPS(resize_to=32)
    params = jvgg.init(jax.random.PRNGKey(3))
    rs = np.random.RandomState(4)
    params = dict(params, **{f"lin{i}": jnp.asarray(rs.rand(d).astype(np.float32))
                             for i, d in enumerate((64, 128, 256, 512, 512))})
    vgg = L.VGG16LPIPS(resize_to=32, device="meta")
    load_jax_params(vgg, params, device="cpu")
    return jvgg, params, vgg


def _images(n, size, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, size, size)).astype(np.float32)


@pytest.mark.parametrize("size", [32, 40, 24])  # as is, antialiased down, up
def test_lpips_embedding_matches_jax(vgg_pair, size):
    jvgg, params, vgg = vgg_pair
    x = _images(2, size, size)
    want = JL.lpips_embed(jvgg, params, jnp.asarray(x))
    got = L.lpips_embed(vgg, t(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_lpips_distances_match_jax(vgg_pair):
    jvgg, params, vgg = vgg_pair
    a, b = _images(2, 32, 1), _images(2, 32, 2)
    want = JL.lpips_distance(jvgg, params, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(to_np(L.lpips_distance(vgg, t(a), t(b))), np.asarray(want), **TOL)
    want_t = JL.lpips_training_distance(jvgg, params, jnp.asarray(a), jnp.asarray(b))
    pred = t(b).requires_grad_()
    got_t = L.lpips_training_distance(vgg, t(a), pred)
    np.testing.assert_allclose(to_np(got_t), np.asarray(want_t), **TOL)
    # Gradient through the prediction only, equal to JAX's.
    (g,) = torch.autograd.grad(got_t.sum(), pred)
    gj = jax.jit(jax.grad(
        lambda p: JL.lpips_training_distance(jvgg, params, jnp.asarray(a), p).sum()))(
        jnp.asarray(b))
    np.testing.assert_allclose(to_np(g), np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_load_lpips_round_trip(tmp_path):
    """An npz in the converter's layout (with the ScalingLayer) loads into
    both packages with the same settings and embeddings."""
    params = JL.VGG16LPIPS().init(jax.random.PRNGKey(5))
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}/{leaf}": np.asarray(a) for leaf, a in v.items()})
        else:
            flat[k] = np.asarray(v)
    flat["preprocess/shift"] = np.asarray([-0.03, -0.088, -0.188], np.float32)
    flat["preprocess/scale"] = np.asarray([0.458, 0.448, 0.450], np.float32)
    meta = {"resize_to": 24, "antialias": False, "calibration_err": 1e-6}
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **flat)
    jnet, jparams, jmeta = JL.load_lpips(path)
    net, tmeta = L.load_lpips(path, device="cpu")
    assert (net.resize_to, net.antialias) == (jnet.resize_to, jnet.antialias) == (24, False)
    assert tmeta == jmeta and tmeta["pretrained"]
    x = _images(2, 40, 6)
    want = JL.lpips_embed(jnet, jparams, jnp.asarray(x))
    np.testing.assert_allclose(to_np(L.lpips_embed(net, t(x))), np.asarray(want), **TOL)
    loaded, pretrained = L.lpips_params_or_warn(path, device="cpu")
    assert pretrained and loaded.resize_to == 24


def test_random_lpips_warns(capsys):
    net, pretrained = L.lpips_params_or_warn(None, device="cpu")
    assert not pretrained and net.resize_to == 256
    assert "RANDOM VGG16" in capsys.readouterr().out
    assert not any(p.requires_grad for p in net.parameters())


def test_gan_losses_and_metrics_match_jax():
    rs = np.random.RandomState(7)
    fake, real = rs.randn(4, 1).astype(np.float32), rs.randn(4, 1).astype(np.float32)
    np.testing.assert_allclose(to_np(L.g_nonsaturating_loss(t(fake))),
                               np.asarray(JL.g_nonsaturating_loss(jnp.asarray(fake))), **TOL)
    np.testing.assert_allclose(
        to_np(L.d_logistic_loss(t(real), t(fake))),
        np.asarray(JL.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake))), **TOL)
    v, f = rs.rand(4).astype(np.float32), np.asarray([1, 0, 1, 1], np.float32)
    np.testing.assert_allclose(to_np(L.masked_mean(t(v), t(f))),
                               np.asarray(JL.masked_mean(jnp.asarray(v), jnp.asarray(f))), **TOL)
    assert np.isfinite(to_np(L.masked_mean(t(v), torch.zeros(4))))
    a, b = _images(3, 8, 8), _images(3, 8, 9)
    np.testing.assert_allclose(to_np(M.psnr(t(a), t(b))),
                               np.asarray(JM.psnr(jnp.asarray(a), jnp.asarray(b))), **TOL)


def test_r1_penalty_analytic():
    a = 1.5
    x = np.random.RandomState(2).randn(3, 2, 4, 4).astype(np.float32)
    pen = L.r1_penalty(lambda imgs: a * imgs.square().sum(dim=(1, 2, 3)), t(x))
    np.testing.assert_allclose(to_np(pen), 4 * a * a * np.square(x).sum(axis=(1, 2, 3)),
                               rtol=1e-4)


def test_r1_penalty_of_discriminator_matches_jax():
    """R1 through the depth D (conv2d_resample, upfirdn2d and bias_act twice
    differentiated), and its gradient with respect to D's weights."""
    kw = dict(c_dim=25, img_resolution=16, img_channels=1, channel_base=256, channel_max=32)
    jd = JD(**kw)
    params = jd.init(jax.random.PRNGKey(8))
    d = Discriminator(**kw, device="meta")
    load_jax_params(d, params, device="cpu")
    rs = np.random.RandomState(9)
    x = (2.25 + rs.rand(4, 1, 16, 16)).astype(np.float32)
    c = rs.randn(4, 25).astype(np.float32)

    def jax_r1(p):
        return JL.r1_penalty(lambda im: jd.apply(p, im, jnp.asarray(c)), jnp.asarray(x))

    want = jax.jit(jax_r1)(params)
    got = L.r1_penalty(lambda im: d.apply(im, t(c)), t(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-6)
    gw = torch.autograd.grad(got.mean(), d.b16.conv0.weight)[0]
    gj = jax.jit(jax.grad(lambda p: jax_r1(p).mean()))(params)
    want_w = np.asarray(gj["b16"]["conv0"]["weight"])
    np.testing.assert_allclose(to_np(gw), want_w, rtol=1e-4, atol=1e-6 * np.abs(want_w).max())
