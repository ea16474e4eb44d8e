"""The port's StyleGAN3 (T configuration) vs gnerf_tpu.models.stylegan3 on
the CPU, fp32, from JAX's init through `load_jax_params`: the filter taps
(1e-7), the modulated conv, the Fourier input, one up=2 and one critically
sampled layer, the tiny generator of tests/test_models_extra.py (atol 1e-4),
its parameter gradients (rtol 1e-3) and the magnitude EMA."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import stylegan3 as J
from gnerf_tpu_torch.models import stylegan3 as T
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, load_jax_params

TINY = dict(z_dim=16, c_dim=0, w_dim=32, img_resolution=32, img_channels=3, channel_base=1024,
            channel_max=32, num_layers=6)
ATOL = 1e-4


@pytest.mark.parametrize("numtaps,cutoff,width,fs,radial", [
    (12, 2.0, 2.0, 16, False), (12, 2.0, 2.0, 16, True), (24, 8.0, 5.3, 64, False),
    (13, 3.17, 4.1, 32, True), (6, 11.3, 9.7, 64, False), (1, 2.0, 2.0, 16, False),
])
def test_design_lowpass_filter_matches_jax(numtaps, cutoff, width, fs, radial):
    want = J.design_lowpass_filter(numtaps, cutoff, width, fs, radial=radial)
    got = T.design_lowpass_filter(numtaps, cutoff, width, fs, radial=radial)
    if numtaps == 1:
        assert got is None and want is None
        return
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("demodulate,padding,gain", [(True, 2, 0.7), (False, 0, None)])
def test_sg3_modulated_conv2d_matches_jax(demodulate, padding, gain):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 9, 9).astype(np.float32)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)
    s = rng.randn(2, 6).astype(np.float32)
    g = None if gain is None else np.float32(gain)
    want = J.sg3_modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), demodulate,
                                  padding, None if g is None else jnp.asarray(g))
    got = T.sg3_modulated_conv2d(t(x), t(w), t(s), demodulate, padding,
                                 None if g is None else torch.tensor(g))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=ATOL)


def test_synthesis_input_matches_jax():
    jin = J.SynthesisInput(w_dim=32, channels=16, size=36, sampling_rate=16.0, bandwidth=2.0)
    params = jin.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)  # a non-identity transform and affine
    params["affine"]["weight"] = jnp.asarray(rng.randn(4, 32).astype(np.float32))
    params["transform"] = jnp.asarray(np.eye(3, dtype=np.float32) + 0.1 * rng.randn(3, 3)
                                      .astype(np.float32))
    tin = T.SynthesisInput(w_dim=32, channels=16, size=36, sampling_rate=16.0, bandwidth=2.0)
    load_jax_params(tin, params)
    w = rng.randn(3, 32).astype(np.float32)
    want = jin.apply(params, jnp.asarray(w))
    got = tin(t(w))
    assert got.shape == (3, 16, 36, 36)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("idx", [0, 5])  # L0: up=2 down=2; L5: critically sampled
def test_synthesis_layer_matches_jax(idx):
    name, jl = J.SynthesisNetwork(w_dim=32, img_resolution=32, img_channels=3,
                                  channel_base=1024, channel_max=32, num_layers=6)._layer(idx)
    assert jl.is_critically_sampled == (idx == 5) and jl.up_factor == 2
    params = jl.init(jax.random.PRNGKey(idx))
    params["magnitude_ema"] = jnp.float32(1.7)
    params["bias"] = jnp.asarray(np.random.RandomState(2).randn(jl.out_channels)
                                 .astype(np.float32))
    kw = {f.name: getattr(jl, f.name) for f in dataclasses.fields(jl)
          if f.name not in ("conv_kernel", "use_radial_filters")}
    tl = T.SynthesisLayer(**kw)
    load_jax_params(tl, params)
    assert tl.padding == jl._padding(*jl._filters()[2:])
    rng = np.random.RandomState(3)
    x = rng.randn(2, jl.in_channels, jl.in_size, jl.in_size).astype(np.float32)
    w = rng.randn(2, 32).astype(np.float32)
    want = jl.apply(params, jnp.asarray(x), jnp.asarray(w))
    got = tl(t(x), t(w))
    assert got.shape == (2, jl.out_channels, jl.out_size, jl.out_size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_np(tl.updated_magnitude_ema(t(x))),
                               np.asarray(jl.updated_magnitude_ema(params, jnp.asarray(x))),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    """(JAX Generator, its params, the port's Generator with them, z)."""
    jg = J.Generator(**TINY)
    params = jg.init(jax.random.PRNGKey(0))
    tg = T.Generator(**TINY, device="meta")
    load_jax_params(tg, params, device="cpu")
    z = np.random.RandomState(1).randn(2, 16).astype(np.float32)
    return jg, params, tg, z


def test_generator_matches_jax(tiny):
    jg, params, tg, z = tiny
    want = np.asarray(jg.apply(params, jnp.asarray(z), None))
    got = to_np(tg(t(z), None))
    assert got.shape == (2, 3, 32, 32) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The designed filters stay out of the state_dict; the keys are the JAX tree's.
    keys = {k.replace(".", "/") for k in tg.state_dict()}
    assert keys == set(flatten_tree(params))
    assert not any(k.endswith(("fu", "fd")) for k in keys)
    assert {k for k in keys if k.startswith("synthesis/input/")} == {
        f"synthesis/input/{k}" for k in ("weight", "affine/weight", "affine/bias", "transform",
                                         "freqs", "phases")}


def test_generator_gradients_match_jax(tiny):
    jg, params, tg, z = tiny
    r = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)

    def loss(p):
        return jnp.sum(jg.apply(p, jnp.asarray(z), None) * r)

    want = flatten_tree(jax.jit(jax.grad(loss))(params))
    tg.zero_grad()
    (tg(t(z), None) * t(r)).sum().backward()
    names = dict(tg.named_parameters())
    assert names
    for name, p in names.items():
        w = np.asarray(want[name.replace(".", "/")])
        assert p.grad is not None, name
        np.testing.assert_allclose(to_np(p.grad), w, rtol=1e-3,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-12), err_msg=name)


def test_bridge_refuses_a_mismatched_tree(tiny):
    _, params, _, _ = tiny
    tg = T.Generator(**TINY, device="cpu")
    flat = dict(flatten_tree(params))
    extra = dict(flat, **{"synthesis/L0_36_32/fu": np.zeros(12, np.float32)})
    with pytest.raises(KeyError):
        load_jax_params(tg, extra)
    missing = {k: v for k, v in flat.items() if k != "synthesis/L3_52_32/magnitude_ema"}
    with pytest.raises(KeyError):
        load_jax_params(tg, missing)
    wrong = dict(flat, **{"synthesis/input/freqs": np.zeros((3, 2), np.float32)})
    with pytest.raises(ValueError):
        load_jax_params(tg, wrong)
