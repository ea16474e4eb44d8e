"""Port ops vs gnerf_tpu.ops on the cases of tests/test_ops.py (fp32, CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu import ops as jops
from gnerf_tpu_torch import ops

ATOL = RTOL = 1e-5


@pytest.mark.parametrize("up,down,padding", [
    (1, 1, (0, 0, 0, 0)),
    (2, 1, (2, 1, 2, 1)),
    (1, 2, (1, 1, 1, 1)),
    (2, 2, (3, 2, 2, 3)),
    (1, 1, (2, -1, -1, 2)),  # negative padding = crop
    (4, 1, (3, 1, 2, 2)),
])
@pytest.mark.parametrize("flip_filter", [False, True])
def test_upfirdn2d_matches_jax(up, down, padding, flip_filter):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 12, 10).astype(np.float32)
    f = np.outer([1.0, 3.0, 5.0, 1.0], [1.0, 2.0, 3.0, 1.0]).astype(np.float32)
    f /= f.sum()
    want = jops.upfirdn2d(jnp.asarray(x), jnp.asarray(f), up=up, down=down, padding=padding,
                          flip_filter=flip_filter, gain=2.0)
    got = ops.upfirdn2d(t(x), t(f), up=up, down=down, padding=padding,
                        flip_filter=flip_filter, gain=2.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_upfirdn2d_separable_matches_jax():
    x = np.random.RandomState(1).randn(1, 2, 16, 16).astype(np.float32)
    taps = [1, 3, 5, 7, 7, 5, 3, 1]
    fj = jops.setup_filter(taps)
    ft = ops.setup_filter(taps)
    assert ft.dim() == 1
    np.testing.assert_allclose(to_np(ft), np.asarray(fj), rtol=1e-7)
    want = jops.upfirdn2d(jnp.asarray(x), fj, up=2, padding=(3, 3, 3, 3), gain=4)
    got = ops.upfirdn2d(t(x), ft, up=2, padding=(3, 3, 3, 3), gain=4)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("helper", ["upsample2d", "downsample2d", "filter2d"])
def test_resample_helpers_match_jax(helper):
    x = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    want = getattr(jops, helper)(jnp.asarray(x), jops.setup_filter([1, 3, 3, 1]))
    got = getattr(ops, helper)(t(x), ops.setup_filter([1, 3, 3, 1]))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act,gain,clamp", [
    ("linear", None, None),
    ("lrelu", None, None),
    ("lrelu", 1.0, 256.0),
    ("relu", None, None),
    ("tanh", None, None),
    ("sigmoid", None, None),
    ("softplus", None, None),
    ("swish", None, None),
    ("elu", None, None),
    ("selu", None, None),
])
def test_bias_act_matches_jax(act, gain, clamp):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 4, 4) * 3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    want = jops.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, gain=gain, clamp=clamp)
    got = ops.bias_act(t(x), t(b), act=act, gain=gain, clamp=clamp)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert ops.activation_funcs[act].def_gain == jops.activation_funcs[act].def_gain


@pytest.mark.parametrize("up,down,kernel,groups", [
    (1, 1, 3, 1),
    (1, 1, 1, 1),
    (2, 1, 3, 1),   # up=2 with flip_weight=False (the SynthesisLayer case)
    (1, 2, 3, 1),
    (1, 2, 1, 1),
    (2, 1, 3, 2),
])
def test_conv2d_resample_matches_jax(up, down, kernel, groups):
    rng = np.random.RandomState(5)
    cin, cout = 4, 6
    x = rng.randn(2, cin, 8, 8).astype(np.float32)
    w = rng.randn(cout, cin // groups, kernel, kernel).astype(np.float32)
    f = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32)
    f /= f.sum()
    kw = dict(up=up, down=down, padding=kernel // 2, groups=groups, flip_weight=(up == 1))
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(f), **kw)
    got = ops.conv2d_resample(t(x), t(w), t(f), **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_hw,out_hw,antialias", [
    ((64, 64), (128, 128), True),   # SR path: upsample (antialias inert)
    ((64, 64), (128, 128), False),
    ((32, 48), (16, 24), True),     # antialiased downsample
    ((32, 48), (16, 24), False),
    ((17, 13), (23, 29), False),    # odd sizes
    ((8, 8), (16, 16), True),       # the tiny SR config's resize
])
def test_interpolate_bilinear_matches_jax(in_hw, out_hw, antialias):
    x = np.random.RandomState(8).randn(2, 3, *in_hw).astype(np.float32)
    want = jops.interpolate_bilinear(jnp.asarray(x), out_hw[0], out_hw[1], antialias=antialias)
    got = ops.interpolate_bilinear(t(x), out_hw[0], out_hw[1], antialias=antialias)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
