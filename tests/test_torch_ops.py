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


@pytest.mark.parametrize("taps,up,down,padding", [
    ([1, 3, 3, 1], 1, 2, (1, 1, 1, 1)),                # D's FIR downsampling
    ([1, 3, 3, 1], 2, 1, (2, 1, 2, 1)),                # G's FIR upsampling
    ([1, 3, 5, 7, 7, 5, 3, 1], 2, 1, (3, 3, 3, 3)),    # separable
])
def test_upfirdn2d_differentiated_matches_jax(taps, up, down, padding):
    """With an input that requires grad (the differentiable convolution):
    the values and the input gradient equal the JAX op's and its VJP's, and
    the values those of the inference path."""
    import jax
    import torch

    rs = np.random.RandomState(len(taps) + up)
    x = rs.randn(2, 3, 10, 10).astype(np.float32)
    fj, ft = jops.setup_filter(taps), ops.setup_filter(taps)
    xt = t(x).requires_grad_()
    got = ops.upfirdn2d(xt, ft, up=up, down=down, padding=padding, gain=up * up)
    want, vjp = jax.vjp(lambda a: jops.upfirdn2d(a, fj, up=up, down=down, padding=padding,
                                                 gain=up * up), jnp.asarray(x))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    cot = rs.randn(*want.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, t(cot))
    np.testing.assert_allclose(to_np(gx), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():
        grouped = ops.upfirdn2d(t(x), ft, up=up, down=down, padding=padding, gain=up * up)
    np.testing.assert_allclose(to_np(got), to_np(grouped), rtol=1e-6, atol=1e-6)


def test_upfirdn2d_double_backward_is_not_per_channel():
    """R1 differentiates the FIR filtering twice; that must not run one
    convolution per channel (PyTorch's double backward of a grouped
    convolution does, even for a constant filter)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    c = 32
    x = torch.randn(2, c, 12, 12, requires_grad=True)
    w = torch.randn(c, c, 3, 3, requires_grad=True)
    f = ops.setup_filter([1, 3, 3, 1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = ops.upfirdn2d(torch.nn.functional.conv2d(x, w, padding=1), f, down=2,
                          padding=1)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        torch.autograd.grad(gx.square().sum(), w)
    convs = sum(e.count for e in prof.key_averages() if e.key == "aten::convolution")
    assert convs < c, convs


def test_upfirdn2d_takes_the_plain_route_on_the_cpu(monkeypatch):
    """A CPU tensor never reaches the kernel: the launch is not called, the
    launch count stays, and the result is the plain version's."""
    import importlib

    import torch

    mod = importlib.import_module("gnerf_tpu_torch.ops.upfirdn2d")

    def no_launch(*args):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(mod, "_launch", no_launch)
    x = torch.randn(2, 3, 9, 7)
    f = ops.setup_filter([1, 3, 3, 1])
    before = ops.upfirdn2d.launches
    for grad in (False, True):
        xg = x.clone().requires_grad_(grad)
        got = ops.upfirdn2d(xg, f, up=2, padding=(2, 1, 2, 1), gain=4)
        want = mod._plain(x, f, (2, 2), (1, 1), (2, 1, 2, 1), False, 4.0)
        torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)
    assert ops.upfirdn2d.launches == before
    with pytest.raises(ValueError):
        ops.upfirdn2d(x.to("meta"), f)


def _upfirdn2d_filter(kind):
    import torch

    if kind == "none":
        return None
    if kind == "sep12":
        return ops.setup_filter(list(np.random.RandomState(12).rand(12) + 0.5))
    if kind == "asym":
        return torch.tensor(np.random.RandomState(35).rand(3, 5), dtype=torch.float32)
    return ops.setup_filter([1, 3, 3, 1])


@pytest.mark.parametrize("kind,up,down,padding,flip", [
    ("4x4", 2, 1, (3, 2, 3, 2), False),        # SR's up=2 conv0
    ("4x4", 1, 2, (1, 1, 1, 1), False),        # D's FIR downsampling
    ("4x4", 1, 2, (1, 1, 1, 1), True),         # the up=2 layers' gradient
    ("4x4", 1, 1, (-1, 2, 2, -1), False),      # negative padding = crop
    ("none", 1, 1, (1, 0, 2, -1), False),      # pad-only, no filter
    ("sep12", 2, 1, (6, 5, 6, 5), False),      # ADA's 12 taps
    ("sep12", 1, 2, (3, 2, -1, -2), True),
    ("asym", (2, 1), (1, 3), (0, 1, 2, 0), False),
])
def test_upfirdn2d_gradient_formula_matches_autograd(monkeypatch, kind, up, down, padding,
                                                     flip):
    """The kernel's Function (`_Upfirdn2d`, its launch replaced by the plain
    version, as the kernel has no CPU mode) in float64: its backward (up and
    down swapped, filter flipped, padding derived) passes gradcheck and,
    differentiated once more through itself, gradgradcheck, and equals
    autograd through the plain version to the last bits of float64."""
    import importlib

    import torch

    mod = importlib.import_module("gnerf_tpu_torch.ops.upfirdn2d")
    monkeypatch.setattr(mod, "_launch", mod._plain)
    f = _upfirdn2d_filter(kind)
    up, down = mod._parse_scaling(up), mod._parse_scaling(down)
    args = (up, down, mod._parse_padding(padding), flip, 2.0)
    g = torch.Generator().manual_seed(len(kind) + sum(up) + sum(down))
    x = torch.randn(1, 2, 16, 14, generator=g, dtype=torch.float64, requires_grad=True)

    def fn(a):
        return mod._Upfirdn2d.apply(a, f, *args)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    out = {}
    for name, route in (("function", fn), ("plain", lambda a: mod._plain(a, f, *args))):
        y = route(x)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), x)
        out[name] = (y, gx, ggx)
    for a, b in zip(out["function"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("stride,padding,size,groups", [(1, 1, 9, 1), (2, 0, 10, 1), (2, 0, 9, 1),
                                                         (1, 0, 8, 2)])
def test_conv2d_twice_differentiated_matches_native(stride, padding, size, groups):
    """The resampling ops' differentiable convolution: values, first and
    second derivatives (an R1-style penalty's weight gradient) equal those
    through F.conv2d's own backward."""
    import torch
    import torch.nn.functional as F

    from gnerf_tpu_torch.ops.upfirdn2d import conv2d

    g = torch.Generator().manual_seed(stride + size)
    x = torch.randn(2, 4, size, size, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(6, 4 // groups, 3, 3, generator=g, dtype=torch.float64, requires_grad=True)
    out = {}
    for name, conv in (("port", lambda a: conv2d(a, w, stride, padding, groups)),
                       ("native", lambda a: F.conv2d(a, w, stride=stride, padding=padding,
                                                     groups=groups))):
        y = conv(x)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        gw = torch.autograd.grad(gx.square().sum(), w)[0]
        out[name] = (y, gx, gw)
    for a, b in zip(out["port"], out["native"]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def _sg3_taps(factor, radial=False):
    """A layer's Kaiser filter (separable [taps]) or jinc filter (radial
    [taps, taps]) for a resampling factor (None for 1)."""
    from gnerf_tpu.models.stylegan3 import design_lowpass_filter

    return design_lowpass_filter(6 * factor, 8.0, 9.0, 64, radial) if factor > 1 else None


@pytest.mark.parametrize("up,down,radial", [
    (1, 1, False), (2, 1, False), (1, 2, False), (2, 2, False), (4, 2, False), (2, 4, False),
    (4, 4, False), (4, 2, True), (2, 4, True),  # 2-D filters at factors 2 and 4
])
def test_filtered_lrelu_and_its_gradient_match_jax(up, down, radial):
    import jax

    rng = np.random.RandomState(up * 10 + down)
    x = rng.randn(2, 3, 10, 10).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    fu, fd = _sg3_taps(up, radial), _sg3_taps(down, radial)
    pad = 6 * max(up, down)
    padding = (pad, pad - 1, pad - 1, pad)
    kw = dict(up=up, down=down, padding=padding, gain=1.3, slope=0.2, clamp=0.9)

    def jfn(x, b):
        return jops.filtered_lrelu(x, None if fu is None else jnp.asarray(fu),
                                   None if fd is None else jnp.asarray(fd), b, **kw)

    want = jfn(jnp.asarray(x), jnp.asarray(b))
    xt, bt = t(x).requires_grad_(True), t(b).requires_grad_(True)
    got = ops.filtered_lrelu(xt, None if fu is None else t(fu), None if fd is None else t(fd),
                             bt, **kw)
    assert got.shape == want.shape
    unclamped = ops.filtered_lrelu(t(x), None if fu is None else t(fu),
                                   None if fd is None else t(fd), t(b), **dict(kw, clamp=None))
    assert (to_np(unclamped) != to_np(got)).any()  # the clamp bites
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-5)
    r = rng.randn(*want.shape).astype(np.float32)
    gx, gb = jax.grad(lambda x, b: jnp.sum(jfn(x, b) * r), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(b))
    (got * t(r)).sum().backward()
    # The bias gradient sums ~10^3 terms to magnitudes near 50, where fp32
    # itself rounds by ~4e-6: 1e-5 of each gradient's largest, at least 1e-5.
    for g, w in ((xt.grad, gx), (bt.grad, gb)):
        w = np.asarray(w)
        np.testing.assert_allclose(to_np(g), w, rtol=0, atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("packing", [{}, {"lane_pack": True}, {"cell_pack": True}])
def test_grid_sample_2d_matches_jax(packing):
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 6, 7, 9).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 50, 2)).astype(np.float32)  # some outside the map
    coords[0, :4] = [[-1.0, -1.0], [1.0, 1.0], [1.2, 0.0], [0.0, -1.06]]
    want = jops.grid_sample_2d(jnp.asarray(feats), jnp.asarray(coords), **packing)
    got = ops.grid_sample_2d(t(feats), t(coords), **packing)
    assert got.shape == (2, 50, 6)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-5)
    assert (to_np(got)[0, 2] == 0).all()  # wholly outside: zeros


def test_grid_sample_3d_matches_jax():
    rng = np.random.RandomState(6)
    grid = rng.randn(2, 4, 5, 6, 7).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 60, 3)).astype(np.float32)
    coords[1, 0] = [0.0, 0.0, 1.5]  # outside along z alone
    want = jops.grid_sample_3d(jnp.asarray(grid), jnp.asarray(coords))
    got = ops.grid_sample_3d(t(grid), t(coords))
    assert got.shape == (2, 60, 4)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-5)
    assert (to_np(got)[1, 0] == 0).all()


def test_fma_matches_jax():
    rng = np.random.RandomState(7)
    a, b, c = rng.randn(3, 1, 5), rng.randn(4, 1), rng.randn(5)
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    want = jops.fma(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_allclose(to_np(ops.fma(t(a), t(b), t(c))), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
