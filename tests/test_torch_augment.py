"""The port's ADA pipe (gnerf_tpu_torch.training.augment) vs the JAX one.

What follows the draws: the filter bank, the geometric step fed the same
inverse transforms, the colour step fed the same matrices, each
augmentation alone under `debug_percentile` (deterministic in both), the
bgc pipe at p = 0 (every gate off, the resampling chain still runs) and the
reflect padding where the pad is wider than the image. The draws are
checked by their rate (the share of samples a brightness-only pipe
changes) and, key for key against JAX's, in tests/test_torch_draws.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.training import augment as JA
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.training import augment as A
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils import prng

WARP_TOL = dict(rtol=1e-4, atol=1e-4)
COLOR_TOL = dict(rtol=1e-5, atol=1e-5)


def _img(n=2, c=3, h=16, w=16, seed=0):
    return np.random.RandomState(seed).rand(n, c, h, w).astype(np.float32) * 2 - 1


def test_filter_bank_matches_jax():
    np.testing.assert_allclose(A._filter_bank(), JA._filter_bank(), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,pad", [(1, 7), (3, 7), (5, 21), (16, 15)])
def test_reflect_pad_matches_jnp_pad_wider_than_image(n, pad):
    """jnp.pad reflects again where the pad reaches past the far edge;
    F.pad(mode='reflect') refuses such pads."""
    x = _img(n=1, c=2, h=n, w=n + 1)
    want = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")
    np.testing.assert_array_equal(to_np(A.reflect_pad(t(x), pad)), np.asarray(want))


def _g_inv(n, seed):
    """Inverse transforms [n, 3, 3] built with the JAX helpers: flip,
    rotation, anisotropic scale and a fractional translation per sample."""
    rs = np.random.RandomState(seed)
    theta = jnp.asarray(rs.uniform(-np.pi, np.pi, n).astype(np.float32))
    sx = jnp.asarray(np.exp2(rs.randn(n) * 0.2).astype(np.float32))
    flip = jnp.asarray(rs.randint(0, 2, n).astype(np.float32))
    tx, ty = (jnp.asarray(rs.randn(n).astype(np.float32) * 2.0) for _ in range(2))
    g = JA._scale2d(1 / (1 - 2 * flip), jnp.ones_like(flip)) @ JA._rotate2d(theta)
    return np.asarray(g @ JA._scale2d(1 / sx, sx) @ JA._translate2d(tx, ty))


@pytest.mark.parametrize("c,h,w", [(3, 16, 16), (6, 20, 12), (1, 8, 8)])
def test_execute_geometric_matches_jax_on_its_matrices(c, h, w):
    """At 8^2 and 16^2 the static margin (ceil(0.55 S) + 6) is wider than
    the image."""
    x = _img(n=3, c=c, h=h, w=w, seed=c)
    g_inv = _g_inv(3, seed=h)
    want = JA.AugmentPipe(pad_fraction=0.55)._execute_geometric(jnp.asarray(x),
                                                               jnp.asarray(g_inv))
    got = A.AugmentPipe(pad_fraction=0.55)._execute_geometric(t(x), t(g_inv))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **WARP_TOL)


def _c_mat(n, seed):
    rs = np.random.RandomState(seed)
    b, c, th, s = (jnp.asarray(v.astype(np.float32)) for v in
                   (rs.randn(n) * 0.2, np.exp2(rs.randn(n) * 0.5), rs.uniform(-3, 3, n),
                    np.exp2(rs.randn(n))))
    v = np.asarray([1, 1, 1, 0]) / np.sqrt(3)
    vv = jnp.asarray(np.outer(v, v))
    m = JA._translate3d(b, b, b) @ JA._scale3d(c, c, c)
    m = (jnp.eye(4) - 2 * vv * (jnp.arange(n) % 2)[:, None, None]) @ m
    m = JA._rotate3d_axis(v, th) @ m
    return np.asarray((vv + (jnp.eye(4) - vv) * s[:, None, None]) @ m)


@pytest.mark.parametrize("c", [1, 3, 6])
def test_execute_color_matches_jax_on_its_matrices(c):
    x = _img(n=4, c=c, h=8, w=8, seed=c)
    cmat = _c_mat(4, seed=c)
    want = JA.AugmentPipe()._execute_color(jnp.asarray(x), jnp.asarray(cmat))
    got = A.AugmentPipe()._execute_color(t(x), t(cmat))
    np.testing.assert_allclose(to_np(got), np.asarray(want), **COLOR_TOL)


GEOMETRIC = ("xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac")
COLOR = ("brightness", "contrast", "lumaflip", "hue", "saturation")


@pytest.mark.parametrize("name,dp", [(n, 0.8) for n in GEOMETRIC + COLOR]
                         + [("rotate90", 0.3), ("imgfilter", 0.7), ("cutout", 0.4)])
def test_each_augmentation_alone_matches_jax_under_debug_percentile(name, dp):
    x = _img(n=2, c=3, h=16, w=16, seed=3)
    want = JA.AugmentPipe(**{name: 1.0})(jax.random.PRNGKey(0), jnp.asarray(x), p=1.0,
                                         debug_percentile=dp)
    got = A.AugmentPipe(**{name: 1.0})(prng.PRNGKey(0), t(x), p=1.0, debug_percentile=dp)
    tol = COLOR_TOL if name in COLOR + ("cutout",) else WARP_TOL
    np.testing.assert_allclose(to_np(got), np.asarray(want), **tol)
    assert not np.allclose(to_np(got), x, atol=1e-3)


def test_bgc_pipe_at_p0_matches_jax():
    """The EG3D pipe (bgc, margin 0.55) on a 6-channel pair at p = 0: no
    augmentation is drawn, but the pad -> upsample -> warp -> downsample
    chain runs (near the identity, not bit for bit)."""
    x = _img(n=2, c=6, h=16, w=16, seed=5)
    cfg = E.EG3DLossConfig(aug="ada")
    jpipe = JE.make_augment_pipe(JE.EG3DLossConfig(aug="ada"))
    want = np.asarray(dataclasses.replace(jpipe, warp_cell_pack=False)(
        jax.random.PRNGKey(0), jnp.asarray(x), p=0.0))
    got = to_np(E.make_augment_pipe(cfg)(prng.PRNGKey(0), t(x), p=0.0))
    np.testing.assert_allclose(got, want, **WARP_TOL)
    assert not np.array_equal(got, x)


def test_brightness_gate_rate():
    """A brightness-only pipe changes a sample with probability p: over
    4,096 samples the share lies within 3 sigma of p."""
    n, p = 4096, 0.3
    x = torch.zeros((n, 3, 2, 2))
    y = A.AugmentPipe(brightness=1.0)(prng.PRNGKey(7), x, p=p)
    share = float((y != x).flatten(1).any(dim=1).float().mean())
    assert abs(share - p) <= 3 * np.sqrt(p * (1 - p) / n), share


@pytest.mark.parametrize("p,rt,batch,target,kimg", [
    (0.0, 0.9, 4, 0.6, 500.0), (0.5, 0.1, 4, 0.6, 500.0), (0.999, 1.0, 32, 0.6, 0.1),
    (0.001, -1.0, 32, 0.6, 0.1), (0.3, 0.6, 8, 0.6, 100.0), (0.2, 0.75, 2, 0.7, 0.004),
])
def test_ada_update_p_matches_jax(p, rt, batch, target, kimg):
    kw = dict(aug="ada", ada_target=target, ada_kimg=kimg)
    assert E.ada_update_p(p, rt, batch, E.EG3DLossConfig(**kw)) == \
        JE.ada_update_p(p, rt, batch, JE.EG3DLossConfig(**kw))


@pytest.mark.parametrize("aug", ["ada", "fixed"])
def test_ada_controller_moves_p_once_per_window(aug):
    """'ada': p moves by ada_update_p on each window's mean sign, once per
    ada_interval reports; 'fixed': p stays at aug_p."""
    cfg = E.EG3DLossConfig(aug=aug, aug_p=0.3, ada_kimg=0.1)
    ctl = E.AdaController(cfg, batch_size=4, p=cfg.aug_p)
    signs = [1.0, 0.5, 1.0, 0.5, -1.0, -0.5, 0.0, -1.0]
    got = [ctl.report(torch.tensor(s)) for s in signs]
    if aug == "fixed":
        assert got == [0.3] * 8
        return
    p1 = E.ada_update_p(0.3, 0.75, 4, cfg)
    p2 = E.ada_update_p(p1, -0.625, 4, cfg)
    assert got == [0.3] * 3 + [p1] * 4 + [p2] and p1 > 0.3 > p2


def test_warp_is_grid_sample_differentiable_to_any_order():
    """`warp` is F.grid_sample (bilinear, zeros, align_corners=False); its
    first and second input derivatives (R1's) equal PyTorch's own where this
    torch has them, and gradgradcheck holds in float64."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(2, 3, 7, 6))
    grid = torch.from_numpy(rs.uniform(-1.2, 1.2, (2, 5, 4, 2)))
    w = torch.from_numpy(rs.randn(2, 3, 5, 4))

    def grads(fn):
        xi = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((fn(xi) * w).square().sum(), xi, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), xi)
        return fn(x), gx.detach(), ggx

    def plain(xi):
        return torch.nn.functional.grid_sample(xi, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=False)

    for got, want in zip(grads(lambda xi: A.warp(xi, grid)), grads(plain)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradgradcheck(lambda xi: A.warp(xi, grid),
                                        (x.clone().requires_grad_(True),))
    with pytest.raises(ValueError, match="input only"):
        A.warp(x, grid.clone().requires_grad_(True))
