"""The port's dual discriminators (gnerf_tpu_torch.models.dual_discriminator)
vs gnerf_tpu.models.dual_discriminator: `filtered_resizing` in its four
modes, the logits of the Single, Dual and Dummy discriminators, R1 through
both inputs of the dual D (with the EG3D blur) and its weight gradient, and
`disc_c_noise` drawn from a key. fp32 on the CPU, JAX
parameters bridged with `load_jax_params`, numpy-seeded inputs. Tolerance
rtol 1e-4 / atol 1e-5 unless a case says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import dual_discriminator as jdd
from gnerf_tpu.ops.upfirdn2d import setup_filter as jsetup_filter
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.models import dual_discriminator as dd
from gnerf_tpu_torch.ops.upfirdn2d import setup_filter
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)
KW = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=512, channel_max=32,
          mbstd_group_size=2)


def _inputs(seed=0, n=2):
    rs = np.random.RandomState(seed)
    return {"image": rs.randn(n, 3, 32, 32).astype(np.float32),
            "image_raw": rs.randn(n, 3, 16, 16).astype(np.float32)}, \
        rs.randn(n, 25).astype(np.float32)


def _pair(name, **extra):
    """(JAX module, its params, the port's module holding them)."""
    jcls, cls = {"single": (jdd.SingleDiscriminator, dd.SingleDiscriminator),
                 "dual": (jdd.DualDiscriminator, dd.DualDiscriminator),
                 "dummy": (jdd.DummyDualDiscriminator, dd.DummyDualDiscriminator)}[name]
    jd = jcls(**KW, **extra)
    params = jd.init(jax.random.PRNGKey(3))
    d = cls(**KW, **extra, device="meta")
    load_jax_params(d, params, device="cpu")
    return jd, params, d


def _j(img):
    return {k: jnp.asarray(v) for k, v in img.items()}


def _t(img):
    return {k: t(v) for k, v in img.items()}


@pytest.mark.parametrize("mode", ["antialiased", "classic", "none", 0.5])
@pytest.mark.parametrize("src,size", [(16, 32), (24, 16)])
def test_filtered_resizing_matches_jax(mode, src, size):
    x = np.random.RandomState(src).randn(2, 3, src, src).astype(np.float32)
    want = jdd.filtered_resizing(jnp.asarray(x), size, jsetup_filter([1, 3, 3, 1]), mode)
    got = dd.filtered_resizing(t(x), size, setup_filter([1, 3, 3, 1]), mode)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_filtered_resizing_rejects_unknown_mode():
    with pytest.raises(ValueError, match="filter_mode"):
        dd.filtered_resizing(torch.zeros(1, 3, 4, 4), 8, filter_mode=1.5)


@pytest.mark.parametrize("name,extra,call", [
    ("single", {}, {}),
    ("dual", {}, {}),
    ("dual", {"filter_mode": "classic"}, {}),
    ("dummy", {}, {"raw_fade": 0.3}),
])
def test_discriminator_logits_match_jax(name, extra, call):
    jd, params, d = _pair(name, **extra)
    img, c = _inputs()
    want = jd.apply(params, _j(img), jnp.asarray(c), **call)
    got = d.apply(_t(img), t(c), **call)
    assert got.shape == (2, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    assert sorted(n.replace(".", "/") for n, _ in d.named_parameters()) == sorted(
        jax.tree_util.keystr(p, simple=True, separator="/")
        for p, _ in jax.tree_util.tree_leaves_with_path(params))


def test_dual_discriminator_has_six_input_channels():
    d = dd.DualDiscriminator(**KW, device="cpu")
    assert d.b32.fromrgb.weight.shape[1] == 6
    assert dd.SingleDiscriminator(**KW, device="cpu").b32.fromrgb.weight.shape[1] == 3


def test_disc_c_noise_from_explicit_generator():
    """With disc_c_noise > 0 the labels get N(0, 1) * their batch std
    (ddof 0) * disc_c_noise from the given key, as the JAX D draws it: the
    same key gives the JAX D's logits, another key others; no key raises."""
    jd, params, d = _pair("dual", disc_c_noise=0.5)
    img, c = _inputs(seed=4, n=4)
    a = d.apply(_t(img), t(c), rng=prng.PRNGKey(3))
    want = jd.apply(params, _j(img), jnp.asarray(c), rng=jax.random.PRNGKey(3))
    np.testing.assert_allclose(to_np(a), np.asarray(want), **TOL)
    other = d.apply(_t(img), t(c), rng=prng.PRNGKey(4))
    assert not torch.allclose(a, other)
    with pytest.raises(ValueError, match="disc_c_noise"):
        d.apply(_t(img), t(c))


BLUR_SIGMA = 1.5


def _r1_setup():
    jd, params, d = _pair("dual")
    img, c = _inputs(seed=6, n=4)
    cfg = E.EG3DLossConfig(r1_gamma=2.0)
    _, run_d = E._make_runners(cfg)
    return jd, params, d, img, c, cfg, run_d


def test_r1_through_both_inputs_matches_jax():
    """dD/dimage (through the blur) and dD/dimage_raw (through the resize
    inside D) against jax.grad, and the penalty (gamma / 2) R1 with its
    gradient with respect to every D weight (the double backward)."""
    jd, params, d, img, c, cfg, run_d = _r1_setup()
    size = E.blur_kernel_size(BLUR_SIGMA)

    def jax_r1(p, with_grads=False):
        def d_sum(i, r):
            return jd.apply(p, {"image": JE.blur_image(i, BLUR_SIGMA, size), "image_raw": r},
                            jnp.asarray(c)).sum()

        gi, gr = jax.grad(d_sum, argnums=(0, 1))(jnp.asarray(img["image"]),
                                                  jnp.asarray(img["image_raw"]))
        r1 = jnp.sum(gi ** 2, axis=(1, 2, 3)) + jnp.sum(gr ** 2, axis=(1, 2, 3))
        loss = (r1 * (cfg.r1_gamma / 2)).mean()
        return (loss, gi, gr) if with_grads else loss

    want_loss, want_gi, want_gr = jax.jit(lambda p: jax_r1(p, True))(params)
    xi, xr = t(img["image"]).requires_grad_(), t(img["image_raw"]).requires_grad_()
    gi, gr = torch.autograd.grad(
        run_d(d, {"image": xi, "image_raw": xr}, t(c), None, BLUR_SIGMA, size).sum(), [xi, xr])
    for got, want in ((gi, want_gi), (gr, want_gr)):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(got), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())

    loss = E._r1(run_d, d, t(img["image"]), t(img["image_raw"]), t(c), BLUR_SIGMA, size, 0, cfg)
    np.testing.assert_allclose(to_np(loss), np.asarray(want_loss), **TOL)
    names = [n for n, _ in d.named_parameters()]
    # The last layer's bias does not reach dD/dx: no gradient (JAX: zeros).
    grads = torch.autograd.grad(loss, list(d.parameters()), allow_unused=True)
    jgrads = jax.jit(jax.grad(jax_r1))(params)
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    # atol: 1e-6 of the largest weight gradient of D. Some small tensors'
    # gradients (fromrgb's bias, ~1e-7) are sums that cancel to 1e-4 of
    # their terms, where fp32 summation order shows.
    scale = max(np.abs(v).max() for v in flat.values())
    for name, g in zip(names, grads):
        want = flat[name.replace(".", "/")]
        got = np.zeros_like(want) if g is None else to_np(g)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 * scale, err_msg=name)


def test_dual_r1_runs_no_convolution_double_backward():
    """R1 through the dual D with the blur on, and its weight gradient, run
    no `aten::_convolution_double_backward` (per-group loops and whole-
    gradient kernels, PERF.md) and far fewer convolutions than channels
    times FIR stages: every differentiated convolution is `_Conv2d`."""
    from torch.profiler import ProfilerActivity, profile

    _, _, d, img, c, cfg, run_d = _r1_setup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = E._r1(run_d, d, t(img["image"]), t(img["image_raw"]), t(c), BLUR_SIGMA,
                     E.blur_kernel_size(BLUR_SIGMA), 0, cfg)
        torch.autograd.grad(loss, list(d.parameters()), allow_unused=True)
    keys = {e.key: e.count for e in prof.key_averages()}
    assert "aten::_convolution_double_backward" not in keys
    assert keys.get("aten::convolution", 0) < 200, keys.get("aten::convolution")
