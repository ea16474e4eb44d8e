"""The pieces of the port's EG3D objective (gnerf_tpu_torch.training.eg3d_loss)
vs gnerf_tpu.training.eg3d_loss: the host schedules over a grid of
cur_nimg, the blur, the pose swap and style mixing, the Freeze-D mask, the
(lazily scaled) Adam hyperparameters, `check_fade_sr_compat` and the
density TV on JAX's own points. fp32 on the CPU; tolerance rtol 1e-4 /
atol 1e-5 unless a case says otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_eg3d import jax_density_points
from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models import dual_discriminator as jdd
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu.training.train import check_fade_sr_compat as jcheck_fade_sr_compat
from gnerf_tpu_torch.models import DualDiscriminator, TriPlaneGenerator
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.training.train import check_fade_sr_compat
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)
NIMG = [0, 1, 2, 1000, 4096, 50_000, 99_999, 100_000, 200_000, 333_333, 500_000, 999_999,
        1_000_000, 2_000_000, 10 ** 9]
SCHEDULE_CFGS = [
    dict(),
    dict(blur_init_sigma=10.0, blur_fade_kimg=200, gpc_reg_prob=0.5, gpc_reg_fade_kimg=1000),
    dict(gpc_reg_prob=None, r1_gamma=10.0, r1_gamma_init=2.0, r1_gamma_fade_kimg=100.0),
    dict(neural_rendering_resolution=64, neural_rendering_resolution_final=128,
         neural_rendering_resolution_fade_kimg=1000.0, res_bucket=8),
    dict(neural_rendering_resolution=64, neural_rendering_resolution_final=100,
         neural_rendering_resolution_fade_kimg=10.0, res_bucket=8),
    dict(neural_rendering_resolution=128, neural_rendering_resolution_final=64,
         neural_rendering_resolution_fade_kimg=100.0),
]


@pytest.mark.parametrize("kw", SCHEDULE_CFGS)
def test_schedules_match_jax(kw):
    jcfg, cfg = JE.EG3DLossConfig(**kw), E.EG3DLossConfig(**kw)
    for n in NIMG:
        sigma = E.blur_sigma_schedule(n, cfg)
        assert sigma == pytest.approx(float(JE.blur_sigma_schedule(n, jcfg)), rel=1e-6), n
        assert E.blur_kernel_size(sigma) == JE.blur_kernel_size(JE.blur_sigma_schedule(n, jcfg))
        assert E.neural_resolution_schedule(n, cfg) == JE.neural_resolution_schedule(n, jcfg), n
        assert E.r1_gamma_schedule(n, cfg) == pytest.approx(
            float(JE.r1_gamma_schedule(n, jcfg)), rel=1e-6), n
        want = JE.swapping_prob_schedule(n, jcfg)
        got = E.swapping_prob_schedule(n, cfg)
        assert (got is None) == (want is None)
        if got is not None:
            assert got == pytest.approx(float(want), rel=1e-6), n


def test_config_defaults_match_jax():
    """Same field names and defaults, apart from the dtype's type and the
    rematerialisation default, which the port chose on the H100 (PERF.md)."""
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(JE.EG3DLossConfig)}
    got = {f.name: f.default for f in dataclasses.fields(E.EG3DLossConfig)}
    assert want.keys() == got.keys()
    assert want.pop("dtype") == jnp.float32 and got.pop("dtype") == torch.float32
    assert want.pop("remat_synthesis") is True and got.pop("remat_synthesis") is False
    assert got == want


@pytest.mark.parametrize("sigma,size", [(2.0, 6), (10.0, 30), (0.7, 2)])
def test_blur_image_matches_jax(sigma, size):
    """30 taps either side run past the 16^2 image: the zero padding counts."""
    x = np.random.RandomState(size).randn(2, 3, 16, 16).astype(np.float32)
    want = JE.blur_image(jnp.asarray(x), sigma, size)
    np.testing.assert_allclose(to_np(E.blur_image(t(x), sigma, size)), np.asarray(want), **TOL)
    torch.testing.assert_close(E.blur_image(t(x), 1e-8, 0), t(x), rtol=0, atol=0)


def test_swapped_conditioning():
    """Probability 1 rolls the labels by one, None gives zeros, 0 keeps
    them; in between each row is either itself or its neighbour's."""
    c = np.random.RandomState(1).randn(6, 25).astype(np.float32)
    key, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    np.testing.assert_array_equal(to_np(E.swapped_conditioning(tkey, t(c), 1.0)),
                                  np.asarray(JE.swapped_conditioning(key, jnp.asarray(c), 1.0)))
    np.testing.assert_array_equal(to_np(E.swapped_conditioning(tkey, t(c), None)), 0.0)
    np.testing.assert_array_equal(to_np(E.swapped_conditioning(tkey, t(c), 0.0)), c)
    mixed = to_np(E.swapped_conditioning(prng.PRNGKey(2), t(c), 0.5))
    rolled = np.roll(c, 1, axis=0)
    rows = [np.array_equal(m, a) or np.array_equal(m, b) for m, a, b in zip(mixed, c, rolled)]
    assert all(rows)


def _tiny_g(**rk_overrides):
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS

    cfg = dict(z_dim=16, w_dim=16, img_resolution=128, plane_resolution=16, channel_base=256,
               channel_max=32, mapping_layers=2, neural_rendering_resolution=8,
               rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS,
                                     superresolution_module="SuperresolutionHybrid2X",
                                     depth_resolution=4, depth_resolution_importance=4,
                                     **rk_overrides))
    return cfg


def _pair_g(seed=0, **cfg_overrides):
    cfg = {**_tiny_g(), **cfg_overrides}
    jg = JGen(**cfg)
    params = jg.init(jax.random.PRNGKey(seed))
    g = TriPlaneGenerator(**cfg, device="meta")
    load_jax_params(g, params, device="cpu")
    return jg, params, g


def test_style_mixing():
    """prob 0 is the identity; prob 1 keeps index 0 and replaces a suffix
    of ws, from one cutoff for the whole batch, with the mapping of a fresh
    z (the JAX package's semantics; tests/test_torch_draws.py holds the
    draws to JAX's)."""
    g = TriPlaneGenerator(**_tiny_g(), device="cpu")
    z = torch.randn(3, 16, generator=torch.Generator().manual_seed(1))
    c = torch.zeros(3, 25)
    mapping = g.backbone.mapping
    ws = mapping(z, c)
    same = E.apply_style_mixing(mapping, ws, 16, c, prng.PRNGKey(2), 0.0)
    assert same is ws
    for seed in range(4):
        mixed = E.apply_style_mixing(mapping, ws, 16, c, prng.PRNGKey(seed), 1.0)
        diff = (mixed != ws).any(dim=2)  # [N, num_ws]
        assert not diff[:, 0].any() and (diff == diff[0]).all()
        cut = int(diff[0].float().argmax())
        assert cut >= 1 and diff[0, cut:].all() and not diff[0, :cut].any()
        fresh = mixed[:, cut:]
        assert torch.allclose(fresh, fresh[:, :1].expand_as(fresh))  # one broadcast w per row


D_KW = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=512, channel_max=32,
            mbstd_group_size=1)


@pytest.mark.parametrize("layers", [0, 1, 3, 4, 7, 20])
def test_freeze_d_mask_matches_jax(layers):
    jd = jdd.DualDiscriminator(**D_KW)
    params = jd.init(jax.random.PRNGKey(0))
    mask = JE.freeze_d_trainable_mask(jd, params, layers)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): bool(v)
            for p, v in jax.tree_util.tree_leaves_with_path(mask)}
    disc = DualDiscriminator(**D_KW, device="cpu")
    got = E.freeze_d_trainable_mask(disc, layers)
    assert got == want
    assert any(not v for v in got.values()) == (layers > 0)
    # init_eg3d_state freezes exactly the masked weights and leaves them
    # out of D's optimizer.
    g = TriPlaneGenerator(**_tiny_g(), device="cpu")
    state = E.init_eg3d_state(g, disc, E.EG3DLossConfig(freeze_d_layers=layers))
    trainable = {n.replace(".", "/"): p.requires_grad for n, p in disc.named_parameters()}
    assert trainable == want
    in_opt = {id(p) for grp in state.opt_d.param_groups for p in grp["params"]}
    assert in_opt == {id(p) for p in disc.parameters() if p.requires_grad}
    assert all(p.requires_grad for p in g.parameters())
    assert not any(p.requires_grad for p in state.g_ema.parameters())


@pytest.mark.parametrize("interval", [0, 1, 4, 16])
def test_scaled_adam_matches_optax(interval):
    """betas (0, 0.99), eps 1e-8, and under lazy regularization lr and both
    betas scaled by interval / (interval + 1): three steps of the same
    gradients move a weight as optax does."""
    lr = 0.002
    opt_j = JE._make_adam(lr, None, JE.EG3DLossConfig(), for_d=False, reg_interval=interval)
    rs = np.random.RandomState(interval)
    w0 = rs.randn(5, 3).astype(np.float32)
    grads = [rs.randn(5, 3).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    pj, sj = jnp.asarray(w0), opt_j.init(jnp.asarray(w0))
    p = torch.nn.Parameter(t(w0))
    opt = E._make_adam([p], lr, interval)
    for gr in grads:
        upd, sj = opt_j.update(jnp.asarray(gr), sj, pj)
        pj = pj + upd
        p.grad = t(gr)
        opt.step()
    np.testing.assert_allclose(to_np(p), np.asarray(pj), rtol=1e-5, atol=1e-7)
    mb = interval / (interval + 1) if interval > 1 else 1.0
    group = opt.param_groups[0]
    assert group["lr"] == pytest.approx(lr * mb) and group["eps"] == 1e-8
    assert group["betas"] == pytest.approx((0.0, 0.99 ** mb))


def test_check_fade_sr_compat_raises_as_jax():
    """The configs of tests/test_models_extra.py::test_fade_sr_compat_check:
    the 2X SR module under a fade raises, no fade is a no-op, and an SR
    variant with the fixed-input resize guard passes, in both packages."""
    jg, params, g = _pair_g()
    cfg_kw = dict(neural_rendering_resolution=8, neural_rendering_resolution_final=4,
                  neural_rendering_resolution_fade_kimg=1.0, res_bucket=4)
    with pytest.raises(ValueError, match="resize guard"):
        jcheck_fade_sr_compat(jg, params, JE.EG3DLossConfig(**cfg_kw), img_resolution=16)
    with pytest.raises(ValueError, match="resize guard"):
        check_fade_sr_compat(g, E.EG3DLossConfig(**cfg_kw), img_resolution=16)
    check_fade_sr_compat(g, E.EG3DLossConfig(neural_rendering_resolution=8), img_resolution=16)

    g4x_cfg = dict(_tiny_g(), img_resolution=256)
    g4x_cfg["rendering_kwargs"] = dict(g4x_cfg["rendering_kwargs"], sr_input_resolution=8,
                                       superresolution_module="SuperresolutionHybrid4X")
    jg4 = JGen(**g4x_cfg)
    jcheck_fade_sr_compat(jg4, jg4.init(jax.random.PRNGKey(1)),
                          JE.EG3DLossConfig(**cfg_kw), img_resolution=16)
    check_fade_sr_compat(TriPlaneGenerator(**g4x_cfg, device="cpu"),
                         E.EG3DLossConfig(**cfg_kw), img_resolution=16)


def test_density_tv_on_jax_points_matches_jax():
    """The TV value, and its gradient with respect to ws, on the points
    JAX's density_regularization draws from its key."""
    jg, params, g = _pair_g(seed=5)
    jcfg = JE.EG3DLossConfig(density_reg_points=64, density_reg_p_dist=0.05)
    cfg = E.EG3DLossConfig(density_reg_points=64, density_reg_p_dist=0.05)
    z = np.random.RandomState(2).randn(2, 16).astype(np.float32)
    ws = np.asarray(jg.mapping(params, jnp.asarray(z), jnp.zeros((2, 25))))
    key = jax.random.PRNGKey(11)

    def jax_tv(w):
        return JE.density_regularization(jg, params, w, key, jcfg)

    want, want_gw = jax.value_and_grad(jax_tv)(jnp.asarray(ws))
    coords, dirs = jax_density_points(key, 2, jcfg)
    w = t(ws).requires_grad_()
    got = E.density_tv(g, w, coords, dirs, cfg)
    (gw,) = torch.autograd.grad(got, w)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    want_gw = np.asarray(want_gw)
    np.testing.assert_allclose(to_np(gw), want_gw, rtol=1e-4, atol=1e-6 * np.abs(want_gw).max())
    # The port's own draws of another key: the same shapes, the
    # perturbation at its scale.
    c2, d2 = E.density_reg_points(2, cfg, prng.PRNGKey(1), "cpu")
    assert c2.shape == (2, 128, 3) and d2.shape == (2, 128, 3)
    assert float(c2[:, :64].abs().max()) <= 1.0
    assert 0.02 < float((c2[:, 64:] - c2[:, :64]).std()) < 0.08

