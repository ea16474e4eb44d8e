"""Shared set-up of the EG3D parity tests (tests/test_torch_eg3d_step.py,
tests/test_torch_eg3d_phases.py; tests/test_torch_eg3d.py takes the JAX
density points; the seeded phases of tests/test_torch_seeded_eg3d.py and
test_torch_seeded_ada.py at the end): the tiny G of
tests/test_torch_training.py with its JAX key withheld from the synthesis,
a tiny dual D, one batch of the JAX SyntheticDataset, and the comparison of
the port's state with the JAX state after Adam steps.

In the unseeded tests the draws of a JAX step are taken out of play: the
synthesis gets no key
(constant noise, deterministic sampling: the port's rng=None), the swap
probability is exactly 1 (gpc_reg_fade_kimg 1e9 keeps it there in float32
after the first step), style mixing is off, and the density regularizer's
points are derived from the JAX key exactly as `density_regularization`
splits it, then handed to the port's TV.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from _torch_port import to_np
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models.dual_discriminator import DualDiscriminator as JDual
from gnerf_tpu.training import dataset as jds
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.models import DualDiscriminator, TriPlaneGenerator
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, load_jax_params, module_params

TOL = dict(rtol=1e-4, atol=1e-5)
TINY_G = dict(z_dim=32, w_dim=32, img_resolution=128, plane_resolution=16, channel_base=512,
              channel_max=32, mapping_layers=2, neural_rendering_resolution=8)
TINY_D = dict(c_dim=25, img_resolution=16, img_channels=3, channel_base=256, channel_max=32,
              mbstd_group_size=2)
# density_reg_p_dist 0.05 (default 0.004): at the default the TV is a
# difference of nearly equal sigmas, where fp32 rounding alone is ~1e-4 of it.
CFG = dict(neural_rendering_resolution=8, density_reg_points=16, density_reg_p_dist=0.05,
           blur_init_sigma=1.0, blur_fade_kimg=1.0, gpc_reg_fade_kimg=1e9, r1_gamma=2.0)


def tiny_rendering_kwargs():
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS

    return dict(DEFAULT_RENDERING_KWARGS, superresolution_module="SuperresolutionHybrid2X",
                depth_resolution=4, depth_resolution_importance=4)


class JGenNoRng(JGen):
    """The JAX G with the step's key withheld from the synthesis."""

    def synthesis(self, params, ws, c, neural_rendering_resolution=None, noise_mode="const",
                  rng=None, **kw):
        return super().synthesis(params, ws, c,
                                 neural_rendering_resolution=neural_rendering_resolution,
                                 noise_mode="const", rng=None, **kw)


def jax_networks(**cfg_overrides):
    g = JGenNoRng(**TINY_G, rendering_kwargs=tiny_rendering_kwargs())
    disc = JDual(**TINY_D)
    return g, disc, JE.EG3DLossConfig(**CFG, remat_synthesis=False, **cfg_overrides)


def port_state(jstate, lazy, **cfg_overrides):
    """The port's EG3DState holding the JAX state's parameters."""
    g = TriPlaneGenerator(**TINY_G, rendering_kwargs=tiny_rendering_kwargs(), device="meta")
    load_jax_params(g, jstate["params_g"], device="cpu")
    d = DualDiscriminator(**TINY_D, device="meta")
    load_jax_params(d, jstate["params_d"], device="cpu")
    cfg = E.EG3DLossConfig(**{**CFG, **cfg_overrides})
    return E.init_eg3d_state(g, d, cfg, lazy=lazy), cfg


def tiny_batch(seed=0):
    ds = jds.SyntheticDataset(resolution=16, depth_resolution=8, size=16)
    items = jds.collate([ds[i] for i in range(2 * seed, 2 * seed + 2)])
    c = np.asarray(items["loss_c"], np.float32)
    return {"z": np.random.RandomState(seed).randn(2, 32).astype(np.float32), "c": c,
            "real_image": np.asarray(items["loss_image"], np.float32) / 127.5 - 1.0,
            "real_c": c}


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_density_points(key, n, cfg):
    """JAX's density_regularization draws for `key`, as torch tensors."""
    k1, k2, k3 = jax.random.split(key, 3)
    initial = jax.random.uniform(k1, (n, cfg.density_reg_points, 3)) * 2 - 1
    perturbed = initial + jax.random.normal(k2, initial.shape) * cfg.density_reg_p_dist
    coords = jnp.concatenate([initial, perturbed], axis=1)
    dirs = jax.random.normal(k3, coords.shape)
    return torch.from_numpy(np.array(coords)), torch.from_numpy(np.array(dirs))


def use_jax_points(monkeypatch, key, jcfg):
    """The port's next density draws become JAX's for `key`."""
    pts = jax_density_points(key, 2, jcfg)
    monkeypatch.setattr(E, "density_reg_points", lambda n, cfg, rng, device: pts)


class AdamLog:
    """The gradient of every Adam step a phase takes: with beta1 = 0 the
    first moment is the last gradient itself."""

    def __init__(self, state):
        self.state = state
        self.grads = {}
        self.lr_sum = {}

    def record(self, opt_name):
        opt = getattr(self.state, opt_name)
        lr = opt.param_groups[0]["lr"]
        for p in (p for grp in opt.param_groups for p in grp["params"]):
            self.grads.setdefault(id(p), []).append(to_np(opt.state[p]["exp_avg"]).copy())
            self.lr_sum[id(p)] = self.lr_sum.get(id(p), 0.0) + lr


def assert_adam_steps_match(name, jax_new, param, log):
    """Adam maps each gradient to about +-lr (exactly so on the first step),
    so a weight whose gradient lies within fp32 summation noise may move the
    other way in the other package. Every weight off rtol 1e-4 / atol 1e-5
    of the JAX result must have had such a gradient in one of its steps
    (below 3e-4 of its tensor's largest), be within two steps' lr of it,
    and be one of under 1% of the tensor's weights."""
    got, want = to_np(param), np.asarray(jax_new)
    off = ~np.isclose(got, want, **TOL)
    if not off.any():
        return
    tiny = np.zeros(got.shape, bool)
    for gr in log.grads.get(id(param), []):
        tiny |= np.abs(gr) < 3e-4 * np.abs(gr).max()
    assert off.mean() < 0.01, (name, off.mean())
    assert tiny[off].all(), (name, int((off & ~tiny).sum()))
    assert np.abs(got - want).max() <= 2 * log.lr_sum[id(param)] + 1e-5, name


def assert_state_matches(jstate, state, log):
    """G (with w_avg), D and G_ema equal the JAX state's, trained weights
    under the Adam rule above."""
    for root, module in (("params_g", state.g), ("params_d", state.disc)):
        params = {n.replace(".", "/"): p for n, p in module.named_parameters()}
        bufs = module_params(module)
        flat = flatten_tree(jstate[root])
        assert set(flat) == set(bufs), sorted(set(flat) ^ set(bufs))[:5]
        for k, v in flat.items():
            if k in params and params[k].requires_grad:
                assert_adam_steps_match(f"{root}/{k}", v, params[k], log)
            else:
                np.testing.assert_allclose(bufs[k], np.asarray(v), **TOL, err_msg=f"{root}/{k}")
    ema = module_params(state.g_ema)
    for k, v in flatten_tree(jstate["params_g_ema"]).items():
        np.testing.assert_allclose(ema[k], np.asarray(v), **TOL, err_msg=f"G_ema/{k}")


def assert_stats_match(stats, jstats):
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **TOL, err_msg=k)


# The seeded phases (tests/test_torch_seeded_eg3d.py, test_torch_seeded_ada.py):
# JAX's G with its noise on, the swap at probability 0.75 (cur_nimg 500 of a
# 1 kimg fade), style mixing at 0.5, the blur at sigma 0.5; every draw from
# the phase's key in both packages, as the CLI keys them: Gmain + Dmain on
# the step key, Greg on fold_in(key, 1), Dreg on fold_in(key, 2).
SEEDED_NIMG = 500
SEEDED_CFG = dict(CFG, gpc_reg_fade_kimg=1.0, style_mixing_prob=0.5)


def seeded_jax_phases(phases, **cfg_overrides):
    """(initial JAX state, [(state, stats) after each phase of `phases`],
    the step key) from the real JAX G with noisy layers."""
    import functools

    g = JGen(**TINY_G, rendering_kwargs=tiny_rendering_kwargs())
    disc = JDual(**TINY_D)
    jcfg = JE.EG3DLossConfig(**SEEDED_CFG, remat_synthesis=False, **cfg_overrides)
    main, greg, dreg, opt_g, opt_d = JE.make_eg3d_phase_steps(g, disc, jcfg)
    state = JE.init_eg3d_state(g, disc, opt_g, opt_d, jax.random.PRNGKey(0))
    from _torch_port import with_noise_strength

    noisy = with_noise_strength(jax.tree_util.tree_map(np.asarray, state["params_g"]))
    state = dict(state, params_g=noisy, params_g_ema=noisy,
                 cur_nimg=jnp.asarray(SEEDED_NIMG, jnp.int32))
    batch = jnp_batch(tiny_batch())
    key = jax.random.fold_in(jax.random.PRNGKey(1), SEEDED_NIMG)
    sigma = JE.blur_sigma_schedule(SEEDED_NIMG, jcfg)
    size = JE.blur_kernel_size(sigma)
    aug_p = jcfg.aug_p
    out, s = [], state
    for phase in phases:
        if phase == "main":
            s, st = jax.jit(functools.partial(main, blur_size=size, res=8))(
                s, batch, key, sigma, aug_p)
        elif phase == "greg":
            s, st = jax.jit(greg)(s, batch, jax.random.fold_in(key, 1))
        else:
            s, st = jax.jit(functools.partial(dreg, blur_size=size, res=8))(
                s, batch, jax.random.fold_in(key, 2), sigma, aug_p)
        out.append((s, st))
    return state, out, sigma, size


def check_seeded_phases(jax_run, phases, **cfg_overrides):
    """The port's phases from the JAX run's state and the same keys: every
    stat and the state after each phase (assert_state_matches)."""
    from gnerf_tpu_torch.utils import prng

    jstate0, results, sigma, size = jax_run
    state, cfg = port_state(jstate0, lazy=True, **SEEDED_CFG, **cfg_overrides)
    state.cur_nimg = SEEDED_NIMG
    main, greg, dreg = E.make_eg3d_phase_steps(cfg)
    batch = torch_batch(tiny_batch())
    key = prng.fold_in(prng.PRNGKey(1), SEEDED_NIMG)
    log = AdamLog(state)
    for phase, (jnew, jstats) in zip(phases, results):
        if phase == "main":
            _, stats = main(state, batch, key, sigma, cfg.aug_p, blur_size=size, res=8)
            log.record("opt_g")
            log.record("opt_d")
        elif phase == "greg":
            _, stats = greg(state, batch, prng.fold_in(key, 1))
            log.record("opt_g")
        else:
            _, stats = dreg(state, batch, prng.fold_in(key, 2), sigma, cfg.aug_p,
                            blur_size=size, res=8)
            log.record("opt_d")
        assert_stats_match(stats, jstats)
        assert state.cur_nimg == int(jnew["cur_nimg"])
        assert_state_matches(jnew, state, log)
