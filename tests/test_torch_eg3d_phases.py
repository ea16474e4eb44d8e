"""The port's lazy-regularization phases (`make_eg3d_phase_steps`) vs the
JAX package's: Gmain + Dmain, then Greg, then Dreg, from the same
parameters and batch with the blur on (tests/_torch_eg3d.py says how the
JAX draws are taken out of play). After each phase every stat, G (with
w_avg), G_ema and D match at rtol 1e-4 / atol 1e-5, the trained weights
under the Adam-flip rule; Adam's lr and betas are scaled by
interval / (interval + 1). Also: Freeze-D keeps its layers bitwise through
every phase."""

import functools

import jax
import pytest

from _torch_eg3d import (AdamLog, assert_state_matches, assert_stats_match, jax_networks,
                         jnp_batch, port_state, tiny_batch, torch_batch, use_jax_points)
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils import prng

GREG_KEY, DREG_KEY = 2, 3


def _sched(cfg, nimg):
    sigma = JE.blur_sigma_schedule(nimg, cfg)
    return sigma, JE.blur_kernel_size(sigma)


@pytest.fixture(scope="module")
def jax_phases():
    """JAX state and stats after Gmain + Dmain, Greg and Dreg."""
    g, disc, jcfg = jax_networks()
    main, greg, dreg, opt_g, opt_d = JE.make_eg3d_phase_steps(g, disc, jcfg)
    state0 = JE.init_eg3d_state(g, disc, opt_g, opt_d, jax.random.PRNGKey(0))
    batch = jnp_batch(tiny_batch())
    sigma, size = _sched(jcfg, 0)
    s1, st1 = jax.jit(functools.partial(main, blur_size=size, res=8))(
        state0, batch, jax.random.PRNGKey(1), sigma, 0.0)
    s2, st2 = jax.jit(greg)(s1, batch, jax.random.PRNGKey(GREG_KEY))
    sigma2, size2 = _sched(jcfg, 2)
    s3, st3 = jax.jit(functools.partial(dreg, blur_size=size2, res=8))(
        s2, batch, jax.random.PRNGKey(DREG_KEY), sigma2, 0.0)
    return jcfg, state0, [(s1, st1), (s2, st2), (s3, st3)]


def test_phases_match_jax(jax_phases, monkeypatch):
    jcfg, jstate0, phases = jax_phases
    state, cfg = port_state(jstate0, lazy=True)
    main, greg, dreg = E.make_eg3d_phase_steps(cfg)
    batch = torch_batch(tiny_batch())
    log = AdamLog(state)

    sigma, size = _sched(jcfg, 0)
    _, stats = main(state, batch, None, sigma, blur_size=size, res=8)
    log.record("opt_g")
    log.record("opt_d")
    assert_stats_match(stats, phases[0][1])
    assert state.cur_nimg == 2
    assert_state_matches(phases[0][0], state, log)

    k_reg = jax.random.split(jax.random.PRNGKey(GREG_KEY))[1]
    use_jax_points(monkeypatch, k_reg, jcfg)
    _, stats = greg(state, batch, None)
    log.record("opt_g")
    assert_stats_match(stats, phases[1][1])
    assert_state_matches(phases[1][0], state, log)

    sigma2, size2 = _sched(jcfg, 2)
    assert size2 == 2
    _, stats = dreg(state, batch, None, sigma2, blur_size=size2, res=8)
    log.record("opt_d")
    assert_stats_match(stats, phases[2][1])
    assert state.cur_nimg == int(phases[2][0]["cur_nimg"]) == 2
    assert_state_matches(phases[2][0], state, log)


def test_lazy_adam_is_scaled(jax_phases):
    _, jstate0, _ = jax_phases
    state, cfg = port_state(jstate0, lazy=True)
    for opt, lr, interval in ((state.opt_g, cfg.glr, 4), (state.opt_d, cfg.dlr, 16)):
        mb = interval / (interval + 1)
        group = opt.param_groups[0]
        assert group["lr"] == pytest.approx(lr * mb)
        assert group["betas"] == pytest.approx((0.0, 0.99 ** mb))
    fused, _ = port_state(jstate0, lazy=False)
    assert fused.opt_g.param_groups[0]["lr"] == cfg.glr
    assert fused.opt_d.param_groups[0]["betas"] == (0.0, 0.99)


def test_frozen_d_layers_stay_bitwise(jax_phases):
    """--freezed 2: b16's fromrgb and conv0 stay bitwise through Dmain and
    Dreg, while R1's input gradient still flows through them; b16.conv1 and
    the epilogue move."""
    _, jstate0, _ = jax_phases
    state, cfg = port_state(jstate0, lazy=True, freeze_d_layers=2)
    main, greg, dreg = E.make_eg3d_phase_steps(cfg)
    batch = torch_batch(tiny_batch())
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    main(state, batch, prng.PRNGKey(0))
    greg(state, batch, prng.PRNGKey(1))
    dreg(state, batch, None)
    after = state.disc.state_dict()
    for k, v in after.items():
        frozen = k.startswith(("b16.fromrgb.", "b16.conv0."))
        assert v.equal(before[k]) == frozen, k
