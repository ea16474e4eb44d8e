"""The EG3D phases with the ADA pipe (aug='ada') vs the JAX package's.

At aug_p = 0 every gate of the bgc pipe is off and p_rot is 0, yet the
static geometric chain (reflect pad -> upsample -> warp -> downsample) and
the pair's resizes still run in front of every D call, R1 included. That
chain is deterministic, so Gmain + Dmain and Dreg (R1 through the pipe and
D's double backward) are held to the JAX phases from the same parameters
and batch with the blur on, at rtol 1e-4 / atol 1e-5 under the Adam-flip
rule (tests/_torch_eg3d.py takes the JAX draws out of play). The pipe's own
draws at p = 0.5 from the step's key are tests/test_torch_seeded_ada.py's."""

import functools

import jax
import pytest
import torch

from _torch_eg3d import (AdamLog, assert_state_matches, assert_stats_match, jax_networks,
                         jnp_batch, port_state, tiny_batch, torch_batch)
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.utils import prng

DREG_KEY = 3


def _sched(cfg, nimg):
    sigma = JE.blur_sigma_schedule(nimg, cfg)
    return sigma, JE.blur_kernel_size(sigma)


@pytest.fixture(scope="module")
def jax_ada_phases():
    """JAX state and stats after Gmain + Dmain, then Dreg, with aug='ada'
    at aug_p = 0."""
    g, disc, jcfg = jax_networks(aug="ada")
    main, _, dreg, opt_g, opt_d = JE.make_eg3d_phase_steps(g, disc, jcfg)
    state0 = JE.init_eg3d_state(g, disc, opt_g, opt_d, jax.random.PRNGKey(0))
    batch = jnp_batch(tiny_batch())
    sigma, size = _sched(jcfg, 0)
    s1, st1 = jax.jit(functools.partial(main, blur_size=size, res=8))(
        state0, batch, jax.random.PRNGKey(1), sigma, 0.0)
    sigma2, size2 = _sched(jcfg, 2)
    s2, st2 = jax.jit(functools.partial(dreg, blur_size=size2, res=8))(
        s1, batch, jax.random.PRNGKey(DREG_KEY), sigma2, 0.0)
    return jcfg, state0, [(s1, st1), (s2, st2)]


def test_ada_phases_at_p0_match_jax(jax_ada_phases):
    jcfg, jstate0, phases = jax_ada_phases
    state, cfg = port_state(jstate0, lazy=True, aug="ada")
    assert E.make_augment_pipe(cfg) is not None
    main, _, dreg = E.make_eg3d_phase_steps(cfg)
    batch = torch_batch(tiny_batch())
    log = AdamLog(state)

    sigma, size = _sched(jcfg, 0)
    _, stats = main(state, batch, None, sigma, 0.0, blur_size=size, res=8)
    log.record("opt_g")
    log.record("opt_d")
    assert_stats_match(stats, phases[0][1])
    assert_state_matches(phases[0][0], state, log)

    sigma2, size2 = _sched(jcfg, 2)
    _, stats = dreg(state, batch, None, sigma2, 0.0, blur_size=size2, res=8)
    log.record("opt_d")
    assert_stats_match(stats, phases[1][1])
    assert_state_matches(phases[1][0], state, log)


def test_ada_pipe_changes_what_d_sees_at_p1(jax_ada_phases):
    """With p = 1 the D logits of the same images move, and the same key
    gives the same logits twice."""
    _, jstate0, _ = jax_ada_phases
    state, cfg = port_state(jstate0, lazy=True, aug="ada")
    _, run_d = E._make_runners(cfg)
    batch = torch_batch(tiny_batch())
    img = {"image": batch["real_image"],
           "image_raw": torch.nn.functional.interpolate(batch["real_image"], size=(8, 8))}

    def logits(p, nimg=0):
        with torch.no_grad():
            return run_d(state.disc, img, batch["real_c"], prng.fold_in(prng.PRNGKey(1), nimg),
                         aug_p=p)

    assert torch.equal(logits(1.0), logits(1.0))
    assert not torch.allclose(logits(1.0), logits(0.0), rtol=1e-3, atol=1e-4)
    assert not torch.equal(logits(1.0), logits(1.0, nimg=2))


def test_r1_through_the_pipe_runs_no_convolution_double_backward(jax_ada_phases):
    """Dreg at p = 1 (every FIR filter of the pipe differentiated twice):
    every convolution goes through `_Conv2d`, none through PyTorch's
    convolution double backward."""
    from torch.profiler import ProfilerActivity, profile

    _, jstate0, _ = jax_ada_phases
    state, cfg = port_state(jstate0, lazy=True, aug="ada")
    _, _, dreg = E.make_eg3d_phase_steps(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, stats = dreg(state, torch_batch(tiny_batch()), prng.PRNGKey(2), 0.0, 1.0, res=8)
    keys = {e.key for e in prof.key_averages()}
    assert "aten::grid_sampler_2d_backward" in keys
    assert "aten::_convolution_double_backward" not in keys
    assert torch.isfinite(stats["Loss/D/reg"])
