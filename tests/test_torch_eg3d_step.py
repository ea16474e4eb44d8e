"""The port's fused EG3D step (`make_eg3d_train_step`) vs the JAX package's:
one step from the same parameters and batch, with the blur on, the pose
swap and both regularizers (tests/_torch_eg3d.py says how the JAX draws are
taken out of play). Every stat, G (with w_avg), G_ema and D after the step
match at rtol 1e-4 / atol 1e-5, the trained weights under the Adam-flip
rule. The JAX compile takes most of the file's time; the lazy phases are in
tests/test_torch_eg3d_phases.py so the two compiles run on two workers."""

import functools

import jax
import pytest

from _torch_eg3d import (AdamLog, assert_state_matches, assert_stats_match, jax_networks,
                         jnp_batch, port_state, tiny_batch, torch_batch, use_jax_points)
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.training import eg3d_loss as E


@pytest.fixture(scope="module")
def jax_step():
    g, disc, jcfg = jax_networks()
    step, opt_g, opt_d = JE.make_eg3d_train_step(g, disc, jcfg)
    state = JE.init_eg3d_state(g, disc, opt_g, opt_d, jax.random.PRNGKey(0))
    sigma = JE.blur_sigma_schedule(0, jcfg)
    size = JE.blur_kernel_size(sigma)
    key = jax.random.PRNGKey(1)
    new, stats = jax.jit(functools.partial(step, blur_size=size, res=8))(
        state, jnp_batch(tiny_batch()), key, sigma, 0.0)
    return jcfg, state, new, stats, key, sigma, size


def test_fused_step_matches_jax(jax_step, monkeypatch):
    jcfg, jstate, jnew, jstats, key, sigma, size = jax_step
    assert size == 3
    state, cfg = port_state(jstate, lazy=False)
    k_g, _ = jax.random.split(key)
    use_jax_points(monkeypatch, jax.random.split(k_g, 3)[1], jcfg)
    log = AdamLog(state)
    _, stats = E.make_eg3d_train_step(cfg)(state, torch_batch(tiny_batch()), None, sigma,
                                           blur_size=size, res=8)
    log.record("opt_g")
    log.record("opt_d")
    assert_stats_match(stats, jstats)
    assert state.cur_nimg == int(jnew["cur_nimg"]) == 2
    assert_state_matches(jnew, state, log)


def test_fused_step_gradients_reach_their_own_networks(jax_step):
    """All of G trains and D's weights get one gradient per step, from the D
    loss alone (none from G's loss, though D runs inside it); the step
    updates every G tensor the loss reaches and every D tensor."""
    _, jstate, _, _, _, sigma, size = jax_step
    state, cfg = port_state(jstate, lazy=False)
    d_grads = {name: 0 for name, _ in state.disc.named_parameters()}
    for name, p in state.disc.named_parameters():
        p.register_hook(lambda g, name=name: d_grads.__setitem__(name, d_grads[name] + 1))
    g_before = {k: v.clone() for k, v in state.g.state_dict().items()}
    d_before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    E.make_eg3d_train_step(cfg)(state, torch_batch(tiny_batch()), None, sigma,
                                blur_size=size, res=8)
    assert set(d_grads.values()) == {1}, d_grads
    assert all(not v.equal(d_before[k]) for k, v in state.disc.state_dict().items())
    moved = {k for k, v in state.g.state_dict().items() if not v.equal(g_before[k])}
    assert "backbone.mapping.w_avg" in moved and "decoder.fc0.weight" in moved
    assert any(k.startswith("superresolution.") for k in moved)
