"""The port's lazy-regularization phases (`make_eg3d_phase_steps`) vs the
JAX package's: Gmain + Dmain, then Greg, then Dreg, from the same
parameters and batch with the blur on (tests/_torch_eg3d.py says how the
JAX draws are taken out of play). After each phase every stat, G (with
w_avg), G_ema and D match at rtol 1e-4 / atol 1e-5, the trained weights
under the Adam-flip rule; Adam's lr and betas are scaled by
interval / (interval + 1). Also: Freeze-D keeps its layers bitwise through
every phase."""

import functools
import os

import jax
import pytest
import torch

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


@pytest.fixture(scope="module")
def jax_freeze_dreg():
    """Under --freezed 2 (optax multi_transform over D): the JAX initial
    state, its state after one Dreg, that state through the JAX
    `save_train_state` / `load_train_state` and one Dreg more, the file."""
    import tempfile

    import jax.numpy as jnp
    import numpy as np

    from gnerf_tpu.training import train_loop as JT

    g, disc, jcfg = jax_networks(freeze_d_layers=2)
    _, _, dreg, opt_g, opt_d = JE.make_eg3d_phase_steps(g, disc, jcfg)
    # Leaves without weak types, as load_train_state gives them back, so the
    # second Dreg reuses the first one's compile.
    state0 = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), JE.init_eg3d_state(
        g, disc, opt_g, opt_d, jax.random.PRNGKey(0)))
    sigma, size = _sched(jcfg, 2)
    step = jax.jit(functools.partial(dreg, blur_size=size, res=8))
    batch = jnp_batch(tiny_batch())
    s1, _ = step(state0, batch, jax.random.PRNGKey(DREG_KEY), sigma, 0.0)
    path = os.path.join(tempfile.mkdtemp(), "jax_state.npz")
    JT.save_train_state(path, s1, config={"aug_p_live": 0.125})
    loaded, config = JT.load_train_state(path, s1)
    assert config == {"aug_p_live": 0.125}
    s2, st2 = step(loaded, batch, jax.random.PRNGKey(DREG_KEY), sigma, 0.0)
    yield state0, s1, (s2, st2), path
    os.remove(path)


def test_jax_freeze_d_state_resumes_in_port(jax_freeze_dreg):
    """JAX's full state under Freeze-D (one Dreg taken) loads into the port
    bit for bit, with the live ADA p in its config; one Dreg more equals
    JAX's from its own load of the file (D under the Adam-flip rule, the
    frozen layers bitwise), and the Adam count is 2 in both."""
    import numpy as np

    from gnerf_tpu_torch.training import jax_state
    from gnerf_tpu_torch.training import train_loop as T

    state0, s1, (s2, st2), path = jax_freeze_dreg
    state, cfg = port_state(state0, lazy=True, freeze_d_layers=2)
    _, config, _ = T.load_train_state(path, state)
    assert config["aug_p_live"] == 0.125
    plan = jax_state.leaf_plan(state)
    for leaf, (p, x) in zip(plan, jax.tree_util.tree_flatten_with_path(s1)[0]):
        assert leaf.path == jax.tree_util.keystr(p)
        np.testing.assert_array_equal(jax_state.leaf_value(leaf), np.asarray(x), leaf.path)
    frozen = {k: v.clone() for k, v in state.disc.state_dict().items()
              if k.startswith(("b16.fromrgb.", "b16.conv0."))}
    _, _, dreg = E.make_eg3d_phase_steps(cfg)
    sigma, size = _sched(cfg, 2)
    log = AdamLog(state)
    _, stats = dreg(state, torch_batch(tiny_batch()), None, sigma, blur_size=size, res=8)
    log.record("opt_d")
    assert_stats_match(stats, st2)
    assert_state_matches(s2, state, log)
    for k, v in frozen.items():
        assert torch.equal(state.disc.state_dict()[k], v), k
    params = [p for grp in state.opt_d.param_groups for p in grp["params"]]
    assert {int(state.opt_d.state[p]["step"]) for p in params} == {2}
    count = s2["opt_state_d"].inner_states["train"].inner_state[0].count
    assert int(count) == 2


def test_port_freeze_d_state_loads_in_jax(jax_freeze_dreg, tmp_path, capsys):
    """The port's EG3D state under Freeze-D after a Gmain + Dmain and a Dreg,
    written by the port, loads in the JAX `load_train_state` with no cast
    warning, every leaf equal to the port's bit for bit."""
    import numpy as np

    from gnerf_tpu.training import train_loop as JT
    from gnerf_tpu_torch.training import jax_state
    from gnerf_tpu_torch.training import train_loop as T

    state0, s1, _, _ = jax_freeze_dreg
    state, cfg = port_state(state0, lazy=True, freeze_d_layers=2)
    main, _, dreg = E.make_eg3d_phase_steps(cfg)
    batch = torch_batch(tiny_batch())
    main(state, batch, prng.PRNGKey(0))
    dreg(state, batch, prng.PRNGKey(1))
    path = str(tmp_path / "port_state.npz")
    T.save_train_state(path, state, config={"aug_p_live": 0.5})
    capsys.readouterr()
    loaded, config = JT.load_train_state(path, s1)
    assert "WARNING" not in capsys.readouterr().out and config == {"aug_p_live": 0.5}
    assert int(loaded["cur_nimg"]) == 2
    leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
    plan = jax_state.leaf_plan(state)
    assert len(leaves) == len(plan)
    for leaf, (p, x) in zip(plan, leaves):
        want = jax_state.leaf_value(leaf)
        x = np.asarray(x)
        assert jax.tree_util.keystr(p) == leaf.path
        assert x.dtype == want.dtype and np.array_equal(x, want), leaf.path
    steps = {leaf.name: int(jax_state.leaf_value(leaf)) for leaf in plan if leaf.kind == "step"}
    assert steps == {"opt_g/step": 1, "opt_d/step": 2}
    d = {leaf.tensor for leaf in plan if leaf.name.startswith("opt_d/exp_avg/")}
    assert d == {p for grp in state.opt_d.param_groups for p in grp["params"]}
