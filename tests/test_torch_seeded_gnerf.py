"""The port's seeded G-NeRF train step vs the JAX package's, from the same
key: JAX's G with its random noise on (noise_strength 0.5 in every layer),
the stratified jitter and the importance samples drawn from the step's key
in both packages, nothing handed over. The tiny configuration and the
checks of tests/test_torch_training.py: every stat, E with its BN
statistics, G, D and G_ema after the step at rtol 1e-4 / atol 1e-5, the
trained weights under the Adam-flip rule. The JAX compile takes most of
the file's time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import one_torch_thread, to_np, with_noise_strength  # noqa: F401
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.training import train_loop as JT
from gnerf_tpu_torch.training import train_loop as T
from gnerf_tpu_torch.training.train import step_key
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, module_params
from test_torch_training import (TINY_G, TOL, assert_adam_step_matches, jax_setup, port_state,
                                 tiny_batch, tiny_rendering_kwargs, torch_batch)


@pytest.fixture(scope="module")
def seeded_jax_step():
    """One JAX step of the real G (noise_mode 'random' on the step's key)
    from a seeded init with noisy layers: (init state, new state, stats,
    batch)."""
    _, enc, disc, vgg, cfg = jax_setup(False)
    g = JGen(**TINY_G, rendering_kwargs=tiny_rendering_kwargs())
    state = JT.init_train_state(g, enc, disc, vgg, cfg, jax.random.PRNGKey(0))
    noisy = with_noise_strength(jax.tree_util.tree_map(np.asarray, state.params_g))
    state = state.replace(params_g=noisy, params_g_ema=noisy)
    opt_g, opt_d = JT.make_optimizers(g, state.params_e, state.params_g, cfg)
    step = jax.jit(JT.make_train_step(g, enc, disc, vgg, opt_g, opt_d, cfg))
    batch = tiny_batch()
    new, stats = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, step_key_jax(0, 0))
    return state, new, {k: float(v) for k, v in stats.items()}, batch


def step_key_jax(seed, cur_nimg):
    """The JAX CLI's step key (`gnerf_tpu/training/train.py:1001-1020`)."""
    return jax.random.fold_in(jax.random.PRNGKey(seed + 1), cur_nimg)


def test_step_key_is_the_jax_clis():
    for seed, nimg in ((0, 0), (3, 8), (41, 2 ** 20)):
        np.testing.assert_array_equal(step_key(seed, nimg).numpy(),
                                      np.asarray(step_key_jax(seed, nimg)).astype(np.int64))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_seeded_step_matches_jax(seeded_jax_step, remat):
    """The step from the same key, also with the synthesis and the fakes'
    VGG rematerialised (the recompute draws from the same keys)."""
    jstate, jnew, jstats, batch = seeded_jax_step
    state, cfg = port_state(jstate, False, remat_synthesis=remat, remat_lpips=remat)
    _, stats = T.make_train_step(cfg)(state, torch_batch(batch), step_key(0, 0))
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), v, **TOL, err_msg=k)
    for jtree, module, root in ((jnew.params_e, state.enc, "E"),
                                (jnew.state_e, state.enc, "E_state"),
                                (jnew.params_g, state.g, "G"), (jnew.params_d, state.disc, "D")):
        params = {n.replace(".", "/"): p for n, p in module.named_parameters()}
        bufs = module_params(module)
        for k, v in flatten_tree(jtree).items():
            if k in params and params[k] in state.opt_g.state:
                assert_adam_step_matches(f"{root}/{k}", v, params[k], state.opt_g)
            else:
                np.testing.assert_allclose(bufs[k], np.asarray(v), **TOL, err_msg=f"{root}/{k}")
    ema = module_params(state.g_ema)
    for k, v in flatten_tree(jnew.params_g_ema).items():
        np.testing.assert_allclose(ema[k], np.asarray(v), **TOL, err_msg=f"G_ema/{k}")


def test_another_key_gives_another_step(seeded_jax_step):
    """The key reaches the step: the losses move with it."""
    jstate, _, jstats, batch = seeded_jax_step
    state, cfg = port_state(jstate, False)
    _, stats = T.make_train_step(cfg)(state, torch_batch(batch), prng.PRNGKey(12345))
    assert not np.isclose(float(stats["Loss/G/l1_loss"]), jstats["Loss/G/l1_loss"], rtol=1e-4)
    assert to_np(stats["Loss/G/total"]).shape == ()
