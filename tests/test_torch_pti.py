"""The port's PTI step (gnerf_tpu_torch.training.pti) vs the JAX package's.

From the same G, VGG, pivot ws and a two-image coaching batch, one
`make_pti_step` (LPIPS + L1) and one with the locality regularizer (its z
drawn by each package from the same step key) give the JAX losses at rtol 1e-4 / atol 1e-5 and the JAX weights under the Adam-flip
rule (tests/_torch_eg3d.py): the SR module stays bitwise, every other G
weight moves as in JAX. The locality case starts from a tuned G whose
decoder differs from the original's: with the two equal (a first step) the
regularizer is 0 and its gradient is rounding noise, which decides the
sign of Adam's first step wherever the main term's gradient is small."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_eg3d import AdamLog, assert_adam_steps_match
from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from _torch_pti import assert_g_matches, jax_setup, pivot_ws, port_networks, tiny_targets
from gnerf_tpu.training import pti as JP
from gnerf_tpu_torch.training import pti as P
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

STEP_KEY = 10


def test_morphed_w_code_matches_jax():
    rs = np.random.RandomState(0)
    new, fixed = rs.randn(1, 5, 8).astype(np.float32), rs.randn(2, 5, 8).astype(np.float32)
    want = JP.morphed_w_code(jnp.asarray(new), jnp.asarray(fixed), 3.0)
    got = P.morphed_w_code(t(new), t(fixed), 3.0)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(to_np(got) - fixed), 3.0, rtol=1e-5)


@pytest.mark.parametrize("locality", [False, True])
def test_pti_step_matches_jax(locality):
    g, params_g, vgg, params_vgg = jax_setup()
    loss_image, loss_c = tiny_targets()
    ws = pivot_ws(g, params_g)
    kw = dict(lr=1e-3, neural_rendering_resolution=8)
    kw.update(use_locality_reg=True) if locality else kw.update(l1_lambda=1.0)
    jcfg = JP.PTIConfig(**kw)
    jstate = JP.init_pti_state(g, params_g, vgg, params_vgg, jcfg)
    if locality:
        rs = np.random.RandomState(4)
        decoder = jax.tree_util.tree_map(
            lambda x: x + 0.05 * rs.randn(*x.shape).astype(np.float32), params_g["decoder"])
        jstate = dict(jstate, params_g=dict(jstate["params_g"], decoder=decoder))
    step = jax.jit(JP.make_pti_step(g, vgg, jcfg, JP.make_optimizer(params_g, jcfg)))
    batch = {"ws": ws, "loss_image": loss_image, "loss_c": loss_c}
    key = jax.random.PRNGKey(STEP_KEY)
    jnew, jstats = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    tg, tvgg = port_networks(params_g, params_vgg)
    state = P.init_pti_state(tg, tvgg, P.PTIConfig(**kw))
    if locality:
        load_jax_params(state.g.decoder, decoder)
    _, stats = P.make_pti_step(P.PTIConfig(**kw))(
        state, {k: t(v) for k, v in batch.items()}, prng.PRNGKey(STEP_KEY))

    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)
    log = AdamLog(state)
    log.record("opt")
    assert_g_matches(jnew["params_g"], state.g,
                     lambda k, v, p: assert_adam_steps_match(k, v, p, log))
    sr_before = {k: v.clone() for k, v in tg.superresolution.state_dict().items()}
    for k, v in state.g.superresolution.state_dict().items():
        assert torch.equal(v, sr_before[k]), k
    moved = [not torch.equal(p, q) for (n, p), q in
             zip(state.g.named_parameters(), tg.parameters()) if not n.startswith("superres")]
    assert sum(moved) > len(moved) // 2


def test_run_pti_matches_jax_from_seed():
    """`run_pti` from a seed with the locality regularizer: each step's key
    split from PRNGKey(seed) and its z drawn from it in both packages; the
    per-step losses within rtol 1e-4 / atol 1e-5."""
    g, params_g, vgg, params_vgg = jax_setup()
    loss_image, loss_c = tiny_targets()
    ws = pivot_ws(g, params_g)
    kw = dict(lr=1e-3, neural_rendering_resolution=8, use_locality_reg=True,
              latent_ball_num_of_samples=2)
    _, want = JP.run_pti(g, params_g, vgg, params_vgg, jnp.asarray(ws), jnp.asarray(loss_image),
                         jnp.asarray(loss_c), num_steps=3, cfg=JP.PTIConfig(**kw),
                         rng=jax.random.PRNGKey(5))
    tg, tvgg = port_networks(params_g, params_vgg)
    _, got = P.run_pti(tg, tvgg, t(ws), t(loss_image), t(loss_c), num_steps=3,
                       cfg=P.PTIConfig(**kw), seed=5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
