"""The port's G-NeRF train step over gloo ranks on the CPU vs the JAX
package's global-batch step on a 4-device mesh, and vs the port's world 1.

The tiny configuration of tests/test_torch_training.py at a global batch of
8 (2 rows a rank at data=4): E in train mode (its BatchNorm moments over
the 8 rows), G frozen but for its mapping, the depth D with R1, VGG-LPIPS.
The JAX step is jitted with the batch sharded over 'data' and the state
replicated, as the JAX CLI runs it, and equals the JAX step on one device.
The port runs the step at data=4 and at (data=2, rays=2), where each ray
rank renders half the rays; with rng=None against JAX, and with the step
generator against the port's world 1, so that the draws are the world-1
draws cut to each rank. Tolerance rtol 1e-4 / atol 1e-5 against JAX,
atol 1e-5 between worlds, gradients within 3e-2 of each tensor's largest;
trained weights under the Adam-flip rule (tests/_torch_ddp.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_ddp_workers as W
from _torch_ddp import (GRADS, TOL, WORLDS, assert_grads_match, assert_snapshot_matches,
                        assert_stats_match, grad_gaps, jax_snapshot)
from _torch_dist import run_ranks
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.models import Discriminator as JD
from gnerf_tpu.models import ResNeXt50Encoder as JEnc
from gnerf_tpu.parallel import make_mesh as jax_make_mesh
from gnerf_tpu.training import dataset as jds
from gnerf_tpu.training import losses as JL
from gnerf_tpu.training import train_loop as JT
from gnerf_tpu.utils.checkpoint import flatten_tree
from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator
from gnerf_tpu_torch.training import losses as L
from gnerf_tpu_torch.training.train import step_generator
from gnerf_tpu_torch.utils.checkpoint import load_jax_params
from test_torch_training import (ENC_LAYERS, TINY_D, TINY_G, JGenNoRng, smooth_photos,
                                 tiny_rendering_kwargs)

BATCH = 8
# (lr, b1, b2, eps) of each module's Adam (TrainConfig's defaults).
HYPER = {"enc": (1e-3, 0.9, 0.999, 1e-8), "g": (1e-3, 0.9, 0.999, 1e-8),
         "disc": (8e-6, 0.0, 0.999, 1e-8)}
SCENARIOS = {"dp": (4, 1, False), "dp_sp": (2, 2, False), "dp_sp_rng": (2, 2, True)}


def global_batch():
    ds = jds.SyntheticDataset(resolution=16, depth_resolution=8, size=16)
    batch = jds.collate([ds[i] for i in range(BATCH)])
    batch["condition_image"] = smooth_photos(BATCH, 64, seed=0)
    return {k: np.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's step on the 4-device mesh and on one device, the port's world 1
    (rng None and seeded) and the port's gloo runs, from one init."""
    g = JGenNoRng(**TINY_G, rendering_kwargs=tiny_rendering_kwargs())
    enc = JEnc(out_dim=32, layers=ENC_LAYERS, groups_as_dense=False)
    disc, vgg = JD(**TINY_D), JL.VGG16LPIPS(resize_to=32)
    cfg = JT.TrainConfig(batch_size=BATCH, neural_rendering_resolution=8, train_gen=False,
                         remat_synthesis=False, remat_lpips=False)
    jstate = JT.init_train_state(g, enc, disc, vgg, cfg, jax.random.PRNGKey(0))
    opt_g, opt_d = JT.make_optimizers(g, jstate.params_e, jstate.params_g, cfg)
    train_step = JT.make_train_step(g, enc, disc, vgg, opt_g, opt_d, cfg)
    batch = global_batch()

    mesh = jax_make_mesh(data=4, devices=jax.devices()[:4])
    repl = NamedSharding(mesh, P())
    data_sh = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
               for k, v in batch.items()}
    sharded = jax.jit(train_step, in_shardings=(repl, data_sh, repl),
                      out_shardings=(repl, repl))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jnew, jstats = sharded(jax.device_put(jstate, repl),
                           {k: jax.device_put(v, data_sh[k]) for k, v in jbatch.items()},
                           jax.device_put(jax.random.PRNGKey(1), repl))
    one_new, one_stats = jax.jit(train_step)(jstate, jbatch, jax.random.PRNGKey(1))

    spec = dict(g=dict(TINY_G, rendering_kwargs=tiny_rendering_kwargs()),
                enc=dict(out_dim=32, layers=ENC_LAYERS), disc=dict(TINY_D),
                vgg=dict(resize_to=32),
                cfg=dict(batch_size=BATCH, neural_rendering_resolution=8, train_gen=False))
    tg = TriPlaneGenerator(**spec["g"], device="cpu")
    load_jax_params(tg, jstate.params_g)
    te = ResNeXt50Encoder(**spec["enc"], device="cpu")
    load_jax_params(te, jstate.params_e, jstate.state_e)
    td = Discriminator(**spec["disc"], device="cpu")
    load_jax_params(td, jstate.params_d)
    tv = L.VGG16LPIPS(**spec["vgg"], device="cpu")
    load_jax_params(tv, jstate.params_vgg)
    spec["state"] = {k: m.state_dict() for k, m in
                     (("g", tg), ("enc", te), ("disc", td), ("vgg", tv))}
    path = os.path.join(tmp_path_factory.mktemp("ddp_train"), "spec.pt")
    torch.save(spec, path)

    from gnerf_tpu_torch.training import train_loop as T

    world1 = {}
    # The third run takes the batch with its rows swapped in pairs: the same
    # step up to the order of fp32 sums.
    for key, seeded, rows in ((False, False, slice(None)), (True, True, slice(None)),
                              ("swapped", False, [1, 0, 3, 2, 5, 4, 7, 6])):
        state, pcfg = W.build_gnerf(spec)
        _, stats = T.make_train_step(pcfg)(
            state, {k: torch.from_numpy(v[rows]) for k, v in batch.items()},
            step_generator(0, 0, "cpu") if seeded else None)
        world1[key] = dict(snapshot=W.state_snapshot(state), cur_nimg=state.cur_nimg,
                           stats={k: float(v) for k, v in stats.items()})
    ranks = run_ranks(W.gnerf_case, 4, path, batch, SCENARIOS, timeout=400)
    return dict(jax=jax_snap(jnew), jstats=jstats, jax_nimg=int(jnew.cur_nimg),
                jax_one=jax_snap(one_new),
                one_stats=one_stats, world1=world1, ranks=ranks)


def jax_snap(new):
    return jax_snapshot(new, {"enc": {**flatten_tree(new.params_e), **flatten_tree(new.state_e)},
                              "g": new.params_g, "disc": new.params_d,
                              "g_ema": new.params_g_ema},
                        {"opt_state_g": {"e": "enc", "g": "g"}, "opt_state_d": {None: "disc"}},
                        HYPER)


def test_jax_sharded_step_equals_one_device(runs):
    """The oracle: JAX's step with the batch sharded over 4 devices is its
    step on one device (global-batch semantics)."""
    assert_stats_match(runs["jstats"], runs["one_stats"], TOL)
    assert_grads_match(runs["jax"], runs["jax_one"])
    assert_snapshot_matches([runs["jax"]], [runs["jax_one"]], TOL)


def test_world1_gradient_noise_floor(runs):
    """What GRADS allows for: world 1 on the same rows in another order
    gives the same stats within atol 1e-5, and gradients that differ by
    more than fp32 rounding (the encoder's BatchNorm backward amplifies the
    order of the sums), yet within GRADS."""
    base, swapped = runs["world1"][False], runs["world1"]["swapped"]
    assert_stats_match(swapped["stats"], base["stats"], WORLDS)
    gaps = grad_gaps(swapped["snapshot"], base["snapshot"])
    assert 1e-6 < max(gaps.values()) <= GRADS, max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("scenario", ["dp", "dp_sp"])
def test_step_matches_jax_sharded_step(runs, scenario):
    """data=4 and (data=2, rays=2), rng=None: every stat (global means), E
    with its BN buffers, G, D and G_ema equal JAX's on the 4-device mesh;
    cur_nimg counts the global batch; every rank holds the same state."""
    ranks = runs["ranks"]
    assert all(r[scenario]["consistent"] for r in ranks)
    for r in ranks:
        assert_stats_match(r[scenario]["stats"], runs["jstats"], TOL)
        assert r[scenario]["cur_nimg"] == runs["jax_nimg"] == BATCH
    assert_grads_match(ranks[0][scenario]["snapshot"], runs["jax"])
    assert_snapshot_matches([ranks[0][scenario]["snapshot"]], [runs["jax"]], TOL)


@pytest.mark.parametrize("scenario", ["dp", "dp_sp", "dp_sp_rng"])
def test_step_matches_port_world1(runs, scenario):
    """The same steps against the port's own world-1 step on the 8 rows
    (seeded: the generator's draws for the global batch, cut to each rank's
    rows and rays): stats, the averaged gradients (Adam's first moments)
    and the state."""
    want = runs["world1"][scenario.endswith("_rng")]
    for r in runs["ranks"]:
        assert_stats_match(r[scenario]["stats"], want["stats"], WORLDS)
        assert r[scenario]["cur_nimg"] == want["cur_nimg"]
    snap = runs["ranks"][0][scenario]["snapshot"]
    assert_grads_match(snap, want["snapshot"])
    assert_snapshot_matches([snap], [want["snapshot"]], WORLDS)
