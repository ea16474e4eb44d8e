"""The port's EG3D phases over gloo ranks on the CPU vs the JAX package's
global-batch phases on a 4-device mesh, and vs the port's world 1.

The tiny G and dual D of tests/_torch_eg3d.py (mbstd group 2) at a global
batch of 8: at data=4 each rank holds 2 rows, so every minibatch-std group
(rows j and j + 4) spans two ranks, and the pose swap (probability 1 here)
rolls labels across ranks. Gmain + Dmain, Greg (with JAX's density points,
each rank taking its rows) and Dreg run at data=4 from one init; Gmain +
Dmain at (data=2, rays=2); with rng=None, as tests/_torch_eg3d.py takes
JAX's draws out of play. ADA at p = 0.5 (Gmain + Dmain, then Dreg, on
keys: each rank draws its rows of every world-1 draw) runs on 2 ranks
against the port's own world 1 (tests/test_torch_seeded_ada.py holds the
seeded ADA phases to JAX's). Tolerances and the Adam rule are
tests/_torch_ddp.py's.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_ddp_workers as W
from _torch_ddp import (TOL, WORLDS, assert_grads_match, assert_snapshot_matches,
                        assert_stats_match, jax_snapshot)
from _torch_dist import run_ranks
from _torch_eg3d import CFG, TINY_D, TINY_G, jax_density_points, jax_networks, tiny_rendering_kwargs
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.parallel import make_mesh as jax_make_mesh
from gnerf_tpu.training import dataset as jds
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu_torch.models import DualDiscriminator, TriPlaneGenerator
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

BATCH = 8
GREG_KEY, DREG_KEY = 2, 3
SCENARIOS = {"dp": (4, 1, "mgd", False, 0.0), "dp_sp": (2, 2, "m", False, 0.0)}


def global_batch():
    ds = jds.SyntheticDataset(resolution=16, depth_resolution=8, size=16)
    items = jds.collate([ds[i] for i in range(BATCH)])
    c = np.asarray(items["loss_c"], np.float32)
    return {"z": np.random.RandomState(0).randn(BATCH, 32).astype(np.float32), "c": c,
            "real_image": np.asarray(items["loss_image"], np.float32) / 127.5 - 1.0,
            "real_c": c}


def write_spec(path, jstate, cfg_overrides=None):
    spec = dict(g=dict(TINY_G, rendering_kwargs=tiny_rendering_kwargs()), disc=dict(TINY_D),
                cfg=dict(CFG, **(cfg_overrides or {})), lazy=True)
    g = TriPlaneGenerator(**spec["g"], device="meta")
    load_jax_params(g, jstate["params_g"], device="cpu")
    d = DualDiscriminator(**spec["disc"], device="meta")
    load_jax_params(d, jstate["params_d"], device="cpu")
    spec["state"] = {"g": g.state_dict(), "disc": d.state_dict()}
    torch.save(spec, path)
    return spec


def world1(spec, batch, phases, seeded, aug_p, density_points=None):
    """The port's phases in this process, on the whole batch."""
    from gnerf_tpu_torch.training import eg3d_loss as E

    state, cfg = W.build_eg3d(spec)
    steps = E.make_eg3d_phase_steps(cfg)
    local = {k: torch.from_numpy(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        if density_points is not None:
            pts = tuple(torch.from_numpy(p) for p in density_points)
            mp.setattr(E, "density_reg_points", lambda n, cfg, rng, device: pts)
        return [dict(snapshot=W.state_snapshot(state), cur_nimg=state.cur_nimg,
                     stats={k: float(v) for k, v in stats.items()})
                for stats in W.run_eg3d_phases(state, cfg, steps, local, phases, seeded, aug_p)]


def hyper(spec):
    """(lr, b1, b2, eps) of the lazy Adams, read from the port's optimizers."""
    state, _ = W.build_eg3d(spec)
    out = {}
    for module, opt in (("g", state.opt_g), ("disc", state.opt_d)):
        group = opt.param_groups[0]
        out[module] = (group["lr"], *group["betas"], group["eps"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    g, disc, jcfg = jax_networks()
    main, greg, dreg, opt_g, opt_d = JE.make_eg3d_phase_steps(g, disc, jcfg)
    state0 = JE.init_eg3d_state(g, disc, opt_g, opt_d, jax.random.PRNGKey(0))
    batch = global_batch()
    k_reg = jax.random.split(jax.random.PRNGKey(GREG_KEY))[1]
    points = tuple(np.asarray(p) for p in jax_density_points(k_reg, BATCH, jcfg))

    mesh = jax_make_mesh(data=4, devices=jax.devices()[:4])
    repl = NamedSharding(mesh, P())
    bsh = {k: NamedSharding(mesh, P("data", *([None] * (v.ndim - 1))))
           for k, v in batch.items()}
    jbatch = {k: jax.device_put(jnp.asarray(v), bsh[k]) for k, v in batch.items()}

    def sharded(fn, n_scalars=0, **kw):
        return jax.jit(functools.partial(fn, **kw),
                       in_shardings=(repl, bsh, repl) + (repl,) * n_scalars,
                       out_shardings=(repl, repl))

    def sched(nimg):
        sigma = JE.blur_sigma_schedule(nimg, jcfg)
        return sigma, JE.blur_kernel_size(sigma)

    sigma, size = sched(0)
    s1, st1 = sharded(main, 2, blur_size=size, res=8)(
        jax.device_put(state0, repl), jbatch, jax.random.PRNGKey(1), sigma, 0.0)
    one, one_stats = jax.jit(functools.partial(main, blur_size=size, res=8))(
        state0, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1), sigma, 0.0)
    s2, st2 = sharded(greg)(s1, jbatch, jax.random.PRNGKey(GREG_KEY))
    sigma2, size2 = sched(BATCH)
    s3, st3 = sharded(dreg, 2, blur_size=size2, res=8)(
        s2, jbatch, jax.random.PRNGKey(DREG_KEY), sigma2, 0.0)

    tmp = tmp_path_factory.mktemp("ddp_eg3d")
    spec = write_spec(os.path.join(tmp, "spec.pt"), state0)
    hp = hyper(spec)

    def snap(st):
        return jax_snapshot(st, {"g": st["params_g"], "disc": st["params_d"],
                                 "g_ema": st["params_g_ema"]},
                            {"opt_state_g": {None: "g"}, "opt_state_d": {None: "disc"}}, hp)

    jax_runs = [dict(snapshot=snap(s), stats={k: float(v) for k, v in st.items()},
                     cur_nimg=int(s["cur_nimg"])) for s, st in ((s1, st1), (s2, st2), (s3, st3))]
    ranks = run_ranks(W.eg3d_case, 4, os.path.join(tmp, "spec.pt"), batch, SCENARIOS, points,
                      timeout=400)
    ada_path = os.path.join(tmp, "spec_ada.pt")
    ada_spec = write_spec(ada_path, state0, dict(aug="ada"))
    return dict(jax=jax_runs, ranks=ranks,
                jax_one=dict(snapshot=snap(one), stats={k: float(v) for k, v in one_stats.items()},
                             cur_nimg=int(one["cur_nimg"])),
                world1=world1(spec, batch, "mgd", False, 0.0, points),
                ada=run_ranks(W.eg3d_case, 2, ada_path, batch,
                              {"ada": (2, 1, "md", True, 0.5)}, timeout=300),
                ada_world1=world1(ada_spec, batch, "md", True, 0.5))


def _check(results, wants, stats_tol, state_tol):
    """Each phase's stats, gradients and state, and cur_nimg; every rank
    holds the same state."""
    for r in results:
        for got, want in zip(r, wants):
            assert got["consistent"]
            assert_stats_match(got["stats"], want["stats"], stats_tol)
            assert got["cur_nimg"] == want["cur_nimg"]
    snaps = [got["snapshot"] for got in results[0]]
    for i in range(len(snaps)):
        assert_grads_match(snaps[i], wants[i]["snapshot"])
        assert_snapshot_matches(snaps[:i + 1], [w["snapshot"] for w in wants[:i + 1]],
                                state_tol, modules=("g", "g_ema", "disc"))


def test_jax_sharded_main_phase_equals_one_device(runs):
    """The oracle: JAX's Gmain + Dmain with the batch sharded over 4 devices
    is its phase on one device."""
    want, got = runs["jax_one"], runs["jax"][0]
    assert_stats_match(got["stats"], want["stats"], TOL)
    assert_grads_match(got["snapshot"], want["snapshot"])
    assert_snapshot_matches([got["snapshot"]], [want["snapshot"]], TOL,
                            modules=("g", "g_ema", "disc"))


def test_phases_at_data4_match_jax_sharded_phases(runs):
    """Gmain + Dmain, Greg and Dreg with mbstd groups and the pose swap
    across ranks: every stat, G (with w_avg), G_ema and D after each phase
    equal JAX's on the 4-device mesh; cur_nimg counts the global batch."""
    assert runs["jax"][0]["cur_nimg"] == BATCH
    _check([r["dp"] for r in runs["ranks"]], runs["jax"], TOL, TOL)


def test_main_phase_at_2x2_matches_jax_sharded_phase(runs):
    """Gmain + Dmain at (data=2, rays=2): the render split over the ray
    ranks, the rest as at data=4."""
    _check([r["dp_sp"] for r in runs["ranks"]], runs["jax"][:1], TOL, TOL)


@pytest.mark.parametrize("scenario", ["dp", "dp_sp"])
def test_phases_match_port_world1(runs, scenario):
    results = [r[scenario] for r in runs["ranks"]]
    _check(results, runs["world1"][:len(results[0])], WORLDS, WORLDS)


def test_ada_at_p05_on_two_ranks_matches_world1(runs):
    """The bgc pipe at p = 0.5 in front of every D call (R1 included), its
    draws each rank's rows of world 1's; 'Loss/signs/real', the ADA
    controller's input, is the global batch's mean on every rank."""
    results = [r["ada"] for r in runs["ada"]]
    _check(results, runs["ada_world1"], WORLDS, WORLDS)
    signs = [r[0]["stats"]["Loss/signs/real"] for r in results]
    assert signs[0] == signs[1] == pytest.approx(runs["ada_world1"][0]["stats"]
                                                 ["Loss/signs/real"], abs=1e-6)
