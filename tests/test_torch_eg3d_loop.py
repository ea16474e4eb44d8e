"""`train.eg3d_loop_step`: the EG3D loop's step as a function of the port,
the one the CLI's loop takes its steps through. A caller that builds the
CLI's trainer and feed from the package's own pieces and steps through it
reaches the CLI's state; the EG3D phases and the gradient all-reduce open
their spans (`utils.profiling`).

Port only, no JAX: the CLI's networks at tiny widths (the fixture of
tests/test_torch_train_cli.py), the synthetic preset, batch 2 on the CPU.
"""

import copy

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from _torch_port import one_torch_thread  # noqa: F401
from _torch_state import saved_state
from gnerf_tpu_torch.training import train
from gnerf_tpu_torch.training.eg3d_loss import (AdaController, init_eg3d_state,
                                                make_eg3d_phase_steps)
from gnerf_tpu_torch.training.train_loop import TrainConfig
from gnerf_tpu_torch.utils import profiling
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

SEED, BATCH = 3, 2
EG3D_SPANS = {"eg3d.gmain", "eg3d.dmain", "eg3d.greg", "eg3d.dreg", "eg3d.optimizer",
              "eg3d.ema", "disc"}


def _tiny_networks(mp):
    """The CLI's EG3D networks at tiny widths (depth and widths only), and
    4 + 4 samples a ray in its synthetic preset."""
    import gnerf_tpu_torch.models as models

    def shrink(cls, **small):
        return lambda *a, **kw: cls(*a, **{**kw, **small})

    mp.setitem(train.RENDERING_PRESETS, "synthetic", dict(
        train.RENDERING_PRESETS["synthetic"], depth_resolution=4, depth_resolution_importance=4))
    mp.setattr(models, "TriPlaneGenerator", shrink(
        models.TriPlaneGenerator, plane_resolution=16, channel_base=512, channel_max=32))
    mp.setattr(models, "DualDiscriminator", shrink(
        models.DualDiscriminator, channel_base=256, channel_max=32))


def _networks(draw=True):
    """(G, D, the loss configuration) of the CLI's run at the tiny widths:
    the synthetic preset's rendering kwargs, --batch 2, --seed 3."""
    rk = train._rendering_kwargs(train.RENDERING_PRESETS["synthetic"], False, 1.0, "none",
                                 0.25, 1.0, "")
    g, disc = train.eg3d_networks(SEED, 32, 32, 128, rk, device="cpu", draw=draw)
    cfg = TrainConfig(batch_size=BATCH, random_seed=SEED)
    return g, disc, train.eg3d_loss_config(rk, cfg, g.neural_rendering_resolution)


def _host_profile():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory, one_torch_thread):
    """The CLI's two-step run (its saved state), and two steps through
    `eg3d_loop_step` of a trainer and feed built from the package's pieces
    (step 0, which runs all four phases, under a host profile)."""
    with pytest.MonkeyPatch.context() as mp:
        _tiny_networks(mp)
        mp.setattr(train, "_tb_writer", lambda run_dir: None)  # no TensorBoard import
        run = train.run_training(outdir=str(tmp_path_factory.mktemp("eg3d")), objective="eg3d",
                                 dataset_name="synthetic", batch=BATCH, kimg=0.004, tick=0.004,
                                 snap=0, seed=SEED, z_dim=32, w_dim=32, device="cpu")
        g, disc, lcfg = _networks()
        state = init_eg3d_state(g, disc, lcfg, lazy=True)
        batches = train._shard_batches(train._dataset("synthetic", "", "", 128), BATCH,
                                       SEED + state.cur_nimg, None)
        phases, ada, aug_p = make_eg3d_phase_steps(lcfg), AdaController(lcfg, BATCH, 0.0), 0.0
        profiling.take()
        with _host_profile() as prof:
            stats, aug_p = train.eg3d_loop_step(state, phases, lcfg, next(batches), SEED, aug_p,
                                                ada, batch=BATCH, device="cpu")
        spans = profiling.take()
        stats, aug_p = train.eg3d_loop_step(state, phases, lcfg, next(batches), SEED, aug_p,
                                            ada, batch=BATCH, device="cpu")
        want, _ = saved_state(run, "eg3d")
        templates = _networks(draw=False)[:2]
    return {"state": state, "stats": stats, "want": want, "templates": templates,
            "events": {e.name for e in prof.events()}, "spans": spans}


def test_loop_step_reaches_the_cli_state(two_steps):
    """Two steps (the first with Greg and Dreg) through `eg3d_loop_step`
    leave G, G_ema and D where the CLI's two-step run leaves them."""
    state, want = two_steps["state"], two_steps["want"]
    assert state.cur_nimg == 2 * BATCH and "Loss/D/total" in two_steps["stats"]
    g, disc = two_steps["templates"]
    for name, module, template in (("g", state.g, g), ("g_ema", state.g_ema, copy.deepcopy(g)),
                                   ("disc", state.disc, disc)):
        load_jax_params(template, want[name], device="cpu")
        got, exp = module.state_dict(), template.state_dict()
        assert got.keys() == exp.keys()
        for k in got:
            torch.testing.assert_close(got[k], exp[k], rtol=0, atol=0, msg=f"{name}.{k}")


def test_eg3d_phases_open_their_spans(two_steps):
    """Step 0 runs all four phases: each opens `gnerf.eg3d.<phase>`, in
    order, Adam and the EMA theirs, the dual D `gnerf.disc`."""
    names = two_steps["events"]
    assert {profiling.PREFIX + s for s in EG3D_SPANS} <= names, sorted(names)
    by_name = {name: (start, end) for name, _, start, end in two_steps["spans"]
               if name.startswith("eg3d.")}
    assert EG3D_SPANS - {"disc"} <= set(by_name)
    order = [by_name[f"eg3d.{p}"] for p in ("gmain", "dmain", "greg", "dreg")]
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:])), order


def test_gradient_allreduce_opens_its_span():
    """`pmean_grads` over a group opens `gnerf.ddp.allreduce` (a world-1
    gloo group here) and leaves the mean unchanged; without a group it
    opens none."""
    from gnerf_tpu_torch.parallel import pmean_grads

    grads = [torch.arange(3.0), torch.ones(2, 2)]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with _host_profile() as prof:
            out = pmean_grads(grads, dist.group.WORLD)
        names = [e.name for e in prof.events()]
        assert names.count(profiling.PREFIX + "ddp.allreduce") == 1
        for a, b in zip(out, grads):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
    with _host_profile() as prof:
        pmean_grads(grads, None)
    assert profiling.PREFIX + "ddp.allreduce" not in {e.name for e in prof.events()}
