"""The port's training CLI (gnerf_tpu_torch.training.train) vs the JAX one:
the options a dry run records, one-step CPU runs of both objectives that
write the JAX run-directory layout and resume from it, an EG3D run under
`--aug ada` that resumes with its live p bit for bit, and the options that
are not ported raising instead of falling back."""

import json
import os

import numpy as np
import pytest

from _torch_port import ENC_UNIFORM, assert_init_matches, one_torch_thread  # noqa: F401
from _torch_state import saved_state


def _printed_options(text):
    lines = text.splitlines()
    start = lines.index("{")
    end = start + lines[start:].index("}")
    return json.loads("\n".join(lines[start:end + 1]))


def test_dry_run_options_match_jax(tmp_path, capsys):
    """Equal to the JAX CLI's options except `num_devices` (the JAX CPU
    backend here has 8 virtual devices) and the rematerialisation defaults,
    which the port chose by measuring on the H100 (PERF.md)."""
    _check_dry_run_options(tmp_path, capsys)


def test_dry_run_options_match_jax_eg3d(tmp_path, capsys):
    """--objective eg3d records the same options in both CLIs (the JAX CLI
    prints its G-NeRF TrainConfig for both objectives; the port does too)."""
    _check_dry_run_options(tmp_path, capsys, objective="eg3d", freezed=2,
                           density_reg_every=8, d_reg_interval=4, style_mixing_prob=0.5)


@pytest.mark.parametrize("aug", ["ada", "fixed"])
def test_dry_run_options_match_jax_eg3d_aug(tmp_path, capsys, aug):
    """--objective eg3d --aug ada|fixed records the JAX CLI's options."""
    _check_dry_run_options(tmp_path, capsys, objective="eg3d", aug=aug, aug_p=0.2,
                           ada_target=0.7, ada_kimg=100.0)


def _check_dry_run_options(tmp_path, capsys, **extra):
    from gnerf_tpu.training.train import run_training as jax_run
    from gnerf_tpu_torch.training.train import run_training

    kw = dict(outdir=str(tmp_path), dataset_name="synthetic", preset="ffhq", batch=4, kimg=1,
              tick=1, dry_run=True, **extra)
    assert jax_run(**kw) is None
    want = _printed_options(capsys.readouterr().out)
    assert run_training(**kw, device="cpu") is None
    got = _printed_options(capsys.readouterr().out)
    assert got.pop("num_devices") == 1 and want.pop("num_devices") >= 1
    for k in ("remat_synthesis", "remat_lpips"):
        assert got["config"].pop(k) is False and want["config"].pop(k) is True
    assert got == want
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(chain=2), ValueError, "--chain"),
    (dict(ray_shards=2), ValueError, "--ray_shards 2 must divide device count 1"),
])
def test_unported_options_raise(tmp_path, kw, exc, match):
    """--chain > 1 is not ported; --ray_shards that does not divide the
    world (here one process) raises with the JAX CLI's message."""
    from gnerf_tpu_torch.training.train import run_training

    with pytest.raises(exc, match=match):
        run_training(outdir=str(tmp_path), dry_run=True, device="cpu", **kw)


@pytest.fixture
def tiny_networks(monkeypatch):
    """The CLI's networks at the tests' tiny widths (depth and widths only;
    the preset, the dataset and the loop are the CLI's own)."""
    import gnerf_tpu_torch.models as models
    from gnerf_tpu_torch.training import losses

    def shrink(cls, **small):
        return lambda *a, **kw: cls(*a, **{**kw, **small})

    monkeypatch.setattr(models, "TriPlaneGenerator", shrink(
        models.TriPlaneGenerator, plane_resolution=16, channel_base=512, channel_max=32))
    monkeypatch.setattr(models, "ResNeXt50Encoder", shrink(
        models.ResNeXt50Encoder, layers=(1, 1, 1, 1)))
    monkeypatch.setattr(models, "Discriminator", shrink(
        models.Discriminator, channel_base=256, channel_max=32))
    monkeypatch.setattr(models, "DualDiscriminator", shrink(
        models.DualDiscriminator, channel_base=256, channel_max=32))
    monkeypatch.setattr(losses, "VGG16LPIPS", shrink(losses.VGG16LPIPS, resize_to=32))


@pytest.mark.parametrize("objective", ["gnerf", "eg3d"])
def test_cli_networks_match_jax_init_state(tiny_networks, objective):
    """The CLI's networks from --seed are the JAX CLI's: G-NeRF's E, G, D
    and random VGG from `init_train_state(..., PRNGKey(seed))`, EG3D's G and
    dual D from `init_eg3d_state(..., PRNGKey(seed))`, at the tiny widths."""
    import optax

    import jax
    from gnerf_tpu.models import Discriminator as JD
    from gnerf_tpu.models import DualDiscriminator as JDD
    from gnerf_tpu.models import ResNeXt50Encoder as JEnc
    from gnerf_tpu.models import TriPlaneGenerator as JGen
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS
    from gnerf_tpu.training import VGG16LPIPS as JVGG
    from gnerf_tpu.training.eg3d_loss import init_eg3d_state as jinit_eg3d
    from gnerf_tpu.training.train_loop import TrainConfig as JCfg
    from gnerf_tpu.training.train_loop import init_train_state as jinit
    from gnerf_tpu_torch.training import train
    from gnerf_tpu_torch.training.train_loop import TrainConfig
    from gnerf_tpu_torch.utils.checkpoint import flatten_tree

    seed, rk = 3, dict(DEFAULT_RENDERING_KWARGS)
    jg = JGen(z_dim=32, w_dim=32, rendering_kwargs=rk, plane_resolution=16, channel_base=512,
              channel_max=32)
    if objective == "gnerf":
        cfg = TrainConfig(neural_rendering_resolution=32)
        g, enc, disc, vgg, pretrained = train.gnerf_networks(seed, cfg, 32, 32, 512, rk,
                                                             device="cpu")
        want = jinit(jg, JEnc(out_dim=32, layers=(1, 1, 1, 1)),
                     JD(c_dim=25, img_resolution=32, img_channels=1, channel_base=256,
                        channel_max=32),
                     JVGG(resize_to=32), JCfg(neural_rendering_resolution=32),
                     jax.random.PRNGKey(seed))
        assert not pretrained
        assert_init_matches(enc, {**flatten_tree(want.params_e), **flatten_tree(want.state_e)},
                            uniform=ENC_UNIFORM)
        assert_init_matches(vgg, want.params_vgg)
        pairs = [(g, want.params_g), (disc, want.params_d)]
    else:
        g, disc = train.eg3d_networks(seed, 32, 32, 512, rk, device="cpu")
        want = jinit_eg3d(jg, JDD(c_dim=25, img_resolution=512, img_channels=3,
                                  channel_base=256, channel_max=32),
                          optax.adam(1e-3), optax.adam(1e-3), jax.random.PRNGKey(seed))
        pairs = [(g, want["params_g"]), (disc, want["params_d"])]
    for module, tree in pairs:
        assert_init_matches(module, tree)


def test_one_step_run_writes_run_directory_and_resumes(tmp_path, tiny_networks):
    from gnerf_tpu.utils import checkpoint as jckpt
    from gnerf_tpu_torch.training.train import run_training

    kw = dict(dataset_name="synthetic", batch=2, tick=0.002, snap=1, z_dim=32, w_dim=32,
              device="cpu")
    run = run_training(outdir=str(tmp_path / "a"), kimg=0.002, **kw)
    names = set(os.listdir(run))
    assert {"training_options.json", "log.txt", "stats.jsonl", "id_images.png",
            "fakes-000000.png", "network-snapshot-best.npz", "network-snapshot-latest.npz",
            "network-snapshot-000000.npz", "network-snapshot-final.npz",
            "training-state-latest.npz"} <= names
    with open(os.path.join(run, "stats.jsonl")) as fh:
        stats = [json.loads(line) for line in fh]
    assert len(stats) == 1 and stats[0]["kimg"] == 0.002
    assert np.isfinite(stats[0]["Loss/G/total"]["mean"]) and "Metrics/val_ssim" in stats[0]
    assert "Metrics/val_lpips" not in stats[0]  # random VGG: no perceptual curve
    with open(os.path.join(run, "log.txt")) as fh:
        assert "tick 1" in fh.read()
    trees, config = jckpt.load_checkpoint(os.path.join(run, "network-snapshot-final.npz"))
    assert set(trees) == {"G_ema", "G", "E", "E_state", "D"}
    assert config["config"]["batch_size"] == 2

    state_path = os.path.join(run, "training-state-latest.npz")
    run2 = run_training(outdir=str(tmp_path / "b"), kimg=0.004, resume=state_path, **kw)
    state2, config2 = saved_state(run2)
    assert int(state2["cur_nimg"]) == 4 and "best_ssim" in config2
    with open(os.path.join(run2, "log.txt")) as fh:
        assert "Resumed from" in fh.read()


def test_eg3d_one_step_run_writes_run_directory_and_resumes(tmp_path, tiny_networks):
    """One EG3D step (Gmain + Dmain, Greg and Dreg: sched_idx 0) writes the
    JAX EG3D layout; its final snapshot loads in the JAX package, whose dual
    D gives the port's D logits; --resume continues from the full state."""
    import jax.numpy as jnp
    import torch

    from gnerf_tpu.models.dual_discriminator import DualDiscriminator as JDual
    from gnerf_tpu.utils import checkpoint as jckpt
    from gnerf_tpu_torch.models import DualDiscriminator
    from gnerf_tpu_torch.training.train import run_training
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params

    kw = dict(objective="eg3d", dataset_name="synthetic", batch=2, tick=0.002, snap=1,
              z_dim=32, w_dim=32, device="cpu")
    run = run_training(outdir=str(tmp_path / "a"), kimg=0.002, **kw)
    assert {"training_options.json", "log.txt", "stats.jsonl", "network-snapshot-latest.npz",
            "network-snapshot-000000.npz", "network-snapshot-final.npz",
            "training-state-latest.npz"} <= set(os.listdir(run))
    with open(os.path.join(run, "stats.jsonl")) as fh:
        stats = [json.loads(line) for line in fh]
    assert len(stats) == 1 and stats[0]["kimg"] == 0.002
    for k in ("Loss/G/total", "Loss/D/total", "Loss/G/density_reg", "Loss/D/reg",
              "Loss/scores/fake", "Loss/signs/real", "Progress/augment"):
        assert np.isfinite(stats[0][k]["mean"]), k
    with open(os.path.join(run, "log.txt")) as fh:
        assert "tick 1" in fh.read()

    trees, config = jckpt.load_checkpoint(os.path.join(run, "network-snapshot-final.npz"))
    assert set(trees) == {"G_ema", "G", "D"} and config["config"]["batch_size"] == 2
    state_trees, state_cfg = saved_state(run, "eg3d")
    assert state_cfg["aug_p_live"] == 0.0
    d_kw = dict(c_dim=25, img_resolution=128, img_channels=3, channel_base=256, channel_max=32)
    d = DualDiscriminator(**d_kw, device="meta")
    load_jax_params(d, state_trees["disc"], device="cpu")
    rs = np.random.RandomState(0)
    img = {"image": rs.randn(2, 3, 128, 128).astype(np.float32),
           "image_raw": rs.randn(2, 3, 64, 64).astype(np.float32)}
    c = rs.randn(2, 25).astype(np.float32)
    want = JDual(**d_kw).apply(trees["D"], {k: jnp.asarray(v) for k, v in img.items()},
                               jnp.asarray(c))
    got = d.apply({k: torch.from_numpy(v) for k, v in img.items()}, torch.from_numpy(c))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    run2 = run_training(outdir=str(tmp_path / "b"), kimg=0.004,
                        resume=os.path.join(run, "training-state-latest.npz"), **kw)
    assert int(saved_state(run2, "eg3d")[0]["cur_nimg"]) == 4
    with open(os.path.join(run2, "log.txt")) as fh:
        assert "Resumed EG3D training state" in fh.read()


def test_eg3d_ada_run_resumes_its_live_p_bit_for_bit(tmp_path, tiny_networks, monkeypatch):
    """--aug ada at tiny widths: one step, then --resume for a second, ends
    bit for bit where two uninterrupted steps end (every module, both Adam
    states, the live p). The controller runs every step here
    (ada_interval 1) and the dataset has one item, so the resumed run's
    reseeded data order and its fresh r_t window change nothing."""
    import dataclasses

    from gnerf_tpu_torch.training import dataset, train
    from gnerf_tpu_torch.utils.checkpoint import flatten_tree

    config = train.eg3d_loss_config
    monkeypatch.setattr(train, "eg3d_loss_config", lambda *a, **k: dataclasses.replace(
        config(*a, **k), ada_interval=1))
    synthetic = dataset.SyntheticDataset
    monkeypatch.setattr(dataset, "SyntheticDataset", lambda **k: synthetic(**k, size=1))
    kw = dict(objective="eg3d", aug="ada", aug_p=0.2, ada_kimg=0.1, dataset_name="synthetic",
              batch=2, tick=0.002, snap=10, z_dim=32, w_dim=32, device="cpu")

    def final_state(run):
        named, cfg = saved_state(run, "eg3d")
        return flatten_tree(named), cfg["aug_p_live"]

    once = train.run_training(outdir=str(tmp_path / "once"), kimg=0.004, **kw)
    first = train.run_training(outdir=str(tmp_path / "a"), kimg=0.002, **kw)
    _, p_first = final_state(first)
    assert p_first != 0.2
    with open(os.path.join(first, "stats.jsonl")) as fh:
        assert json.loads(fh.readline())["Progress/augment"]["mean"] == pytest.approx(0.2)
    resumed = train.run_training(outdir=str(tmp_path / "b"), kimg=0.004,
                                 resume=os.path.join(first, "training-state-latest.npz"), **kw)
    with open(os.path.join(resumed, "stats.jsonl")) as fh:
        assert json.loads(fh.readline())["Progress/augment"]["mean"] == pytest.approx(p_first)
    (want, p_want), (got, p_got) = final_state(once), final_state(resumed)
    assert p_got == p_want != p_first
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert v.dtype == got[k].dtype and np.array_equal(v, got[k]), k
