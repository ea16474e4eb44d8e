"""The port's training CLI (gnerf_tpu_torch.training.train) vs the JAX one:
the options a dry run records, a one-step CPU run that writes the JAX
run-directory layout and resumes from it, and the options that are not
ported raising instead of falling back."""

import json
import os

import numpy as np
import pytest

from _torch_port import one_torch_thread  # noqa: F401


def _printed_options(text):
    lines = text.splitlines()
    start = lines.index("{")
    end = start + lines[start:].index("}")
    return json.loads("\n".join(lines[start:end + 1]))


def test_dry_run_options_match_jax(tmp_path, capsys):
    """Equal to the JAX CLI's options except `num_devices` (the JAX CPU
    backend here has 8 virtual devices) and the rematerialisation defaults,
    which the port chose by measuring on the H100 (PERF.md)."""
    from gnerf_tpu.training.train import run_training as jax_run
    from gnerf_tpu_torch.training.train import run_training

    kw = dict(outdir=str(tmp_path), dataset_name="synthetic", preset="ffhq", batch=4, kimg=1,
              tick=1, dry_run=True)
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
    (dict(objective="eg3d"), NotImplementedError, "Queue 1 item 11"),
    (dict(chain=2), ValueError, "--chain"),
    (dict(ray_shards=2), ValueError, "item 14"),
])
def test_unported_options_raise(tmp_path, kw, exc, match):
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
    monkeypatch.setattr(losses, "VGG16LPIPS", shrink(losses.VGG16LPIPS, resize_to=32))


def test_one_step_run_writes_run_directory_and_resumes(tmp_path, tiny_networks):
    from gnerf_tpu.utils import checkpoint as jckpt
    from gnerf_tpu_torch.training.train import run_training
    from gnerf_tpu_torch.utils.checkpoint import load_checkpoint

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
    trees2, _ = load_checkpoint(os.path.join(run2, "training-state-latest.npz"))
    assert int(trees2["train_state_torch"]["cur_nimg"]) == 4
    with open(os.path.join(run2, "log.txt")) as fh:
        assert "Resumed from" in fh.read()
