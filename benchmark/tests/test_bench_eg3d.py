"""The EG3D training cell on the CPU at a tiny size: the program's loop
step (`eg3d_loop_step`, the CLI's own) against the frozen reference
(`reference/eg3d_train.py`), step 0 running all four phases, and each
planted fault of the program turning `correct` false.

The tiny cell keeps the 8XDC superresolution at its widths (the reference
has no smaller form), so each case takes tens of seconds."""

import pytest
import torch

from benchmark import harness

from . import _tiny


def eg3d_cell(batch=2, checked_steps=3, start_kimg=2000):
    c = harness.load_cell("train-eg3d-ffhq512")
    c.config["generator"].update(plane_resolution=32, channel_base=1024, channel_max=64,
                                 depth_resolution=4, depth_resolution_importance=4)
    c.config["rendering_kwargs"].update(depth_resolution=4, depth_resolution_importance=4)
    c.config["discriminator"].update(channel_base=8192, channel_max=16)
    c.traffic.update(batch=batch, checked_steps=checked_steps, warmup_steps=0, dataset_size=16,
                     start_kimg=start_kimg)
    c.seed, c.device = 2 ** 31 + 7, "cpu"
    return c


def checks(cell) -> dict:
    """The cell's checks after its checked steps (no window)."""
    drv = harness.driver(cell.traffic["kind"]).Driver(cell, lambda msg: None)
    drv.setup()
    drv.release()
    return {name: (value, limit) for name, value, limit in drv.check()}


def _plant(monkeypatch, fault):
    from gnerf_tpu_torch.models import dual_discriminator
    from gnerf_tpu_torch.training import eg3d_loss

    if fault == "r1_left_out":
        r1 = eg3d_loss._r1
        monkeypatch.setattr(eg3d_loss, "_r1", lambda *a, **k: r1(*a, **k) * 0.0)
    elif fault == "greg_skipped":
        make = eg3d_loss.make_eg3d_phase_steps
        monkeypatch.setattr(eg3d_loss, "make_eg3d_phase_steps",
                            lambda *a, **k: (lambda m, g, d: (m, None, d))(*make(*a, **k)))
    elif fault == "raw_dropped":
        resized = dual_discriminator._resized_raw
        monkeypatch.setattr(dual_discriminator, "_resized_raw",
                            lambda img, mode: resized(img, mode) * 0.0)
    elif fault == "ema_not_applied":
        monkeypatch.setattr(eg3d_loss, "ema_update", lambda *a, **k: None)
    elif fault == "lr_not_lazy":
        make = eg3d_loss._make_adam
        monkeypatch.setattr(eg3d_loss, "_make_adam", lambda params, lr, reg_interval=0:
                            make(params, lr))


def test_the_loop_step_matches_the_reference():
    got = checks(eg3d_cell())
    assert all(value <= limit for value, limit in got.values()), got
    assert got["loss_gap"][0] < 1e-4 and got["grad_gap"][0] < 1e-3, got


def test_blur_and_pose_swap_fade_match_the_reference():
    """From kimg 0: the blur on D's input (sigma 10) and the certain pose swap."""
    got = checks(eg3d_cell(checked_steps=1, start_kimg=0))
    assert all(value <= limit for value, limit in got.values()), got


@pytest.mark.parametrize("fault", ["r1_left_out", "greg_skipped", "raw_dropped",
                                   "ema_not_applied", "lr_not_lazy"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    got = checks(eg3d_cell(batch=1, checked_steps=1))
    assert any(value > limit for value, limit in got.values()), got
