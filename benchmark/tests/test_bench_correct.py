"""`correct` fails where it must: a run with the timed path broken
underneath (each fault a cell can have, planted in the program), and the
control (the reference in the program's place, one precision below the
configuration's).

The planted runs go through the whole harness except its look for a card,
on the CPU at a tiny size. The controls at the cells' own sizes need the
card (`-m cuda`: `python3 -m pytest benchmark/tests -m cuda`)."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from benchmark import calibrate, harness
from benchmark import run as bench_run

from . import _tiny


def _result(cell) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench_run.run(cell, _tiny.DEVICE) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _altered_answer(monkeypatch):
    """Every frame 16 levels brighter where the service makes it."""
    from gnerf_tpu_torch.infer import server

    to_u8 = server._to_u8
    monkeypatch.setattr(server, "_to_u8", lambda image: to_u8(image + 0.125))


def _half_batch(monkeypatch):
    """A render of N cameras renders the first half and repeats it."""
    from gnerf_tpu_torch.infer.server import GNerfService

    render = GNerfService._render

    def half(self, g, planes, ws, c, rendering_kwargs=None):
        k = (c.shape[0] + 1) // 2
        out = render(self, g, planes[:k] if planes.shape[0] > 1 else planes, ws[:k], c[:k],
                     rendering_kwargs)
        return torch.cat([out, out])[:c.shape[0]]

    monkeypatch.setattr(GNerfService, "_render", half)


def _train_fault(monkeypatch, kind):
    from gnerf_tpu_torch.training import train_loop

    make = train_loop.make_train_step

    def broken(cfg, *args, **kwargs):
        inner = make(cfg, *args, **kwargs)

        def step(state, batch, rng=None):
            if kind == "half_batch":  # half of the rows left out, the means over the rest
                n = batch["condition_image"].shape[0] // 2
                return inner(state, {k: v[:n] for k, v in batch.items()}, rng)
            params = [p for m in (state.enc, state.disc) for p in m.parameters()]
            if kind == "batchnorm_frozen":  # E's BatchNorm scales and biases never move
                params = [p for k, p in state.enc.named_parameters() if "bn" in k.split(".")[-2:][0]]
            saved = [p.detach().clone() for p in params]
            out = inner(state, batch, rng)
            with torch.no_grad():  # the state comes back unchanged
                for p, v in zip(params, saved):
                    p.copy_(v)
            return out

        return step

    monkeypatch.setattr(train_loop, "make_train_step", broken)


@pytest.mark.parametrize("workload,fault", [
    ("orbit-ffhq512", "sound"),
    ("orbit-ffhq512", "altered_answer"),
    ("orbit-ffhq512", "half_batch"),
    ("encode-ffhq512", "altered_answer"),
    ("train-gnerf-ffhq512", "state_unchanged"),
    ("train-gnerf-ffhq512", "half_batch"),
    ("train-gnerf-ffhq512", "batchnorm_frozen"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    cell = _tiny.cell(workload, seconds=1.0)
    cell.traffic.update(frames=4)
    if workload.startswith("train"):
        _train_fault(monkeypatch, fault)
    elif fault == "altered_answer":
        _altered_answer(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch)
    result = _result(cell)
    assert result["correct"] is (fault == "sound"), result["checks"]
    if fault == "batchnorm_frozen":  # the short leaves' own number catches it
        checks = result["checks"]
        assert checks["update_gap"]["value"] <= checks["update_gap"]["limit"], checks
        assert checks["update_gap_short"]["value"] > 0.5, checks


@pytest.mark.parametrize("workload", ["orbit-ffhq512", "encode-ffhq512"])
def test_fp8_control_fails_at_a_tiny_size(workload):
    """The inference control on the CPU: the bf16 parts in float8 e4m3."""
    cell = _tiny.cell(workload, seconds=1.0)
    cell.traffic.update(frames=4)
    r = calibrate.readings(workload, 2 ** 31 + 3, 1.0, device="cpu", cell=cell)
    limits = cell.config["limits"]
    assert r["lower"] <= limits["frame_mad"] and r["lower_max_gap"] <= limits["frame_max_gap"], r
    assert r["upper"] > limits["frame_mad"] or r["upper_max_gap"] > limits["frame_max_gap"], r


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["orbit-ffhq512", "encode-ffhq512"])
def test_control_fails_at_the_cell_size(workload):
    _card()
    cell = _tiny.load(workload)
    limits = cell.config["limits"]
    for seed in (11, 2 ** 31 + 12, 13):
        r = calibrate.readings(workload, seed, 3.0, cell=cell)
        assert r["lower"] <= limits["frame_mad"] and r["lower_max_gap"] <= limits["frame_max_gap"]
        assert r["upper"] > limits["frame_mad"] or r["upper_max_gap"] > limits["frame_max_gap"], r


@pytest.mark.cuda
def test_training_control_and_fault_fail_at_the_cell_size():
    _card()
    workload = "train-gnerf-ffhq512"
    limits = harness.load_cell(workload).config["limits"]
    for seed in (21, 2 ** 31 + 22, 23):
        r = calibrate.readings(workload, seed, 0.0)
        assert all(r["lower"][k] <= v for k, v in limits.items()), r
        for planted in ("control", "half_batch"):
            assert any(r[planted][k] > v for k, v in limits.items()), r
