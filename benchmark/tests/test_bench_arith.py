"""The yardstick's arithmetic: tails with missing requests, rates over the
whole window, idle time as an interval union, the decoder's bytes."""

import json
import time

import numpy as np
import pytest

from benchmark import harness, readers, roofline, trace
from benchmark.drivers import open_loop, orbit


def test_percentile_is_nearest_rank():
    assert harness.percentile(range(1, 101), 0.95) == 95
    assert harness.percentile([3.0], 0.95) == 3.0
    assert harness.percentile([5, 1, 4, 2, 3], 0.5) == 3


def test_p95_counts_missing_requests_as_slowest():
    served = [0.010] * 94
    missing = [30.0] * 6  # 6 % refused or never back: the p95 is a missing one
    assert harness.latency_p95_ms(served, missing) == pytest.approx(30000.0)
    assert harness.latency_p95_ms(served + [0.010], [30.0] * 5) == pytest.approx(10.0)


def test_interval_union_and_idle_share():
    busy, merged = trace._union([(0, 2), (1, 3), (5, 6), (5.5, 5.6), (8, 9)])
    assert busy == pytest.approx(5.0)
    assert merged == [[0, 3], [5, 6], [8, 9]]
    tr = trace.Trace(window_s=10.0, busy_s=5.0)
    assert readers.device_idle_pct({"trace": tr}) == pytest.approx(50.0)
    assert readers.device_idle_pct({"trace": trace.Trace(window_s=10.0, busy_s=0.0)}) is None


def test_decoder_bytes_by_hand():
    n, m, c, h, d = 1, 15 * 64 * 64 * 96, 32, 64, 33
    by_hand = 3 * m * c * 2 + c * h * 2 + (h + h * d + d) * 4 + m * d * 4
    assert roofline.decoder_bytes(n, m, c, h, d, bf16=True) == by_hand
    # The bound chip_smoke.py states for the orbit chunk: 0.5705 ms.
    assert roofline.decoder_bound_s(n, m, c, h, d, True) * 1e3 == pytest.approx(0.5705, abs=1e-4)
    fp32 = 4 * 3 * 196608 * 32 * 4 + 32 * 64 * 4 + (64 + 64 * 33 + 33) * 4 + 4 * 196608 * 33 * 4
    assert roofline.decoder_bytes(4, 196608, 32, 64, 33, bf16=False) == fp32
    # ... and for the training pass: 0.1211 ms.
    assert roofline.decoder_bound_s(4, 196608, 32, 64, 33, False) * 1e3 == pytest.approx(
        0.1211, abs=1e-4)


def test_kernel_roofline_share():
    tr = trace.Trace(window_s=1.0, busy_s=1.0, kernels={"osg_decode_tc<4, 16>": [0.004, 4]})
    r = {"trace": tr, "bound": 0.0008}
    assert readers.kernel_roofline_pct(r, "osg_decode", "bound") == pytest.approx(80.0)
    assert readers.kernel_roofline_pct(r, "threefry", "bound") is None


class _Clock:
    """A clock that moves only when the stand-in service works."""

    def __init__(self):
        self.now = 100.0

    def perf_counter(self):
        return self.now


class _Service:
    """Stands in for GNerfService: each call takes a fixed time on `clock`."""

    def __init__(self, frames, clock):
        self.frames, self.clock = frames, clock

    def encode_image(self, photo):
        self.clock.now += 0.01
        return "id"

    def render_orbit(self, ident, frames):
        self.clock.now += 0.05
        return [np.zeros((2, 2, 3), np.uint8)] * frames


def test_orbit_rate_takes_every_frame_and_the_whole_window(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(orbit, "time", clock)
    cell = harness.load_cell("orbit-ffhq512")
    drv = orbit.Driver(cell, lambda msg: None)
    drv.s = type("S", (), {"svc": _Service(120, clock), "photos": [None] * 4})()
    t0 = clock.now
    rate = drv.window(0.2)["frames_per_s"]
    elapsed = clock.now - t0
    videos = drv.counters["videos"]
    assert videos == 4  # whole videos until the window has passed: 4 x 60 ms
    assert drv.counters["frames"] == 120 * videos
    assert rate == pytest.approx(120 * videos / elapsed, rel=1e-12)
    assert elapsed == pytest.approx(0.24)


def test_schedule_offers_the_same_load_for_every_seed():
    traffic = json.loads((harness.BENCH / "traffic" / "serve.json").read_text())
    a = open_loop.schedule(1, traffic, 30.0)
    b = open_loop.schedule(2 ** 31 + 7, traffic, 30.0)
    n = round(traffic["rate_per_s"] * 30)
    assert len(a) == len(b) == n
    for plan in (a, b):
        kinds = [r[1] for r in plan]
        assert kinds.count("encode") == round(0.05 * n)
        assert all(0 <= r[0] < 30 for r in plan)
        assert [r[0] for r in plan] == sorted(r[0] for r in plan)
    assert a != b
    assert open_loop.schedule(1, traffic, 30.0) == a


def test_every_seed_takes_the_same_gaps_in_another_order():
    traffic = json.loads((harness.BENCH / "traffic" / "encode.json").read_text())
    gaps = []
    for seed in (1, 2, 2 ** 31 + 7):
        due = np.array([r[0] for r in open_loop.schedule(seed, traffic, 50.0)])
        gaps.append(np.diff(due, prepend=0.0))
    for g in gaps[1:]:
        assert not np.allclose(g, gaps[0])
        np.testing.assert_allclose(np.sort(g), np.sort(gaps[0]), rtol=0, atol=1e-9)
