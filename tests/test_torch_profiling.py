"""The port's spans (gnerf_tpu_torch.utils.profiling) at its layer boundaries.

Port only, no JAX: the tiny G-NeRF train step of tests/test_torch_training.py
(z = w = 32, 16^2 planes, 8^2 render, 4+4 depths, SR 2X, D at 8^2, VGG
resized to 32, batch 2, the encoder with one block per stage) and a tiny
`GNerfService`, both drawn from seeded keys on the CPU. A span costs one
flag read off and must change nothing that runs; under a profiler it opens
a `gnerf.*` host range and keeps (name, thread, start, end) for `take()`.
"""

import copy
import threading

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.infer.server import GNerfService
from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator
from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS
from gnerf_tpu_torch.training import dataset as tds
from gnerf_tpu_torch.training import losses as L
from gnerf_tpu_torch.training import train_loop as T
from gnerf_tpu_torch.training.train import step_key
from gnerf_tpu_torch.utils import prng, profiling

TINY_G = dict(z_dim=32, w_dim=32, img_resolution=128, plane_resolution=16, channel_base=512,
              channel_max=32, mapping_layers=2, neural_rendering_resolution=8,
              rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS,
                                    superresolution_module="SuperresolutionHybrid2X",
                                    depth_resolution=4, depth_resolution_importance=4))
TINY_D = dict(c_dim=25, img_resolution=8, img_channels=1, channel_base=256, channel_max=32,
              mbstd_group_size=1)
STEP_PARTS = ["train.g_forward", "train.g_backward", "train.d_forward", "train.d_backward",
              "train.optimizer", "train.ema"]
RENDER_STAGES = ["render.coarse", "render.importance", "render.fine", "render.composite"]


def host_profile():
    """A CPU profile of every thread's host ops, as the benchmark's host window takes it."""
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def gnerf_events(prof):
    return [e for e in prof.events() if e.name.startswith(profiling.PREFIX)]


def test_span_off_is_the_shared_null_context():
    profiling.take()
    assert profiling.span("off.a") is profiling.span("off.b") is profiling._NULL

    @profiling.profiled_function("off.fn")
    def fn(x):
        return x + 1

    assert fn(1) == 2
    with profiling.span("off.c"):
        pass
    assert not [s for s in profiling.take() if s[0].startswith("off.")]


def test_spans_nest_by_thread_under_a_cpu_profile():
    profiling.take()

    def worker():
        with profiling.span("probe.worker"):
            torch.ones(4).sum()

    with host_profile() as prof:
        with profiling.span("probe.outer"):
            with profiling.span("probe.inner"):
                torch.ones(4).sum()
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = {s[0]: s for s in profiling.take() if s[0].startswith("probe.")}
    assert sorted(spans) == ["probe.inner", "probe.outer", "probe.worker"]
    _, main, o0, o1 = spans["probe.outer"]
    _, inner_thread, i0, i1 = spans["probe.inner"]
    _, other, w0, w1 = spans["probe.worker"]
    assert inner_thread == main == threading.get_ident() != other
    assert o0 <= i0 < i1 <= w0 < w1 <= o1
    events = {e.name: e for e in gnerf_events(prof)}
    assert {"gnerf.probe.outer", "gnerf.probe.inner", "gnerf.probe.worker"} <= set(events)
    assert all(e.device_type == DeviceType.CPU for e in events.values())
    outer, inner, work = (events[f"gnerf.probe.{n}"] for n in ("outer", "inner", "worker"))
    assert outer.thread == inner.thread != work.thread
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    # The list's clock is the events': both count from the trace's start.
    base = prof.profiler.kineto_results.trace_start_ns()
    assert abs((i0 - base) / 1e3 - inner.time_range.start) < 1e3


def test_span_without_private_torch_hooks(monkeypatch):
    """Where torch lacks `_RecordFunctionFast` or the process-wide flag, a
    span still keeps its entry for `take()`, gated by the thread-local flag
    (set on the profiling thread alone, and not under `profile_all_threads`)."""
    monkeypatch.setattr(profiling, "_RecordFunctionFast", None)
    monkeypatch.setattr(profiling, "_profiling", torch._C._autograd._profiler_enabled)
    profiling.take()
    assert profiling.span("probe.off") is profiling._NULL
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("probe.kept"):
            torch.ones(4).sum()
    assert [s[0] for s in profiling.take() if s[0].startswith("probe.")] == ["probe.kept"]
    assert not gnerf_events(prof)


def tiny_train_state():
    keys = prng.split(prng.PRNGKey(3), 4)
    g = TriPlaneGenerator(**TINY_G, device="cpu", key=keys[0])
    enc = ResNeXt50Encoder(out_dim=32, layers=(1, 1, 1, 1), device="cpu", key=keys[1])
    disc = Discriminator(**TINY_D, device="cpu", key=keys[2])
    vgg = L.VGG16LPIPS(resize_to=32, device="cpu", key=keys[3])
    cfg = T.TrainConfig(batch_size=2, neural_rendering_resolution=8)
    return T.init_train_state(g, enc, disc, vgg, cfg), T.make_train_step(cfg)


def tiny_batch():
    ds = tds.SyntheticDataset(resolution=16, depth_resolution=8, size=16, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in tds.collate([ds[0], ds[1]]).items()}
    rs = np.random.RandomState(2)
    photos = np.kron(rs.randint(0, 256, (2, 3, 8, 8)), np.ones((8, 8))).astype(np.uint8)
    batch["condition_image"] = torch.from_numpy(photos)
    return batch


@pytest.fixture(scope="module")
def train_steps():
    """One step from the same seeded state without and with a profiler:
    (stats and parameters off, the same on, the spans, the events)."""
    first, step = tiny_train_state()
    out = []
    for traced in (False, True):
        state = copy.deepcopy(first)
        profiling.take()
        if traced:
            with host_profile() as prof:
                _, stats = step(state, tiny_batch(), step_key(0, state.cur_nimg))
        else:
            _, stats = step(state, tiny_batch(), step_key(0, state.cur_nimg))
        params = {f"{root}/{k}": v.detach().clone()
                  for root, m in (("E", state.enc), ("G", state.g), ("G_ema", state.g_ema),
                                  ("D", state.disc))
                  for k, v in m.state_dict().items()}
        out.append(({k: v.detach().clone() for k, v in stats.items()}, params))
    return out[0], out[1], profiling.take(), gnerf_events(prof)


def test_train_step_spans(train_steps):
    _, _, spans, events = train_steps
    main = threading.get_ident()
    mine = [s for s in spans if s[1] == main]
    names = [s[0] for s in mine]
    assert names.count("train.step") == 1 and names.count("train.step_key") == 1
    (_, _, s0, s1), = [s for s in mine if s[0] == "train.step"]
    parts = sorted((s for s in mine if s[0] in STEP_PARTS), key=lambda s: s[2])
    assert [s[0] for s in parts] == STEP_PARTS
    assert all(s0 <= a < b <= s1 for _, _, a, b in parts)
    assert all(p[3] <= q[2] for p, q in zip(parts, parts[1:]))
    (_, _, f0, f1), = [s for s in parts if s[0] == "train.g_forward"]
    for model in ("encoder", "mapping", "backbone", "render", "sr", "lpips", "disc"):
        inside = [s for s in mine if s[0] == model and f0 <= s[2] and s[3] <= f1]
        assert inside, model
    assert all(names.count(stage) == 1 for stage in RENDER_STAGES)
    assert {e.name for e in events} >= {"gnerf.train.step", *("gnerf." + p for p in STEP_PARTS)}


def test_spans_change_no_step_result(train_steps):
    (stats_off, params_off), (stats_on, params_on), _, _ = train_steps
    assert stats_off.keys() == stats_on.keys()
    for k in stats_off:
        assert torch.equal(stats_off[k], stats_on[k]), k
    assert params_off.keys() == params_on.keys()
    for k in params_off:
        assert torch.equal(params_off[k], params_on[k]), k


@pytest.fixture(scope="module")
def orbits():
    """A 20-frame orbit (chunks of 15 and 5) of one seeded photo without and
    with a profiler: (frames off, frames on, spans, service worker's thread)."""
    keys = prng.split(prng.PRNGKey(4))
    g = TriPlaneGenerator(**TINY_G, device="cpu", key=keys[0]).eval().requires_grad_(False)
    enc = ResNeXt50Encoder(out_dim=32, layers=(1, 1, 1, 1), device="cpu",
                           key=keys[1]).eval().requires_grad_(False)
    svc = GNerfService(g, enc, dtype=torch.float32, device="cpu", microbatch=0)
    photo = np.kron(np.random.RandomState(5).randint(0, 256, (3, 8, 8)),
                    np.ones((8, 8))).astype(np.uint8)
    try:
        off = svc.render_orbit(svc.encode_image(photo), frames=20)
        profiling.take()
        with host_profile():
            on = svc.render_orbit(svc.encode_image(photo), frames=20)
        worker = svc._device_worker.submit(threading.get_ident).result()
    finally:
        svc.close()
    return off, on, profiling.take(), worker


def test_orbit_spans(orbits):
    _, _, spans, worker = orbits
    names = [s[0] for s in spans if s[1] == worker]
    assert names.count("orbit.poses") == 1
    assert names.count("orbit.render") == names.count("orbit.to_host") == 2
    for stage in RENDER_STAGES:
        assert names.count(stage) == 2, stage
    assert names.count("identity.encode") == names.count("identity.prepare") == 1
    assert {"encoder", "mapping", "backbone", "render", "sr"} <= set(names)
    order = [n for n in names if n.startswith("orbit.")]
    assert order == ["orbit.poses", "orbit.render", "orbit.to_host", "orbit.render",
                     "orbit.to_host"]


def test_spans_change_no_frame(orbits):
    off, on, _, _ = orbits
    assert len(off) == len(on) == 20
    for a, b in zip(off, on):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_data_iterator_spans_by_thread():
    ds = tds.SyntheticDataset(resolution=16, depth_resolution=8, size=8, seed=2)
    profiling.take()
    with host_profile():
        it = tds.data_iterator(ds, batch_size=2, seed=3)
        batches = [next(it) for _ in range(3)]
    assert all(b["condition_image"].shape[0] == 2 for b in batches)
    spans = [s for s in profiling.take() if s[0].startswith("data.")]
    main = threading.get_ident()
    consumer = {s[1] for s in spans if s[0] == "data.next"}
    producer = {s[1] for s in spans if s[0] == "data.batch"}
    assert consumer == {main}
    assert len(producer) == 1 and main not in producer
    assert sum(s[0] == "data.next" for s in spans) == 3
    assert sum(s[0] == "data.batch" for s in spans) >= 3


@pytest.mark.cuda
def test_span_holds_its_kernels_on_the_profilers_clock():
    """Spans around runs of kernels ended by synchronize() hold every one of
    them on the clock of a device-only profile. The host wakes from the
    synchronize some way after the last kernel ends (8-160 us on the H100's
    host): the median of 20 spans is within 100 us of the close, each within 1 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device's clock is the card's")
    a = torch.randn(1024, 1024, device="cuda")
    for _ in range(3):
        a = torch.tanh(a @ a) * 0.01
    torch.cuda.synchronize()
    profiling.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with profiling.span("clock"):
                for _ in range(20):
                    a = torch.tanh(a @ a) * 0.01
                torch.cuda.synchronize()
    spans = [s for s in profiling.take() if s[0] == "clock"]
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    assert len(spans) == 20 and len(kernels) >= 20 * 40
    tails, held = [], 0
    for _, _, start, end in spans:
        start, end = (start - base) / 1e3, (end - base) / 1e3
        inside = [(k0, k1) for k0, k1 in kernels if start <= k0 < end]
        assert len(inside) >= 40 and all(k1 <= end for _, k1 in inside)
        tails.append(end - max(k1 for _, k1 in inside))
        held += len(inside)
    assert held == len(kernels)
    assert sorted(tails)[len(tails) // 2] < 100.0, tails
    assert max(tails) < 1000.0, tails
