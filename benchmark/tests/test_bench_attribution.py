"""Device-idle time split by the program's spans (`attribution`): the exact
split on synthetic intervals, the existing Trace and readers unchanged by
the program's spans, and the span readers silent without them."""

import dataclasses
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import attribution, harness, trace
from gnerf_tpu_torch.utils import profiling

SPAN_METRICS = ("idle_step_ms.train", "idle_data_ms.train", "idle_orbit_ms.orbit",
                "idle_prep_ms.orbit")
OUT = attribution.OUTSIDE


@dataclasses.dataclass
class Attributed(trace.Trace):
    """A Trace with the window's split by program span, where `trace.profiled`
    would keep it once it sets `idle_split`."""
    idle_split: dict = dataclasses.field(default_factory=dict)


def test_idle_intervals_are_the_window_less_the_busy_union():
    busy = [(12, 14), (2, 5), (4, 6), (30, 45)]
    assert attribution.idle_intervals(busy, 0, 40) == [(0, 2), (6, 12), (14, 30)]
    assert attribution.idle_intervals([], 1, 3) == [(1, 3)]
    assert attribution.idle_intervals([(0, 10)], 2, 8) == []


def test_timeline_of_nested_spans():
    spans = [("step", 0, 100), ("g", 10, 40), ("enc", 15, 20), ("opt", 60, 70)]
    assert attribution.timeline(spans) == [
        (0, 10, ("step",)), (10, 15, ("step", "g")), (15, 20, ("step", "g", "enc")),
        (20, 40, ("step", "g")), (40, 60, ("step",)), (60, 70, ("step", "opt")),
        (70, 100, ("step",))]


def test_split_on_two_threads_is_exact():
    # Stepping thread "M": data.next, then train.step with two parts; the
    # data thread "D" holds data.batch; "A" (autograd) holds render.
    spans = [("data.next", "M", 0, 10), ("train.step", "M", 10, 90),
             ("train.g_forward", "M", 12, 40), ("train.optimizer", "M", 50, 70),
             ("data.batch", "D", 5, 60), ("render", "A", 20, 30)]
    busy = [(3, 8), (15, 35), (45, 55), (65, 80)]
    split = attribution.split_idle(busy, (0, 100), spans, ("train.",))
    # idle: [0, 3] [8, 15] [35, 45] [55, 65] [80, 100]
    assert split["idle"] == 50
    assert split["stacks"] == {("data.next",): 5, ("train.step",): 17,
                               ("train.step", "train.g_forward"): 8,
                               ("train.step", "train.optimizer"): 10, (): 10}
    assert split["innermost"] == {"data.next": 3 + 2, "train.step": 2 + 5 + 10,
                                  "train.g_forward": 3 + 5, "train.optimizer": 10, OUT: 10}
    assert sum(split["innermost"].values()) == split["idle"]
    assert split["inside"] == {"data.next": 5, "train.step": 35, "train.g_forward": 8,
                               "train.optimizer": 10}
    assert split["gaps"][:3] == [(20, OUT), (10, "train.step | data.batch"),
                                 (10, "train.optimizer")]


def test_split_without_spans_is_all_outside():
    split = attribution.split_idle([(1, 2)], (0, 4), [], ("train.",))
    assert split["innermost"] == {OUT: 3} and split["inside"] == {}
    split = attribution.split_idle([(1, 2)], (0, 4), [("x", 1, 0, 4)], ("train.",))
    assert split["innermost"] == {OUT: 3}


def _reading(tr, counters):
    return {"trace": tr, "counters": counters, "flops": {"step": 1e12, "prep": 1e9,
                                                        "frame": 1e10},
            "decoder_bound_s": 1e-4, "peak_flops": 1e15,
            "spans": trace.Trace(1.0, 0.5, spans={"render": [0.3, 2], "sr": [0.1, 2],
                                                  "prep.encoder": [0.01, 1],
                                                  "encode": [0.02, 1]}),
            "span_counters": {"frames": 2}}


def _split(stacks, spans=9):
    """A split from {stack: idle s}, as `window_split` gives it."""
    innermost, inside = {}, {}
    for st, v in stacks.items():
        innermost[st[-1] if st else OUT] = innermost.get(st[-1] if st else OUT, 0.0) + v
        for name in set(st):
            inside[name] = inside.get(name, 0.0) + v
    return {"idle": sum(stacks.values()), "stacks": stacks, "innermost": innermost,
            "inside": inside, "gaps": [], "spans": spans,
            "names": sorted({n for st in stacks for n in st})}


def test_existing_readers_read_the_same_with_the_split():
    plain = trace.Trace(window_s=2.0, busy_s=1.5, kernels={"osg_decode_tc<4, 16>": [0.01, 8]})
    split = _split({("train.step",): 0.3, (): 0.2})
    attributed = Attributed(**vars(plain), idle_split=split)
    counters = {"steps": 4, "frames": 8, "videos": 1, "data_wait_s": 0.01, "batch_mean": 2.0}
    names = [p.stem for p in (harness.BENCH / "metrics").glob("*.py")]
    old = [n for n in names if n not in SPAN_METRICS]
    assert len(old) == 12
    for name in old:
        read = harness.reader(name)
        assert read(_reading(plain, counters)) == read(_reading(attributed, counters)), name


def test_span_readers_are_none_without_their_spans():
    counters = {"steps": 4, "frames": 8, "videos": 1}
    plain = trace.Trace(window_s=2.0, busy_s=1.5)
    other = Attributed(window_s=2.0, busy_s=1.5,
                                        idle_split=_split({(): 0.5}, spans=0))
    for name in SPAN_METRICS:
        read = harness.reader(name)
        assert read({"trace": plain, "counters": counters}) is None, name
        assert read({"trace": other, "counters": counters}) is None, name


def test_span_readers_per_step_and_frame():
    split = _split({("train.step",): 0.1, ("train.step", "train.ema"): 0.1,
                    ("data.next",): 0.04, (): 0.05,
                    ("orbit.poses",): 0.08, ("orbit.to_host",): 0.02,
                    ("orbit.render", "render"): 0.05,
                    # prepare nested in encode: counted once
                    ("identity.encode", "identity.prepare"): 0.016,
                    ("identity.encode", "encoder"): 0.008})
    r = {"trace": Attributed(window_s=2.0, busy_s=1.5, idle_split=split),
         "counters": {"steps": 4, "frames": 8}}
    assert harness.reader("idle_step_ms.train")(r) == pytest.approx(50.0)
    assert harness.reader("idle_data_ms.train")(r) == pytest.approx(10.0)
    assert harness.reader("idle_orbit_ms.orbit")(r) == pytest.approx(12.5)
    assert harness.reader("idle_prep_ms.orbit")(r) == pytest.approx(3.0)


def test_program_spans_leave_the_trace_of_a_host_window_as_it_was():
    """`trace.reduce` of a host profile reads the same Trace fields whether
    the program's spans run inside the benchmark's or not."""
    def work(with_program):
        with torch.profiler.record_function(trace.SPAN + "outer"):
            for _ in range(3):
                if with_program:
                    with profiling.span("probe.part"):
                        torch.ones(64).cumsum(0)
                else:
                    torch.ones(64).cumsum(0)

    def fields(with_program):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            work(with_program)
        tr = trace.reduce(prof, 1.0)
        return {"kernels": tr.kernels, "spans": {k: v[1] for k, v in tr.spans.items()},
                "busy_s": tr.busy_s, "gaps": tr.gaps}

    profiling.take()
    assert fields(True) == fields(False)
    assert [s[0] for s in profiling.take()] == ["probe.part"] * 3


def test_window_split_lays_the_program_spans_over_the_window():
    profiling.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        n0, t0 = time.time_ns(), time.perf_counter()
        with profiling.span("train.step"):
            torch.ones(64).cumsum(0)
        n1, window_s = time.time_ns(), time.perf_counter() - t0
    split = attribution.window_split(prof, (n0, n1), profiling.take())
    tr = trace.reduce(prof, window_s)
    assert split["spans"] == 1 and split["names"] == ["train.step"]
    # No device here: the whole window is idle, and the step holds most of it.
    assert tr.busy_s == 0
    assert split["idle"] == pytest.approx((n1 - n0) / 1e9, rel=1e-6)
    assert 0 < split["inside"]["train.step"] <= split["idle"]
    assert sum(split["innermost"].values()) == pytest.approx(split["idle"], rel=1e-9)
