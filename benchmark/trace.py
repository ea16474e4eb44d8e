"""The traced window: torch.profiler over the cell's work, reduced to what
the per-layer readers take.

Spans are `record_function` ranges opened by the benchmark's own wrappers
(`wrap`), around methods of the program's instances, on whichever thread
calls them (the profiler records every thread). A span's device seconds are
the device time of the kernels launched inside it. Busy time is the union of
every kernel, copy and set on the device; idle is the rest of the window.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field

SPAN = "bench."


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: dict = field(default_factory=dict)   # name -> [device s, count]
    spans: dict = field(default_factory=dict)     # span -> [device s, count]
    gaps: list = field(default_factory=list)      # the 10 longest: [(s, span open)]

    def kernel_s(self, part: str) -> tuple[float, int]:
        """(device s, launches) of the kernels whose name holds `part`."""
        hits = [v for k, v in self.kernels.items() if part in k]
        return sum(h[0] for h in hits), sum(h[1] for h in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[0])[:10]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[name, s] for s, name in gaps]}


def wrap(obj, method: str, span: str) -> None:
    """Open the span `bench.<span>` around every call of `obj.method`."""
    from torch.profiler import record_function

    inner = getattr(obj, method)

    @functools.wraps(inner)
    def traced(*args, **kwargs):
        with record_function(SPAN + span):
            return inner(*args, **kwargs)

    setattr(obj, method, traced)


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def reduce(prof, window_s: float) -> Trace:
    """A profile's events -> Trace (times in seconds)."""
    from torch.autograd import DeviceType

    device, spans_cpu = [], []
    kernels: dict = {}
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith(SPAN):
            if e.device_type == DeviceType.CPU:
                entry = spans.setdefault(e.name[len(SPAN):], [0.0, 0])
                entry[0] += e.device_time_total / 1e6
                entry[1] += 1
                spans_cpu.append((e.time_range.start, e.time_range.end, e.name[len(SPAN):]))
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        device.append((s, t))
        entry = kernels.setdefault(e.name, [0.0, 0])
        entry[0] += (t - s) / 1e6
        entry[1] += 1
    busy_us, merged = _union(device)
    longest = sorted(((s1 - e0, (e0 + s1) / 2) for (_, e0), (s1, _) in zip(merged, merged[1:])),
                     reverse=True)[:10]
    gaps = []
    for length, mid in longest:  # named by the innermost span open on the host
        open_spans = [(b - a, name) for a, b, name in spans_cpu if a <= mid <= b]
        gaps.append((length / 1e6, min(open_spans)[1] if open_spans else "outside spans"))
    return Trace(window_s=window_s, busy_s=busy_us / 1e6, kernels=kernels, spans=spans, gaps=gaps)


@contextlib.contextmanager
def profiled(out: dict, spans: bool):
    """Profile the block; `out["trace"]` holds the Trace after. With `spans`
    the host's ops and the benchmark's spans are recorded too, on every
    thread; that slows the host, so busy and idle time, kernel times and
    rates are read from a window profiled without them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if spans:
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if spans or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts, **kw) as prof:
        t0 = time.perf_counter()
        yield
        sync()
        window_s = time.perf_counter() - t0
    out["trace"] = reduce(prof, window_s)
