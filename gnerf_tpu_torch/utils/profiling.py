"""Named spans at the port's layer boundaries, for torch.profiler.

Port of `gnerf_tpu/utils/profiling.py` (`profiled_function`; EG3D's
`misc.profiled_function` scopes). `span(name)` and `profiled_function(name)`
cost one flag read while no torch profiler runs: they return a shared null
context, read no clock and record nothing. While one runs (in any thread of
the process), a span

- opens a host range named `gnerf.<name>` (a `cpu_op`, as `record_function`
  would open but without its mirror on the device's timeline, which a
  reading of device-busy time would count as device work), so the span
  shows, nested by thread, in any profile or Chrome trace taken with host
  activity (on threads other than the profiling one with
  `_ExperimentalConfig(profile_all_threads=True)`);
- and, on closing, appends `(name, thread id, start ns, end ns)` to a bounded
  in-memory list (`take()`). Its times are on the profiler's own clock (Unix
  nanoseconds, `time.time_ns`: the clock of a profile's events before
  `trace_start_ns` is taken from them), so the spans can be laid over a
  profile of the device alone, which records no host ranges at all.

A span never synchronises, reads no tensor and changes nothing that runs.

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, key)
    prof.export_chrome_trace("step.json")   # gnerf.train.* in Perfetto
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

# Both are private to torch (checked on 2.11 and 2.13). Without the first a
# span keeps only its entry in `take()`'s list; without the second the
# profiler's thread-local flag gates the spans, which keeps those of the
# profiling thread alone, and none under `profile_all_threads`.
try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None
if hasattr(_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _profiler._is_profiler_enabled
else:
    _profiling = torch._C._autograd._profiler_enabled

PREFIX = "gnerf."
MAX_SPANS = 1 << 16  # the list keeps the newest; a 6 s train window makes ~300

_NULL = contextlib.nullcontext()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)


class _Span:
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = None if _RecordFunctionFast is None else _RecordFunctionFast(
            PREFIX + self.name)
        if self._range is not None:
            self._range.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _spans.append((self.name, threading.get_ident(), self._start, end))
        return False


def span(name: str):
    """A context manager: the span `gnerf.<name>` while a profiler runs,
    else the shared null context. `torch.autograd.profiler`'s process-wide
    flag decides, not the thread-local `_profiler_enabled()`, so spans on
    the data thread and the service's device worker are kept too."""
    if not _profiling():
        return _NULL
    return _Span(name)


def profiled_function(name: str):
    """Decorator: every call of the function inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def take() -> list:
    """The spans closed since the last call, oldest first, as
    `(name, thread id, start ns, end ns)`; the list is emptied."""
    out = []
    while True:
        try:
            out.append(_spans.popleft())
        except IndexError:
            return out
