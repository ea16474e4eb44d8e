"""Device-idle time of a window profiled on the device alone, attributed to
the program's own spans (`gnerf_tpu_torch.utils.profiling`).

The program keeps each span it closes while a profiler runs as `(name,
thread id, start ns, end ns)` on the profiler's clock. Laid over the
window's device-idle intervals (the window less the union of every kernel,
copy and set, as `trace.reduce` merges them), each idle interval is split
over the innermost span open, at each moment, on the stepping thread: the
thread that holds the cell's top spans (the main thread's `train.step`, the
service's device worker's `orbit.*` and `identity.*`). What no span covers
is `outside program spans`; the split adds up to the window's idle time.

`window_split` makes the split from the device-only window's profile, its
`time.time_ns()` edges and `profiling.take()`; the span readers
(`idle_ms_per`) read it as the `idle_split` of `r["trace"]`. `trace.profiled`
does not set that field, so in `run.py`'s traced runs they read None.
"""

from __future__ import annotations

from benchmark import trace

OUTSIDE = "outside program spans"
# The prefixes of the cells' top spans: the train step's on the main thread,
# the orbit's and identity prep's on the service's device worker. No two
# cells share one, so the thread that holds the most of them steps the cell.
TOP = ("train.", "orbit.", "identity.")


def idle_intervals(busy, start: float, end: float) -> list:
    """[start, end] less the union of the `busy` intervals (any order)."""
    _, merged = trace._union(busy)
    out, t = [], start
    for s, e in merged:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def timeline(spans) -> list:
    """Properly nested spans of one thread, [(name, start, end)], -> the
    pieces of time between their edges that some span covers, [(start,
    end, stack)], `stack` naming the spans open there, outermost first."""
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    ordered = sorted(spans, key=lambda sp: (sp[1], -sp[2]))
    out = []
    for a, b in zip(edges, edges[1:]):
        stack = tuple(name for name, s, e in ordered if s <= a and e >= b)
        if stack:
            out.append((a, b, stack))
    return out


def _open_at(pieces, t) -> tuple:
    for a, b, stack in pieces:
        if a <= t < b:
            return stack
    return ()


def _add(into: dict, key, value) -> None:
    into[key] = into.get(key, 0.0) + value


def split_idle(busy, window, spans, top=TOP) -> dict:
    """Split the window's idle time by program span.

    busy: device intervals [(start, end)]; window: (start, end); spans:
    [(name, thread, start, end)], all on one clock and in one unit; top:
    the name prefixes of the cell's top spans. Returns `idle` (the total),
    `stacks` {the stepping thread's open spans, outermost first (() for
    none): idle}, `innermost` {its innermost span, or OUTSIDE: idle},
    `inside` {name: idle while it is open anywhere on it}, and `gaps`, the
    10 longest idle intervals as (length, name): the stepping thread's
    innermost span at the gap's middle, then every span innermost on
    another thread there. All in the input's unit.
    """
    idle = idle_intervals(busy, *window)
    threads: dict = {}
    for name, tid, s, e in spans:
        threads.setdefault(tid, []).append((name, s, e))
    held = {tid: sum(e - s for name, s, e in sp if name.startswith(tuple(top)))
            for tid, sp in threads.items()}
    stepping = max(held, key=held.get) if any(held.values()) else None
    pieces = timeline(threads[stepping]) if stepping is not None else []
    stacks: dict = {}
    j = 0
    for s, e in idle:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        t, k = s, j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, stack = pieces[k]
            lo, hi = max(a, s), min(b, e)
            if lo > t:
                _add(stacks, (), lo - t)
            _add(stacks, stack, hi - lo)
            t, k = hi, k + 1
        if e > t:
            _add(stacks, (), e - t)
    innermost: dict = {}
    inside: dict = {}
    for stack, v in stacks.items():
        _add(innermost, stack[-1] if stack else OUTSIDE, v)
        for name in set(stack):
            _add(inside, name, v)
    others = [timeline(sp) for tid, sp in threads.items() if tid != stepping]
    gaps = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        stack = _open_at(pieces, mid)
        names = [stack[-1] if stack else OUTSIDE]
        names += sorted({st[-1] for st in (_open_at(p, mid) for p in others) if st})
        gaps.append((e - s, " | ".join(names)))
    return {"idle": sum(e - s for s, e in idle), "stacks": stacks, "innermost": innermost,
            "inside": inside, "gaps": gaps}


def window_split(prof, edges_ns, spans) -> dict:
    """`split_idle` of a profile of the device alone, in seconds.

    prof: the window's torch.profiler profile; edges_ns: the window's start
    and end as `time.time_ns()` read them; spans: the program's spans of the
    window, `profiling.take()` after it. Adds the number of spans and their
    names to the split."""
    from torch.autograd import DeviceType

    # Seconds from the trace's start: its events count us from there, the
    # spans Unix ns.
    base = prof.profiler.kineto_results.trace_start_ns()
    busy = [(e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith(trace.SPAN)]
    spans = [(name, tid, (s - base) / 1e9, (e - base) / 1e9) for name, tid, s, e in spans]
    split = split_idle(busy, tuple((n - base) / 1e9 for n in edges_ns), spans, TOP)
    split.update(spans=len(spans), names=sorted({sp[0] for sp in spans}))
    return split


def idle_ms_per(r, names, counter: str, how: str = "inside") -> float | None:
    """Device-idle ms per unit of `counter` while one of the spans `names`
    (a name ending in "." stands for every span under it) is open on the
    stepping thread (`how="inside"`, each moment counted once) or is its
    innermost span (`how="innermost"`); None where the window has none of
    them."""
    split = getattr(r["trace"], "idle_split", None)
    n = r["counters"].get(counter, 0)
    if not split or not n:
        return None
    def hit(name):
        return any(name == x or (x.endswith(".") and name.startswith(x)) for x in names)

    def pick(stack):
        return any(map(hit, stack)) if how == "inside" else bool(stack) and hit(stack[-1])

    if not any(map(hit, split["names"])):
        return None
    return 1e3 * sum(v for st, v in split["stacks"].items() if pick(st)) / n
