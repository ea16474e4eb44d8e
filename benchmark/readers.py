"""Shared arithmetic of the per-layer metric readers (`metrics/<name>.py`).

Each reader takes the reading `r` of a traced run and returns a number, or
None where the trace holds nothing to read. `r["trace"]` is the window
profiled on the device alone and `r["counters"]` what the driver counted
in it; `r["spans"]` is the window profiled with the host's ops and the
benchmark's spans, `r["span_counters"]` its counts.
"""

from __future__ import annotations


def device_idle_pct(r) -> float | None:
    """The share of the traced window in which nothing ran on the device."""
    tr = r["trace"]
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def span_ms_per(r, span: str, counter: str, minus: str | None = None) -> float | None:
    """Device ms inside span `span` (less span `minus` nested in it) per
    unit of `counter`."""
    spans, n = r["spans"].spans, r["span_counters"].get(counter, 0)
    if span not in spans or not n:
        return None
    device_s = spans[span][0] - (spans[minus][0] if minus and minus in spans else 0.0)
    return 1e3 * device_s / n if device_s > 0 else None


def kernel_roofline_pct(r, kernel: str, bound_key: str) -> float | None:
    """The kernel's bound time (one call at the cell's shape, r[bound_key])
    times its launches, over its device time, in percent."""
    device_s, launches = r["trace"].kernel_s(kernel)
    if not launches or device_s <= 0:
        return None
    return 100.0 * r[bound_key] * launches / device_s
