"""Device ms of the lazy regularizers a step, amortised at their cadence:
Greg (the density TV) a call over its interval (every 4th step) plus Dreg
(R1 through the dual D) a call over its interval (every 16th step), each
timed by CUDA events on the stream around its calls inside the benchmark's
span: over the device-only window, or over the span window for a phase
the former did not run (the two hold 16 steps or more, so a Dreg)."""


def read(r):
    total = 0.0
    for phase, interval in zip(("greg", "dreg"), r["reg_intervals"]):
        c = next((c for c in (r["counters"], r["span_counters"])
                  if c.get(f"{phase}_calls")), None)
        if c is None:
            return None
        total += c[f"{phase}_device_s"] / c[f"{phase}_calls"] / interval
    return 1e3 * total
