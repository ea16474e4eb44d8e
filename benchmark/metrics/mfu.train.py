"""A step's FLOPs (forward, backward and R1's double backward, counted over
the reference step at the cell's shapes) per second of the traced window,
as a share of the H100's 67 TFLOP/s of fp32 outside the tensor cores."""


def read(r):
    c, f, tr = r["counters"], r["flops"], r["trace"]
    if not f or not c.get("steps") or tr.window_s <= 0:
        return None
    return 100.0 * c["steps"] * f["step"] / tr.window_s / r["peak_flops"]
