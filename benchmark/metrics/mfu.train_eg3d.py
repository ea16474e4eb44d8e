"""The window's EG3D phases (Gmain + Dmain every step, Greg and Dreg as
counted), each priced at its FLOPs (forward, backward and R1's double
backward, counted over the reference phase at the cell's shapes), per
second of the traced window, as a share of the H100's 67 TFLOP/s of fp32
outside the tensor cores."""


def read(r):
    c, f, tr = r["counters"], r["flops"], r["trace"]
    if not f or not c.get("steps") or tr.window_s <= 0:
        return None
    work = (c["steps"] * (f["gmain"] + f["dmain"]) + c.get("greg", 0) * f.get("greg", 0)
            + c.get("dreg", 0) * f.get("dreg", 0))
    return 100.0 * work / tr.window_s / r["peak_flops"]
