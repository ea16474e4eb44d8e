"""The window's FLOPs (identity preparations and frames, counted over the
ShapeNet reference at the cell's shapes) per second, as a share of 989
TFLOP/s."""


def read(r):
    c, f, tr = r["counters"], r["flops"], r["trace"]
    if not f or not c.get("frames") or tr.window_s <= 0:
        return None
    work = c["videos"] * f["prep"] + c["frames"] * f["frame"]
    return 100.0 * work / tr.window_s / r["peak_flops"]
