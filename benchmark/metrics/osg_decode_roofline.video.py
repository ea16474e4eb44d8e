"""`osg_decode`'s share of its byte bound at a video frame's pass (N=1,
M=64^2 x 128, bf16; two a frame): bound time x launches / device time."""
from benchmark.readers import kernel_roofline_pct


def read(r):
    return kernel_roofline_pct(r, "osg_decode", "decoder_bound_s")
