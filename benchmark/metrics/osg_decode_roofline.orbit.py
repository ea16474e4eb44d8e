"""`osg_decode`'s share of its byte bound at the orbit chunk's shape
(N=1, M=15 x 64^2 x 96, bf16): bound time x launches / device time."""
from benchmark.readers import kernel_roofline_pct


def read(r):
    return kernel_roofline_pct(r, "osg_decode", "decoder_bound_s")
