"""`osg_decode`'s share of its byte bound in the training pass (N=4,
M=64^2 x 48, fp32, through `OSGDecode`): bound x launches / device time."""
from benchmark.readers import kernel_roofline_pct


def read(r):
    return kernel_roofline_pct(r, "osg_decode", "decoder_bound_s")
