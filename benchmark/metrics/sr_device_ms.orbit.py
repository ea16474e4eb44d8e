"""Device ms a frame inside `g.superresolution` (SuperresolutionHybrid8XDC)."""
from benchmark.readers import span_ms_per


def read(r):
    return span_ms_per(r, "sr", "frames")
