"""Device ms a frame inside `g.render_planes` outside the superresolution:
ray sampling, the two tri-plane passes, importance sampling, the march."""
from benchmark.readers import span_ms_per


def read(r):
    return span_ms_per(r, "render", "frames", minus="sr")
