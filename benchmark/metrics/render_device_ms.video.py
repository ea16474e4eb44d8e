"""Device ms a frame inside `g.render_planes` outside the superresolution
(SuperresolutionHybrid2X): ray sampling, the two tri-plane passes,
importance sampling, the march on a white background. Read from the
eager frames the driver profiles after the windows: the window's frames
replay a CUDA graph of the same kernels, which no span sees."""


def read(r):
    tr, n = r.get("eager"), r.get("eager_frames")
    if tr is None or not n or "render" not in tr.spans:
        return None
    device_s = tr.spans["render"][0] - tr.spans.get("sr", [0.0])[0]
    return 1e3 * device_s / n if device_s > 0 else None
