"""Device ms a frame inside `g.superresolution` (SuperresolutionHybrid2X:
block64, block0 and block1). Read, as `render_device_ms.video` is, from the
eager frames the driver profiles after the windows: the window's frames
replay a CUDA graph of the same kernels, which no span sees."""


def read(r):
    tr, n = r.get("eager"), r.get("eager_frames")
    if tr is None or not n or "sr" not in tr.spans:
        return None
    device_s = tr.spans["sr"][0]
    return 1e3 * device_s / n if device_s > 0 else None
