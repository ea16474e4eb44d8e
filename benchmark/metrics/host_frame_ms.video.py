"""Host ms a frame inside the video loop's frame call (`IdentityFrames`:
one frame's launches, the program's `video.frame` span: its CUDA graph's
replay, or the warm-up frame and the capture where the graph is new), on the
host clock of the driver's wrapper, from the device-only window."""


def read(r):
    c = r["counters"]
    if not c.get("frames") or "host_frame_s" not in c:
        return None
    return 1e3 * c["host_frame_s"] / c["frames"]
