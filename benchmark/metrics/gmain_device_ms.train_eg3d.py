"""Device ms a step of Gmain (G's loss on fresh fakes through the dual D,
its backward through all of G, Adam on G, the w_avg update): CUDA events
on the stream around each call, inside the benchmark's span, over the
device-only window's steps."""


def read(r):
    c = r["counters"]
    if not c.get("gmain_calls") or not c.get("steps"):
        return None
    return 1e3 * c["gmain_device_s"] / c["steps"]
