"""Device ms a step of Dmain (fakes of the updated G without a graph, the
dual D on fakes and reals, its backward, Adam on D): CUDA events on the
stream around each call, inside the benchmark's span, over the
device-only window's steps."""


def read(r):
    c = r["counters"]
    if not c.get("dmain_calls") or not c.get("steps"):
        return None
    return 1e3 * c["dmain_device_s"] / c["steps"]
