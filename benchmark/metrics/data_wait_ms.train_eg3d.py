"""Host ms an EG3D step spends in `next(batches)`, timed by the benchmark
around the loop's own call (the copy to the device is inside the step)."""


def read(r):
    c = r["counters"]
    return 1e3 * c["data_wait_s"] / c["steps"] if c.get("steps") else None
