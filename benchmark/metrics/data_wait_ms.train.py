"""Host ms a step spends in `next(batches)` and the copy of the batch to
the device, timed by the benchmark around the loop's own calls."""


def read(r):
    c = r["counters"]
    return 1e3 * c["data_wait_s"] / c["steps"] if c.get("steps") else None
