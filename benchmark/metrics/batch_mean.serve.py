"""Mean size of the micro-batches `GNerfService` ran in the window (frames
a batch), from its own `batch_sizes` counter."""


def read(r):
    return r["counters"].get("batch_mean")
