"""Device-idle ms a step while the stepping thread is inside the program's
`data.next` span (`data_iterator` waiting for the next batch), from the
device-only window."""
from benchmark.attribution import idle_ms_per


def read(r):
    return idle_ms_per(r, ["data.next"], "steps")
