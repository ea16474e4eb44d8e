"""Device-idle ms a step while the stepping thread is inside the program's
`train.step` span (`make_train_step`), from the device-only window."""
from benchmark.attribution import idle_ms_per


def read(r):
    return idle_ms_per(r, ["train.step"], "steps")
