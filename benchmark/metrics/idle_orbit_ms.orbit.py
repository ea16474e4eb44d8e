"""Device-idle ms a frame while the service's device worker's innermost
span is `orbit.poses` (the orbit's camera labels) or `orbit.to_host` (a
chunk's frames copied to host arrays), from the device-only window."""
from benchmark.attribution import idle_ms_per


def read(r):
    return idle_ms_per(r, ["orbit.poses", "orbit.to_host"], "frames", how="innermost")
