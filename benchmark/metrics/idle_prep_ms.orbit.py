"""Device-idle ms a frame while the service's device worker is inside an
`identity.*` span (`_encode_image`, `_prepare`), from the device-only window."""
from benchmark.attribution import idle_ms_per


def read(r):
    return idle_ms_per(r, ["identity."], "frames")
