"""Share of the video cell's traced window with no kernel or copy on the device."""
from benchmark.readers import device_idle_pct as read  # noqa: F401
