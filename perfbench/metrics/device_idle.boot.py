"""Share of the traced window (%) in which no kernel, copy or set ran
on the device: 1 - (union of the device's intervals) / (the window)."""
from perfbench.readers import device_idle as read  # noqa: F401
