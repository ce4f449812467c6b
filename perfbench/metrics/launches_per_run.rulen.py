"""Device kernel launches in the traced window over the ensemble runs
its calls completed."""
from perfbench.readers import launches_per_run as read  # noqa: F401
