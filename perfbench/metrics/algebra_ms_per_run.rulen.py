"""Device milliseconds a Rule-N run spends in kernels other than K1 (the
+-1 Gram) and K2 (the +-1 draw): the n x n algebra, the back-projection
and the rotation."""
from perfbench.readers import algebra_ms_per_run as read  # noqa: F401
