"""K1's share (%) of its roofline in Rule-N runs: the least time of the
runs' +-1 Grams (two a run, each of the logical (n_obs, p) field, on the
int8 peak; :mod:`perfbench.roofline`) over K1's device time in the
traced window."""
from perfbench.readers import syrk_roofline as read  # noqa: F401
