"""Mean host seconds of the fits' rotate stage in the traced window (a
harness span around its public calls, ending in a device synchronize)."""
from perfbench.readers import span_mean


def read(ctx):
    return span_mean(ctx, 'rotate')
