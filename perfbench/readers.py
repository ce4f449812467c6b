"""What the per-layer metrics' files (``metrics/<name>.py``) read, shared
by the cells whose metrics read the same quantity.  Each takes the
traced window's context (``activity``: :class:`perfbench.trace.Activity`,
``window_s``, ``units``: the runs or fits the traced calls completed,
``spans``, ``config``) and returns a number, or None when the trace has
nothing to read."""
from perfbench.kernels import K1_KERNELS, K2_KERNELS
from perfbench.roofline import pm1_gram_least_s


def launches_per_run(ctx):
    """Device kernel launches over the runs."""
    act = ctx['activity']
    if not ctx['units'] or not act.launches():
        return None
    return act.launches() / ctx['units']


def algebra_ms_per_run(ctx):
    """Device milliseconds a run spends in kernels other than K1 (the
    +-1 Gram) and K2 (the +-1 draw)."""
    act = ctx['activity']
    if not ctx['units'] or not act.launches():
        return None
    return 1e3 * act.kernel_s(exclude=K1_KERNELS + K2_KERNELS) / ctx['units']


def syrk_roofline(ctx):
    """K1's share (%) of its roofline: the least time of the runs' +-1
    Grams (two a run, of the logical (n_obs, p) fields, on the int8
    peak) over K1's device time."""
    k1 = ctx['activity'].kernel_s(K1_KERNELS)
    if k1 <= 0 or not ctx['units']:
        return None
    c = ctx['config']
    p = c['n_lat'] * c['n_lon']
    least = 2 * pm1_gram_least_s(c['n_obs'], p) * ctx['units']
    return 100.0 * least / k1


def device_idle(ctx):
    """Share (%) of the traced window in which no kernel, copy or set ran
    on the device."""
    busy = ctx['activity'].busy_s()
    if busy <= 0 or ctx['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx['window_s'])


def span_mean(ctx, name):
    """Mean host seconds of the harness span ``name`` (a stage of a fit,
    ending in a device synchronize)."""
    spans = ctx['spans'].get(name)
    if not spans:
        return None
    return sum(spans) / len(spans)
