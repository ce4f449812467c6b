"""The n x n tail's share (%) of its roofline in Rule-N runs: a run's
least time at the record's length (40 n^3 / 3 operations at 67 TFLOP/s,
or its bytes at 3.35 TB/s; :mod:`perfbench.roofline_tail`) over the
device milliseconds of its ``fold`` and ``reduce`` spans."""
from perfbench.roofline_tail import (COUNTED_SPANS, spans_ms_per_run,
                                     tail_least_s)


def read(ctx):
    ms = spans_ms_per_run(ctx, COUNTED_SPANS)
    if not ms:
        return None
    return 100.0 * tail_least_s(ctx['config']['n_obs']) / (1e-3 * ms)
