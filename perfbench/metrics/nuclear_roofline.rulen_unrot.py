"""The Newton-Schulz nuclear norm's share (%) of its roofline in Rule-N
runs: the least time of the runs' ``nuclear`` spans, counted from each
span's ``steps`` at the record's length (:mod:`perfbench.
roofline_nuclear`), over the spans' device milliseconds (CUDA events)."""
from perfbench.roofline_nuclear import nuclear_least_s, nuclear_spans


def read(ctx):
    spans = nuclear_spans(ctx)
    if not spans:
        return None
    n = ctx['config']['n_obs']
    least = sum(nuclear_least_s(n, s['attrs']['steps']) for s in spans)
    return 100.0 * least / (1e-3 * sum(s['device_ms'] for s in spans))
