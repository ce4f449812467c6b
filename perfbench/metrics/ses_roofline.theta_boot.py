"""The SES sweeps' share (%) of their roofline in bootstrap runs: the
least time of the runs' ``ses`` spans, counted from each span's
``steps``, ``grid`` and ``columns`` (:mod:`perfbench.roofline_ext`),
over the spans' device milliseconds (CUDA events)."""
from perfbench.program_trace import analysis, under_run
from perfbench.roofline_ext import ses_least_s


def read(ctx):
    a = analysis(ctx)
    if a is None:
        return None
    sweeps = [s for s in a['spans'] if s['name'] == 'ses'
              and s['device_ms'] and under_run(a, s, 'bootstrapping')]
    if not sweeps:
        return None
    least = sum(ses_least_s(s['attrs']['steps'], s['attrs']['grid'],
                            s['attrs']['columns']) for s in sweeps)
    return 100.0 * least / (1e-3 * sum(s['device_ms'] for s in sweeps))
