"""Device milliseconds a bootstrap run spends in its ``gram`` span (the
resample's temporal Grams, the analytic fold, the jitter, Cholesky and
the reduced kernel), from the CUDA events of the program's spans."""
from perfbench.program_trace import device_ms_per_run


def read(ctx):
    return device_ms_per_run(ctx, 'gram', 'bootstrapping')
