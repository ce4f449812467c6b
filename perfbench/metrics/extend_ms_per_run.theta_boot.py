"""Device milliseconds a bootstrap run spends in its ``extend`` spans (the
theta forecasts and backcasts of both fields and the tripled records),
from the CUDA events of the program's spans."""
from perfbench.program_trace import device_ms_per_run


def read(ctx):
    return device_ms_per_run(ctx, 'extend', 'bootstrapping')
