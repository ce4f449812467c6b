"""Device milliseconds an unrotated Rule-N run spends in its ``nuclear``
span (the Newton-Schulz nuclear norm of its reduced kernel, the run's
total), from the CUDA events of the program's spans."""
from perfbench.program_trace import device_ms_per_run


def read(ctx):
    return device_ms_per_run(ctx, 'nuclear', 'rule_n')
