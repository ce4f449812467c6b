"""Device milliseconds a Rule-N run spends in its ``varimax`` span (the
rotation of the back-projected loadings, one host read of the criterion
an iteration), from the CUDA events of the program's spans."""
from perfbench.program_trace import device_ms_per_run


def read(ctx):
    return device_ms_per_run(ctx, 'varimax', 'rule_n')
