"""Device milliseconds a Rule-N run spends in its ``project`` spans (the
+-1 back-projection of each field: the int8 field cast to f32 in column
blocks and the product ``X^T S``), from the CUDA events of the program's
spans."""
from perfbench.program_trace import device_ms_per_run


def read(ctx):
    return device_ms_per_run(ctx, 'project', 'rule_n')
