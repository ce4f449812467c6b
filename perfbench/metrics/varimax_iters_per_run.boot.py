"""Varimax iterations a bootstrap run takes: the ``iterations`` of its
``varimax`` span, summed over the window's runs and divided by them."""
from perfbench.program_trace import attr_per_run


def read(ctx):
    return attr_per_run(ctx, 'varimax', 'bootstrapping', 'iterations')
