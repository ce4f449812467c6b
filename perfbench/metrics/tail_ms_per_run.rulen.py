"""Device milliseconds a Rule-N run spends in the n x n tail: its
``fold``, ``reduce`` and ``recover`` spans (the analytic fold and jitter
of both Grams; their Cholesky factors and the reduced kernel ``M = La^H
Lb / dof``; the recovery ``L^-H T`` with its H^T stack), from the CUDA
events of the program's spans."""
from perfbench.roofline_tail import TAIL_SPANS, spans_ms_per_run


def read(ctx):
    return spans_ms_per_run(ctx, TAIL_SPANS)
