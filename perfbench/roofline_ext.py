"""Least times of the boundary extension's SES sweeps
(``xmca_tpu_torch/core/theta.py``), from the sweeps' logical shapes as
their ``ses`` spans give them: ``steps`` T, ``grid`` G smoothing
parameters a series and ``columns`` C series.

A sweep of T steps makes three multiply-adds a step, a grid point and a
series (the level and the two sums of the closed-form initial level's
SSE), two operations each, and reads the float32 series once.  The
peaks are one NVIDIA H100 SXM's, NVIDIA's data sheet: 67 TFLOP/s, its
FP32 rate and its FP64 tensor-core rate, the highest any implementation
of the recursion could use, and 3.35 TB/s of HBM
(:data:`perfbench.roofline.PEAK_BYTES`).  The count is the same work
whatever implements it, so a fused kernel cannot read above 100%.
"""
from perfbench.roofline import PEAK_BYTES

PEAK_SES_FLOPS = 67e12


def ses_ops(T, G, C):
    """Operations of one sweep: 3 T G C multiply-adds, two each."""
    return 3 * T * G * C * 2


def ses_bytes(T, C):
    """The (T, C) float32 series read once."""
    return 4 * T * C


def ses_least_s(T, G, C):
    """The larger of the sweep's operations over 67 TFLOP/s and its bytes
    over the memory rate, in seconds."""
    return max(ses_ops(T, G, C) / PEAK_SES_FLOPS, ses_bytes(T, C) / PEAK_BYTES)
