"""Least time of a complexified Rule-N run's n x n tail, from the logical
problem at the record's length n, whatever implements it.

Per run and field: the analytic fold of the real temporal Gram, ``H G``
and then ``(H G) H^T``, 2 n^3 real multiply-adds; and the Cholesky factor
of the folded Hermitian Gram, n^3 / 6 complex multiply-adds (LAPACK's
``zpotrf``).  Then one product of the two triangular factors, ``M = La^H
Lb``, n^3 / 3 complex multiply-adds.  A real multiply-add is 2
operations, a complex one 8: 2 (4 n^3 + 4 n^3 / 3) + 8 n^3 / 3 = 40 n^3
/ 3 operations a run.  Bytes: the two float32 Grams and H read once, the
complex64 ``M`` written once.

The peaks are one NVIDIA H100 SXM's, NVIDIA's data sheet: 67 TFLOP/s,
its float32 rate outside the tensor cores (the configuration's float32
with TF32 off), and 3.35 TB/s of HBM (:data:`perfbench.roofline.
PEAK_BYTES`).  The share's time is the device time of the tail's
``fold`` and ``reduce`` spans, which hold that work.
"""
from perfbench.program_trace import device_ms_per_run
from perfbench.roofline import PEAK_BYTES

PEAK_F32_FLOPS = 67e12
# the spans of the n x n tail (xmca_tpu_torch.core.fastpath), and those
# of them that hold the work the roofline counts
TAIL_SPANS = ('fold', 'reduce', 'recover')
COUNTED_SPANS = ('fold', 'reduce')


def tail_ops(n):
    """Operations of one run's folds, Cholesky factors and reduced kernel
    at record length n: 40 n^3 / 3."""
    fold = 2 * n ** 3 * 2
    factor = n ** 3 / 6 * 8
    reduce = n ** 3 / 3 * 8
    return 2 * (fold + factor) + reduce


def tail_bytes(n):
    """Two float32 n x n Grams and H read once, the complex64 n x n
    kernel written once."""
    return 3 * 4 * n * n + 8 * n * n


def tail_least_s(n):
    """The larger of the run's operations over 67 TFLOP/s and its bytes
    over the memory rate, in seconds."""
    return max(tail_ops(n) / PEAK_F32_FLOPS, tail_bytes(n) / PEAK_BYTES)


def spans_ms_per_run(ctx, names):
    """Summed device ms a Rule-N run spends in the spans ``names``, or
    None where the program records none of them."""
    ms = [device_ms_per_run(ctx, name, 'rule_n') for name in names]
    ms = [m for m in ms if m is not None]
    return sum(ms) if ms else None
