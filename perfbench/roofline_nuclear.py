"""Least time of the Newton-Schulz nuclear norm that totals an unrotated
Rule-N run, from the logical problem, whatever implements it.

The total is ``Re tr(W^H M)`` of the polar iterate ``W`` of the run's
complex n x n reduced kernel ``M``.  Each cubic step ``W <- a W - b W
(W^H W)`` of the iterate takes the Hermitian ``W^H W``, n^3 / 2 complex
multiply-adds (one triangle), and ``W (W^H W)``, n^3; the trace reads
``W``'s and ``M``'s diagonal products, n^2.  A complex multiply-add is 8
operations, so a span of ``steps`` steps is 8 (3 n^3 / 2 steps + n^2)
operations: at n = 2000 and 20 steps 1.92e12, 28.7 ms.  Bytes: each step
reads the complex64 iterate and writes the next one; the trace reads
``W`` and ``M`` once.  Since the Hermitian product is counted at half, a
kernel that forms only its triangle cannot read above 100%.

The peaks are one NVIDIA H100 SXM's, NVIDIA's data sheet: 67 TFLOP/s, its
float32 rate outside the tensor cores (the configuration's float32 with
TF32 off), and 3.35 TB/s of HBM (:data:`perfbench.roofline.PEAK_BYTES`).
The share's time is the device time of the program's ``nuclear`` spans,
each of which holds one such norm and names its ``steps``.
"""
from perfbench.program_trace import analysis, under_run
from perfbench.roofline import PEAK_BYTES
from perfbench.roofline_tail import PEAK_F32_FLOPS

# bytes of a complex64 entry
C64 = 8


def nuclear_ops(n, steps):
    """Operations of ``steps`` cubic steps of an n x n complex iterate
    and the trace: 8 (3 n^3 / 2 steps + n^2)."""
    return 8 * (1.5 * n ** 3 * steps + n ** 2)


def nuclear_bytes(n, steps):
    """The complex64 iterate read and written once a step, then ``W`` and
    ``M`` read once for the trace."""
    return C64 * n * n * (2 * steps + 2)


def nuclear_least_s(n, steps):
    """The larger of the operations over 67 TFLOP/s and the bytes over
    the memory rate, in seconds."""
    return max(nuclear_ops(n, steps) / PEAK_F32_FLOPS,
               nuclear_bytes(n, steps) / PEAK_BYTES)


def nuclear_spans(ctx):
    """The ``nuclear`` spans with a device time under the window's Rule-N
    runs, or None where the program records none."""
    a = analysis(ctx)
    if a is None:
        return None
    spans = [s for s in a['spans'] if s['name'] == 'nuclear'
             and s['device_ms'] is not None and under_run(a, s, 'rule_n')]
    return spans or None
