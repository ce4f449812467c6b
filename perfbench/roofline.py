"""Least times of the kernels the per-layer metrics read, from the
logical problem's shapes (never a padded layout of the program).

Peaks: one NVIDIA H100 SXM at 700 W, NVIDIA's data sheet, dense rates:
1979 TOP/s int8 and 3.35 TB/s of HBM.  A share is the least time over
the measured device time; it is printed beside the card's power limit.
"""

PEAK_OPS = {'int8': 1979e12}
PEAK_BYTES = 3.35e12


def least_time_s(ops, nbytes, kind):
    """The larger of ``ops`` over the peak of ``kind`` and ``nbytes``
    over the memory rate, in seconds."""
    return max(ops / PEAK_OPS[kind], nbytes / PEAK_BYTES)


def gram_ops(n, p):
    """Operations of the lower triangle of an (n, n) Gram over p
    columns: n (n + 1) / 2 p multiply-adds, two operations each."""
    return n * (n + 1) / 2 * p * 2


def gram_bytes(n, p, in_bytes=1):
    """An (n, p) field read once (int8: one byte an entry) and the
    n (n + 1) / 2 float32 triangle written once."""
    return n * p * in_bytes + n * (n + 1) / 2 * 4


def pm1_gram_least_s(n, p):
    """Least time of the Gram of one +-1 (n, p) field on the int8 peak:
    +-1 entries are exact in int8, the highest peak any implementation
    of this Gram could use."""
    return least_time_s(gram_ops(n, p), gram_bytes(n, p), 'int8')
