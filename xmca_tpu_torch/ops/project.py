"""The +-1 Rule-N back-projection on the card (kernel ``csrc/pm1_project.cu``).

:func:`pm1_project` computes ``(X^T S_pad)[:p]`` of a padded +-1 int8
surrogate field in one pass over the field: each element is converted to
f32 in the kernel's registers, so no f32 copy of any part of the field
exists in device memory.  Products and sums are f32 (a +-1 times an f32
value is exact), summed in chunks of rows.  Its plain version is
:func:`xmca_tpu_torch.core.fastpath._pm1_project_plain` (the field cast
to f32 in column blocks, each multiplied with torch), which a CPU field
takes; :func:`xmca_tpu_torch.core.fastpath._pm1_project` routes by
device.
"""
import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.utils import trace

__all__ = ['pm1_project', 'passes']

# columns of S one launch holds: 20 ([Re, Im] of 10 complexified modes)
# or 10 (10 real modes); any other width takes several launches
WIDE, NARROW = 20, 10


def passes(m):
    """``(j0, width)`` of each launch over ``m`` columns of S: tiles of
    ``WIDE`` columns while more than ``NARROW`` remain, then one of
    ``NARROW`` or ``WIDE`` (the last tile's columns past ``m`` are
    zeros the kernel does not write)."""
    out, j0 = [], 0
    while j0 < m:
        width = NARROW if m - j0 <= NARROW else WIDE
        out.append((j0, width))
        j0 += width
    return out


def _check(X, S_pad, p):
    if X.dtype != torch.int8 or X.dim() != 2:
        raise ValueError('pm1_project takes a 2-D int8 field, not {} {}'
                         .format(tuple(X.shape), X.dtype))
    n_pad, p_pad = X.shape
    if (S_pad.dtype != torch.float32 or S_pad.dim() != 2
            or S_pad.shape[0] != n_pad or S_pad.shape[1] < 1):
        raise ValueError('pm1_project takes float32 weights (n_pad, m) with '
                         'n_pad = {} and m >= 1, not {} {}'.format(
                             n_pad, tuple(S_pad.shape), S_pad.dtype))
    if not (1 <= n_pad < 2 ** 31 and 1 <= p_pad < 2 ** 31
            and p_pad % 16 == 0):
        raise ValueError('pm1_project takes 1 <= n_pad < 2^31 rows and a '
                         'multiple of 16 below 2^31 columns; got {}'
                         .format((n_pad, p_pad)))
    if not 1 <= p <= p_pad:
        raise ValueError('pm1_project keeps 1 <= p <= {} columns, not {}'
                         .format(p_pad, p))
    if not (X.is_contiguous() and S_pad.is_contiguous()):
        raise ValueError('pm1_project takes a contiguous field and '
                         'contiguous weights')
    if X.device.type != 'cuda':
        raise ValueError('pm1_project runs on a CUDA device, not {}; the CPU '
                         'takes core.fastpath._pm1_project_plain'
                         .format(X.device))
    if S_pad.device != X.device:
        raise ValueError('pm1_project: the weights are on {}, the field on {}'
                         .format(S_pad.device, X.device))
    if X.data_ptr() % 16:
        raise ValueError('pm1_project copies the field in 16-byte pieces: '
                         'its data must be 16-byte aligned')


def pm1_project(X, S_pad, p):
    """``(X^T S_pad)[:p]`` (p, m) float32 of a contiguous int8 field ``X``
    (n_pad, p_pad) and contiguous float32 weights ``S_pad`` (n_pad, m), on
    a CUDA device; ``p_pad`` a multiple of 16 (the padded layout's 128
    is), ``1 <= p <= p_pad``.  One launch per tile of :func:`passes` (one
    for m <= 20), each counted as a ``pm1_project`` launch; raises before
    any launch on anything else."""
    _check(X, S_pad, p)
    n_pad, p_pad = X.shape
    m = S_pad.shape[1]
    lib = _build.library()
    out = torch.empty((p, m), dtype=torch.float32, device=X.device)
    for j0, width in passes(m):
        err = lib.xmca_pm1_project(X.data_ptr(), p_pad, n_pad, p,
                                   S_pad.data_ptr(), m, j0, width,
                                   out.data_ptr(), _build.stream_of(X))
        _build.check(err, 'pm1_project')
        trace.count('launches', 'pm1_project')
    return out
