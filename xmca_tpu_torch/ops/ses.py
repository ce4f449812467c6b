"""The theta method's SES sweeps on the card (kernel ``csrc/ses_sweep.cu``).

:func:`ses_sweep` is one launch for one sweep of simple exponential
smoothing over every series of a ``(T, p)`` field at every point of a
grid of smoothing parameters, with each series' SSE-least point chosen in
the same launch: the states of a (series, grid point) stay in the
kernel's registers, and only the chosen point's index, alpha and level
``l_T`` are written.  Its plain version is
:func:`xmca_tpu_torch.core.theta._ses_sweep` (a loop of tensor
operations a step, then ``argmin``), which a CPU tensor takes;
:func:`xmca_tpu_torch.core.theta._ses_fit` routes by device.  The kernel
rounds every operation as that loop does on the card, so both choose the
same points and give the same alpha bit for bit.
"""
import torch

from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.ops.syrk import data_ptr
from xmca_tpu_torch.utils import trace

__all__ = ['ses_sweep', 'MAX_GRID']

# a block's grid points: 8 warps of 6 (the theta fit's 33-point coarse
# grid takes 6 warps, its 17-point refined grid 3)
MAX_GRID = 48


def _check(y, alphas, best, offsets, clip):
    if y.dtype not in (torch.float32, torch.float64) or y.dim() != 2:
        raise ValueError('ses_sweep takes a 2-D float32 or float64 series, '
                         'not {} {}'.format(tuple(y.shape), y.dtype))
    T, p = y.shape
    if T < 1 or p < 1 or p >= 2 ** 31 or T >= 2 ** 31:
        raise ValueError('ses_sweep takes 1 <= T, p < 2^31; got ({}, {})'
                         .format(T, p))
    if not (best is None) == (offsets is None) == (clip is None):
        raise ValueError('ses_sweep: a refined grid takes best, offsets and '
                         'clip')
    G = len(alphas if best is None else offsets)
    if not 1 <= G <= MAX_GRID:
        raise ValueError('ses_sweep sweeps 1 to {} grid points, not {}'
                         .format(MAX_GRID, G))
    if y.device.type != 'cuda':
        raise ValueError('ses_sweep runs on a CUDA device, not {}; the CPU '
                         'takes core.theta._ses_sweep'.format(y.device))
    if not y.is_contiguous():
        raise ValueError('ses_sweep takes a contiguous (T, p) series')
    for name, t, dtype, n in (('alphas', alphas, torch.float64, None),
                              ('offsets', offsets, torch.float64, None),
                              ('best', best, torch.int64, p)):
        if t is None:
            continue
        if (t.dtype != dtype or t.dim() != 1 or t.device != y.device
                or not t.is_contiguous() or (n is not None and len(t) != n)):
            raise ValueError('ses_sweep: {} must be a contiguous 1-D {} on '
                             '{}{}'.format(name, dtype, y.device,
                                           '' if n is None else
                                           ' of length {}'.format(n)))
    return G


def ses_sweep(y, alphas, best=None, offsets=None, clip=None, states=False):
    """One SES sweep of every column of ``y`` (T, p), float32 or float64,
    contiguous, on a CUDA device; the arithmetic is float64.

    The grid is ``alphas`` (G,) float64, shared by every column; or, with
    ``best`` (p,) int64 indices into ``alphas``, ``offsets`` (G,) float64
    and ``clip = (lo, hi)``, column c's points ``clamp(alphas[best[c]] +
    offsets, lo, hi)``; 1 <= G <= ``MAX_GRID``.  Returns
    ``(best (p,) int64, alpha (p,) float64, level (p,) float64)``: each
    column's first SSE-least point, its alpha and its ``l_T`` at the
    SSE-optimal initial level; with ``states`` also ``(sse (G, p), l_T
    (G, p))`` float64 at every point.
    """
    G = _check(y, alphas, best, offsets, clip)
    T, p = y.shape
    lo, hi = clip or (0.0, 0.0)
    lib = _build.library()
    f64 = dict(dtype=torch.float64, device=y.device)
    out = (torch.empty(p, dtype=torch.int64, device=y.device),
           torch.empty(p, **f64), torch.empty(p, **f64))
    full = ((torch.empty((G, p), **f64), torch.empty((G, p), **f64))
            if states else (None, None))
    err = lib.xmca_ses_sweep(
        y.data_ptr(), int(y.dtype == torch.float64), T, p, alphas.data_ptr(),
        G, data_ptr(best), data_ptr(offsets), lo, hi,
        *(t.data_ptr() for t in out),
        *(data_ptr(t) for t in full), _build.stream_of(y))
    _build.check(err, 'ses_sweep')
    trace.count('launches', 'ses_sweep')
    return out + full if states else out
