"""Centering, standardization, boundary extension and Hilbert
complexification on tensors.

Counterpart of ``xmca_tpu/core/preprocess.py``.  The analytic signal is a
batched ``torch.fft`` over column chunks, exact at any time length (cuFFT
takes lengths with large prime factors itself), so the JAX package's
circulant power-of-two path for axes longer than 8192 steps has no
counterpart here.  ``complexify(extend='exp'|'theta')`` forecasts and
backcasts every column (:func:`exp_forecast`,
:func:`xmca_tpu_torch.core.theta.theta_forecast`) and takes the analytic
signal of the tripled record.

Under a profiler (:mod:`xmca_tpu_torch.utils.trace`) an extended
``complexify`` is an ``extend`` span (its ``method``, the ``columns``
forecast and backcast, the ``steps`` of each) up to the tripled record,
then an ``analytic`` span (its FFT ``chunks``) for the record's analytic
signal, cut and re-centered.  :func:`extend_field` counts the series it
continues in ``trace.counters()['forecast_columns']``, by method.
"""
import numpy as np
import torch

from xmca_tpu_torch.core.theta import theta_forecast
from xmca_tpu_torch.utils import trace

__all__ = ['center', 'standardize', 'analytic_signal', 'complexify',
           'exp_forecast', 'extend_field', 'check_extension']

# most elements of one column chunk of the analytic signal: a record of
# up to 2^28 elements takes one batched FFT; a longer one goes in equal
# chunks (one cuFFT plan), so its spectrum and the FFT's workspace stay
# ~2 GB each (complex64) however long the record
_CHUNK_ELEMS = 1 << 28


def _analytic_weights(n, dtype):
    """FFT weights of the analytic-signal transform (scipy.signal.hilbert)."""
    h = np.zeros(n, dtype=dtype)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return h


def _n_chunks(n, p):
    """Column chunks of the analytic signal of an (n, p) field."""
    return -(-n * p // _CHUNK_ELEMS)


def analytic_signal(x):
    """Analytic signal of ``x (time, space)`` along dim 0
    (``scipy.signal.hilbert(x, axis=0)``), one column chunk at a time
    into the complex output."""
    n, p = x.shape
    if p == 0:
        # a rank's empty share of a space-axis resample
        return torch.complex(x, torch.zeros_like(x))
    h = torch.as_tensor(_analytic_weights(n, np.float64), device=x.device)
    n_chunks = _n_chunks(n, p)
    chunk = -(-p // n_chunks)
    out = None
    for c0 in range(0, p, chunk):
        Xf = torch.fft.fft(x[:, c0:c0 + chunk], dim=0)
        Xf *= h.to(Xf.real.dtype)[:, None]      # in place: one spectrum
        Z = torch.fft.ifft(Xf, dim=0)
        if n_chunks == 1:
            return Z
        if out is None:
            out = torch.empty((n, p), dtype=Z.dtype, device=x.device)
        out[:, c0:c0 + chunk] = Z
    return out


def exp_forecast(field, period):
    """Linear + decaying-exponential continuation of every column of
    ``field (n, p)`` for ``n`` steps: the OLS trend (slope ``cov / var(x)``,
    where the reference's helper divides by ``mean(x)**2``), continued,
    plus the end-point offset decaying with e-folding time ``period``."""
    n = field.shape[0]
    x = torch.arange(n, dtype=field.dtype, device=field.device)
    xc = x - (n - 1) / 2.0
    xvar = torch.mean(xc ** 2)
    ymean = field.mean(dim=0)
    slope = (xc @ (field - ymean)) / n / xvar
    intercept = ymean - (n - 1) / 2.0 * slope
    linear_end = slope * x[-1] + intercept
    offset = field[-1] - linear_end
    # start at 1: exp(0) would duplicate the final sample
    exp_ext = offset[None, :] * torch.exp(-(x + 1.0)[:, None] / period)
    return exp_ext + (slope[None, :] * x[:, None] + linear_end[None, :])


def check_extension(method):
    """Raise the reference's ``ValueError`` unless ``method`` is 'exp' or
    'theta'."""
    if method not in ('exp', 'theta'):
        raise ValueError(
            '{:} is not a valid extension. Choose either `exp` or `theta`.'
            .format(method))


def extend_field(field, method, period):
    """Forecast continuation of every column (``method`` 'exp' or
    'theta'); backcasts are forecasts of the time-flipped field."""
    check_extension(method)
    trace.count('forecast_columns', method, field.shape[1])
    if method == 'theta':
        return theta_forecast(field, steps=field.shape[0],
                              period=int(period), theta=20.0)
    return exp_forecast(field, float(period))


def complexify(field, extend=False, period=1):
    """Hilbert-complexify a centered field; with ``extend`` ('exp' or
    'theta') the analytic signal of [backcast | field | forecast] is cut
    back to the middle third and re-centered."""
    field = field.real
    if not extend or field.shape[1] == 0:
        return analytic_signal(field)
    n, p = field.shape
    with trace.span('extend', method=extend, columns=2 * p, steps=n):
        # forecast and backcast in one batched call: the columns of
        # [field | flipped field] are independent series
        ext = extend_field(torch.cat([field, field.flip(0)], dim=1), extend,
                           period)
        full = torch.cat([ext[:, p:].flip(0), field, ext[:, :p]], dim=0)
        del ext
    with trace.span('analytic', chunks=_n_chunks(3 * n, p)):
        analytic = analytic_signal(full)[n:2 * n]
        return analytic - analytic.mean(dim=0)


def center(field):
    """Remove the temporal mean."""
    return field - field.mean(dim=0)


def standardize(field, std):
    """Divide by a per-column standard deviation."""
    return field / std
