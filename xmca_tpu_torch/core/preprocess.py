"""Centering, standardization and Hilbert complexification on tensors.

Counterpart of ``xmca_tpu/core/preprocess.py``.  The analytic signal is a
batched ``torch.fft`` over all columns.  Boundary extension
(``extend='exp'/'theta'``) and the circulant path for time axes longer
than 8192 steps are not ported yet.
"""
import numpy as np
import torch

__all__ = ['center', 'standardize', 'analytic_signal', 'complexify']


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


def analytic_signal(x):
    """Analytic signal of ``x (time, space)`` along dim 0
    (``scipy.signal.hilbert(x, axis=0)``)."""
    n = x.shape[0]
    h = torch.as_tensor(_analytic_weights(n, np.float64), device=x.device)
    Xf = torch.fft.fft(x, dim=0)
    Xf *= h.to(Xf.real.dtype)[:, None]      # in place: one spectrum held
    return torch.fft.ifft(Xf, dim=0)


def complexify(field, extend=False, period=1):
    """Hilbert-complexify a centered field (no boundary extension)."""
    if extend:
        raise NotImplementedError(
            "complexify(extend={!r}) is not ported yet (ROADMAP queue 1, "
            "'Extensions')".format(extend))
    return analytic_signal(field.real)


def center(field):
    """Remove the temporal mean."""
    return field - field.mean(dim=0)


def standardize(field, std):
    """Divide by a per-column standard deviation."""
    return field / std
