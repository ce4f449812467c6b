"""Centering, standardization and Hilbert complexification on tensors.

Counterpart of ``xmca_tpu/core/preprocess.py``.  The analytic signal is a
batched ``torch.fft`` over column chunks, exact at any time length (cuFFT
takes lengths with large prime factors itself), so the JAX package's
circulant power-of-two path for axes longer than 8192 steps has no
counterpart here.  Boundary extension (``extend='exp'/'theta'``) is not
ported yet.
"""
import numpy as np
import torch

__all__ = ['center', 'standardize', 'analytic_signal', 'complexify']

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


def analytic_signal(x):
    """Analytic signal of ``x (time, space)`` along dim 0
    (``scipy.signal.hilbert(x, axis=0)``), one column chunk at a time
    into the complex output."""
    n, p = x.shape
    h = torch.as_tensor(_analytic_weights(n, np.float64), device=x.device)
    n_chunks = -(-n * p // _CHUNK_ELEMS)
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
