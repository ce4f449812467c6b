"""Batched Theta-method forecasts on tensors (``extend='theta'``).

Counterpart of ``xmca_tpu/core/theta.py``: every column of a ``(T, p)``
field is deseasonalized (classical moving-average decomposition,
multiplicative for strictly positive columns, additive otherwise), fitted
by simple exponential smoothing (SSE over a 33-point alpha grid, then a
17-point refinement around each column's best point, the initial level
optimal in closed form) and forecast with the Theta drift
``l_T + (theta-1)/theta * b0 * (h - 1 + 1/a - (1-a)^T/a)``, re-seasonalized.

The JAX package's ``lax.scan`` over time has two routes here, chosen by
the field's device (:func:`_ses_fit`).  On a CUDA device each SES sweep
is one launch of a hand-written kernel (:func:`xmca_tpu_torch.ops.ses.
ses_sweep`) that keeps every series' states in registers and chooses
its best grid point itself.  On the CPU, the plain version
(:func:`_ses_sweep`) is a Python loop of batched tensor operations: six
elementwise launches a step, each over all columns and grid points at
once, so one forecast costs about ``2 x 6 T`` launches.  Both sweep in
float64 and round alike, so they choose the same grid points.

Under a profiler (:mod:`xmca_tpu_torch.utils.trace`) a forecast records
a ``seasonal`` span (the seasonal component and the deseasonalized
series) and one ``ses`` span a sweep, with its ``steps``, ``grid``
(smoothing parameters a column: 33 coarse, 17 refined), ``columns`` and
``route`` (``'kernel'`` or ``'plain'``).
"""
import numpy as np
import torch

from xmca_tpu_torch.ops import ses
from xmca_tpu_torch.utils import trace

__all__ = ['theta_forecast']

# the SES fit's smoothing parameters: a coarse grid of 33 points of
# [0.02, 0.98], then 17 across one coarse spacing either side of each
# column's best point, clipped to ALPHA_CLIP
ALPHA_RANGE, N_ALPHAS, N_REFINE = (0.02, 0.98), 33, 17
ALPHA_CLIP = (1e-4, 1.0 - 1e-6)


# rows of the trend formed by one banded product: the band matrix stays
# (2048, 2048 + period) however long the record
_BAND_ROWS = 2048


def _moving_average(y, w):
    """'valid' correlation of every column of ``y (T, p)`` with the
    weights ``w``: ``trend[i] = sum_k w[k] y[i + k]``, as banded products
    over blocks of at most ``_BAND_ROWS`` rows."""
    T, p = y.shape
    L = len(w)
    n_valid = T - L + 1
    rows = min(n_valid, _BAND_ROWS)
    band = np.zeros((rows, rows + L - 1))
    for i, wi in enumerate(w):
        band[np.arange(rows), np.arange(rows) + i] = wi
    band = torch.as_tensor(band, dtype=y.dtype, device=y.device)
    out = y.new_empty((n_valid, p))
    for r0 in range(0, n_valid, rows):
        r = min(rows, n_valid - r0)
        out[r0:r0 + r] = band[:r, :r + L - 1] @ y[r0:r0 + r + L - 1]
    return out


def _seasonal_component(y, period):
    """Classical decomposition seasonal component per column of ``y (T,
    p)``: ``(additive (period, p), multiplicative (period, p), usable_mul
    (p,) bool)``.

    The trend is the centered moving average (half weights at both ends
    for an even period): the 'valid' part of a correlation with a
    symmetric kernel, so of its convolution too (:func:`_moving_average`).
    """
    T, p = y.shape
    if period % 2 == 0:
        w = np.ones(period + 1)
        w[0] = w[-1] = 0.5
        w /= period
    else:
        w = np.ones(period) / period
    half = len(w) // 2
    trend = _moving_average(y, w)

    yv = y[half:T - half]
    phases_v = torch.arange(half, T - half, device=y.device) % period
    detr_add = yv - trend
    safe_trend = torch.where(trend.abs() > 1e-12, trend, 1.0)
    detr_mul = yv / safe_trend

    # per-phase means
    onehot = (phases_v[:, None] == torch.arange(period, device=y.device)
              [None, :]).to(y.dtype)
    counts = onehot.sum(dim=0)
    sa = (onehot.T @ detr_add) / counts[:, None]
    sm = (onehot.T @ detr_mul) / counts[:, None]

    sa = sa - sa.mean(dim=0, keepdim=True)
    sm_mean = sm.mean(dim=0, keepdim=True)
    sm = sm / torch.where(sm_mean.abs() > 1e-12, sm_mean, 1.0)
    usable_mul = y.amin(dim=0) > 0
    return sa, sm, usable_mul


def _ses_sweep(y, alphas):
    """SSE-optimal simple exponential smoothing of every column of ``y
    (T, p)`` at each smoothing parameter of ``alphas``: ``(G,)`` shared by
    all columns, or ``(G, p)`` one grid per column.

    The level is affine in the initial level ``l0``: ``level_t = p_t +
    h_t l0`` with ``p_t = (1-a) p_{t-1} + a y_t`` from ``p_0 = 0`` and
    ``h_t = (1-a)^t``, so the one-step residuals are linear in ``l0`` and
    its SSE-optimal value is closed form.  Returns ``(sse (G, p), l_T (G,
    p))`` at the optimal ``l0`` of each grid point.
    """
    T, p = y.shape
    a = alphas[:, None] if alphas.dim() == 1 else alphas
    with trace.span('ses', steps=T, grid=a.shape[0], columns=p,
                    route='plain'):
        keep = 1.0 - a
        part = y.new_zeros((a.shape[0], p))
        h = torch.ones_like(a)
        s_cc = torch.zeros_like(part)
        s_hc = torch.zeros_like(part)
        s_h2 = torch.zeros_like(a)
        for t in range(T):
            c = y[t] - part                     # residual at l0 = 0
            s_cc.addcmul_(c, c)
            s_hc.addcmul_(h, c)
            s_h2.addcmul_(h, h)
            part.addcmul_(a, c)
            h.mul_(keep)
        l0_opt = s_hc / s_h2
        sse = s_cc - s_hc * s_hc / s_h2
        return sse, part + h * l0_opt


def _ses_fit(y):
    """Batched SES fit of every column: ``(alpha (p,), level l_T (p,))``.

    A coarse sweep over the ``N_ALPHAS`` points of ``ALPHA_RANGE``, then
    one refinement sweep of ``N_REFINE`` points spanning one coarse
    spacing either side of each column's best point, clipped to
    ``ALPHA_CLIP``; ties go to the first index (``argmin``).  A CUDA
    tensor takes the kernel (:func:`_ses_fit_kernel`), any other the
    plain loop (:func:`_ses_fit_plain`).

    The sweeps run in float64 whatever ``y``'s dtype (the JAX package
    sweeps in the field's): the argmin picks a discrete alpha among SSEs
    that can nearly tie, and float32 sums pick a neighbouring grid point
    for some columns, which moves their forecasts by up to ~1e-2 of the
    column's std.  ``alpha`` and ``l_T`` come back in ``y``'s dtype.
    """
    lo, hi = ALPHA_RANGE
    coarse = torch.as_tensor(np.linspace(lo, hi, N_ALPHAS),
                             dtype=torch.float64, device=y.device)
    spacing = (hi - lo) / (N_ALPHAS - 1)
    offsets = torch.as_tensor(np.linspace(-spacing, spacing, N_REFINE),
                              dtype=torch.float64, device=y.device)
    fit = _ses_fit_kernel if y.is_cuda else _ses_fit_plain
    alpha, level = fit(y, coarse, offsets)
    return alpha.to(y.dtype), level.to(y.dtype)


def _ses_fit_plain(y, coarse, offsets):
    """The fit as tensor operations on any device: float64 ``(alpha,
    l_T)`` of the coarse grid ``coarse`` refined by ``offsets``."""
    y = y.to(torch.float64)
    sse, _ = _ses_sweep(y, coarse)
    best = torch.argmin(sse, dim=0)
    fine = torch.clamp(coarse[best][None, :] + offsets[:, None],
                       *ALPHA_CLIP)
    sse_f, l_T_f = _ses_sweep(y, fine)
    best_f = torch.argmin(sse_f, dim=0)[None, :]
    return (torch.take_along_dim(fine, best_f, dim=0)[0],
            torch.take_along_dim(l_T_f, best_f, dim=0)[0])


def _ses_fit_kernel(y, coarse, offsets):
    """The fit as two kernel launches on a CUDA device, one a sweep: the
    coarse one writes each column's best index, the refined one builds
    each column's points from it and writes alpha and ``l_T``.  A float32
    or float64 series is read as it is; a half-precision one is widened
    to float32, which is exact."""
    T, p = y.shape
    if y.dtype in (torch.float16, torch.bfloat16):
        y = y.float()
    y = y.contiguous()
    with trace.span('ses', steps=T, grid=len(coarse), columns=p,
                    route='kernel'):
        best, _, _ = ses.ses_sweep(y, coarse)
    with trace.span('ses', steps=T, grid=len(offsets), columns=p,
                    route='kernel'):
        _, alpha, level = ses.ses_sweep(y, coarse, best, offsets,
                                        clip=ALPHA_CLIP)
    return alpha, level


def theta_forecast(field, steps, period=1, theta=20.0):
    """Forecast every column of ``field (T, p)`` ``steps`` steps ahead;
    deseasonalized when ``period > 1`` and ``T >= 2 period``."""
    y = field.real
    T, p = y.shape
    deseasonalize = period is not None and period > 1 and T >= 2 * period
    if deseasonalize:
        with trace.span('seasonal', period=period, columns=p):
            sa, sm, usable_mul = _seasonal_component(y, period)
            phases = torch.arange(T, device=y.device) % period
            seas_mul = sm[phases]
            safe_mul = torch.where(seas_mul.abs() > 1e-12, seas_mul, 1.0)
            y_ds = torch.where(usable_mul[None, :], y / safe_mul,
                               y - sa[phases])
            del seas_mul, safe_mul
    else:
        y_ds = y

    alpha, l_T = _ses_fit(y_ds)

    # OLS trend slope of the deseasonalized series
    t = torch.arange(T, dtype=y.dtype, device=y.device)
    tc = t - (T - 1) / 2.0
    tvar = torch.mean(tc ** 2)
    b0 = (tc @ (y_ds - y_ds.mean(dim=0))) / (T * tvar)

    h = torch.arange(1, steps + 1, dtype=y.dtype, device=y.device)[:, None]
    drift = h - 1.0 + 1.0 / alpha[None, :] - ((1.0 - alpha) ** T
                                              / alpha)[None, :]
    fc = l_T[None, :] + (theta - 1.0) / theta * b0[None, :] * drift
    if deseasonalize:
        fut = (T + torch.arange(steps, device=y.device)) % period
        fc = torch.where(usable_mul[None, :], fc * sm[fut], fc + sa[fut])
    return fc.to(field.dtype)
