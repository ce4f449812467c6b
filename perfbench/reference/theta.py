"""Plain PyTorch reference of boundary extension by the theta method and
of one bootstrap run of a model solved with it.

It imports nothing of the package under test and takes nothing the
package made.  Written from the method's description, in the precision
it is given (float64; the control runs it in float32 with TF32
products), with TF32 off for its Grams:

* the theta method (Assimakopoulos & Nikolopoulos 2000) in the form
  statsmodels' ``ThetaModel`` implements, with theta = 20: the series is
  deseasonalized by a classical moving-average decomposition of period
  ``period`` (multiplicative for a strictly positive series, additive
  otherwise), simple exponential smoothing (SES) gives the level
  ``l_T``, the drift ``b0`` is the least-squares slope of the
  deseasonalized series on time, and the forecast ``h`` steps ahead is
  ``l_T + (1 - 1/theta) b0 (h - 1 + 1/alpha - (1 - alpha)^T / alpha)``,
  reseasonalized;
* the backcast: the forecast of the time-flipped series, flipped back;
* the analytic signal of the tripled record ``[backcast | field |
  forecast]`` as one (3n x 3n) matrix product, from the discrete
  analytic signal's circulant kernel summed in closed form (no FFT), cut
  back to its middle third and re-centered.

Departures from statsmodels, each the package's documented choice:

* SES's smoothing parameter ``alpha`` is chosen on a grid, not by an
  optimizer: 33 points evenly over [0.02, 0.98], then 17 points evenly
  over one coarse spacing either side of each series' best point,
  clipped to [1e-4, 1 - 1e-6]; a tie goes to the first point;
* the initial level is the one that minimizes the sum of squared
  one-step errors at each ``alpha``, in closed form (the errors are
  affine in it), where statsmodels optimizes it with ``alpha``;
* a record shorter than two periods is not deseasonalized.

Here each SES sweep is a matrix product: the one-step errors of a
series ``y`` at ``alpha`` and initial level ``l0`` are ``R y - l0 h``,
``R`` the identity less the smoother's strictly lower-triangular
weights ``alpha (1 - alpha)^(t - 1 - j)`` and ``h_t = (1 - alpha)^t``.
"""
import math

import numpy as np
import torch

from perfbench.reference import mca

THETA = 20.0
COARSE = np.linspace(0.02, 0.98, 33)
REFINE = 17
ALPHA_CLIP = (1e-4, 1.0 - 1e-6)
# series a block of the SES sweeps holds; columns a block of a field's
# extension holds (two series each: its forecast and its backcast)
SWEEP_SERIES = 16384
EXTEND_COLS = 1 << 19


def seasonal_factors(y, period):
    """Per-phase factors of the classical decomposition of every column
    of ``y (T, C)``: ``(additive (period, C), multiplicative (period,
    C))``.  The trend is the centered moving average (weights 1/period,
    halved at both ends of an even period's period + 1 points), defined
    where the whole window lies in the record; a phase's factor is the
    mean of the detrended values at that phase there, normalized to sum
    to zero (additive) or to average one (multiplicative).  Both the
    moving average and the phase means are matrix products."""
    T = y.shape[0]
    if period % 2 == 0:
        w = [0.5] + [1.0] * (period - 1) + [0.5]
    else:
        w = [1.0] * period
    half = len(w) // 2
    rows = torch.arange(T - 2 * half, device=y.device)
    average = torch.zeros((len(rows), T), dtype=y.dtype, device=y.device)
    for k, wk in enumerate(w):
        average[rows, rows + k] = wk / period
    trend = average @ y
    mid = y[half:T - half]
    phase = (rows + half) % period
    means = (phase[:, None] == torch.arange(period, device=y.device)
             ).to(y.dtype)
    means = (means / means.sum(dim=0)).T        # (period, rows)
    add = means @ (mid - trend)
    mul = means @ (mid / trend)
    return add - add.mean(dim=0), mul / mul.mean(dim=0)


def _powers(alphas, T):
    """``(1 - alpha)^m`` for m = 0..T, shape (G, T + 1)."""
    m = torch.arange(T + 1, dtype=alphas.dtype, device=alphas.device)
    return (1.0 - alphas)[:, None] ** m[None, :]


def ses_operators(alphas, T):
    """For each smoothing parameter of ``alphas (G,)``: the error operator
    ``R (G, T, T)``, the initial level's weights ``h (G, T)`` in the
    errors, and the final level's weights ``w (G, T)`` on the series and
    ``hT (G,)`` on the initial level: ``l_T = w y + hT l0``."""
    T = int(T)
    pw = _powers(alphas, T)
    t = torch.arange(T, device=alphas.device)
    lag = t[:, None] - 1 - t[None, :]
    below = lag >= 0
    a = alphas[:, None, None]
    W = torch.where(below[None], a * pw[:, lag.clamp(min=0)],
                    torch.zeros((), dtype=alphas.dtype,
                                device=alphas.device))
    R = torch.eye(T, dtype=alphas.dtype, device=alphas.device)[None] - W
    w = alphas[:, None] * pw[:, T - 1 - t]
    return R, pw[:, :T], w, pw[:, T]


def ses_sse(y, alphas):
    """SES of every column of ``y (T, C)`` at each of ``alphas (G,)``
    with its best initial level: ``(sse (G, C), l_T (G, C))``."""
    R, h, w, hT = ses_operators(alphas, y.shape[0])
    # |E|^2 of the errors E = R y at l0 = 0, by halves of time (R's
    # upper-right block is zero), and h^T E as (h^T R) y
    top = y.shape[0] // 2
    ee = sum(torch.linalg.vector_norm(E, dim=1).square()
             for E in (R[:, :top, :top] @ y[:top], R[:, top:] @ y))
    hh = (h * h).sum(dim=1)[:, None]
    he = (h[:, None, :] @ R)[:, 0] @ y
    l0 = he / hh
    sse = ee - he * he / hh
    return sse, w @ y + hT[:, None] * l0


def ses_fit(y):
    """``(alpha (C,), l_T (C,))`` of every column of ``y (T, C)``: the
    coarse grid, then the refinement around each column's best point."""
    C = y.shape[1]
    coarse = torch.as_tensor(COARSE, dtype=y.dtype, device=y.device)
    best = torch.empty(C, dtype=torch.long, device=y.device)
    for c0 in range(0, C, SWEEP_SERIES):
        sse, _ = ses_sse(y[:, c0:c0 + SWEEP_SERIES], coarse)
        best[c0:c0 + SWEEP_SERIES] = torch.argmin(sse, dim=0)
    spacing = (COARSE[-1] - COARSE[0]) / (len(COARSE) - 1)
    offsets = torch.as_tensor(np.linspace(-spacing, spacing, REFINE),
                              dtype=y.dtype, device=y.device)
    alpha = torch.empty(C, dtype=y.dtype, device=y.device)
    level = torch.empty(C, dtype=y.dtype, device=y.device)
    # columns with the same best coarse point share their refined grid
    for k in torch.unique(best).tolist():
        cols = torch.nonzero(best == k).flatten()
        fine = torch.clamp(coarse[k] + offsets, *ALPHA_CLIP)
        for c0 in range(0, len(cols), SWEEP_SERIES):
            sel = cols[c0:c0 + SWEEP_SERIES]
            sse, l_T = ses_sse(y[:, sel], fine)
            i = torch.argmin(sse, dim=0)
            alpha[sel] = fine[i]
            level[sel] = torch.take_along_dim(l_T, i[None], dim=0)[0]
    return alpha, level


def theta_forecast(y, steps, period, theta=THETA):
    """The theta forecast of every column of ``y (T, C)``, ``steps``
    steps ahead (module docstring)."""
    T = y.shape[0]
    seasonal = period > 1 and T >= 2 * period
    if seasonal:
        add, mul = seasonal_factors(y, period)
        positive = y.amin(dim=0) > 0
        phase = torch.arange(T, device=y.device) % period
        y_ds = torch.where(positive[None, :], y / mul[phase], y - add[phase])
    else:
        y_ds = y
    alpha, level = ses_fit(y_ds)
    t = torch.arange(T, dtype=y.dtype, device=y.device)
    tc = t - t.mean()
    b0 = (tc @ (y_ds - y_ds.mean(dim=0))) / (tc @ tc)
    h = torch.arange(1, steps + 1, dtype=y.dtype, device=y.device)[:, None]
    drift = h - 1.0 + 1.0 / alpha - (1.0 - alpha) ** T / alpha
    fc = level + (1.0 - 1.0 / theta) * b0 * drift
    if seasonal:
        fut = (T + torch.arange(steps, device=y.device)) % period
        fc = torch.where(positive[None, :], fc * mul[fut], fc + add[fut])
    return fc


def analytic_rows(N, rows, dt, device):
    """Rows ``rows`` (a slice) of the (N x N) analytic-signal operator in
    ``dt``'s complex type: the circulant ``A[t, s] = a[(t - s) mod N]``
    with ``a[m] = sum_k g_k exp(2 pi i k m / N) / N``, ``g`` the analytic
    signal's spectral weights (1 at frequency 0 and, for even N, at N/2;
    2 at the positive frequencies; 0 at the negative ones), summed in
    float64 with each phase reduced mod N."""
    g = torch.as_tensor(mca.analytic_weights(N), dtype=torch.float64)
    k = torch.arange(N, dtype=torch.int64)
    phase = (k[:, None] * k[None, :]) % N
    ang = (2 * math.pi / N) * phase.to(torch.float64)
    a = torch.complex((torch.cos(ang) * g[None, :]).sum(dim=1),
                      (torch.sin(ang) * g[None, :]).sum(dim=1)) / N
    t = torch.arange(N)[rows]
    A = a[(t[:, None] - torch.arange(N)[None, :]) % N]
    return A.to(device, mca.complex_of(dt))


def extended_signal(x, period, A_mid=None, cols=EXTEND_COLS):
    """The extended analytic signal of a centered field ``x (n, p)``, one
    block of ``cols`` columns at a time: each column's theta forecast and
    backcast of ``n`` steps, the middle third of the tripled record's
    analytic signal (``A_mid``: rows n..2n of the (3n x 3n) operator,
    built when not given), re-centered.  Returns ``Z (n, p)`` complex."""
    n, p = x.shape
    if A_mid is None:
        A_mid = analytic_rows(3 * n, slice(n, 2 * n), x.dtype, x.device)
    Z = torch.empty((n, p), dtype=A_mid.dtype, device=x.device)
    for c0 in range(0, p, cols):
        b = x[:, c0:c0 + cols]
        w = b.shape[1]
        fc = theta_forecast(torch.cat([b, b.flip(0)], dim=1), n, period)
        full = torch.cat([fc[:, w:].flip(0), b, fc[:, :w]], dim=0)
        z = torch.complex(A_mid.real @ full, A_mid.imag @ full)
        Z[:, c0:c0 + w] = z - z.mean(dim=0)
    return Z


def extended_side(x, period, A_mid, cols=EXTEND_COLS):
    """``(Z, Z Z^H)`` of a field re-centered and extended, the Gram summed
    over column blocks (:func:`mca.hermitian_gram`) with TF32 off
    whatever the caller set: the Gram of a resample is singular beyond
    the regularization, and a TF32 one is indefinite."""
    Z = extended_signal(x - x.mean(dim=0), period, A_mid, cols)
    G = torch.zeros((Z.shape[0],) * 2, dtype=Z.dtype, device=Z.device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for c0 in range(0, Z.shape[1], cols):
            G += mca.hermitian_gram(Z[:, c0:c0 + cols])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return Z, G


def boot_run(fields, s, block, period, dt, right=None, k=10, n_iter=12,
             tol=1e-4):
    """One moving-block bootstrap run of run seed ``s`` of a model solved
    with theta extension, on two prepared fields (:class:`mca.Field`):
    a CPU generator seeded with ``s`` draws ``n // block`` block starts
    (``randint``) of the left field's resample in time, then the start
    block ``randn((n, k + 16))`` float32.  Both fields are re-centered,
    extended (:func:`extended_signal`) and solved as complex fields: the
    Hermitian Grams, the regularization, the Cholesky factors and the
    subspace iteration of :func:`mca._solve`, the spatial vectors ``Z^H
    (L^-H T)`` and varimax (:func:`mca.rotated_variance`).  The right
    field is not resampled, so its ``(Z, Gram)`` is the same every run
    and may be handed in (``right``).  Returns ``(variance sorted
    largest first, converged, right, singular values)``, the last the
    subspace iteration's ahead of the rotation, largest first."""
    n = fields[0].n
    device = fields[0].kept.device
    gen = torch.Generator().manual_seed(int(s))
    n_blocks = n // block
    starts = torch.randint(0, n_blocks, (n_blocks,), generator=gen)
    idx = (starts[:, None] * block + torch.arange(block)[None, :]).reshape(-1)
    omega = torch.randn((n, min(k + 16, n)), generator=gen,
                        dtype=torch.float32)
    A_mid = analytic_rows(3 * n, slice(n, 2 * n), dt, device)
    Zl, Gl = extended_side(fields[0].kept[idx.to(device)], period, A_mid)
    if right is None:
        right = extended_side(fields[1].kept, period, A_mid)
    Zr, Gr = right
    ps = [f.p for f in fields]
    La, Lb, _, U, sv, V = mca._solve([Gl, Gr], ps, n - 1, omega.to(device),
                                     k, n_iter, 1e-6, mca.F32_EPS)
    Vl = _spatial(La, U, Zl)
    Vr = _spatial(Lb, V, Zr)
    var, conv = mca.rotated_variance(Vl, Vr, sv, tol)
    return (torch.sort(var, descending=True).values.cpu().numpy(), conv,
            right, torch.sort(sv, descending=True).values.cpu().numpy())


def _spatial(L, T, Z, cols=EXTEND_COLS):
    """``Z^H (L^-H T)`` (p, m), one block of columns at a time."""
    S = torch.linalg.solve_triangular(L.mH, T, upper=True)
    out = torch.empty((Z.shape[1], S.shape[1]), dtype=S.dtype,
                      device=S.device)
    for c0 in range(0, Z.shape[1], cols):
        out[c0:c0 + cols] = Z[:, c0:c0 + cols].mH @ S
    return out
