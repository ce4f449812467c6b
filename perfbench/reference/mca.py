"""Plain PyTorch reference of the cells' computations.

It imports nothing of the package under test and takes nothing the
package made: it draws the same inputs from the same seeds (the fields'
host arrays, the frozen +-1 draw of :mod:`perfbench.reference.philox`,
the start blocks and resample indices from seeded ``torch.Generator``
calls) and computes, in the precision it is given (float64; the control
runs it in float32 with TF32 products):

* the complexified truncated MCA: standardized, sqrt(cos(lat))-weighted
  fields; the Gram of their analytic signal ``A X X^T A^H`` with ``A =
  ifft(diag(h) fft(I))`` (``scipy.signal.hilbert``'s weights ``h``); the
  regularization ``delta I``; Cholesky factors; the reduced kernel ``M =
  La^H Lb / (n - 1)``; its leading triplets by the configured subspace
  iteration from the run's start block; the spatial vectors ``Z^H T``;
  the spectrum's total as the exact nuclear norm of ``M``;
* Kaiser-normalized varimax with the exact polar factor (an SVD);
* one Rule-N run of two +-1 fields, and one moving-block bootstrap run.

The configuration states float32 fields and products; the constants of
the regularization are the ones float32 implies (``F32_EPS``), whatever
precision the reference itself runs in.
"""
import math

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)


def complex_of(dt):
    return torch.complex128 if dt == torch.float64 else torch.complex64


def analytic_weights(n):
    """FFT weights of the analytic signal (``scipy.signal.hilbert``)."""
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return h


def analytic_matrix(n, dt, device):
    """``A`` with ``analytic(x) = A x`` for a real length-n series, built
    in complex128 one block of columns at a time and cast to ``dt``'s
    complex type."""
    h = torch.as_tensor(analytic_weights(n), device=device)
    A = torch.empty((n, n), dtype=torch.complex128, device=device)
    step = max(1, (1 << 27) // n)
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        E = torch.zeros((n, c1 - c0), dtype=torch.complex128, device=device)
        E[torch.arange(c0, c1, device=device),
          torch.arange(c1 - c0, device=device)] = 1.0
        A[:, c0:c1] = torch.fft.ifft(h[:, None] * torch.fft.fft(E, dim=0),
                                     dim=0)
    return A.to(complex_of(dt))


def regularize(G, p, jitter_rel, input_eps=F32_EPS):
    """``G + delta I``: ``delta = max(f mean(diag G), 50 eps ||G||_F)``
    with ``f = max(jitter_rel, 8 eps sqrt(p), input_eps / 2)`` and eps of
    float32, the configuration's precision."""
    d = float(torch.mean(torch.real(torch.diagonal(G))))
    floor = max(jitter_rel, 8.0 * F32_EPS * math.sqrt(p), 0.5 * input_eps)
    delta = max(floor * d, 50.0 * F32_EPS * float(torch.linalg.norm(G)))
    return G + delta * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)


def hermitian_gram(Z):
    """``Z Z^H`` from two real products of ``[Re Z, Im Z]``, so that a
    rounded product is still the Gram of the rounded parts (a complex
    product in TF32 is not)."""
    P = torch.cat([Z.real, Z.imag], dim=1)
    Q = torch.cat([Z.imag, -Z.real], dim=1)
    return torch.complex(P @ P.T, Q @ P.T)


def analytic_gram(G, A):
    """``A G A^H`` for a real symmetric ``G`` (``G`` itself when ``A`` is
    None: a real solve)."""
    if A is None:
        return G
    AG = A @ G.to(A.dtype)
    return AG @ A.mH


def subspace_svd(M, omega, k, n_iter):
    """Leading-k triplets of ``M`` by subspace iteration from ``omega``:
    QR of ``M omega``, ``n_iter`` rounds of QR of ``M M^H Q``, then the
    eigendecomposition of ``B B^H`` with ``B = Q^H M``."""
    Q = torch.linalg.qr(M @ omega.to(M.dtype)).Q
    for _ in range(n_iter):
        Q = torch.linalg.qr(M @ (M.mH @ Q)).Q
    B = Q.mH @ M
    w, W = torch.linalg.eigh(B @ B.mH)
    w, W = torch.flip(w, (0,)), torch.flip(W, (1,))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = Q @ W
    V = M.mH @ (U / torch.where(s > 0, s, torch.ones_like(s)).to(M.dtype))
    return U[:, :k], s[:k], V[:, :k]


def varimax(L, tol, max_iter=1000):
    """Kaiser-normalized varimax of the loadings ``L`` (rows, k) with the
    exact polar factor; stops when the criterion's nuclear norm changes
    by less than ``tol`` relatively, and never asks for less than 100
    eps of float32, the configuration's precision (the package's rule
    for float32 loadings).  Returns ``(L R, converged, iterations)``."""
    rows, k = L.shape
    tol = max(float(tol), 100.0 * F32_EPS)
    An = L / torch.sqrt(torch.sum(torch.abs(L) ** 2, dim=1))[:, None]
    R = torch.eye(k, dtype=L.dtype, device=L.device)
    d, d_old, i = 0.0, 0.0, 0

    def change():
        return abs(d - d_old) / (d if d != 0 else 1.0)

    while i < max_iter and (i == 0 or change() >= tol):
        B = An @ R
        col_ss = torch.sum(torch.abs(B) ** 2, dim=0)
        C = An.mH @ (torch.abs(B) ** 2 * B - B * col_ss[None, :] / rows)
        u, sv, vh = torch.linalg.svd(C)
        R = u @ vh
        i, d, d_old = i + 1, float(torch.sum(sv)), d
    return L @ R, change() < tol, i


def rotated_variance(Vl, Vr, s, tol, max_iter=1000):
    """Varimax of the sqrt(s)-scaled stack ``[Vl; Vr]`` (none when
    ``tol`` is None: an unrotated model): each mode's variance ``|left
    column| |right column|``, unsorted, and whether the rotation
    converged."""
    L = torch.cat([Vl, Vr], dim=0) * torch.sqrt(s).to(Vl.dtype)[None, :]
    B, conv = (L, True) if tol is None else varimax(L, tol, max_iter)[:2]
    n = Vl.shape[0]
    var = (torch.linalg.norm(B[:n], dim=0)
           * torch.linalg.norm(B[n:], dim=0))
    return var, conv and bool(torch.isfinite(var).all())


def _blocks(p, n, budget=1 << 28):
    """Column slices of a p-wide field of n rows, ~``budget`` elements
    each."""
    step = max(1, budget // max(1, n))
    return [slice(c0, min(p, c0 + step)) for c0 in range(0, p, step)]


class Field:
    """A field's columns as the fit prepares them: centered, divided by
    the population standard deviation (``normalize``) and weighted by
    sqrt(cos(lat) + 1e-6) (``coslat``), in the reference's precision.
    The host array (n, n_lat, n_lon) goes to the device once, in blocks
    of whole rows, and is prepared there one block of columns at a time
    into a copy that stays on the device."""

    def __init__(self, host, lat, dt, device, normalize=True, coslat=True):
        n = host.shape[0]
        self.n, self.p = n, int(np.prod(host.shape[1:]))
        self.dt, self.device = dt, device
        raw = torch.empty((n, self.p), dtype=torch.float32, device=device)
        rows = host.reshape(n, self.p)
        step = max(1, (1 << 28) // self.p)
        for r0 in range(0, n, step):
            raw[r0:r0 + step] = torch.as_tensor(
                rows[r0:r0 + step]).to(device, torch.float32)
        w = None
        if coslat:
            w = np.sqrt(np.cos(np.deg2rad(np.asarray(lat, np.float64)))
                        + 1e-6)
            w = torch.as_tensor(np.repeat(w, self.p // len(w)),
                                device=device, dtype=dt)
        self.kept = torch.empty((n, self.p), dtype=dt, device=device)
        for cols in _blocks(self.p, n):
            x = raw[:, cols].to(dt)
            x = x - x.mean(dim=0)
            if normalize:
                x = x / torch.sqrt(torch.mean(x * x, dim=0))
            if w is not None:
                x = x * w[cols][None, :]
            self.kept[:, cols] = x
        del raw

    def blocks(self):
        for cols in _blocks(self.p, self.n):
            yield cols, self.kept[:, cols]


def gram(blocks, n, dt, device):
    """``X X^T`` summed over the column blocks of a field."""
    G = torch.zeros((n, n), dtype=dt, device=device)
    for _, b in blocks:
        G += b @ b.T
    return G


def project(blocks, S, p):
    """``X^T S`` (p, m) for a real field's column blocks and complex
    ``S``."""
    out = torch.empty((p, S.shape[1]), dtype=S.dtype, device=S.device)
    for cols, b in blocks:
        out[cols] = b.T.to(S.dtype) @ S
    return out


def _solve(grams, ps, dof, omega, k, n_iter, jitter_rel, input_eps):
    """Analytic Grams -> regularization -> Cholesky -> ``M`` -> leading
    triplets; returns ``(La, Lb, M, U, s, V)``."""
    Ls = [torch.linalg.cholesky(regularize(G, p, jitter_rel, input_eps))
          for G, p in zip(grams, ps)]
    M = (Ls[0].mH @ Ls[1]) / dof
    U, s, V = subspace_svd(M, omega, k, n_iter)
    return Ls[0], Ls[1], M, U, s, V


def _spatial(L, T_side, A, blocks, p):
    """``Z^H (L^-H T)`` for ``Z = A X``: ``X^T (A^H L^-H T)`` (``A`` None:
    ``Z = X``)."""
    T = torch.linalg.solve_triangular(L.mH, T_side, upper=True)
    return project(blocks, T if A is None else A.mH @ T, p)


def fit(fields, solver_seed, seed_device, dt, device, k=10, n_iter=12,
        tol=1e-8, A=None, with_total=True):
    """The truncated MCA of two prepared fields (:class:`Field`): of
    their analytic signals ``A X`` when ``A`` is given (complexified),
    else of the fields themselves; varimax-rotated to ``tol``, or not
    rotated when ``tol`` is None.  Returns ``{'svals', 'variance'
    (sorted, largest first), 'total' (None unless ``with_total``),
    'converged'}`` as numpy / floats.  The start block is drawn as the
    package documents it: ``randn((n, k + 16))`` float32 from a
    generator on ``seed_device`` seeded with ``solver_seed``."""
    n = fields[0].n
    gen = torch.Generator(device=seed_device).manual_seed(int(solver_seed))
    omega = torch.randn((n, min(k + 16, n)), generator=gen,
                        dtype=torch.float32, device=seed_device)
    grams = [analytic_gram(gram(f.blocks(), n, dt, device), A)
             for f in fields]
    La, Lb, M, U, s, V = _solve(grams, [f.p for f in fields], n - 1,
                                omega.to(device), k, n_iter, 1e-6, F32_EPS)
    del grams
    total = (float(torch.sum(torch.linalg.svdvals(M))) if with_total
             else None)
    Vl = _spatial(La, U, A, fields[0].blocks(), fields[0].p)
    Vr = _spatial(Lb, V, A, fields[1].blocks(), fields[1].p)
    var, conv = rotated_variance(Vl, Vr, s, tol)
    var = torch.sort(var, descending=True).values
    return {'svals': s.cpu().numpy().astype(np.float64),
            'variance': var.cpu().numpy().astype(np.float64),
            'total': total, 'converged': conv}


def run_seeds(seed, n_runs):
    """Per-run uint32 seeds of a call's seed, as the package documents
    its ensembles' seeds: ``(seed * 2654435761 + r) mod 2^32``."""
    base = (int(seed) * 2654435761) % (2 ** 32)
    return [(base + r) % (2 ** 32) for r in range(n_runs)]


def _pm1_blocks(X, mu, dt):
    for cols in _blocks(X.shape[1], X.shape[0]):
        yield cols, X[:, cols].to(dt) - mu[cols][None, :]


def rulen_run(s, n, ps, dt, device, A, k=10, n_iter=6, tol=1e-4,
              jitter_rel=2e-3):
    """One Rule-N run of run seed ``s``: two +-1 fields (seeds ``2 s`` and
    ``2 s + 1`` mod 2^32), centered, complexified, solved for ``k``
    modes by ``n_iter`` subspace rounds from the start block
    ``randn((n, k + 16))`` of a CPU generator seeded with ``s``, and
    varimax-rotated to ``tol``.  Returns ``(variance sorted largest
    first, converged)``."""
    from perfbench.reference.philox import pm1_field
    Xs = [pm1_field((2 * s + i) & 0xFFFFFFFF, n, p, device)
          for i, p in enumerate(ps)]
    mus = [X.sum(dim=0, dtype=torch.int64).to(dt) / n for X in Xs]
    grams = [analytic_gram(gram(_pm1_blocks(X, mu, dt), n, dt, device), A)
             for X, mu in zip(Xs, mus)]
    gen = torch.Generator().manual_seed(int(s))
    omega = torch.randn((n, min(k + 16, n)), generator=gen,
                        dtype=torch.float32).to(device)
    La, Lb, _, U, sv, V = _solve(grams, ps, n - 1, omega, k, n_iter,
                                 jitter_rel, F32_EPS)
    del grams
    Vl = _spatial(La, U, A, _pm1_blocks(Xs[0], mus[0], dt), ps[0])
    Vr = _spatial(Lb, V, A, _pm1_blocks(Xs[1], mus[1], dt), ps[1])
    var, conv = rotated_variance(Vl, Vr, sv, tol)
    return torch.sort(var, descending=True).values.cpu().numpy(), conv


def boot_run(fields, s, block, dt, A, right_gram=None, k=10, n_iter=12,
             tol=1e-4):
    """One moving-block bootstrap run of run seed ``s`` on two prepared
    fields (:class:`Field`, kept on the device), the left one resampled
    in time: a CPU generator seeded with ``s`` draws ``n // block``
    block starts (``randint``), then the start block ``randn((n, k +
    16))`` float32; the resample is centered and solved and rotated as
    :func:`fit` does.  Each Gram is formed, one block of columns at a
    time, from the analytic signal ``Z = A X`` itself (a resample
    repeats steps, so its Gram is singular beyond the regularization,
    and only ``Z Z^H`` from real products (:func:`hermitian_gram`) stays
    positive semi-definite when they are rounded) with TF32 off whatever
    the caller set: the control's TF32 Grams of a resample are
    indefinite at the configured regularization even so, and give no
    number.  The right field is not resampled: its Gram
    (``right_gram``, the same in every run) may be handed in.
    Returns ``(variance sorted largest first, converged, right Gram)``."""
    n = fields[0].n
    gen = torch.Generator().manual_seed(int(s))
    n_blocks = n // block
    starts = torch.randint(0, n_blocks, (n_blocks,), generator=gen)
    idx = (starts[:, None] * block + torch.arange(block)[None, :]).reshape(-1)
    omega = torch.randn((n, min(k + 16, n)), generator=gen,
                        dtype=torch.float32)
    idx = idx.to(A.device)

    def left():
        for cols, b in fields[0].blocks():
            b = b[idx]
            yield cols, b - b.mean(dim=0)

    def gram_of(blocks):
        G = torch.zeros((n, n), dtype=A.dtype, device=A.device)
        for _, b in blocks:
            G += hermitian_gram(A @ b.to(A.dtype))
        return G

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        grams = [gram_of(left()),
                 gram_of(fields[1].blocks()) if right_gram is None
                 else right_gram]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    ps = [f.p for f in fields]
    La, Lb, _, U, sv, V = _solve(grams, ps, n - 1, omega.to(A.device),
                                 k, n_iter, 1e-6, F32_EPS)
    Vl = _spatial(La, U, A, left(), ps[0])
    Vr = _spatial(Lb, V, A, fields[1].blocks(), ps[1])
    var, conv = rotated_variance(Vl, Vr, sv, tol)
    return (torch.sort(var, descending=True).values.cpu().numpy(), conv,
            grams[1])
