"""Matmul-only truncated solve and Rule-N surrogate pipeline on tensors.

Counterpart of ``xmca_tpu/core/fastpath.py``.  The algebra is the same:
for centered fields ``A (n, p_l)``, ``B (n, p_r)`` with ``n <= p`` the
singular values of ``A^H B`` are those of ``M = La^H Lb / dof`` with
``La = chol(A A^H)``, ``Lb = chol(B B^H)``; the leading triplets of the
n x n kernel ``M`` come from a subspace iteration, the spectrum total
from a Newton-Schulz nuclear norm, and the spatial vectors from
``V = X^H (L^-H U)``.  A complexified solve never builds ``Z = X + iHX``:
its Gram is folded from the real one (:func:`_analytic_fold`).

Precision: every n x n product runs at the operands' own precision (f32
on the card with TF32 off, f64 in the CPU tests).  bf16 fields (Rule-N's
Gaussian and generated surrogates) enter the data-sized products upcast
to f32 (:func:`_data_dot`), so they accumulate in f32 as the JAX
package's ``_data_dot`` does; their Grams take the jitter floor of bf16
input.  The JAX package's 3-pass ``HIGH`` tier (``_dot_high``) and
``grade='fast'``'s single-pass bf16 n x n dot both become f32 here, which
is more accurate; the
+-1 surrogate back-projection ``X^T S`` runs in f32 as well (a +-1 field
is exact in f32): on the card one kernel reads the int8 field once, on
the CPU it is cast one column block at a time (:func:`_pm1_project`).  The
generated surrogate's kernels round ``S`` to bf16 and sum in f32, as the
JAX package's kernels do.

Random start blocks are arguments (``omega``): the caller draws them from
an explicit ``torch.Generator``, and tests inject the JAX package's own.

Under a profiler the stages record spans (:mod:`xmca_tpu_torch.utils.
trace`): ``draw`` (a +-1 field and its sums), ``gram`` (the Grams and what
is formed from them up to the reduced kernel; ``route='data'`` where the
Grams are products over the data), ``subspace`` (:func:`subspace_svd`)
and ``project`` (the spatial vectors).  The n x n tail records ``fold``
(:func:`_fold_jitter`: the analytic fold by H and the jitter) and
``reduce`` (the two sides' Cholesky factors and, where a caller takes
totals from it, ``M = La^H Lb / dof``; elsewhere ``subspace`` applies
``M`` through the factors and never forms it), inside the ``gram`` span
that holds that work, and ``recover``
(:func:`_recover`: ``L^-H T`` and the H^T stack) where the spatial
vectors are formed.
"""
import numpy as np
import torch

from xmca_tpu_torch.core.linalg import (ns_polar_iterate_scaled,
                                        ns_polar_schedule)
from xmca_tpu_torch.core.preprocess import _analytic_weights
from xmca_tpu_torch.ops.project import pm1_project
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.utils import trace

_F32_EPS = float(np.finfo(np.float32).eps)


def _real_dtype(dtype):
    return torch.empty((), dtype=dtype).real.dtype


def _complex_dtype(real_dtype):
    return torch.complex128 if real_dtype == torch.float64 \
        else torch.complex64


def _eps(dtype):
    return float(torch.finfo(_real_dtype(dtype)).eps)


def _data_dot(a, b):
    """``a @ b`` over the data axis; bf16 operands are upcast to f32
    (exact), so the product accumulates and returns f32."""
    if a.dtype == torch.bfloat16:
        a = a.to(torch.float32)
    if b.dtype == torch.bfloat16:
        b = b.to(torch.float32)
    return a @ b


def _jitter(G, p, jitter_rel, input_eps=None):
    """Add the rank-deficiency jitter to a (possibly complex) Gram.

    ``delta = max(rel_floor * mean(diag), 50 eps ||G||_F)`` with
    ``rel_floor = max(jitter_rel, 8 eps sqrt(p), 0.5 input_eps)``; stays a
    device tensor (no host read).
    """
    d = torch.mean(torch.real(torch.diagonal(G)))
    eps = _eps(G.dtype)
    rel_floor = max(jitter_rel, 8.0 * eps * float(np.sqrt(p)))
    if input_eps is not None:
        rel_floor = max(rel_floor, 0.5 * float(input_eps))
    delta = torch.maximum(rel_floor * d,
                          (50.0 * eps) * torch.linalg.norm(G))
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return G + delta * eye


def _fold_jitter(G, p, input_eps, H=None, jitter_rel=1e-6):
    """The Gram step of the n x n tail, for every route: the analytic
    fold of a real temporal Gram when ``H`` is given
    (:func:`_analytic_fold`), then the rank jitter at the contracted width
    ``p`` and the input precision ``input_eps`` (:func:`_jitter`)."""
    with trace.span('fold'):
        if H is not None:
            G = _analytic_fold(G, H)
        return _jitter(G, p, jitter_rel, input_eps=input_eps)


def hilbert_imag_matrix(n, dtype=np.float64):
    """The real n x n matrix H with ``analytic(x) = x + i H x``, on the
    host: the imaginary part of ``ifft(diag(h) fft(I))`` in float64, as
    the JAX package builds it.  The reference of :func:`hilbert_operator`;
    it holds two complex n x n arrays, so nothing at run time calls it."""
    h = _analytic_weights(int(n), np.float64)
    F = np.fft.fft(np.eye(int(n)), axis=0)
    A = np.fft.ifft(h[:, None] * F, axis=0)
    return np.ascontiguousarray(A.imag.astype(dtype))


def hilbert_operator(n, dtype=torch.float64, device='cpu'):
    """:func:`hilbert_imag_matrix` built on ``device`` in ``dtype``.

    The analytic-signal transform ``F^-1 diag(h) F`` is circulant: a
    circular convolution with ``a = ifft(h)``, so ``H[i, j] =
    Im a[(i - j) mod n]``.  One float64 FFT of length n, rounded to
    ``dtype``, fills the matrix: ``u = [a_rev, a_rev]`` (``a`` reversed)
    read as the Hankel matrix ``u[i + j]`` is H with its rows reversed.
    The only n x n buffer is H itself (0.85 GB in f32 at n = 14610).
    """
    n = int(n)
    h = trace.to_device(_analytic_weights(n, np.float64), device,
                        'hilbert.weights')
    a_rev = torch.fft.ifft(h).imag.to(dtype).flip(0)
    u = torch.cat([a_rev, a_rev])
    return u.as_strided((n, n), (1, 1)).flip(0)


def _cholesky(G):
    """Lower Cholesky factor of ``G``, NaN where the factorization fails
    (a non-finite or indefinite ``G``) as XLA's is in the JAX package;
    no error check, so no host read."""
    L, info = torch.linalg.cholesky_ex(G)
    return L.masked_fill_(info != 0, float('nan'))


def _analytic_fold(G, H):
    """``G_Z = (G + H G H^T) + i (H G - G H^T)`` from a real symmetric G."""
    HG = H @ G
    real = G + HG @ H.T
    imag = HG - HG.T
    return torch.complex(real, imag)


def analytic_temporal_gram(X, H, jitter_rel=1e-6):
    """Jittered temporal Gram of ``analytic(X)`` from real ``X`` (f32 from
    a bf16 ``X``), of ``X`` itself where ``H`` is None; summed over the
    space shards of a :func:`~xmca_tpu_torch.parallel.mesh.space_context`."""
    G = _mesh.space_sum(_data_dot(X, X.mH))
    return _fold_jitter(G, _mesh.space_total(X.shape[1], X.device),
                        _eps(X.dtype), H, jitter_rel)


def analytic_reduced_kernel(Xl, Xr, H, jitter_rel=1e-6):
    """Chol-reduced kernel of the complexified fields (of the fields as
    given where ``H`` is None), ``(M, La, Lb)``."""
    La, Lb, M = _data_reduce(Xl, Xr, H, None, 0, 0, jitter_rel,
                             form=True)[:3]
    return M, La, Lb


def temporal_gram(X, jitter_rel=1e-6):
    """Jittered temporal Gram ``X X^H + eps I`` (f32 from a bf16 ``X``);
    summed over the space shards of a space context."""
    return analytic_temporal_gram(X, None, jitter_rel)


def reduced_kernel(Xl, Xr, jitter_rel=1e-6):
    """n x n matrix with the singular values of ``Xl^H Xr / dof``."""
    return analytic_reduced_kernel(Xl, Xr, None, jitter_rel)


def _center_gram(G):
    """``C G C`` with ``C = I - 1 1^T / n``: the temporal Gram of the
    rows of a field re-centered, from their Gram ``G`` (real or
    Hermitian) alone."""
    return (G - G.mean(dim=1, keepdim=True) - G.mean(dim=0, keepdim=True)
            + G.mean())


def centered_factor(G, p, input_eps, H=None, jitter_rel=1e-6):
    """Lower Cholesky factor of the jittered temporal Gram of a field's
    rows re-centered, from their Gram ``G``: :func:`_center_gram`, then
    :func:`_fold_jitter` and the factor the data route takes of the
    centered rows themselves."""
    return _cholesky(_fold_jitter(_center_gram(G), p, input_eps, H,
                                  jitter_rel))


def _orthonormalize(Y, method='qr'):
    """Orthonormal basis of the thin block ``Y``: Householder QR
    (``'qr'``) or two rounds of Cholesky-QR (``'cholqr2'``)."""
    if method == 'qr':
        return torch.linalg.qr(Y).Q
    if method != 'cholqr2':
        raise ValueError("orth must be 'qr' or 'cholqr2'")

    def one_round(Y):
        G = Y.mH @ Y
        d = torch.mean(torch.real(torch.diagonal(G)))
        eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
        R = torch.linalg.cholesky(G + (8.0 * _eps(G.dtype)) * d * eye)
        Rinv = torch.linalg.solve_triangular(R, eye, upper=False)
        return Y @ Rinv.mH

    return one_round(one_round(Y))


def start_block(m, k, dtype, generator):
    """Gaussian start block ``(m, min(k + 16, m))`` of
    :func:`subspace_svd` for a square ``(m, m)`` kernel (16 oversampling
    columns), drawn from ``generator`` on its device."""
    kk = min(k + 16, m)
    real = _real_dtype(dtype)
    omega = torch.randn((m, kk), generator=generator, dtype=real,
                        device=generator.device)
    return omega.to(dtype)


def _kernel_products(M):
    """``(apply, apply_h, dtype)`` of a square kernel: ``apply(Y) = M Y``,
    ``apply_h(Y) = M^H Y``.  ``M`` is the kernel as a tensor, or factored
    as ``(La, Lb, dof)`` for ``M = La^H Lb / dof``, which is then never
    formed: each product is two thin products with the factors, and the
    thin result is divided by ``dof``."""
    if torch.is_tensor(M):
        return (lambda Y: M @ Y), (lambda Y: M.mH @ Y), M.dtype
    La, Lb, dof = M
    return ((lambda Y: (La.mH @ (Lb @ Y)) / dof),
            (lambda Y: (Lb.mH @ (La @ Y)) / dof), La.dtype)


@trace.spanned('subspace')
def subspace_svd(M, omega, k, n_iter=8, orth='qr'):
    """Leading-k singular triplets of a square kernel by subspace
    iteration from the start block ``omega (m, kk)``; returns ``(U, s,
    V)``.  ``M`` is the kernel, or its factors ``(La, Lb, dof)``
    (:func:`_kernel_products`)."""
    apply, apply_h, dtype = _kernel_products(M)
    Q = _orthonormalize(apply(omega.to(dtype)), orth)
    for _ in range(n_iter):
        Q = _orthonormalize(apply(apply_h(Q)), orth)
    B = apply_h(Q).mH
    # a non-finite kernel gives NaN triplets (as XLA's eigh does) instead
    # of torch's error: eigh runs on the identity and its results are
    # replaced, with no host read
    BB = B @ B.mH
    finite = torch.isfinite(BB).all()
    eye = torch.eye(BB.shape[0], dtype=BB.dtype, device=BB.device)
    w, W = torch.linalg.eigh(torch.where(finite, BB, eye))
    w = torch.flip(w.masked_fill(~finite, float('nan')), (-1,))
    W = torch.flip(W.masked_fill(~finite, float('nan')), (-1,))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U = Q @ W
    safe = torch.where(s > 0, s, torch.ones_like(s)).to(dtype)
    V = apply_h(U / safe[None, :])
    return U[:, :k], s[:k], V[:, :k]


# host constants of (l0, tol): the exact schedule converges
# sigma_min/fro = 1e-9 to 1e-8, the surrogate schedule stops at 1e-4
_NS_SCALES_EXACT = tuple(ns_polar_schedule(l0=1e-9, tol=1e-8))
_NS_SCALES_SURR = tuple(ns_polar_schedule(l0=1e-7, tol=1e-4))


def _nuclear(M, scales, schedule):
    """``Re tr(W^H M)`` of the scaled Newton-Schulz polar iterate ``W`` of
    ``M`` on ``scales``: one ``nuclear`` span (its ``steps`` and
    ``schedule``), the steps counted in ``trace.counters()['ns_steps']``
    under ``schedule``."""
    trace.count('ns_steps', schedule, len(scales))
    with trace.span('nuclear', steps=len(scales), schedule=schedule):
        W = ns_polar_iterate_scaled(M, scales)
        return torch.real(torch.trace(W.mH @ M))


def nuclear_norm(M):
    """``sum(svals(M))`` via the scaled Newton-Schulz polar iteration
    (exact schedule, every step at the operands' precision)."""
    return _nuclear(M, _NS_SCALES_EXACT, 'exact')


def nuclear_norm_surrogate(M):
    """Nuclear norm on the 1e-4 schedule, for per-surrogate totals."""
    return _nuclear(M, _NS_SCALES_SURR, 'surrogate')


def _chol_reduce(factors, dof, omega, k, n_iter, form, **gram):
    """The reduction of the n x n tail, for every route.

    ``factors()`` returns the lower Cholesky factors ``(La, Lb)`` of the
    two sides' jittered temporal Grams; they and, where ``form`` is true,
    the reduced kernel ``M = La^H Lb / dof`` are one ``gram`` span with the
    route's attributes ``gram``, around the tail's ``reduce`` span.  The
    subspace SVD from the start block ``omega`` follows (none where
    ``omega`` is None), of ``M`` or, unformed, through the factors.
    Returns ``(La, Lb, M, U, s, V)``, ``M`` None unless formed: a caller
    forms it only to take totals from it.  Counts the reduction in
    ``trace.counters()['reduced_kernels']``, as ``'formed'`` or
    ``'factored'``.
    """
    trace.count('reduced_kernels', 'formed' if form else 'factored')
    with trace.span('gram', **gram), trace.span('reduce'):
        La, Lb = factors()
        M = (La.mH @ Lb) / dof if form else None
    if omega is None:
        return La, Lb, M, None, None, None
    return (La, Lb, M) + subspace_svd((La, Lb, dof) if M is None else M,
                                      omega, k=k, n_iter=n_iter)


def _recover(L, T_side, H=None):
    """The recovery of the n x n tail, for every route: ``L^-H T`` of one
    side's factor ``L`` and singular vectors ``T_side``; with ``H``, the
    real stack :func:`analytic_projection_stack` of it."""
    with trace.span('recover'):
        T = torch.linalg.solve_triangular(L.mH, T_side, upper=True)
        return T if H is None else analytic_projection_stack(T, H)


def analytic_projection_stack(T, H):
    """Real (n, 2k) stack ``[Re S, Im S]`` of ``S = T - i H^T T``, so
    ``Z^H T = X^T S`` for ``Z = (I + iH) X`` runs as ONE real product."""
    Ht = H.T.to(T.real.dtype)
    HtT = torch.complex(Ht @ T.real, Ht @ T.imag)
    S = T - 1j * HtT
    return torch.cat([S.real, S.imag], dim=1)


def combine_analytic_projection(P):
    """Inverse of the :func:`analytic_projection_stack` split."""
    k = P.shape[1] // 2
    return torch.complex(P[:, :k], P[:, k:])


def _data_reduce(Xl, Xr, H, omega, k, n_iter, jitter_rel, form):
    """The data route into the tail: each field's jittered temporal Gram
    (folded with ``H``, :func:`analytic_temporal_gram`) and its factor,
    then :func:`_chol_reduce` (``M`` formed where ``form`` is true)."""
    def factors():
        return tuple(_cholesky(analytic_temporal_gram(X, H, jitter_rel))
                     for X in (Xl, Xr))

    return _chol_reduce(factors, Xl.shape[0] - 1, omega, k, n_iter,
                        form=form, route='data')


def _spatial_vectors(X, L, T_side, H=None):
    """``V = X^H (L^-H T)`` of a field as given; with ``H``, ``Z^H (L^-H
    T)`` of ``Z = (I + iH) X`` without materializing Z, a ``project``
    span."""
    if H is None:
        return _data_dot(X.mH, _recover(L, T_side))
    with trace.span('project'):
        return combine_analytic_projection(
            _data_dot(X.mH, _recover(L, T_side, H)))


def fast_solve_truncated_totals(Xl, Xr, omega, n_modes, n_iter=8,
                                jitter_rel=1e-6):
    """Leading-n_modes solve + exact totals:
    ``(s, V_left, V_right, total_cov, total_sq)``."""
    return fast_solve_truncated_totals_analytic(Xl, Xr, None, omega, n_modes,
                                                n_iter, jitter_rel)


def fast_solve_truncated_totals_analytic(Xl, Xr, H, omega, n_modes,
                                         n_iter=8, jitter_rel=1e-6):
    """Truncated solve of the COMPLEXIFIED fields from real data (the
    analytic fold; the fields as given where ``H`` is None); same
    contract as :func:`fast_solve_truncated_totals` applied to
    ``analytic(Xl), analytic(Xr)``."""
    La, Lb, M, U, s, V = _data_reduce(Xl, Xr, H, omega, n_modes, n_iter,
                                      jitter_rel, form=True)
    return (s, _spatial_vectors(Xl, La, U, H), _spatial_vectors(Xr, Lb, V, H),
            nuclear_norm(M), torch.sum(torch.abs(M) ** 2))


# ---------------------------------------------------------------------------
# One ensemble run on data (bootstrap resamples): the spectrum or the
# rotated variance of given fields.  ``omega`` is the run's start block.
# ---------------------------------------------------------------------------

def _rotated_variance(Vl, Vr, s, power, tol, polar_method, space=None):
    """Promax of the sqrt(s)-scaled loading stack ``[Vl; Vr]`` (``Vl``
    alone when ``Vr`` is None): ``(variance descending, converged,
    n_iter)``; a non-finite variance counts as not converged."""
    from xmca_tpu_torch.core.rotation import promax

    trace.keep('rotated_svals', s)
    sqrt_s = torch.sqrt(s).to(Vl.dtype)
    L = Vl if Vr is None else torch.cat([Vl, Vr], dim=0)
    L = L * sqrt_s[None, :]
    L_rot, _, _, converged, n_it = promax(
        L, power=power, tol=tol, polar_method=polar_method, space=space)
    n_left = Vl.shape[0]
    norm_left = _mesh.col_norm(L_rot[:n_left])
    if Vr is None:
        variance = norm_left ** 2
    else:
        variance = norm_left * _mesh.col_norm(L_rot[n_left:])
    variance = torch.sort(variance, descending=True).values
    return (variance, converged and trace.to_host(
        torch.isfinite(variance).all(), 'variance.finite', bool), n_it)


def _rotated_of(Xl, Xr, H, omega, n_rot, power, tol, n_iter, jitter_rel,
                bivariate, polar_method):
    La, Lb, _, U, s, V = _data_reduce(Xl, Xr, H, omega, n_rot, n_iter,
                                      jitter_rel, form=False)
    Vl = _spatial_vectors(Xl, La, U, H)
    Vr = _spatial_vectors(Xr, Lb, V, H) if bivariate else None
    var, conv, _ = _rotated_variance(Vl, Vr, s, power, tol, polar_method)
    return var, conv


def fast_rotated_variance_analytic(Xl, Xr, H, omega, n_rot, power=1,
                                   tol=1e-8, n_iter=8, jitter_rel=1e-6,
                                   bivariate=True, polar_method='ns'):
    """Rotated variance spectrum of the COMPLEXIFIED fields from real
    centered ``Xl``, ``Xr``: analytic reduced kernel, subspace SVD,
    triangular recovery, ``V = Z^H T`` without Z, data-space promax.
    Returns ``(variance, converged)``."""
    if Xr is None or not bivariate:
        Xr = Xl
    return _rotated_of(Xl, Xr, H, omega, n_rot, power, tol, n_iter,
                       jitter_rel, bivariate, polar_method)


def fast_spectrum_analytic(Xl, Xr, H, omega, k, n_iter=8, with_nuclear=True,
                           jitter_rel=1e-6):
    """Top-k complexified kernel spectrum from real fields (of the fields
    as given where ``H`` is None) and its total (the surrogate-schedule
    nuclear norm, or the sum of the k values)."""
    _, _, M, _, s, _ = _data_reduce(Xl, Xr, H, omega, k, n_iter, jitter_rel,
                                    form=with_nuclear)
    return s, nuclear_norm_surrogate(M) if with_nuclear else torch.sum(s)


def fast_spectrum(Xl, Xr, omega, k, n_iter=8, with_nuclear=True,
                  jitter_rel=1e-6):
    """Top-k singular values of the MCA kernel and its total, as
    :func:`fast_spectrum_analytic` on the fields as given."""
    return fast_spectrum_analytic(Xl, Xr, None, omega, k, n_iter,
                                  with_nuclear, jitter_rel)


def fast_rotated_variance(Xl, Xr, omega, n_rot, power=1, tol=1e-8, n_iter=8,
                          jitter_rel=1e-6, bivariate=True,
                          polar_method='ns'):
    """Rotated variance spectrum of the fields as given (real or
    complex), with spatial vectors ``V = X^H (L^-H U)``; returns
    ``(variance, converged)``."""
    return _rotated_of(Xl, Xl if Xr is None else Xr, None, omega, n_rot,
                       power, tol, n_iter, jitter_rel, bivariate,
                       polar_method)


# the most bytes of f32 that the plain +-1 back-projection casts at once:
# the JAX package casts inside the contraction, so no f32 copy of a whole
# field may exist here
_PROJECT_BYTES = 1 << 30


def _pm1_cols(rows):
    """Columns of one f32 block of a field of ``rows`` rows: as many as
    ``_PROJECT_BYTES`` holds, at least one."""
    return max(1, _PROJECT_BYTES // (4 * rows))


def _pm1_blocks(X, stop):
    """``(c0, f32 copy of X[:, c0:c0 + w])`` for the column blocks of an
    int8 field ``X`` that start below ``stop``, each :func:`_pm1_cols`
    wide, the last one cut at the field's width."""
    cols = _pm1_cols(X.shape[0])
    for c0 in range(0, stop, cols):
        yield c0, X[:, c0:c0 + cols].to(torch.float32)


@trace.spanned('project')
def _pm1_project(X, S, p):
    """``X^T S`` (p, m) f32 of a padded +-1 int8 field ``X`` (n_pad,
    p_pad) and f32 weights ``S`` (n_obs, m); padded columns are dropped.
    A CUDA field takes the kernel (:func:`xmca_tpu_torch.ops.project.
    pm1_project`: the field read once, never copied to f32), any other
    the plain version (:func:`_pm1_project_plain`)."""
    S_pad = S.new_zeros((X.shape[0], S.shape[1]))
    S_pad[:S.shape[0]] = S
    return (pm1_project if X.is_cuda else _pm1_project_plain)(X, S_pad, p)


def _pm1_project_plain(X, S_pad, p):
    """``(X^T S_pad)[:p]`` on any device, the int8 field cast to f32 one
    column block at a time (:func:`_pm1_blocks`).  Blocks run over the
    padded width, so a field of one block gives the whole-field product
    ``(S_pad^T X)^T`` bit for bit."""
    out = S_pad.new_empty((p, S_pad.shape[1]))
    for c0, block in _pm1_blocks(X, p):
        part = (S_pad.T @ block).T
        out[c0:c0 + part.shape[0]] = part[:p - c0]
    return out


def _surrogate_spectrum(grams, mus, project, n_obs, n_vars, H, rotated,
                        omega, n_rot, power, tol, n_iter, polar_method):
    """The n x n tail of one Rule-N surrogate solve, shared by the +-1
    and the generated pipelines.

    ``grams[i]`` is field i's jittered (folded) Gram, ``mus[i]`` its
    column means (p_i,), and ``project(i, S)`` returns ``X_i^T S``
    (p_i, m) f32 for the raw field i; ``H`` is the f32 Hilbert operator
    of complexified fields, else None.  Cholesky and the subspace SVD of
    the reduced kernel; unrotated, the spectrum and its NS nuclear-norm
    total (the kernel formed for it); rotated, the centered
    back-projection of the loadings and promax in the space
    :func:`ensemble_space` picks (the kernel applied through the
    factors).  Returns
    ``(variance, total, converged, n_iter_rot)``.
    """
    from xmca_tpu_torch.core.rotation import ensemble_space

    bivariate = len(n_vars) == 2

    def factors():
        La = _cholesky(grams[0])
        return La, _cholesky(grams[1]) if bivariate else La

    La, Lb, M, U, s, V = _chol_reduce(factors, n_obs - 1, omega, n_rot,
                                      n_iter, form=not rotated)
    if not rotated:
        return (s, nuclear_norm_surrogate(M),
                trace.to_host(torch.isfinite(s).all(), 'variance.finite',
                              bool), 0)

    def spatial(i, L_chol, T_side):
        S = _recover(L_chol, T_side, H).to(torch.float32)
        P = project(i, S) - mus[i][:, None] * torch.sum(S, dim=0)[None, :]
        return P if H is None else combine_analytic_projection(P)

    Vl = spatial(0, La, U)
    Vr = spatial(1, Lb, V) if bivariate else None
    rows = Vl.shape[0] + (0 if Vr is None else Vr.shape[0])
    variance, converged, n_it = _rotated_variance(
        Vl, Vr, s, power, tol, polar_method,
        space=ensemble_space(rows, Vl.shape[1], Vl.element_size()))
    return variance, torch.sum(variance), converged, n_it


def fast_surrogate_variance_tri(seed, omega, n_obs, n_vars, H=None,
                                complexify=False, rotated=False, n_rot=10,
                                power=1, tol=1e-8, n_iter=8,
                                jitter_rel=1e-6, polar_method='ns',
                                grade='exact', fields=None):
    """One Rule-N surrogate solve on +-1 fields with the triangle Gram.

    Per field (seed ``2 * seed + i`` mod 2^32): the draw kernel writes a
    padded, masked +-1 int8 field and its column sums
    (:func:`xmca_tpu_torch.ops.surrogate.sign_field_sums`), the syrk
    kernel forms the raw Gram, centering comes from the Gram alone
    (``w = G 1 / n``, ``mu.mu = 1^T G 1 / n^2``), then the analytic fold,
    the jitter, Cholesky, the reduced kernel and the subspace SVD.  The
    rotated variant back-projects the loadings (``X^T S``, f32, in one
    kernel launch on the card: :func:`_pm1_project`) and runs
    promax in the space :func:`ensemble_space` picks.

    ``grade='fast'`` keeps the JAX package's 2e-3 jitter floor; its n x n
    products stay f32.  ``omega`` is the subspace start block (on the
    device the run uses).  ``fields`` (tests only) injects pre-drawn
    padded int8 fields with zero pads, one per field, instead of drawing.

    Returns ``(variance, total, converged, n_iter_rot)``; the last is the
    rotation's iteration count (0 when not rotated).
    """
    from xmca_tpu_torch.ops.surrogate import sign_field_sums
    from xmca_tpu_torch.ops.syrk import pad_to, syrk

    device = omega.device
    if grade == 'fast':
        jitter_rel = max(jitter_rel, 2e-3)
    elif grade != 'exact':
        raise ValueError("grade must be 'exact' or 'fast'")
    H = H.to(device=device, dtype=torch.float32) if complexify else None

    grams, mus, Xs = [], [], []
    for i, p in enumerate(n_vars):
        n_pad, p_pad = pad_to(n_obs, p)
        with trace.span('draw'):
            if fields is None:
                X, colsum = sign_field_sums(
                    (2 * int(seed) + i) & 0xFFFFFFFF, n_obs, p, n_pad,
                    p_pad, device)
            else:
                X = fields[i]
                if (tuple(X.shape) != (n_pad, p_pad)
                        or X.dtype != torch.int8):
                    raise ValueError('injected field {} must be int8 {}'
                                     .format(i, (n_pad, p_pad)))
                colsum = X.sum(dim=0, dtype=torch.int32)
        with trace.span('gram'):
            G = syrk(X, pm1=True)[:n_obs, :n_obs]
            w = torch.sum(G, dim=1) / n_obs
            Gc = G - w[:, None] - w[None, :] + torch.sum(w) / n_obs
            grams.append(_fold_jitter(Gc, p, _F32_EPS, H, jitter_rel))
        mus.append(colsum[:p].to(torch.float32) / n_obs)
        Xs.append(X)

    def project(i, S):
        return _pm1_project(Xs[i], S, n_vars[i])

    return _surrogate_spectrum(grams, mus, project, n_obs, n_vars, H,
                               rotated, omega, n_rot, power, tol, n_iter,
                               polar_method)


def fast_surrogate_variance_gen(seed, omega, n_obs, n_vars, H=None,
                                complexify=False, rotated=False, n_rot=10,
                                power=1, tol=1e-8, n_iter=8,
                                jitter_rel=1e-6, dist='normal32',
                                polar_method='ns', fields=None):
    """One Rule-N surrogate solve whose fields are generated on the fly
    and never stored (the JAX package's ``fast_surrogate_variance_gen``).

    Per field (seed ``2 * seed + i`` mod 2^32, distribution ``dist``):
    :func:`xmca_tpu_torch.ops.surrogate.surrogate_gram` generates the
    field inside the Gram kernel and returns the raw Gram with its
    centering terms; :func:`centered_gram_from_raw` centers it, then the
    analytic fold, the jitter, Cholesky, the reduced kernel and the
    subspace SVD.  The rotated variant back-projects the loadings with
    :func:`surrogate_project`, which regenerates the same field (one
    ``(n, 2k)`` stack when complexified), centers them with the column
    means and runs promax in the space :func:`ensemble_space` picks.

    ``omega`` is the subspace start block (on the device the run uses).
    ``fields`` (tests only) injects pre-drawn ``(n_obs, p_i)`` fields,
    one per side, which then go through the plain ``gram_from_field``
    and ``project_from_field`` instead of the kernels.

    Returns ``(variance, total, converged, n_iter_rot)``; the last is the
    rotation's iteration count (0 when not rotated).
    """
    from xmca_tpu_torch.ops.surrogate import (centered_gram_from_raw,
                                              gram_from_field,
                                              project_from_field,
                                              surrogate_gram,
                                              surrogate_project)

    device = omega.device
    seeds = [(2 * int(seed) + i) & 0xFFFFFFFF for i in range(len(n_vars))]
    H = H.to(device=device, dtype=torch.float32) if complexify else None

    grams, mus = [], []
    for i, p in enumerate(n_vars):
        if fields is None:
            G, mu, u, mumu = surrogate_gram(seeds[i], n_obs, p, dist, device)
        elif tuple(fields[i].shape) != (n_obs, p):
            raise ValueError('injected field {} must have shape {}'
                             .format(i, (n_obs, p)))
        else:
            G, mu, u, mumu = gram_from_field(fields[i])
        grams.append(_fold_jitter(centered_gram_from_raw(G, u, mumu), p,
                                  _F32_EPS, H, jitter_rel))
        mus.append(mu)

    def project(i, S):
        if fields is None:
            return surrogate_project(seeds[i], S, n_obs, n_vars[i], dist,
                                     device)
        return project_from_field(fields[i], S)

    return _surrogate_spectrum(grams, mus, project, n_obs, n_vars, H,
                               rotated, omega, n_rot, power, tol, n_iter,
                               polar_method)
