"""Varimax / Promax rotation as fixed-point iterations on tensors.

Counterpart of ``xmca_tpu/core/rotation.py``.  The JAX ``lax.while_loop``
becomes a Python loop with the same condition and the same tolerance
clamp; the convergence scalar is read on the host once per iteration
(the ``sync`` site 'varimax.criterion' of :mod:`xmca_tpu_torch.utils.
trace`; a profiled ``varimax`` span holds its ``iterations`` and the
polar's ``polar_steps``).
Non-convergence is a returned flag, not an exception, so Monte-Carlo
ensembles can drop the run.  Inside a
:func:`~xmca_tpu_torch.parallel.mesh.space_context` the loading rows are
sharded over space: every sum over rows (the criterion, the column sums
of squares, promax's column maxima and least-squares Grams) is reduced
over the shards and the row count is the global one.
"""
import torch

from xmca_tpu_torch.core.linalg import (pinv_hermitian_diag,
                                        unitary_polar_factor)
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.utils import trace

__all__ = ['varimax', 'promax', 'ensemble_space']


def _auto_polar_method(A):
    """'svd' for CPU tensors (exact, fast there); the convergence-gated
    Newton-Schulz polar on the card, where a small dense SVD per step is
    a solver call and a matmul polar is a few GEMMs."""
    return 'svd' if A.device.type == 'cpu' else 'ns-gated'


def ensemble_space(n, p, itemsize):
    """'mode' for a tall, narrow Monte-Carlo loading stack (the one-time
    fourth-moment tensor stays under 512 MB and its build amortizes),
    else 'data' — the JAX package's gate, unchanged."""
    return ('mode'
            if p <= 32 and n >= 32 * p * p
            and n * p * p * itemsize <= 512 * 1024 ** 2
            else 'data')


@trace.spanned('varimax', iterations=0, polar_steps=0)
def varimax(A, gamma=1.0, max_iter=1000, tol=1e-8, polar_method=None,
            space=None):
    """Orthogonal Varimax rotation with Kaiser normalization.

    ``space='data'`` (default) contracts the criterion against the whole
    (n, p) stack each step; ``space='mode'`` iterates on p-space tensors
    after one fourth-moment contraction (exact rewrite, more f32
    roundoff; Monte-Carlo ensembles only).

    Returns ``(B, R, converged, n_iter)`` with ``converged`` a Python bool.
    """
    if polar_method is None:
        polar_method = _auto_polar_method(A)
    n, p = A.shape
    n = _mesh.space_total(n, A.device)
    dtype = A.dtype
    eps = float(torch.finfo(dtype).eps)
    # the relative nuclear-norm change cannot resolve below the dtype's
    # roundoff floor: f32 runs stop at their achievable accuracy
    tol = max(float(tol), 100.0 * eps)

    h = torch.sqrt(torch.sum((A * A.conj()).real, dim=1))
    An = A * (1.0 / h)[:, None].to(dtype)
    gamma_n = gamma / n

    if space == 'mode':
        G2 = _mesh.space_sum(An.mH @ An)
        Q = (An[:, :, None] * An[:, None, :]).reshape(-1, p * p)
        T = _mesh.space_sum(Q.mH @ Q)

        def criterion_of(R):
            V = G2 @ R
            col_ss = torch.sum((R.conj() * V).real, dim=0)
            W = (R[:, None, :] * R[None, :, :]).reshape(p * p, p)
            Y = (T @ W).reshape(p, p, p)
            crit1 = torch.sum(Y * R.conj()[None, :, :], dim=1)
            return crit1 - gamma_n * (V * col_ss[None, :])
    elif space in (None, 'data'):
        def criterion_of(R):
            basis = An @ R
            col_ss = _mesh.space_sum(
                torch.sum((basis * basis.conj()).real, dim=0))
            return _mesh.space_sum(An.mH @ (
                basis ** 2 * basis.conj()
                - gamma_n * (basis * col_ss[None, :])))
    else:
        raise ValueError("space must be 'data' or 'mode'")

    def rel_change(d, d_old):
        return abs(d - d_old) / (d if d != 0 else 1.0)

    i, R, d, d_old = 0, torch.eye(p, dtype=dtype, device=A.device), 0.0, 0.0
    while i < max_iter and (i == 0 or rel_change(d, d_old) >= tol):
        R, d_new = unitary_polar_factor(criterion_of(R), method=polar_method)
        d_old, d = d, trace.to_host(d_new, 'varimax.criterion', float)
        i += 1
    converged = rel_change(d, d_old) < tol
    trace.annotate(iterations=i)
    return A @ R, R, converged, i


def promax(A, power=1, max_iter=1000, tol=1e-8, polar_method=None,
           space=None):
    """Oblique Promax rotation (``power=1`` is Varimax).

    Returns ``(B, R, phi, converged, n_iter)``.
    """
    p = A.shape[1]
    dtype = A.dtype
    X, R, converged, n_iter = varimax(
        A, max_iter=max_iter, tol=tol, polar_method=polar_method,
        space=space,
    )
    if power == 1:
        phi = torch.eye(p, dtype=dtype, device=A.device)
        return X, R, phi, converged, n_iter

    # Kaiser pre-normalization by communalities, column max-normalization
    h = torch.sqrt(torch.sum((X * X.conj()).real, dim=1))
    Xn_rows = X * (1.0 / h)[:, None].to(dtype)
    # a shard may hold no rows (a space-axis resample): its maxima are 0
    col_max = _mesh.space_max(
        torch.abs(Xn_rows).amax(dim=0) if Xn_rows.shape[0]
        else Xn_rows.new_zeros(p, dtype=Xn_rows.real.dtype))
    Xn = Xn_rows / col_max[None, :]
    # Procrustes target (Richman 1986) and least-squares fit
    P = Xn * torch.abs(Xn) ** (power - 1)
    G = _mesh.space_sum(Xn_rows.mH @ Xn_rows)
    L = torch.linalg.solve(G, _mesh.space_sum(Xn_rows.mH @ P))
    # rescale columns by sqrt(diag(inv(L^H L)))
    L = L @ torch.sqrt(pinv_hermitian_diag(L.mH @ L).to(dtype))

    B = h[:, None].to(dtype) * (Xn_rows @ L)
    R = R @ L
    L_inv = torch.linalg.inv(L)
    return B, R, L_inv @ L_inv.mH, converged, n_iter
