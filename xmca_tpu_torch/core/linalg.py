"""Field decompositions, polar factors and Newton-Schulz iterations on
torch tensors.

Counterpart of ``xmca_tpu/core/linalg.py``.  Every matmul here is a plain
``@`` at the tensors' own precision: float32 on the card runs in full f32
(PyTorch's default, TF32 off), which is at least as accurate as the JAX
package's ``HIGHEST`` tier, and there is no counterpart of its 3-pass
``HIGH`` tier.  The small dense factorizations (``eigh``, ``svd``) are
``torch.linalg``'s on every device: cuSOLVER on the card, LAPACK on the
CPU.  Not ported: ``_kernel_svd_polar`` (a QDWH stand-in for the TPU's
slow dense SVD) and ``randomized_decomposition`` (no caller).
"""
import torch

from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.utils import trace

__all__ = ['safe_reciprocal', 'field_decomposition', 'kernel_svd',
           'pinv_hermitian_diag', 'ns_polar_schedule', 'ns_polar_apply',
           'ns_polar_iterate', 'ns_polar_iterate_scaled',
           'unitary_polar_factor']


def safe_reciprocal(s, rel_cutoff=None):
    """1/s with entries below a relative cutoff zeroed (rank deficiency)."""
    if rel_cutoff is None:
        rel_cutoff = torch.finfo(s.dtype).eps * s.shape[-1] * 10
    cutoff = torch.amax(s, dim=-1, keepdim=True) * rel_cutoff
    keep = s > cutoff
    return torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def _nan_unless_finite(A, shapes):
    """NaN tensors of ``shapes`` (pairs of a shape and True for ``A``'s
    dtype, False for its real dtype) when ``A`` holds a NaN or an
    infinity (on any space shard), else None.  A factorization of such an
    input returns these instead of raising, as XLA's do in the JAX
    package (one host read)."""
    if _mesh.space_all(bool(torch.isfinite(A).all()), A.device):
        return None
    return tuple(torch.full(shape, float('nan'), device=A.device,
                            dtype=A.dtype if same else A.real.dtype)
                 for shape, same in shapes)


def field_decomposition(X, method='gram'):
    """Thin SVD ``X = K @ diag(L) @ M^H`` with ``r = min(n, p)`` modes.

    ``method='gram'``: eigendecompose the smaller Gram matrix (``X^H X``
    if p <= n, else ``X X^H``) and recover the other factor with one
    matmul; ``method='svd'``: a direct ``torch.linalg.svd``.  A
    non-finite ``X`` gives NaN factors.

    Returns ``K (n, r)``, ``L (r,)`` descending and ``M (p, r)``.

    Inside a space context ``X`` is this rank's block of columns and ``M``
    its rows: with 'gram' on a field wider than long, the ``X X^H`` Gram
    is the sum of the shards'; otherwise the blocks are gathered, the
    whole field is decomposed on every rank and each keeps its rows.
    """
    n, p = X.shape
    if _mesh.space_sharded():
        p_all = _mesh.space_total(p, X.device)
        if method != 'gram' or p_all <= n:
            full, lo = _mesh.space_gather_cols(X)
            with _mesh.space_context(None):
                K, L, M = field_decomposition(full, method)
            return K, L, M[lo:lo + p]
    else:
        p_all = p
    r = min(n, p_all)
    nan = _nan_unless_finite(X, (((n, r), True), ((r,), False),
                                 ((p, r), True)))
    if nan is not None:
        return nan
    if method == 'svd':
        K, L, Mh = torch.linalg.svd(X, full_matrices=False)
        return K, L, Mh.mH
    if method != 'gram':
        raise ValueError('method must be one of {"gram", "svd"}')
    if p_all <= n:
        w, V = torch.linalg.eigh(X.mH @ X)            # ascending
        w, V = torch.flip(w, (-1,)), torch.flip(V, (-1,))
        L = torch.sqrt(torch.clamp(w, min=0.0))
        K = X @ (V * safe_reciprocal(L))
        M = V
    else:
        w, Q = torch.linalg.eigh(_mesh.space_sum(X @ X.mH))
        w, Q = torch.flip(w, (-1,)), torch.flip(Q, (-1,))
        L = torch.sqrt(torch.clamp(w, min=0.0))
        K = Q
        M = X.mH @ (Q * safe_reciprocal(L))
    return K[:, :r], L[:r], M[:, :r]


def kernel_svd(K, compute_uv=True):
    """Thin SVD ``(U, s, Vh)`` of a small dense kernel matrix (only ``s``
    when ``compute_uv`` is False); NaN for a non-finite ``K``."""
    m, n = K.shape
    r = min(m, n)
    nan = _nan_unless_finite(K, (((m, r), True), ((r,), False),
                                 ((r, n), True)))
    if not compute_uv:
        return torch.linalg.svdvals(K) if nan is None else nan[1]
    return torch.linalg.svd(K, full_matrices=False) if nan is None else nan


def pinv_hermitian_diag(H):
    """``diag(diag(pinv(H)))``: the inverse's diagonal, degrading
    gracefully (pseudo-inverse) for a singular ``H``."""
    return torch.diag(torch.diag(torch.linalg.pinv(H)))


def ns_polar_schedule(l0=1e-9, tol=1e-7, max_steps=64):
    """Greedy minimax scale schedule for the SCALED cubic NS iteration.

    One cubic step maps a singular value ``x`` to ``f(s x)`` with
    ``f(y) = 1.5 y - 0.5 y^3``; ``s = sqrt(3 / (u^2 + u l + l^2))`` is the
    per-step minimax choice over the spectrum interval ``[l, u]``.
    Returns the host-side scale list reaching ``min sval >= 1 - tol`` from
    a worst-case ``sigma_min / ||.||_F >= l0`` (host copy of the JAX
    package's schedule, same numbers).
    """
    scales, l, u = [], float(l0), 1.0
    for _ in range(max_steps):
        if l >= 1.0 - tol:
            break
        s = (3.0 / (u * u + u * l + l * l)) ** 0.5
        scales.append(s)

        def f(y):
            return 1.5 * y - 0.5 * y ** 3

        fl, fu = f(s * l), f(s * u)
        l = min(fl, fu)
        u = 1.0 if s * u >= 1.0 else max(fl, fu)
    return scales


def _prescale(A):
    """``A / ||A||_F``, zero-safe (a zero matrix stays zero)."""
    fro = torch.linalg.norm(A)
    return A / torch.where(fro == 0, torch.ones_like(fro), fro)


def ns_polar_apply(W, scales):
    """Scaled NS steps ``W <- 1.5 s W - 0.5 s^3 W (W^H W)`` on an
    already-prescaled iterate."""
    for s in scales:
        W = (1.5 * s) * W - (0.5 * s ** 3) * (W @ (W.mH @ W))
    return W


def ns_polar_iterate(A, n_steps):
    """Fixed-count unscaled Newton-Schulz polar iterate of ``A``."""
    W = _prescale(A)
    for _ in range(n_steps):
        W = 1.5 * W - 0.5 * (W @ (W.mH @ W))
    return W


def ns_polar_iterate_scaled(A, scales):
    """Scaled Newton-Schulz polar iterate with a precomputed schedule."""
    return ns_polar_apply(_prescale(A), scales)


def _trace_real(W, A):
    return torch.real(torch.trace(W.mH @ A))


def unitary_polar_factor(A, method='svd'):
    """Unitary polar factor of ``A`` plus its nuclear norm, ``(W, d)``.

    ``'svd'``: exact, ``U V^H`` and ``sum(s)`` from a dense SVD.
    ``'ns'``: 30 unscaled Newton-Schulz steps; ``'ns<k>'``: k steps (for
    well-conditioned noise criteria).  ``'ns-gated'``: iterate on the
    orthogonality defect ``||W^H W - I||_F`` until it drops below
    ``10 k eps`` or 80 steps; the defect is read on the host once per
    step, like the JAX ``while_loop``'s condition (the ``sync`` site
    'polar.defect').  The Newton-Schulz steps taken are added to the open
    span's ``polar_steps`` (:mod:`xmca_tpu_torch.utils.trace`).
    """
    if method.startswith('ns') and method[2:].isdigit():
        trace.add('polar_steps', int(method[2:]))
        W = ns_polar_iterate(A, int(method[2:]))
        return W, _trace_real(W, A)
    if method == 'ns':
        trace.add('polar_steps', 30)
        W = ns_polar_iterate(A, 30)
        return W, _trace_real(W, A)
    if method == 'ns-gated':
        W = _prescale(A)
        k = A.shape[-1]
        eye = torch.eye(k, dtype=A.dtype, device=A.device)
        defect_tol = 10.0 * k * torch.finfo(A.dtype).eps
        i, defect = 0, float('inf')
        while i < 80 and defect > defect_tol:
            H = W.mH @ W
            defect = trace.to_host(torch.linalg.norm(H - eye),
                                   'polar.defect', float)
            W = 1.5 * W - 0.5 * (W @ H)
            i += 1
        trace.add('polar_steps', i)
        return W, _trace_real(W, A)
    if method == 'svd':
        u, s, vh = torch.linalg.svd(A)
        return u @ vh, torch.sum(s)
    raise NotImplementedError(
        'polar method {!r} is not ported (svd, ns, ns<k>, ns-gated are)'
        .format(method))
