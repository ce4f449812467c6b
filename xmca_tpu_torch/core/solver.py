"""The exact MCA/PCA solve on torch tensors.

Counterpart of ``xmca_tpu/core/solver.py``: per-field decomposition
``X = K L M^H`` (:func:`field_decomposition`), the score-space kernel
``(K_l L_l)^H (K_r L_r) / dof``, its SVD, and the spatial vectors
``V = M U_kernel``.  The only dense factorizations run on
``min(n_obs, n_space)``-sized matrices; every product is a plain ``@`` at
the operands' precision (f32 with TF32 off on the card, f64 in the CPU
tests).  Inside a :func:`~xmca_tpu_torch.parallel.mesh.space_context`
the fields are this rank's column blocks and the spatial vectors its
rows (:func:`field_decomposition`).
"""
import torch

from xmca_tpu_torch.core.linalg import field_decomposition, kernel_svd
from xmca_tpu_torch.core.rotation import promax
from xmca_tpu_torch.parallel import mesh as _mesh

__all__ = ['solve_mca', 'solve_pca', 'solve', 'solve_svals',
           'solve_truncated', 'solve_rotated_variance']


def _kernel(Kl, Ll, Kr, Lr, dof):
    """Cross-covariance kernel in score space: ``(K_l L_l)^H (K_r L_r)/dof``."""
    return (Ll[:, None] * (Kl.mH @ Kr) * Lr[None, :]) / dof


def solve_mca(Xl, Xr, method='gram'):
    """Bivariate MCA of centered fields ``Xl (n, p_l)``, ``Xr (n, p_r)``:
    ``(singular_values (r,), V_left (p_l, r), V_right (p_r, r))``,
    descending, ``r = min(min(n, p_l), min(n, p_r))``."""
    dof = Xl.shape[0] - 1
    Kl, Ll, Ml = field_decomposition(Xl, method)
    Kr, Lr, Mr = field_decomposition(Xr, method)
    Uk, s, Vkh = kernel_svd(_kernel(Kl, Ll, Kr, Lr, dof))
    return s, Ml @ Uk, Mr @ Vkh.mH


def solve_pca(X, method='gram'):
    """Univariate PCA (the left field twice): ``(singular_values, V)``."""
    dof = X.shape[0] - 1
    K, L, M = field_decomposition(X, method)
    Uk, s, _ = kernel_svd(_kernel(K, L, K, L, dof))
    return s, M @ Uk


def solve(fields, method='gram'):
    """Dispatch on the number of fields: ``(svals, [V per field])``."""
    if len(fields) == 1:
        s, V = solve_pca(fields[0], method=method)
        return s, [V]
    s, Vl, Vr = solve_mca(fields[0], fields[1], method=method)
    return s, [Vl, Vr]


def solve_svals(Xl, Xr=None, method='gram'):
    """The singular-value spectrum only; no spatial vectors."""
    dof = Xl.shape[0] - 1
    Kl, Ll, _ = field_decomposition(Xl, method)
    if Xr is None:
        Kr, Lr = Kl, Ll
    else:
        Kr, Lr, _ = field_decomposition(Xr, method)
    return kernel_svd(_kernel(Kl, Ll, Kr, Lr, dof), compute_uv=False)


def solve_truncated(Xl, Xr=None, n_modes=None, method='gram'):
    """Exact solve keeping only the leading ``n_modes`` spatial vectors."""
    dof = Xl.shape[0] - 1
    Kl, Ll, Ml = field_decomposition(Xl, method)
    if Xr is None:
        Kr, Lr, Mr = Kl, Ll, Ml
    else:
        Kr, Lr, Mr = field_decomposition(Xr, method)
    Uk, s, Vkh = kernel_svd(_kernel(Kl, Ll, Kr, Lr, dof))
    return (s[:n_modes], Ml @ Uk[:, :n_modes],
            Mr @ Vkh.mH[:, :n_modes])


def solve_rotated_variance(Xl, Xr=None, n_rot=10, power=1, tol=1e-8,
                           method='gram', bivariate=True):
    """Descending variance spectrum of the rotated solution
    (``solve`` + ``rotate`` + ``variance()``) and the rotation's
    ``converged`` flag (a Python bool) instead of an exception."""
    s, Vl, Vr = solve_truncated(Xl, Xr, n_modes=n_rot, method=method)
    n_vars_left = Vl.shape[0]
    sqrt_s = torch.sqrt(s).to(Vl.dtype)
    if bivariate:
        L = torch.cat([Vl, Vr], dim=0) * sqrt_s[None, :]
    else:
        # PCA: the loading stack holds only the single field's vectors
        L = Vl * sqrt_s[None, :]
    L_rot, _, _, converged, _ = promax(L, power=power, tol=tol)
    norm_left = _mesh.col_norm(L_rot[:n_vars_left])
    if bivariate:
        variance = norm_left * _mesh.col_norm(L_rot[n_vars_left:])
    else:
        variance = norm_left ** 2
    return torch.sort(variance, descending=True).values, converged
