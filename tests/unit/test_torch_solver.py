"""The port's exact solve (``core/linalg.py`` decompositions and
``core/solver.py``) against the JAX package at float64 on CPU.

Both packages get the same numpy-seeded inputs and run the same algebra
through LAPACK/BLAS, so singular values agree to 1e-10 relative and
singular vectors to 1e-8 after per-mode unit-factor alignment (LAPACK
and torch may pick another sign or phase for a mode).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.conftest import align_modes
from xmca_tpu.core import linalg as jlin
from xmca_tpu.core import solver as jsol
from xmca_tpu_torch.core import linalg as tlin
from xmca_tpu_torch.core import solver as tsol

SV_RTOL = 1e-10
VEC_ATOL = 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(n, p, cplx, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    if cplx:
        X = X + 1j * rng.standard_normal((n, p))
    return X


def _n(x):
    return x.resolve_conj().numpy()


def _svals_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=SV_RTOL,
                               atol=SV_RTOL * np.abs(ref).max())


def _vecs_close(got, ref, modes=None):
    got, ref = np.asarray(got)[:, :modes], np.asarray(ref)[:, :modes]
    np.testing.assert_allclose(align_modes(got, ref), ref, rtol=0,
                               atol=VEC_ATOL)


def test_safe_reciprocal():
    s = np.array([[4.0, 2.0, 1e-3, 1e-17, 0.0], [1.0, 1e-14, 3.0, 0.5, 2.0]])
    for cutoff in (None, 1e-2):
        np.testing.assert_array_equal(
            _n(tlin.safe_reciprocal(_t(s), cutoff)),
            np.asarray(jlin.safe_reciprocal(jnp.asarray(s), cutoff)))


@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('method,shape', [('gram', (48, 30)),
                                          ('gram', (30, 48)),
                                          ('svd', (48, 30)),
                                          ('svd', (30, 48))])
def test_field_decomposition(method, shape, cplx):
    """Both Gram branches (p <= n, p > n) and the direct SVD."""
    X = _data(*shape, cplx, seed=1)
    K_j, L_j, M_j = jlin.field_decomposition(jnp.asarray(X), method)
    K_t, L_t, M_t = tlin.field_decomposition(_t(X), method)
    assert K_t.shape == K_j.shape and M_t.shape == M_j.shape
    _svals_close(_n(L_t), L_j)
    _vecs_close(_n(K_t), K_j)
    _vecs_close(_n(M_t), M_j)
    # the factors reproduce X
    np.testing.assert_allclose(_n((K_t * L_t) @ M_t.mH), X, rtol=0, atol=1e-10)


@pytest.mark.parametrize('cplx', [False, True])
def test_kernel_svd(cplx):
    K = _data(20, 15, cplx, seed=2)
    U_j, s_j, Vh_j = jlin.kernel_svd(jnp.asarray(K))
    U_t, s_t, Vh_t = tlin.kernel_svd(_t(K))
    _svals_close(_n(s_t), s_j)
    _vecs_close(_n(U_t), U_j)
    _vecs_close(_n(Vh_t.mH), np.asarray(Vh_j).conj().T)
    _svals_close(_n(tlin.kernel_svd(_t(K), compute_uv=False)),
                 jlin.kernel_svd(jnp.asarray(K), compute_uv=False))


@pytest.mark.parametrize('singular', [False, True])
def test_pinv_hermitian_diag(singular):
    A = _data(6, 6, True, seed=3)
    H = A @ A.conj().T
    if singular:
        H = A[:, :4] @ A[:, :4].conj().T
    np.testing.assert_allclose(
        _n(tlin.pinv_hermitian_diag(_t(H))),
        np.asarray(jlin.pinv_hermitian_diag(jnp.asarray(H))), rtol=1e-9,
        atol=1e-12)


def _fields(wide, cplx):
    """Two centered fields with five shared modes: n < p (``wide``) or
    n > p."""
    n, p_l, p_r = (40, 90, 70) if wide else (90, 40, 30)
    rng = np.random.default_rng(4)
    t = np.arange(n)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 6)[None] / n)
    out = []
    for p in (p_l, p_r):
        X = modes @ rng.standard_normal((5, p)) + rng.standard_normal((n, p))
        if cplx:
            X = X + 1j * (np.cos(2 * np.pi * t[:, None] / n)
                          * rng.standard_normal((1, p)))
        out.append(X - X.mean(0))
    return out


# the centered fields have rank n - 1 (wide) or p; the null mode's
# vectors are arbitrary, so vectors are compared over the leading 20
@pytest.mark.parametrize('method', ['gram', 'svd'])
@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('wide', [True, False])
def test_solves(wide, cplx, method):
    """solve_mca, solve_pca, solve (both arities), solve_svals and
    solve_truncated."""
    Xl, Xr = _fields(wide, cplx)
    jl, jr, tl, tr = jnp.asarray(Xl), jnp.asarray(Xr), _t(Xl), _t(Xr)
    s_j, Vl_j, Vr_j = jsol.solve_mca(jl, jr, method=method)
    s_t, Vl_t, Vr_t = tsol.solve_mca(tl, tr, method=method)
    _svals_close(_n(s_t), s_j)
    _vecs_close(_n(Vl_t), Vl_j, 20)
    _vecs_close(_n(Vr_t), Vr_j, 20)

    s_j, V_j = jsol.solve_pca(jl, method=method)
    s_t, V_t = tsol.solve_pca(tl, method=method)
    _svals_close(_n(s_t), s_j)
    _vecs_close(_n(V_t), V_j, 20)
    s_t1, (V_t1,) = tsol.solve([tl], method=method)
    np.testing.assert_array_equal(_n(s_t1), _n(s_t))
    np.testing.assert_array_equal(_n(V_t1), _n(V_t))
    s_t2, Vs_t2 = tsol.solve([tl, tr], method=method)
    assert len(Vs_t2) == 2

    for right in (jr, None):
        s_j = jsol.solve_svals(jl, right, method=method)
        s_t = tsol.solve_svals(tl, None if right is None else tr,
                               method=method)
        _svals_close(_n(s_t), s_j)

    s_j, Vl_j, Vr_j = jsol.solve_truncated(jl, jr, n_modes=4, method=method)
    s_t, Vl_t, Vr_t = tsol.solve_truncated(tl, tr, n_modes=4, method=method)
    assert Vl_t.shape == Vl_j.shape == (Xl.shape[1], 4)
    _svals_close(_n(s_t), s_j)
    _vecs_close(_n(Vl_t), Vl_j)
    _vecs_close(_n(Vr_t), Vr_j)


@pytest.mark.parametrize('bivariate,power,cplx', [(True, 1, False),
                                                  (True, 2, True),
                                                  (False, 1, True),
                                                  (False, 3, False)])
def test_solve_rotated_variance(bivariate, power, cplx):
    Xl, Xr = _fields(True, cplx)
    right = Xr if bivariate else None
    var_j, conv_j = jsol.solve_rotated_variance(
        jnp.asarray(Xl), None if right is None else jnp.asarray(right),
        n_rot=4, power=power, bivariate=bivariate)
    var_t, conv_t = tsol.solve_rotated_variance(
        _t(Xl), None if right is None else _t(right), n_rot=4, power=power,
        bivariate=bivariate)
    assert conv_t is True and bool(conv_j)
    np.testing.assert_allclose(_n(var_t), np.asarray(var_j), rtol=1e-8)
