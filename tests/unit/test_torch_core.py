"""The port's core algebra against the JAX package at float64 on CPU.

Every test feeds the same numpy-seeded inputs (and, for the subspace
iteration, the JAX package's own start block) to the JAX function and
its counterpart in ``xmca_tpu_torch.core``.  Both run the same algebra
through LAPACK/BLAS in float64, so the tolerances are roundoff-sized:
1e-9 relative unless a test says otherwise.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xmca_tpu.core import fastpath as jfast
from xmca_tpu.core import linalg as jlin
from xmca_tpu.core import rotation as jrot
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.core import linalg as tlin
from xmca_tpu_torch.core import preprocess as tpre
from xmca_tpu_torch.core import rotation as trot

RTOL = 1e-9          # f64 roundoff through the same LAPACK/BLAS algebra


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope='module')
def fields():
    """Two centered (n, p) fields with a few shared modes, n < p."""
    rng = np.random.default_rng(0)
    n, p_l, p_r = 48, 150, 130
    t = np.arange(n)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 6)[None] / n)
    Xl = modes @ rng.standard_normal((5, p_l)) + rng.standard_normal(
        (n, p_l))
    Xr = modes @ rng.standard_normal((5, p_r)) + rng.standard_normal(
        (n, p_r))
    return Xl - Xl.mean(0), Xr - Xr.mean(0)


def _align(A, B):
    """A's columns times the unit factors that best match B's."""
    ip = np.sum(np.conj(A) * B, axis=0)
    return A * ip / np.abs(ip)


def test_ns_polar_schedule_matches():
    for l0, tol in ((1e-9, 1e-8), (1e-7, 1e-4), (1e-3, 1e-6)):
        assert tlin.ns_polar_schedule(l0, tol) == jlin.ns_polar_schedule(
            l0, tol)


@pytest.mark.parametrize('method', ['svd', 'ns', 'ns14', 'ns-gated'])
@pytest.mark.parametrize('cplx', [False, True])
def test_unitary_polar_factor(method, cplx):
    rng = np.random.default_rng(1)
    A = rng.standard_normal((6, 6))
    if cplx:
        A = A + 1j * rng.standard_normal((6, 6))
    # well-conditioned: the fixed-count NS variants converge on it
    A = A + 4 * np.eye(6)
    W_j, d_j = jlin.unitary_polar_factor(jnp.asarray(A), method=method)
    W_t, d_t = tlin.unitary_polar_factor(_t(A), method=method)
    np.testing.assert_allclose(_np(W_t), np.asarray(W_j), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=RTOL)


def test_hilbert_matrix_and_analytic_signal(fields):
    n = fields[0].shape[0]
    np.testing.assert_allclose(tfast.hilbert_imag_matrix(n),
                               jfast.hilbert_imag_matrix(n, np.float64),
                               rtol=0, atol=1e-14)
    Z = tpre.analytic_signal(_t(fields[0]))
    H = tfast.hilbert_imag_matrix(n)
    np.testing.assert_allclose(Z.numpy(), fields[0] + 1j * (H @ fields[0]),
                               rtol=0, atol=1e-12)


def test_analytic_fold_and_reduced_kernel(fields):
    Xl, Xr = fields
    H = jfast.hilbert_imag_matrix(Xl.shape[0], np.float64)
    G = Xl @ Xl.T
    np.testing.assert_allclose(
        tfast._analytic_fold(_t(G), _t(H)).numpy(),
        np.asarray(jfast._analytic_fold(jnp.asarray(G), jnp.asarray(H))),
        rtol=RTOL, atol=1e-9)
    M_j, La_j, _ = jfast.analytic_reduced_kernel(
        jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H))
    M_t, La_t, _ = tfast.analytic_reduced_kernel(_t(Xl), _t(Xr), _t(H))
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=RTOL,
                               atol=1e-9)
    np.testing.assert_allclose(La_t.numpy(), np.asarray(La_j), rtol=RTOL,
                               atol=1e-9)
    M_j, _, _ = jfast.reduced_kernel(jnp.asarray(Xl), jnp.asarray(Xr))
    M_t, _, _ = tfast.reduced_kernel(_t(Xl), _t(Xr))
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), rtol=RTOL,
                               atol=1e-9)


@pytest.mark.parametrize('orth', ['qr', 'cholqr2'])
def test_subspace_svd_with_jax_start_block(fields, orth):
    Xl, Xr = fields
    H = jfast.hilbert_imag_matrix(Xl.shape[0], np.float64)
    M, _, _ = jfast.analytic_reduced_kernel(
        jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H))
    key = jax.random.PRNGKey(3)
    k, n_iter = 4, 8
    kk = min(k + 16, *M.shape)
    omega = np.asarray(jax.random.normal(key, (M.shape[1], kk),
                                         jnp.float64))
    U_j, s_j, V_j = jfast.subspace_svd(M, key, k=k, n_iter=n_iter,
                                       orth=orth)
    U_t, s_t, V_t = tfast.subspace_svd(_t(np.asarray(M)), _t(omega), k=k,
                                       n_iter=n_iter, orth=orth)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    np.testing.assert_allclose(_align(U_t.numpy(), np.asarray(U_j)),
                               np.asarray(U_j), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_align(V_t.numpy(), np.asarray(V_j)),
                               np.asarray(V_j), rtol=0, atol=1e-8)


@pytest.fixture(scope='module')
def tail_factors():
    """``(La, Lb, dof)`` of a complexified pair at the n x n tail's shape
    (n = 300; 12 shared modes of falling amplitude plus noise), complex128
    from the port's data route."""
    rng = np.random.default_rng(1)
    n, p_l, p_r = 300, 420, 380
    t = np.arange(n)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 13)[None] / n) \
        * np.linspace(6, 1, 12)[None]
    Xl, Xr = (modes @ rng.standard_normal((12, p)) + rng.standard_normal(
        (n, p)) for p in (p_l, p_r))
    Xl, Xr = Xl - Xl.mean(0), Xr - Xr.mean(0)
    H = tfast.hilbert_imag_matrix(n, np.float64)
    La, Lb = tfast._data_reduce(_t(Xl), _t(Xr), _t(H), None, 0, 0, 1e-6,
                                form=True)[:2]
    assert La.dtype == torch.complex128
    return La, Lb, n - 1


@pytest.mark.parametrize('dtype', [torch.complex128, torch.complex64])
def test_subspace_svd_through_the_factors(tail_factors, dtype):
    """The subspace SVD applied through the factors ``(La, Lb, dof)``
    against the same kernel formed, from one start block, k = 10 and six
    rounds: in complex128 the spectra agree to 1e-10 and the vectors to
    1e-8; in complex64 (TF32 off) the factored route's spectrum lies
    within 2x of the formed route's error (relative, in the 2-norm)
    against the complex128 one."""
    assert torch.get_float32_matmul_precision() == 'highest'
    La, Lb, dof = tail_factors
    k, n_iter = 10, 6
    omega = tfast.start_block(La.shape[0], k, torch.complex128,
                              torch.Generator().manual_seed(5))
    ref = tfast.subspace_svd((La.mH @ Lb) / dof, omega, k, n_iter)
    La, Lb = La.to(dtype), Lb.to(dtype)
    formed = tfast.subspace_svd((La.mH @ Lb) / dof, omega, k, n_iter)
    factored = tfast.subspace_svd((La, Lb, dof), omega, k, n_iter)
    for out in (formed, factored):
        assert all(x.dtype == dtype for x in (out[0], out[2]))
    if dtype == torch.complex128:
        np.testing.assert_allclose(factored[1].numpy(), formed[1].numpy(),
                                   rtol=1e-10)
        for i in (0, 2):
            got, want = factored[i].numpy(), formed[i].numpy()
            np.testing.assert_allclose(_align(got, want), want, rtol=0,
                                       atol=1e-8)
        return
    s_ref = ref[1].numpy()
    err_formed, err_factored = (
        np.linalg.norm(out[1].double().numpy() - s_ref)
        / np.linalg.norm(s_ref) for out in (formed, factored))
    assert 0 < err_factored <= 2 * err_formed


def test_nuclear_norms(fields):
    Xl, Xr = fields
    H = jfast.hilbert_imag_matrix(Xl.shape[0], np.float64)
    M, _, _ = jfast.analytic_reduced_kernel(
        jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H))
    exact = np.linalg.svd(np.asarray(M), compute_uv=False).sum()
    nn_t = float(tfast.nuclear_norm(_t(np.asarray(M))))
    np.testing.assert_allclose(nn_t, float(jfast.nuclear_norm(M)),
                               rtol=RTOL)
    np.testing.assert_allclose(nn_t, exact, rtol=1e-7)
    np.testing.assert_allclose(
        float(tfast.nuclear_norm_surrogate(_t(np.asarray(M)))),
        float(jfast.nuclear_norm_surrogate(M)), rtol=RTOL)


@pytest.mark.parametrize('analytic', [False, True])
def test_fast_solve_truncated_totals(fields, analytic):
    """The whole truncated solve: spectrum and totals to 1e-9, spatial
    vectors to 1e-8 after per-mode phase alignment."""
    Xl, Xr = fields
    n = Xl.shape[0]
    key = jax.random.PRNGKey(0)
    k = 4
    dtype = jnp.complex128 if analytic else jnp.float64
    omega = np.asarray(jax.random.normal(key, (n, min(k + 16, n)),
                                         jnp.float64)).astype(dtype)
    if analytic:
        H = jfast.hilbert_imag_matrix(n, np.float64)
        out_j = jfast.fast_solve_truncated_totals_analytic(
            jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H), key,
            n_modes=k, n_iter=12)
        out_t = tfast.fast_solve_truncated_totals_analytic(
            _t(Xl), _t(Xr), _t(H), _t(omega), n_modes=k, n_iter=12)
    else:
        out_j = jfast.fast_solve_truncated_totals(
            jnp.asarray(Xl), jnp.asarray(Xr), key, n_modes=k, n_iter=12)
        out_t = tfast.fast_solve_truncated_totals(
            _t(Xl), _t(Xr), _t(omega), n_modes=k, n_iter=12)
    s_j, Vl_j, Vr_j, cov_j, sq_j = (np.asarray(o) for o in out_j)
    s_t, Vl_t, Vr_t, cov_t, sq_t = (_np(o) for o in out_t)
    np.testing.assert_allclose(s_t, s_j, rtol=RTOL)
    np.testing.assert_allclose(cov_t, cov_j, rtol=RTOL)
    np.testing.assert_allclose(sq_t, sq_j, rtol=RTOL)
    np.testing.assert_allclose(_align(Vl_t, Vl_j), Vl_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(_align(Vr_t, Vr_j), Vr_j, rtol=0, atol=1e-8)


def _loadings(cplx, n, p, seed):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, p)) * np.linspace(3, 1, p)[None]
    if cplx:
        L = L + 1j * rng.standard_normal((n, p)) * np.linspace(3, 1, p)
    return L


@pytest.mark.parametrize('space', ['data', 'mode'])
@pytest.mark.parametrize('polar', ['svd', 'ns-gated'])
@pytest.mark.parametrize('cplx', [False, True])
def test_varimax(space, polar, cplx):
    """Same fixed point, same iteration count: B and R to 1e-8."""
    A = _loadings(cplx, 400, 4, 5)
    B_j, R_j, conv_j, it_j = jrot.varimax(
        jnp.asarray(A), tol=1e-10, polar_method=polar, space=space)
    B_t, R_t, conv_t, it_t = trot.varimax(
        _t(A), tol=1e-10, polar_method=polar, space=space)
    assert conv_t and bool(conv_j)
    assert it_t == int(it_j)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize('cplx', [False, True])
def test_promax(cplx):
    A = _loadings(cplx, 300, 4, 6)
    B_j, R_j, phi_j, conv_j, _ = jrot.promax(jnp.asarray(A), power=3)
    B_t, R_t, phi_t, conv_t, _ = trot.promax(_t(A), power=3)
    assert conv_t and bool(conv_j)
    for got, ref in ((B_t, B_j), (R_t, R_j), (phi_t, phi_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-8)


def test_ensemble_space_gate_matches():
    for n, p, item in ((200000, 10, 8), (2000, 10, 8), (10 ** 7, 10, 8),
                       (100000, 40, 4)):
        assert trot.ensemble_space(n, p, item) == jrot.ensemble_space(
            n, p, item)


def test_jitter_matches(fields):
    G = fields[0] @ fields[0].T
    for input_eps in (None, 2.0 ** -7):
        got = tfast._jitter(_t(G), 150, 1e-6, input_eps).numpy()
        ref = np.asarray(jfast._jitter(jnp.asarray(G), 150, 1e-6,
                                       input_eps))
        np.testing.assert_allclose(got, ref, rtol=1e-14)
