"""The port's ensemble pieces against the JAX package at float64 on CPU.

* the Hilbert operator built on the device (circulant, one FFT) against
  the host build of both packages, and the analytic signal in column
  chunks against JAX's;
* the bootstrap's block indices;
* the four per-run spectra of ``core.fastpath`` and
  ``stats.significance._surrogate_variance`` against JAX's on the same
  (resampled) fields, with the JAX package's own start block injected.

Both packages run the same algebra in float64; each test states its
tolerance.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from xmca_tpu.core import fastpath as jfast
from xmca_tpu.stats import significance as jsig
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.stats import significance as tsig

N, P_L, P_R, K = 48, 150, 130, 4
# f64 roundoff through the same algebra; the rotations stop at tol 1e-8
# after the same number of steps in both packages
RTOL = 1e-8


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def fields():
    """Two (48, p) fields with five shared modes, resampled in blocks of
    8 steps with replacement (the same rows for both packages)."""
    rng = np.random.default_rng(0)
    t = np.arange(N)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 6)[None] / N)
    Xl = modes @ rng.standard_normal((5, P_L)) + rng.standard_normal(
        (N, P_L))
    Xr = modes @ rng.standard_normal((5, P_R)) + rng.standard_normal(
        (N, P_R))
    blocks = rng.integers(0, N // 8, N // 8)
    idx = (blocks[:, None] * 8 + np.arange(8)[None]).reshape(-1)
    return Xl[idx], Xr[idx]


def _centered(fields, cplx):
    out = [f - f.mean(0) for f in fields]
    if cplx:
        H = jfast.hilbert_imag_matrix(N, np.float64)
        out = [f + 1j * (H @ f) for f in out]
    return out


def _omega(key, k):
    """The start block JAX's subspace_svd draws from ``key``."""
    kk = min(k + 16, N)
    return np.asarray(jax.random.normal(key, (N, kk), jnp.float64))


@pytest.mark.parametrize('n', [1, 2, 7, 64, 65, 300])
def test_hilbert_operator_matches_host_build(n):
    """The circulant device build against both host builds (float64,
    1e-12 absolute) and in float32 (one f32 rounding, 1e-7)."""
    H = tfast.hilbert_operator(n)
    ref = jfast.hilbert_imag_matrix(n, np.float64)
    assert H.shape == (n, n) and H.dtype == torch.float64
    assert H.is_contiguous()
    np.testing.assert_allclose(H.numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tfast.hilbert_imag_matrix(n), ref, rtol=0,
                               atol=1e-12)
    H32 = tfast.hilbert_operator(n, torch.float32)
    assert H32.dtype == torch.float32
    np.testing.assert_allclose(H32.numpy(), ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize('chunk_elems', [1 << 28, N * 7, N * 50])
def test_analytic_signal_column_chunks(monkeypatch, chunk_elems):
    """One batched FFT, 22 equal chunks of 7 columns (the last shorter),
    and 3 of 50 (the last 50 too) give JAX's analytic signal (1e-12)."""
    from xmca_tpu.core.preprocess import analytic_signal as janalytic
    from xmca_tpu_torch.core import preprocess as tpre
    monkeypatch.setattr(tpre, '_CHUNK_ELEMS', chunk_elems)
    x = np.random.default_rng(2).standard_normal((N, P_L))
    np.testing.assert_allclose(tpre.analytic_signal(_t(x)).numpy(),
                               np.asarray(janalytic(jnp.asarray(x))),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize('replace', [True, False])
@pytest.mark.parametrize('n_total,block', [(60, 1), (60, 4), (60, 60),
                                           (96, 12)])
def test_block_indices(n_total, block, replace):
    """Every index is in range and in a whole block; without replacement
    each block appears exactly once."""
    gen = torch.Generator().manual_seed(5)
    idx = tsig._block_indices(gen, n_total, block, replace)
    assert idx.dtype == torch.int64 and idx.shape == (n_total,)
    assert int(idx.min()) >= 0 and int(idx.max()) < n_total
    rows = idx.reshape(-1, block).numpy()
    starts = rows[:, 0]
    assert (starts % block == 0).all()
    np.testing.assert_array_equal(rows, starts[:, None] + np.arange(block))
    if not replace:
        np.testing.assert_array_equal(np.sort(starts),
                                      np.arange(0, n_total, block))
    again = tsig._block_indices(torch.Generator().manual_seed(5), n_total,
                                block, replace)
    assert torch.equal(idx, again)


@pytest.mark.parametrize('bivariate', [True, False])
@pytest.mark.parametrize('power', [1, 2])
def test_fast_rotated_variance_analytic(fields, bivariate, power):
    Xl, Xr = _centered(fields, False)
    H = jfast.hilbert_imag_matrix(N, np.float64)
    key = jax.random.PRNGKey(11)
    var_j, conv_j = jfast.fast_rotated_variance_analytic(
        jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H), key, n_rot=K,
        power=power, tol=1e-8, n_iter=12, bivariate=bivariate,
        polar_method='ns-gated')
    var_t, conv_t = tfast.fast_rotated_variance_analytic(
        _t(Xl), _t(Xr), _t(H), _t(_omega(key, K)).to(torch.complex128),
        n_rot=K, power=power, tol=1e-8, n_iter=12, bivariate=bivariate,
        polar_method='ns-gated')
    assert conv_t is True and bool(conv_j)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=RTOL)


@pytest.mark.parametrize('bivariate', [True, False])
@pytest.mark.parametrize('with_nuclear', [True, False])
def test_fast_spectrum_analytic(fields, bivariate, with_nuclear):
    Xl, Xr = _centered(fields, False)
    Xr = Xr if bivariate else Xl
    H = jfast.hilbert_imag_matrix(N, np.float64)
    key = jax.random.PRNGKey(12)
    s_j, tot_j = jfast.fast_spectrum_analytic(
        jnp.asarray(Xl), jnp.asarray(Xr), jnp.asarray(H), key, k=K,
        n_iter=12, with_nuclear=with_nuclear)
    s_t, tot_t = tfast.fast_spectrum_analytic(
        _t(Xl), _t(Xr), _t(H), _t(_omega(key, K)), k=K, n_iter=12,
        with_nuclear=with_nuclear)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=RTOL)


@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('bivariate', [True, False])
def test_fast_spectrum(fields, cplx, bivariate):
    Xl, Xr = _centered(fields, cplx)
    Xr = Xr if bivariate else Xl
    key = jax.random.PRNGKey(13)
    s_j, tot_j = jfast.fast_spectrum(jnp.asarray(Xl), jnp.asarray(Xr), key,
                                     k=K, n_iter=12)
    s_t, tot_t = tfast.fast_spectrum(_t(Xl), _t(Xr), _t(_omega(key, K)),
                                     k=K, n_iter=12)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=RTOL)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=RTOL)


@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('bivariate', [True, False])
def test_fast_rotated_variance(fields, cplx, bivariate):
    Xl, Xr = _centered(fields, cplx)
    key = jax.random.PRNGKey(14)
    var_j, conv_j = jfast.fast_rotated_variance(
        jnp.asarray(Xl), jnp.asarray(Xr) if bivariate else None, key,
        n_rot=K, power=2, tol=1e-8, n_iter=12, bivariate=bivariate,
        polar_method='ns-gated')
    var_t, conv_t = tfast.fast_rotated_variance(
        _t(Xl), _t(Xr) if bivariate else None, _t(_omega(key, K)), n_rot=K,
        power=2, tol=1e-8, n_iter=12, bivariate=bivariate,
        polar_method='ns-gated')
    assert conv_t is True and bool(conv_j)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=RTOL)


@pytest.mark.parametrize('spectrum', ['fast', 'exact'])
@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('rotated', [False, True])
@pytest.mark.parametrize('bivariate', [True, False])
def test_surrogate_variance(fields, spectrum, cplx, rotated, bivariate):
    """One bootstrap run's solve on resampled, uncentered fields: the
    variance (or spectrum), its total and the converged flag."""
    fs = list(fields) if bivariate else [fields[0]]
    H = jfast.hilbert_imag_matrix(N, np.float64)
    key = jax.random.PRNGKey(15)
    kw = dict(spectrum=spectrum, n_modes_fast=K, subspace_iters=12,
              hilbert_H=None, polar_method='ns-gated')
    if spectrum == 'fast' and cplx:
        kw['hilbert_H'] = H
    args = (cplx, rotated, K, 2, 1e-8, 'gram')
    var_j, tot_j, conv_j = jsig._surrogate_variance(
        [jnp.asarray(f) for f in fs], *args,
        **dict(kw, fast_key=key,
               hilbert_H=None if kw['hilbert_H'] is None
               else jnp.asarray(H)))
    omega = _t(_omega(key, K)) if spectrum == 'fast' else None
    var_t, tot_t, conv_t = tsig._surrogate_variance(
        [_t(f) for f in fs], *args,
        **dict(kw, omega=omega,
               hilbert_H=None if kw['hilbert_H'] is None else _t(H)))
    assert conv_t is True and bool(conv_j)
    assert var_t.shape == np.asarray(var_j).shape
    # the leading K values (an exact unrotated spectrum runs on to noise
    # modes near zero, where a relative tolerance means nothing)
    np.testing.assert_allclose(var_t.numpy()[:K], np.asarray(var_j)[:K],
                               rtol=RTOL)
    np.testing.assert_allclose(float(tot_t), float(tot_j), rtol=RTOL)
