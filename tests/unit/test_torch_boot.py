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


# ---------------------------------------------------------------------------
# The bootstrap's two routes: the stored (Gram-space) route against the
# data route, run for run, and which requests take which.
# ---------------------------------------------------------------------------

def _model_fields(fields, bivariate):
    """Centered float64 fields of a model (the fixture's rows)."""
    fs = list(fields) if bivariate else [fields[0]]
    return [_t(f - f.mean(0)) for f in fs]


def _boot(fs, monkeypatch=None, **kw):
    """``bootstrap_spectra`` of ``fs`` (3 runs, K modes, seed 11) and the
    runs it counted by route; with ``monkeypatch`` every run takes the
    data route."""
    if monkeypatch is not None:
        monkeypatch.setattr(tsig, '_gram_route', lambda *a: False)
    from xmca_tpu_torch.utils import trace
    trace.reset_counters('gram_routes')
    kw = dict(dict(n_rot=K, power=2, tol=1e-8, seed=11, spectrum='fast',
                   subspace_iters=12), **kw)
    spectra, conv = tsig.bootstrap_spectra(fs, 3, K, **kw)
    return spectra, conv, trace.counts('gram_routes')


_SIDES = [(True, False, True), (False, True, True), (True, True, True),
          (False, False, True), (True, False, False), (False, False, False)]


@pytest.mark.parametrize('block_size,replace', [(1, True), (1, False),
                                                (8, True), (8, False)])
@pytest.mark.parametrize('rotated', [False, True])
@pytest.mark.parametrize('cplx', [False, True])
@pytest.mark.parametrize('on_left,on_right,bivariate', _SIDES)
def test_stored_route_matches_data_route(fields, monkeypatch, on_left,
                                         on_right, bivariate, cplx, rotated,
                                         block_size, replace):
    """A time resample solved from the fields' Grams (``C G[idx][:, idx]
    C``, the back-projection ``X^T P^T C S``) equals the same resample
    gathered and solved as data, run for run: one and two fields, each
    allowed pair of resampled sides, real and complexified (the analytic
    fold), unrotated and promax-rotated, blocks of 1 and 8 steps drawn
    with and without replacement."""
    fs = _model_fields(fields, bivariate)
    kw = dict(on_left=on_left, on_right=on_right, block_size=block_size,
              replace=replace, complexify=cplx, rotated=rotated,
              hilbert_H=tfast.hilbert_operator(N) if cplx else None)
    got, conv, routes = _boot(fs, **kw)
    assert routes == {'stored': 3}
    want, conv_d, routes_d = _boot(fs, monkeypatch, **kw)
    assert routes_d == {'data': 3}
    assert conv.all() and conv_d.all()
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize('case', ['extend', 'axis1', 'exact'])
def test_data_route_serves_extension_columns_and_exact(fields, case):
    """An extended complexified bootstrap (each resample's boundary
    forecast changes), a column resample and the exact spectrum take the
    data route in every run."""
    fs = _model_fields(fields, True)
    kw = {'extend': dict(complexify=True, extend='exp', period=1),
          'axis1': dict(axis=1, block_size=10),
          'exact': dict(spectrum='exact')}[case]
    _, conv, routes = _boot(fs, rotated=True, **kw)
    assert routes == {'data': 3} and conv.all()


def test_iterative_api_bootstrap_takes_stored_route():
    """``bootstrapping(strategy='iterative')`` of a complexified, rotated
    in-memory model: every run of every round in Gram space."""
    from xmca_tpu_torch.array import MCA
    from xmca_tpu_torch.utils import trace
    rng = np.random.default_rng(3)
    t = np.arange(64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 6)[None] / 64)
    left, right = (modes @ rng.standard_normal((5, p))
                   + rng.standard_normal((64, p)) for p in (90, 70))
    m = MCA(left, right, device='cpu')
    m.set_solver(truncate=6, seed=2)
    m.solve(complexify=True)
    m.rotate(4)
    trace.reset_counters('gram_routes')
    out = np.asarray(m.bootstrapping(2, n_modes=3, block_size=8,
                                     strategy='iterative', seed=9))
    assert trace.counts('gram_routes') == {'stored': 2 * 3}
    assert np.isfinite(out).all() and (out != 0).any()


@pytest.mark.parametrize('n_runs', [1, 3])
def test_stored_route_products_over_the_data(fields, monkeypatch, n_runs):
    """A rotated, complexified time-axis bootstrap of two fields makes
    two Gram products a call and two back-projections a run over the
    data, and no product or any other operation gives a tensor of data
    size (n_obs x columns)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    fs = _model_fields(fields, True)
    shapes = []
    real_dot = tfast._data_dot

    def counted(a, b):
        shapes.append((tuple(a.shape), tuple(b.shape)))
        return real_dot(a, b)

    monkeypatch.setattr(tfast, '_data_dot', counted)
    largest = [0]

    def storages(tree):
        return {x.untyped_storage().data_ptr(): x
                for x in torch.utils._pytree.tree_leaves(tree)
                if isinstance(x, torch.Tensor)}

    class Sizes(TorchDispatchMode):
        """The most elements of any new storage (views of an operation's
        inputs, such as ``X.T``, allocate none)."""
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            given = storages((args, kwargs))
            for ptr, o in storages(out).items():
                if ptr not in given:
                    largest[0] = max(largest[0], o.untyped_storage().nbytes()
                                     // o.element_size())
            return out

    with Sizes():
        tsig.bootstrap_spectra(
            fs, n_runs, K, n_rot=K, rotated=True, complexify=True,
            hilbert_H=tfast.hilbert_operator(N), block_size=8, seed=4,
            spectrum='fast', subspace_iters=12)
    grams = [s for s in shapes if s[1][1] == N]
    assert len(grams) == 2
    assert len(shapes) - len(grams) == 2 * n_runs
    assert largest[0] < N * min(P_L, P_R)
