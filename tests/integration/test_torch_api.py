"""The port's public API against the JAX package on CPU, float64.

* The API faults F1-F4: ``xMCA.rule_n`` / ``rule_north`` return labeled
  arrays, ``rule_n`` and ``bootstrapping`` take ``disable_progress``,
  ``solve`` raises the reference's all-NaN ``RuntimeError`` where JAX does
  and nowhere else, and every JAX ``set_solver`` key is accepted, as
  JAX accepts it (a mesh and another ensemble axis are stored), or
  refused with JAX's ``ValueError``, never a ``TypeError``.
* ``bootstrapping``: the JAX model's solution is carried into the port
  (``utils.state``), both packages run the exact spectrum with rotation
  tolerance 1e-8, and one block spans the resampled axis, so every run
  resamples nothing and both packages solve the same data: the spectra
  agree to 1e-7 relative ('standard' and 'iterative', both axes, MCA and
  xMCA, real and complexified, unrotated and promax).
* Complexified records longer than the analytic fold's 8192 steps: the
  (8200 x 12, 8200 x 10) model of the ROADMAP probe against JAX's
  singular values (1e-6), and the non-fold truncated branch with both
  packages' threshold patched to 64 steps at (128 x 160, 128 x 140)
  (1e-7), where ``rule_n`` builds its Hilbert operator above the
  threshold.
* Boundary extension (``solve(complexify=True, extend='exp'|'theta')``):
  the solve, ``predict`` and ``bootstrapping`` ('standard' and
  'iterative', one block spanning the axis, exact spectrum) of the port's
  own solve and of the JAX solution carried into it, against JAX at
  1e-7; ``extend='foo'`` raises JAX's ``ValueError``.
* F5-F7: integer and bool fields solve as the JAX package's integer run
  (f32 tolerance) and bit for bit as their float32 copies; a
  non-integer promax power is kept and equals JAX's own ``promax`` at
  that power; ``rotate`` beyond the kept modes raises ``ValueError``
  and changes nothing (JAX raises its misleading ``RuntimeError``).
"""
import re

import numpy as np
import pytest
import torch

from tests.conftest import align_modes
from xmca_tpu.array import MCA as JMCA
from xmca_tpu.compat import xr as jxr
from xmca_tpu.xarray import xMCA as JxMCA
from xmca_tpu_torch.array import MCA as TMCA
from xmca_tpu_torch.compat import xr as txr
from xmca_tpu_torch.utils.state import install_state, to_state
from xmca_tpu_torch.xarray import xMCA as TxMCA

N_OBS, K = 64, 4
# the same algebra in float64 on identical (carried) data: roundoff only
BOOT_TOL = 1e-7


def _values(x):
    return np.asarray(getattr(x, 'values', x))


def _coord(da, d):
    return np.asarray(getattr(da.coords[d], 'values', da.coords[d]))


def _arrays(n_fields, grid=(8, 20), n_obs=N_OBS):
    """``n_fields`` (time, lat, lon) fields with 8 shared sinusoidal modes
    plus noise, and their coordinates."""
    n_lat, n_lon = grid
    t = np.arange(n_obs, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None] / n_obs)
    p = n_lat * n_lon
    out = []
    for seed in (1, 2)[:n_fields]:
        r = np.random.default_rng(seed)
        data = modes @ r.standard_normal((8, p)) + r.standard_normal(
            (n_obs, p))
        out.append(data.reshape(n_obs, n_lat, n_lon))
    coords = {'time': t, 'lat': np.linspace(-60, 60, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    return out, coords


def _build(pkg, api, arrays, coords):
    if api == 'mca':
        return JMCA(*arrays) if pkg == 'jax' else TMCA(*arrays, device='cpu')
    xr = jxr if pkg == 'jax' else txr
    das = [xr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
           for a in arrays]
    return JxMCA(*das) if pkg == 'jax' else TxMCA(*das, device='cpu')


def _pair(api, n_fields, cplx=True, power=1, truncate=None):
    """A solved JAX model and a port model holding its state."""
    arrays, coords = _arrays(n_fields)
    jm = _build('jax', api, arrays, coords)
    if truncate:
        jm.set_solver(truncate=truncate)
    jm.normalize()
    if api == 'xmca':
        jm.apply_coslat()
    jm.solve(complexify=cplx)
    if power:
        jm.rotate(K, power=power)
    tm = _build('torch', api, arrays, coords)
    install_state(tm, to_state(jm))
    return jm, tm


# ------------------------------------------------------------------- F1
def test_xmca_significance_returns_labeled_arrays():
    """F1: ``xMCA.rule_n`` is a ('mode', 'run') DataArray named 'singular
    values' with 1-based coordinates; ``rule_north`` a ('mode',) one with
    the analysis attrs, equal to JAX's."""
    jm, tm = _pair('xmca', 2)
    null = tm.rule_n(8, n_modes=3, seed=5)
    assert isinstance(null, txr.DataArray)
    assert tuple(null.dims) == ('mode', 'run') and null.name == 'singular values'
    np.testing.assert_array_equal(_coord(null, 'mode'), [1, 2, 3])
    np.testing.assert_array_equal(_coord(null, 'run'),
                                  np.arange(1, null.shape[1] + 1))
    assert null.shape[1] >= 7 and np.isfinite(_values(null)).all()
    ref = jm.rule_north(3)
    got = tm.rule_north(3)
    assert isinstance(got, txr.DataArray)
    assert tuple(got.dims) == tuple(ref.dims) == ('mode',)
    assert got.name == ref.name and dict(got.attrs) == dict(ref.attrs)
    np.testing.assert_array_equal(_coord(got, 'mode'), _coord(ref, 'mode'))
    np.testing.assert_allclose(_values(got), _values(ref), rtol=1e-12)


# ------------------------------------------------------------------- F2
@pytest.mark.parametrize('api', ['mca', 'xmca'])
def test_disable_progress_is_accepted(api):
    """F2: ``disable_progress`` is taken (and changes nothing: the port
    shows no progress bar)."""
    _, tm = _pair(api, 2)
    quiet = _values(tm.rule_n(4, n_modes=2, seed=3, disable_progress=True))
    np.testing.assert_array_equal(quiet, _values(tm.rule_n(4, n_modes=2,
                                                           seed=3)))
    boot = _values(tm.bootstrapping(2, n_modes=2, block_size=8, seed=3,
                                    disable_progress=True))
    np.testing.assert_array_equal(boot, _values(tm.bootstrapping(
        2, n_modes=2, block_size=8, seed=3)))


# ------------------------------------------------------------------- F3
def _nan_case(cls, case, **kw):
    rng = np.random.default_rng(0)
    A, B = rng.standard_normal((64, 30)), rng.standard_normal((64, 20))
    if case == 'all-nan-weights':
        m = cls(A, B, **kw)
        m.apply_weights(left=np.full(30, np.nan), right=np.full(20, np.nan))
    elif case == 'zero-std':
        m = cls(np.ones((64, 30)) * np.arange(30.0), B, **kw)
        m.normalize()
    else:
        w = np.ones(30)
        w[[2, 5]] = np.nan
        if case.endswith('truncated'):
            # 16 steps: the wide (Cholesky, subspace) truncated pipeline
            A, B = A[:16], B[:16]
        m = cls(A, B, **kw)
        m.apply_weights(left=w)
        if case.endswith('truncated'):
            m.set_solver(truncate=3)
    return m


@pytest.mark.parametrize('case', ['all-nan-weights', 'zero-std',
                                  'some-nan-weights',
                                  'some-nan-weights-truncated'])
def test_all_nan_guard_matches_jax(case):
    """F3: all-NaN fields (NaN weights everywhere, or a normalize of a
    field whose every column has zero std) raise the reference's
    ``RuntimeError`` before any result is installed, in both packages;
    NaN in some columns only raises in neither (JAX's guard is
    ``isnan(X).all()``) and gives the same NaN spectrum, from the dense
    and from the truncated (complexified, folded) solve."""
    jm = _nan_case(JMCA, case)
    tm = _nan_case(TMCA, case, device='cpu')
    if case.startswith('some'):
        cplx = case.endswith('truncated')
        jm.solve(complexify=cplx)
        tm.solve(complexify=cplx)
        s_j, s_t = jm.singular_values(), tm.singular_values()
        assert s_t.shape == s_j.shape
        np.testing.assert_array_equal(np.isnan(s_t), np.isnan(s_j))
        return
    for m in (jm, tm):
        with pytest.raises(RuntimeError, match='Fields are empty'):
            m.solve()
        with pytest.raises(RuntimeError, match='solve'):
            m.singular_values()


# ------------------------------------------------------------------- F4
_JAX_KEYS = [('method', 'svd'), ('batch_size', 4), ('spectrum', 'exact'),
             ('subspace_iters', 8), ('truncate', 3), ('seed', 2),
             ('surrogate_source', 'generated'), ('surrogate_source', 'draw'),
             ('surrogate_dtype', 'float32'), ('surrogate_dtype', 'bfloat16'),
             ('ensemble_tol', 1e-6), ('ensemble_subspace_iters', 4),
             ('runs_per_dispatch', 2)] + [
    ('surrogate_gen_dist', d) for d in ('normal16', 'normal32', 'rademacher',
                                        'rademacher8', 'rademacher1')]
# stored as JAX stores them (a mesh is driven in test_torch_mesh.py)
_STORED = dict(mesh=object(), ensemble_axis='runs')
_INVALID = dict(method='qr', spectrum='dense', surrogate_source='file',
                surrogate_gen_dist='uniform')


@pytest.mark.parametrize('api', ['mca', 'xmca'])
def test_unported_surface_raises_not_implemented(api):
    """F4: every JAX ``set_solver`` key is accepted; ``mesh`` and
    another ``ensemble_axis`` are stored as the JAX package stores them;
    invalid values raise JAX's ``ValueError``; ``batch_size`` and ``runs_per_dispatch`` change
    nothing; ``spectrum='exact'`` runs Rule-N (the 'draw' source) and
    bootstrapping; ``set_field_names`` is ported."""
    jm, tm = _pair(api, 2)
    arrays, coords = _arrays(2)
    for key, value in _JAX_KEYS:
        _build('torch', api, arrays, coords).set_solver(**{key: value})
    for key, value in _STORED.items():
        j, t = _pair(api, 2)
        j.set_solver(**{key: value})
        t.set_solver(**{key: value})
        stored = ((j._ensemble_mesh, t._mesh) if key == 'mesh'
                  else (j._ensemble_axis, t._ensemble_axis))
        assert stored[0] is value and stored[1] is value
    for key, value in _INVALID.items():
        with pytest.raises(ValueError) as ref:
            jm.set_solver(**{key: value})
        with pytest.raises(ValueError, match=re.escape(str(ref.value))):
            tm.set_solver(**{key: value})
    plain = _values(tm.rule_n(4, n_modes=2, seed=9))
    tm.set_solver(batch_size=3, runs_per_dispatch=5)
    np.testing.assert_array_equal(
        _values(tm.rule_n(4, n_modes=2, seed=9)), plain)
    tm.set_solver(spectrum='exact')
    null = _values(tm.rule_n(4, n_modes=2, seed=9))
    assert null.shape == (2, 4) and np.isfinite(null).all()
    assert np.isfinite(_values(tm.bootstrapping(2, n_modes=2,
                                                block_size=8))).all()
    tm.set_field_names('sst', 'prcp')
    jm.set_field_names('sst', 'prcp')
    assert tm._field_names == jm._field_names == {'left': 'sst',
                                                  'right': 'prcp'}


# --------------------------------------------------------- bootstrapping
# (api, fields, complexify, rotation power (0: none), solve, strategy,
#  axis, replace); every value of each axis appears at least twice
BOOT_CASES = [
    ('mca', 2, False, 0, 'dense', 'standard', 0, True),
    ('mca', 2, True, 2, 'dense', 'iterative', 0, False),
    ('mca', 2, False, 2, 'dense', 'standard', 1, True),
    ('mca', 1, True, 0, 'dense', 'iterative', 1, False),
    ('mca', 2, True, 1, 'wide', 'iterative', 0, True),
    ('xmca', 2, True, 2, 'dense', 'standard', 0, False),
    ('xmca', 2, False, 0, 'dense', 'iterative', 1, True),
    ('xmca', 1, False, 2, 'dense', 'iterative', 0, True),
    ('xmca', 2, True, 0, 'wide', 'standard', 1, False),
]


def _boot_id(case):
    api, n_fields, cplx, power, solve, strategy, axis, replace = case
    return '-'.join([api, 'bi' if n_fields == 2 else 'uni',
                     'cplx' if cplx else 'real',
                     ('rot%d' % power) if power else 'unrot', solve,
                     strategy, 'axis%d' % axis,
                     'replace' if replace else 'perm'])


@pytest.mark.parametrize('case', BOOT_CASES, ids=_boot_id)
def test_bootstrapping_single_block_matches_jax(case):
    api, n_fields, cplx, power, solve, strategy, axis, replace = case
    jm, tm = _pair(api, n_fields, cplx, power,
                   truncate=K if solve == 'wide' else None)
    for m in (jm, tm):
        m.set_solver(spectrum='exact', ensemble_tol=1e-8)
    both = n_fields == 2
    if axis == 0:
        block = N_OBS
    else:
        block = sum(tm._n_variables[k] for k in tm._keys) if both \
            else tm._n_variables['left']
    kw = dict(n_modes=K, axis=axis, on_left=True, on_right=both,
              block_size=block, replace=replace, strategy=strategy, seed=11)
    ref = jm.bootstrapping(2, disable_progress=True, **kw)
    got = tm.bootstrapping(2, **kw)
    assert _values(got).shape == _values(ref).shape == (K, 2)
    assert (_values(ref) != 0).all()
    np.testing.assert_allclose(_values(got), _values(ref), rtol=BOOT_TOL)
    if api == 'xmca':
        assert isinstance(got, txr.DataArray)
        assert tuple(got.dims) == tuple(ref.dims) == ('mode', 'run')
        assert got.name == ref.name and dict(got.attrs) == dict(ref.attrs)
        for d in ('mode', 'run'):
            np.testing.assert_array_equal(_coord(got, d), _coord(ref, d))


@pytest.mark.parametrize('kw,match', [
    (dict(block_size=7), 'multiple of block'),
    (dict(axis=1, on_right=True, block_size=7), 'multiple of block'),
    (dict(on_right=True), 'no right field'),
    (dict(axis=2), 'not a valid axis'),
    (dict(strategy='blocks'), 'strategy'),
])
def test_bootstrapping_errors_match_jax(kw, match):
    """The reference's ``ValueError`` for a block that does not divide the
    resampled axis, ``on_right`` without a right field, a bad axis and a
    bad strategy."""
    n_fields = 1 if kw.get('on_right') and 'axis' not in kw else 2
    jm, tm = _pair('mca', n_fields, cplx=False, power=0)
    for m, extra in ((jm, dict(disable_progress=True)), (tm, {})):
        with pytest.raises(ValueError, match=match):
            m.bootstrapping(2, n_modes=2, **dict(kw, **extra))


# ---------------------------------------------------- long complexified
@pytest.mark.parametrize('truncate', [None, 2])
def test_long_complexified_solve_matches_jax(truncate):
    """The ROADMAP probe: (8200 x 12, 8200 x 10) complexified, beyond the
    8192-step fold, dense and ``truncate=2`` (the small-space branch);
    the port's ``torch.fft`` analytic signal against JAX's circulant path
    (1e-6 relative)."""
    rng = np.random.default_rng(3)
    n = 8200
    t = np.arange(n)
    base = np.sin(2 * np.pi * t / 365.25)[:, None]
    A = base * rng.standard_normal(12) + rng.standard_normal((n, 12))
    B = base * rng.standard_normal(10) + rng.standard_normal((n, 10))
    jm, tm = JMCA(A, B), TMCA(A, B, device='cpu')
    for m in (jm, tm):
        if truncate:
            m.set_solver(truncate=truncate)
        m.solve(complexify=True)
    s_j = jm.singular_values(2)
    np.testing.assert_allclose(tm.singular_values(2), s_j, rtol=1e-6)
    assert not tm._complexify_pending and tm._fields['left'].is_complex()


@pytest.fixture
def short_fold(monkeypatch):
    """Both packages' analytic-fold threshold at 64 steps (the records
    below are 128 steps: the branch of records beyond 8192)."""
    import xmca_tpu.core.preprocess as jpre
    import xmca_tpu_torch.api.array as tarr
    monkeypatch.setattr(jpre, '_HILBERT_MATMUL_MAX_N', 64)
    monkeypatch.setattr(tarr, '_HILBERT_MATMUL_MAX_N', 64)


def _long_fields():
    rng = np.random.default_rng(4)
    t = np.arange(128)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 6)[None] / 128)
    A = modes @ rng.standard_normal((5, 160)) + rng.standard_normal(
        (128, 160))
    B = modes @ rng.standard_normal((5, 140)) + rng.standard_normal(
        (128, 140))
    return A, B


def test_non_fold_truncated_branch_matches_jax(short_fold):
    """Above the threshold a wide truncated complexified solve builds Z by
    FFT and runs the subspace pipeline on the complex fields, in both
    packages: singular values and totals within 1e-7; the rotated
    variance too."""
    A, B = _long_fields()
    jm, tm = JMCA(A, B), TMCA(A, B, device='cpu')
    for m in (jm, tm):
        m.set_solver(truncate=K)
        m.normalize()
        m.solve(complexify=True)
        assert not m._complexify_pending
    np.testing.assert_allclose(tm.singular_values(), jm.singular_values(),
                               rtol=1e-7)
    for key in ('total_covariance', 'total_squared_covariance'):
        np.testing.assert_allclose(tm._analysis[key], jm._analysis[key],
                                   rtol=1e-7)
    for m in (jm, tm):
        m.rotate(K)
    np.testing.assert_allclose(tm.variance(), jm.variance(), rtol=1e-7)


def test_rule_n_above_the_fold_threshold(short_fold, monkeypatch):
    """``rule_n`` of a record beyond the threshold builds its n x n
    Hilbert operator on the device (the host build's values, 1e-7 in
    f32) and gives the null spectra of the same model below it (the
    fold and the non-fold solve differ by roundoff: 1e-9)."""
    from xmca_tpu_torch.core.fastpath import hilbert_imag_matrix
    A, B = _long_fields()
    nulls = []
    for patched in (True, False):
        if not patched:
            import xmca_tpu_torch.api.array as tarr
            monkeypatch.setattr(tarr, '_HILBERT_MATMUL_MAX_N', 8192)
        tm = TMCA(A, B, device='cpu')
        tm.set_solver(truncate=K)
        tm.normalize()
        tm.solve(complexify=True)
        assert tm._complexify_pending is not patched
        nulls.append(tm.rule_n(6, n_modes=3, seed=2))
        if patched:
            np.testing.assert_allclose(tm._hilbert.numpy(),
                                       hilbert_imag_matrix(128), rtol=0,
                                       atol=1e-7)
    assert nulls[0].shape == (3, 6) and np.isfinite(nulls[0]).all()
    np.testing.assert_allclose(nulls[0], nulls[1], rtol=1e-9)


# ------------------------------------------------------- boundary extension
# (api, fields, extend, period, solve, rotation power (0: none))
EXTEND_CASES = [
    ('mca', 2, 'exp', 4, 'dense', 1),
    ('mca', 1, 'theta', 12, 'wide', 0),
    ('xmca', 2, 'theta', 12, 'wide', 1),
    ('xmca', 2, 'exp', 1, 'dense', 2),
]


def _extend_id(case):
    api, n_fields, extend, period, solve, power = case
    return '-'.join([api, 'bi' if n_fields == 2 else 'uni', extend,
                     str(period), solve, ('rot%d' % power) if power
                     else 'unrot'])


def _extended(pkg, case, arrays, coords):
    api, _, extend, period, solve, power = case
    m = _build(pkg, api, arrays, coords)
    if solve == 'wide':
        m.set_solver(truncate=K)
    m.normalize()
    if api == 'xmca':
        m.apply_coslat()
    m.solve(complexify=True, extend=extend, period=period)
    if power:
        m.rotate(K, power=power)
    return m


@pytest.mark.parametrize('case', EXTEND_CASES, ids=_extend_id)
def test_extended_solve_predict_bootstrap_match_jax(case):
    """An extended model's spectrum, EOFs (aligned), ``predict`` of new
    steps and single-block bootstraps, the port's own solve and the JAX
    solution carried into the port, against JAX at 1e-7."""
    api, n_fields, extend, _, solve, power = case
    arrays, coords = _arrays(n_fields)
    jm = _extended('jax', case, arrays, coords)
    own = _extended('torch', case, arrays, coords)
    carried = _build('torch', api, arrays, coords)
    install_state(carried, to_state(jm))
    assert own._analysis['extend'] == extend
    assert own._fields['left'].is_complex() and not own._complexify_pending
    ref_s = _values(jm.singular_values(K))
    ref_v = _values(jm.variance(K))
    new = arrays[0][:10]
    if api == 'xmca':
        new = txr.DataArray(new, dims=('time', 'lat', 'lon'),
                            coords=dict(coords, time=coords['time'][:10]))
        jnew = jxr.DataArray(arrays[0][:10], dims=('time', 'lat', 'lon'),
                             coords=dict(coords, time=coords['time'][:10]))
    else:
        jnew = new
    ref_p = _values(jm.predict(left=jnew, n=3)['left'])
    kw = dict(n_modes=K, on_left=True, on_right=n_fields == 2,
              block_size=N_OBS, seed=5)
    for m in (jm, own, carried):
        m.set_solver(spectrum='exact', ensemble_tol=1e-8)
    refs = {st: _values(jm.bootstrapping(2, strategy=st,
                                         disable_progress=True, **kw))
            for st in ('standard', 'iterative')}
    for tm in (own, carried):
        np.testing.assert_allclose(_values(tm.singular_values(K)), ref_s,
                                   rtol=BOOT_TOL)
        np.testing.assert_allclose(_values(tm.variance(K)), ref_v,
                                   rtol=BOOT_TOL)
        got_p = _values(tm.predict(left=new, n=3)['left'])
        got_p = got_p if tm is carried else align_modes(got_p, ref_p)
        np.testing.assert_allclose(got_p, ref_p, rtol=0,
                                   atol=BOOT_TOL * np.abs(ref_p).max())
        eofs, ref_e = (_values(m.eofs(K, rotated=False)['left'])
                       for m in (tm, jm))
        np.testing.assert_allclose(
            align_modes(eofs.reshape(-1, K), ref_e.reshape(-1, K)),
            ref_e.reshape(-1, K), rtol=0,
            atol=BOOT_TOL * np.nanmax(np.abs(ref_e)))
        for st, ref in refs.items():
            got = _values(tm.bootstrapping(2, strategy=st, **kw))
            assert (ref != 0).all()
            np.testing.assert_allclose(got, ref, rtol=BOOT_TOL)


def test_invalid_extension_raises_jax_error():
    """``solve(complexify=True, extend='foo')`` raises JAX's ``ValueError``
    before any state changes; without ``complexify`` the value is only
    stored, as in the JAX package."""
    arrays, coords = _arrays(2)
    for api in ('mca', 'xmca'):
        jm, tm = (_build(pkg, api, arrays, coords) for pkg in ('jax',
                                                               'torch'))
        with pytest.raises(ValueError) as ref:
            jm.solve(complexify=True, extend='foo')
        with pytest.raises(ValueError) as got:
            tm.solve(complexify=True, extend='foo')
        assert str(got.value) == str(ref.value)
        assert not tm._analysis['is_complex']
        for m in (jm, tm):
            m.solve(extend='foo')
        assert tm._analysis['extend'] == jm._analysis['extend'] == 'foo'
        np.testing.assert_allclose(_values(tm.singular_values(3)),
                                   _values(jm.singular_values(3)),
                                   rtol=1e-9)


# ------------------------------------------------------------- F5-F7
def _int_arrays(kind):
    """The test grid's fields as integer (x 10, rounded) or bool data."""
    arrays, coords = _arrays(2)
    if kind == 'bool':
        return [a > 0 for a in arrays], coords
    return [np.rint(10 * a).astype(kind) for a in arrays], coords


def _vec_err(got, ref):
    """Largest difference of aligned mode vectors, relative to the
    reference's largest entry."""
    got, ref = (np.asarray(x).reshape(-1, np.shape(x)[-1]) for x in (got,
                                                                       ref))
    return np.abs(align_modes(got, ref) - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize('api', ['mca', 'xmca'])
@pytest.mark.parametrize('kind', ['int32', 'int64', 'bool'])
def test_integer_fields_solve_as_jax(kind, api):
    """F5: integer and bool fields are promoted to float32 at ingest and
    solve, complexify and rotate as the JAX package's integer run
    (``jnp.mean`` promotes int32 and bool to float32, and int64 to
    float64 under x64): spectrum 1e-5 relative, EOFs and PCs (unrotated
    and rotated, aligned) 1e-4 of their largest entry, rotated variance
    1e-5, with the rotation stopped at the f32 floor (tol 1e-5) in both.
    The integer model equals the port's model of the float32 copy bit
    for bit, and ``predict`` takes integer new data."""
    arrays, coords = _int_arrays(kind)
    floats = [a.astype(np.float32) for a in arrays]
    models = [_build(pkg, api, data, coords)
              for pkg, data in (('jax', arrays), ('torch', arrays),
                                ('torch', floats))]
    for m in models:
        m.normalize()
        m.solve(complexify=True)
        m.rotate(3, tol=1e-5)
    jm, tm, fm = models
    assert tm._fields['left'].dtype == torch.complex64
    np.testing.assert_allclose(_values(tm.singular_values(6)),
                               _values(jm.singular_values(6)), rtol=1e-5)
    np.testing.assert_allclose(_values(tm.variance(3)),
                               _values(jm.variance(3)), rtol=1e-5)
    for getter in ('eofs', 'pcs'):
        for rotated in (False, True):
            got = getattr(tm, getter)(3, rotated=rotated)
            ref = getattr(jm, getter)(3, rotated=rotated)
            same = getattr(fm, getter)(3, rotated=rotated)
            for k in ('left', 'right'):
                assert _vec_err(_values(got[k]), _values(ref[k])) < 1e-4
                np.testing.assert_array_equal(_values(got[k]),
                                              _values(same[k]))
    new = arrays[0][:5]
    fnew = floats[0][:5]
    if api == 'xmca':
        t5 = dict(coords, time=coords['time'][:5])
        new, fnew = (txr.DataArray(x, dims=('time', 'lat', 'lon'),
                                   coords=t5) for x in (new, fnew))
    np.testing.assert_array_equal(_values(tm.predict(left=new)['left']),
                                  _values(fm.predict(left=fnew)['left']))


def test_integer_chunks_solve_as_float32():
    """F5 out of core: loaders that yield integer chunks solve in float32
    (``core.streaming.stream_dtype``), equal to float32 chunks of the
    same values."""
    arrays, _ = _int_arrays('int64')
    flat = [a.reshape(N_OBS, -1) for a in arrays]

    def model(dtype):
        loaders = [(lambda x=x: [x[:, :70].astype(dtype),
                                 x[:, 70:].astype(dtype)]) for x in flat]
        m = TMCA.from_chunks(*loaders, n_observations=N_OBS,
                             left_shape=(8, 20), right_shape=(8, 20),
                             device='cpu')
        m.set_solver(truncate=4)
        m.solve(complexify=True)
        return m
    got, ref = model(np.int64), model(np.float32)
    assert got._stream_dtype == torch.float32
    np.testing.assert_array_equal(got.singular_values(), ref.singular_values())
    np.testing.assert_array_equal(got.eofs(3)['left'], ref.eofs(3)['left'])


def test_float16_fields_stay_refused():
    """float16 is refused by both packages (the port at its first
    factorization), as before the integer promotion."""
    arrays, _ = _arrays(2)
    half = [a.astype(np.float16) for a in arrays]
    with pytest.raises(NotImplementedError):
        JMCA(*half).solve()
    with pytest.raises(NotImplementedError):
        TMCA(*half, device='cpu').solve()


def _loadings_of(tm, n_rot):
    """The port model's unrotated loading stack ``[V_l; V_r] sqrt(s)``."""
    V = [tm._V[k][:, :n_rot].numpy() for k in ('left', 'right')]
    return np.concatenate(V) * np.sqrt(tm.singular_values(n_rot))


def test_float_promax_power_is_kept():
    """F6, decided: the port keeps a non-integer promax power.
    ``rotate(3, power=2.5)`` equals the JAX package's own
    ``core.rotation.promax(L, power=2.5)`` on the port's loadings (1e-8:
    both float64), the power JAX's ``rule_n`` and ``bootstrapping`` run;
    JAX's ``rotate`` truncates it (its variance is that of power 2) and
    stores 2.5.  An integer power agrees with JAX's ``rotate`` (1e-7 on
    the rotated variance, 1e-6 on aligned rotated EOFs)."""
    import jax.numpy as jnp
    from xmca_tpu.core.rotation import promax as jpromax
    jm, tm = _pair('mca', 2, cplx=False, power=0)
    L = _loadings_of(tm, 3)
    tm.rotate(3, power=2.5)
    B, R, _, conv, _ = jpromax(jnp.asarray(L), power=2.5, max_iter=1000,
                               tol=1e-8)
    assert bool(conv)
    B = np.asarray(B)
    n_left = tm._V['left'].shape[0]
    var = (np.linalg.norm(B[:n_left], axis=0)
           * np.linalg.norm(B[n_left:], axis=0))
    np.testing.assert_allclose(tm._variance, var, rtol=1e-8)
    np.testing.assert_allclose(tm.rotation_matrix(), np.asarray(R),
                               atol=1e-8)
    assert tm._analysis['power'] == 2.5
    jm.rotate(3, power=2.5)
    assert jm._analysis['power'] == 2.5
    j2 = _values(jm.variance(3))
    jm.rotate(3, power=2)
    np.testing.assert_allclose(j2, _values(jm.variance(3)), rtol=1e-12)
    assert np.abs(_values(tm.variance(3)) / j2 - 1).max() > 1e-6
    tm.rotate(3, power=2)
    np.testing.assert_allclose(_values(tm.variance(3)),
                               _values(jm.variance(3)), rtol=1e-7)
    assert _vec_err(tm.eofs(3)['left'], _values(jm.eofs(3)['left'])) < 1e-6


@pytest.mark.parametrize('api', ['mca', 'xmca'])
def test_rotate_beyond_kept_modes_raises_value_error(api):
    """F7, decided: ``rotate(n_rot)`` with more modes than the solve kept
    raises ``ValueError`` before any state changes; the JAX package
    raises its misleading 'did not converge' ``RuntimeError`` (it reads
    its converged flag at the wrong offset)."""
    jm, tm = _pair(api, 2, truncate=5)
    for m in (jm, tm):
        m.rotate(3, power=2)
    before = {g: _values(getattr(tm, g)()) for g in ('singular_values',
                                                     'variance')}
    before_eofs = _values(tm.eofs()['left'])
    analysis = dict(tm._analysis)
    R = tm.rotation_matrix()
    with pytest.raises(RuntimeError, match='did not converge'):
        jm.rotate(6)
    for n_rot in (6, 9):
        with pytest.raises(ValueError, match='exceeds the 5 modes'):
            tm.rotate(n_rot)
    assert tm._analysis == analysis
    np.testing.assert_array_equal(tm.rotation_matrix(), R)
    for g, v in before.items():
        np.testing.assert_array_equal(_values(getattr(tm, g)()), v)
    np.testing.assert_array_equal(_values(tm.eofs()['left']), before_eofs)
    tm.rotate(5)
    assert tm._analysis['n_rot'] == 5

