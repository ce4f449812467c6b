"""The port's result layer against the JAX package on CPU, float64.

Each case builds the same numpy-seeded 64-step fields for both packages'
public API (``MCA`` on ndarrays or ``xMCA`` on DataArrays), preprocesses
(``normalize``, plus ``apply_coslat`` for ``xMCA``), solves (exact dense,
truncated wide with the deferred ``Z``, or the truncated small-space
branch on 4 x 10 cells) and rotates (none, varimax, promax power 2).

* Carried state: the JAX model's solution and packed fields are
  installed into a port model (``utils.state``), so both packages hold
  the same numbers and every getter must agree to 1e-9 (relative to the
  result's largest entry): only the order of float operations differs.
* Independent solves: the port solves on its own; its results agree to
  1e-7 after per-mode unit-factor alignment (the packages' LAPACK calls
  may pick another sign or phase per mode, and the truncated solves
  start their subspace iterations from different random blocks).
"""
import numpy as np
import pytest

from tests.conftest import align_modes
from xmca_tpu.array import MCA as JMCA
from xmca_tpu.compat import xr as jxr
from xmca_tpu.xarray import xMCA as JxMCA
from xmca_tpu_torch.array import MCA as TMCA
from xmca_tpu_torch.compat import xr as txr
from xmca_tpu_torch.utils.state import install_state, to_state
from xmca_tpu_torch.xarray import xMCA as TxMCA

N_OBS, K = 64, 4
CARRIED = 1e-9
INDEPENDENT = 1e-7
PHASE = 0.7
SCALINGS = ('None', 'eigen', 'max', 'std')

# (api, fields, complexify, solve, rotation power (0: none), NaN columns,
#  decomposition method); every value of each axis appears at least twice
CASES = [
    ('xmca', 2, True, 'wide', 1, False, 'gram'),     # the main path
    ('xmca', 2, True, 'dense', 2, False, 'gram'),
    ('xmca', 2, False, 'dense', 0, True, 'gram'),
    ('xmca', 1, True, 'small', 1, False, 'gram'),
    ('xmca', 1, False, 'wide', 2, True, 'gram'),
    ('mca', 2, False, 'small', 2, False, 'gram'),
    ('mca', 1, False, 'dense', 1, False, 'svd'),
    ('mca', 2, True, 'wide', 0, False, 'gram'),
    ('mca', 2, True, 'small', 0, True, 'svd'),
    ('mca', 1, True, 'dense', 0, False, 'gram'),
]


def _case_id(case):
    api, n_fields, cplx, solve, power, nan, method = case
    return '-'.join([api, 'bi' if n_fields == 2 else 'uni',
                     'cplx' if cplx else 'real', solve,
                     ('rot%d' % power) if power else 'unrot',
                     'nan' if nan else 'full', method])


def _grid(solve):
    return (4, 10) if solve == 'small' else (8, 20)


def _arrays(grid, nan, n_fields, lat=(-60, 60)):
    """``n_fields`` (time, lat, lon) fields with 8 shared sinusoidal modes,
    and their coordinates; ``nan`` puts NaN into two columns."""
    n_lat, n_lon = grid
    t = np.arange(N_OBS, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None] / N_OBS)
    p = n_lat * n_lon
    out = []
    for seed in (1, 2)[:n_fields]:
        r = np.random.default_rng(seed)
        data = modes @ r.standard_normal((8, p)) + r.standard_normal(
            (N_OBS, p))
        data = data.reshape(N_OBS, n_lat, n_lon)
        if nan:
            data[:10, 1, 3] = np.nan
            data[5, 2, 7] = np.nan
        out.append(data)
    coords = {'time': t, 'lat': np.linspace(*lat, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    return out, coords


def _build(pkg, api, arrays, coords):
    if api == 'mca':
        return JMCA(*arrays) if pkg == 'jax' else TMCA(*arrays, device='cpu')
    xr = jxr if pkg == 'jax' else txr
    das = [xr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
           for a in arrays]
    return JxMCA(*das) if pkg == 'jax' else TxMCA(*das, device='cpu')


def _prepare(model, case):
    api, _, _, solve, _, _, method = case
    model.set_solver(method=method)
    if solve != 'dense':
        model.set_solver(truncate=K)
    model.normalize()
    if api == 'xmca':
        model.apply_coslat()
    return model


def _solve(model, case):
    _, _, cplx, _, power, _, _ = case
    model.solve(complexify=cplx)
    if power:
        model.rotate(K, power=power)
    return model


@pytest.fixture(scope='module', params=CASES, ids=_case_id)
def models(request):
    """(case, JAX model, port model with the JAX state, port model solved
    on its own, the case's arrays and coords)."""
    case = request.param
    api, n_fields, _, solve, _, nan, _ = case
    arrays, coords = _arrays(_grid(solve), nan, n_fields)
    jm = _solve(_prepare(_build('jax', api, arrays, coords), case), case)
    carried = _build('torch', api, arrays, coords)
    install_state(carried, to_state(jm))
    own = _solve(_prepare(_build('torch', api, arrays, coords), case), case)
    return case, jm, carried, own, arrays, coords


def _values(x):
    return np.asarray(getattr(x, 'values', x))


def _coord(da, d):
    return np.asarray(getattr(da.coords[d], 'values', da.coords[d]))


def _same(got, ref, tol=CARRIED, align=False):
    """``got`` equals ``ref`` (dicts, tuples, DataArrays or arrays) to
    ``tol`` of the largest entry, NaN where ``ref`` is NaN; DataArrays
    also carry the same dims, coords and name."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _same(got[k], ref[k], tol, align)
        return
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _same(g, r, tol, align)
        return
    if hasattr(ref, 'dims'):
        assert tuple(got.dims) == tuple(ref.dims)
        assert got.name == ref.name
        for d in ref.coords:
            np.testing.assert_array_equal(_coord(got, d), _coord(ref, d))
    g, r = _values(got), _values(ref)
    assert g.shape == r.shape and g.dtype == r.dtype
    if align:
        g = align_modes(g.reshape(-1, g.shape[-1]),
                        r.reshape(-1, r.shape[-1])).reshape(r.shape)
    scale = np.nanmax(np.abs(r)) if r.size else 1.0
    np.testing.assert_allclose(g, r, rtol=0, atol=tol * scale)


def _n_spec(case):
    """The mode spec a case asks its getters for: the first three modes
    or the slice 2..4."""
    return 3 if CASES.index(case) % 2 else slice(2, 4)


def test_spectrum_and_rotation(models):
    case, jm, tm, _, _, _ = models
    n = _n_spec(case)
    getters = [('singular_values', (n,)), ('explained_variance', (n,)),
               ('scf', ()), ('scf', (2,)), ('variance', (n,)),
               ('rotation_matrix', ()), ('rotation_matrix', (True,)),
               ('correlation_matrix', ())]
    # JAX's rotate stores a 'right' norm for one field too, which its
    # xMCA.norm cannot name (KeyError); the carried state has it as well
    if case[1] == 2 or not case[4]:
        getters.append(('norm', (n,)))
    for name, args in getters:
        _same(getattr(tm, name)(*args), getattr(jm, name)(*args))


def test_eofs_pcs_amplitude_phase(models):
    case, jm, tm, _, _, _ = models
    n = _n_spec(case)
    for scaling in SCALINGS:
        for rotated in (True, False):
            for name in ('eofs', 'pcs'):
                _same(getattr(tm, name)(n, scaling, PHASE, rotated),
                      getattr(jm, name)(n, scaling, PHASE, rotated))
    for name, kw in (('spatial_amplitude', dict(scaling='max')),
                     ('spatial_amplitude', {}),
                     ('spatial_phase', dict(phase_shift=PHASE)),
                     ('temporal_amplitude', dict(scaling='max')),
                     ('temporal_phase', dict(phase_shift=PHASE))):
        _same(getattr(tm, name)(n, **kw), getattr(jm, name)(n, **kw))


def test_correlation_patterns(models):
    case, jm, tm, _, _, _ = models
    n = _n_spec(case)
    _same(tm.homogeneous_patterns(n, PHASE), jm.homogeneous_patterns(
        n, PHASE))
    if case[1] == 2:
        _same(tm.heterogeneous_patterns(n), jm.heterogeneous_patterns(n))


def test_reconstruction_fields_predict(models):
    case, jm, tm, _, arrays, coords = models
    n = _n_spec(case)
    for mode in (None, slice(1, 2), n):
        for original_scale in (True, False):
            _same(tm.reconstructed_fields(mode, original_scale),
                  jm.reconstructed_fields(mode, original_scale))
    for original_scale in (True, False):
        _same(tm.fields(original_scale), jm.fields(original_scale))
    new = [a[::-1][:20] + 0.5 for a in arrays]
    if case[0] == 'xmca':
        new_t = [txr.DataArray(a, dims=('time', 'lat', 'lon'),
                               coords=dict(coords, time=coords['time'][:20]))
                 for a in new]
        new_j = [jxr.DataArray(a, dims=('time', 'lat', 'lon'),
                               coords=dict(coords, time=coords['time'][:20]))
                 for a in new]
    else:
        new_t = new_j = new
    for scaling in SCALINGS:
        _same(tm.predict(*new_t, n=3, scaling=scaling, phase_shift=PHASE),
              jm.predict(*new_j, n=3, scaling=scaling, phase_shift=PHASE))
    _same(tm.predict(*new_t), jm.predict(*new_j))


def test_truncate(models):
    """Truncation to K + 1 modes, on fresh copies of both models (the
    JAX model rebuilt from its own state)."""
    case, jm = models[:2]
    state = to_state(jm)
    j2, t2 = JMCA(), TMCA(device='cpu')
    install_state(j2, state)
    install_state(t2, state)
    j2.truncate(K + 1)
    t2.truncate(K + 1)
    rotated = bool(case[4])
    _same(t2.singular_values(), j2.singular_values())
    _same(t2.scf(), j2.scf())
    assert t2._analysis == j2._analysis
    _same(t2.eofs(rotated=False), j2.eofs(rotated=False))
    _same(t2.pcs(rotated=False), j2.pcs(rotated=False))
    if rotated:
        _same(t2.eofs(), j2.eofs())
        _same(t2.reconstructed_fields(), j2.reconstructed_fields())


def test_independent_solve(models):
    """The port's own solve: spectrum and totals to 1e-7, EOFs and PCs
    to 1e-7 after per-mode alignment, and the phase-free results
    (amplitudes, reconstructions, real-field patterns) to 1e-7.  The
    oblique correlation matrix takes the modes' signs, so it is compared
    on the carried state only."""
    case, jm, _, tm, _, _ = models
    cplx = case[2]
    n = _n_spec(case)
    for name in ('singular_values', 'explained_variance', 'scf',
                 'variance'):
        _same(getattr(tm, name)(), getattr(jm, name)(), INDEPENDENT)
    for key in ('total_covariance', 'total_squared_covariance'):
        np.testing.assert_allclose(tm._analysis[key], jm._analysis[key],
                                   rtol=INDEPENDENT)
    for name in ('eofs', 'pcs'):
        _same(getattr(tm, name)(n), getattr(jm, name)(n), INDEPENDENT,
              align=True)
    for name in ('spatial_amplitude', 'temporal_amplitude'):
        _same(getattr(tm, name)(n), getattr(jm, name)(n), INDEPENDENT)
    _same(tm.reconstructed_fields(n), jm.reconstructed_fields(n),
          INDEPENDENT)
    if not cplx:
        pats_t, pvals_t = tm.homogeneous_patterns(n)
        pats_j, pvals_j = jm.homogeneous_patterns(n)
        _same(pats_t, pats_j, INDEPENDENT, align=True)
        _same(pvals_t, pvals_j, INDEPENDENT)


def test_resolve_complexified():
    """A truncated complexified model solved, read (which materializes
    Z) and solved again, in both packages: the second solve defers
    again on the complex fields and matches."""
    arrays, coords = _arrays((8, 20), False, 2)
    case = ('xmca', 2, True, 'wide', 0, False, 'gram')
    jm = _solve(_prepare(_build('jax', 'xmca', arrays, coords), case), case)
    tm = _solve(_prepare(_build('torch', 'xmca', arrays, coords), case),
                case)
    assert tm._complexify_pending
    _same(tm.pcs(K), jm.pcs(K), INDEPENDENT, align=True)
    assert not tm._complexify_pending and tm._fields['left'].is_complex()
    for model in (jm, tm):
        model.solve(complexify=True)
    assert tm._complexify_pending
    _same(tm.singular_values(), jm.singular_values(), INDEPENDENT)
    _same(tm.eofs(K), jm.eofs(K), INDEPENDENT, align=True)
    _same(tm.pcs(K), jm.pcs(K), INDEPENDENT, align=True)
    assert not tm._complexify_pending


def test_coslat_near_pole():
    """Latitudes up to +-90: the reference weights the data by
    sqrt(cos(lat) + 1e-6) but undoes the weighting (and scales new data)
    with sqrt(cos(lat)), which is ~8e-9 at the poles.  The port
    reproduces that: every result matches JAX's to 1e-9 of each
    element's own size (the pole columns of the original-scale fields
    are ~1e5 times the input there), and the quirk shows in
    fields(original_scale=True): the input again away from the poles
    (within the epsilon's 1e-6), ~1.3e5 times its anomaly at the poles."""
    arrays, coords = _arrays((8, 20), False, 2, lat=(-90, 90))
    case = ('xmca', 2, False, 'dense', 0, False, 'gram')
    jm = _solve(_prepare(_build('jax', 'xmca', arrays, coords), case), case)
    tm = _build('torch', 'xmca', arrays, coords)
    install_state(tm, to_state(jm))
    das = [txr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
           for a in arrays]
    das_j = [jxr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
             for a in arrays]
    for got, ref in ((tm.fields(True), jm.fields(True)),
                     (tm.reconstructed_fields(), jm.reconstructed_fields()),
                     (tm.predict(*das, n=K), jm.predict(*das_j, n=K))):
        for k in ref:
            np.testing.assert_allclose(_values(got[k]), _values(ref[k]),
                                       rtol=CARRIED, atol=0)
    # per column: the norm of the original-scale anomaly over the input's
    data = arrays[0] - arrays[0].mean(0)
    back = tm.fields(True)['left'].values
    ratio = (np.linalg.norm(back - back.mean(0), axis=0)
             / np.linalg.norm(data, axis=0))
    np.testing.assert_allclose(ratio[1:-1], 1.0, rtol=1e-5)
    assert ratio[[0, -1]].min() > 1e5


@pytest.mark.parametrize('getter', ['eofs', 'pcs', 'homogeneous_patterns',
                                    'reconstructed_fields', 'predict',
                                    'spatial_amplitude', 'temporal_phase',
                                    'rotation_matrix', 'correlation_matrix'])
def test_getter_before_solve_raises(getter):
    arrays, coords = _arrays((8, 20), False, 2)
    errors = []
    for pkg in ('jax', 'torch'):
        with pytest.raises(RuntimeError) as info:
            getattr(_build(pkg, 'mca', arrays, coords), getter)()
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_truncate_below_n_rot_raises():
    arrays, coords = _arrays((8, 20), False, 2)
    case = ('mca', 2, False, 'dense', 1, False, 'gram')
    for pkg in ('jax', 'torch'):
        model = _solve(_prepare(_build(pkg, 'mca', arrays, coords), case),
                       case)
        with pytest.raises(ValueError, match='Cannot truncte rotated'):
            model.truncate(K - 1)


def test_heterogeneous_patterns_of_one_field():
    """JAX pairs the one field with itself (its KeyError branch cannot
    be reached), so both packages return the homogeneous maps."""
    arrays, coords = _arrays((8, 20), False, 1)
    case = ('mca', 1, False, 'dense', 0, False, 'gram')
    jm, tm = (_solve(_prepare(_build(pkg, 'mca', arrays, coords), case),
                     case) for pkg in ('jax', 'torch'))
    _same(tm.heterogeneous_patterns(K), jm.heterogeneous_patterns(K),
          INDEPENDENT, align=True)
    _same(tm.heterogeneous_patterns(K), tm.homogeneous_patterns(K), 0)


@pytest.mark.parametrize('bad', ['no_time', 'grid'])
def test_predict_wrong_dims_raises(bad):
    arrays, coords = _arrays((8, 20), False, 2)
    case = ('mca', 2, False, 'dense', 0, False, 'gram')
    new = arrays[0][0] if bad == 'no_time' else arrays[0][:, :, :10]
    messages = []
    for pkg in ('jax', 'torch'):
        model = _solve(_prepare(_build(pkg, 'mca', arrays, coords), case),
                       case)
        with pytest.raises(ValueError) as info:
            model.predict(left=new)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert 'Error in left field' in messages[0]


def test_pvalues_in_float64():
    """A float32 correlation map's p-values: scipy's float32 betainc
    (what the JAX package's host code selects for such a map) errs by
    more than 1e-3 near p = 1 at n = 256; the port evaluates in float64
    and returns the map's dtype."""
    from scipy.special import betainc
    r = np.array([-2.1741926e-4, -2.1740112e-4, 2.6027317e-4], np.float32)
    exact = 2 * betainc(127.0, 127.0, (1 - np.abs(r.astype(float))) / 2)
    got = TMCA._corr_pvalues(r, 256)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    assert np.abs(JMCA._corr_pvalues(r, 256) - exact).max() > 1e-3
