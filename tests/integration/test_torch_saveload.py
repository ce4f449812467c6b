"""Save/load of the port against the JAX package on CPU, float64.

The analyses are written through the h5py netCDF writer (xarray, h5netcdf
and netCDF4 are not installed here), into ``tmp_path``, by either
package, and loaded by both:

* JAX-saved -> port-loaded and port-saved -> JAX-loaded, for the cases
  'std' (normalize + coslat), 'rot' (normalize + varimax) and 'cplx'
  (coslat + complexified), each from the dense and from the truncated
  solve, on ``xMCA``; and the array-level ``MCA.load_analysis``.  The
  getters of every load are held against the JAX package's load of the
  same files (1e-9 of each result's largest entry: the same f64 algebra,
  the rotation recomputed to tol 1e-8 from the same singular vectors).
* ``info.xmca`` written by the port, line for line against JAX's for
  the same solution (but ``created``; floats compared as numbers), and
  the saved arrays equal.
* An ``extend='exp'`` analysis saved by JAX loads alike in both: both
  drop the extension (``_set_analysis`` casts the text by the fresh
  model's ``False``).
* ``summary`` prints what JAX prints.
* Time-varying and full (time, lat, lon) weights (the host path) give
  JAX's fields and spectrum, and a mismatched weight the same
  ``ValueError``.
"""
import os
import re

import numpy as np
import pytest

from xmca_tpu.array import MCA as JMCA
from xmca_tpu.compat import open_dataarray as j_open
from xmca_tpu.compat import xr as jxr
from xmca_tpu.xarray import xMCA as JxMCA
from xmca_tpu_torch.array import MCA as TMCA
from xmca_tpu_torch.compat import open_dataarray as t_open
from xmca_tpu_torch.compat import xr as txr
from xmca_tpu_torch.utils.state import install_state, to_state
from xmca_tpu_torch.xarray import xMCA as TxMCA

N_OBS, GRID = 48, (6, 10)
TOL = 1e-9
FILES = ('singular_values.nc', 'sst_eofs.nc', 'prcp_eofs.nc', 'sst.nc',
         'prcp.nc')


def _values(x):
    return np.asarray(getattr(x, 'values', x))


def _arrays():
    """Two (time, lat, lon) fields with four shared modes plus noise (one
    all-NaN cell in the left field) and their coordinates."""
    n_lat, n_lon = GRID
    t = np.arange(N_OBS, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 5)[None] / N_OBS)
    out = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        p = n_lat * n_lon
        data = modes @ r.standard_normal((4, p)) + r.standard_normal(
            (N_OBS, p))
        out.append(data.reshape(N_OBS, n_lat, n_lon))
    out[0][:, 0, 0] = np.nan
    coords = {'time': t, 'lat': np.linspace(-60, 60, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    return out, coords


def _xmodel(pkg):
    arrays, coords = _arrays()
    xr = jxr if pkg == 'jax' else txr
    das = [xr.DataArray(a, dims=('time', 'lat', 'lon'), coords=coords)
           for a in arrays]
    return JxMCA(*das) if pkg == 'jax' else TxMCA(*das, device='cpu')


def _solved_jax(case, truncate, extend=False):
    m = _xmodel('jax')
    m.set_field_names('sst', 'prcp')
    if truncate:
        m.set_solver(truncate=truncate)
    if case in ('std', 'rot'):
        m.normalize()
    if case in ('std', 'cplx'):
        m.apply_coslat()
    m.solve(complexify=case == 'cplx', extend=extend)
    if case == 'rot':
        m.rotate(4)
    return m


def _port_twin(jm):
    """A port xMCA on the same data holding the JAX model's solution."""
    tm = _xmodel('torch')
    install_state(tm, to_state(jm))
    return tm


def _getters(m):
    out = {'singular_values': m.singular_values(),
           'variance': m.variance(), 'explained': m.explained_variance(),
           'scf': m.scf(), 'eofs_unrotated': m.eofs(rotated=False),
           'eofs': m.eofs(), 'pcs': m.pcs(),
           'fields': m.fields(original_scale=True),
           'scaled_fields': m.fields()}
    return {k: ({kk: _values(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else _values(v))
            for k, v in out.items()}


def _same_getters(got, ref, tol=TOL):
    for name, r in ref.items():
        g = got[name]
        pairs = g.items() if isinstance(r, dict) else [(None, g)]
        for key, gv in pairs:
            rv = r[key] if key is not None else r
            assert gv.shape == rv.shape, (name, key)
            np.testing.assert_array_equal(np.isnan(gv), np.isnan(rv))
            np.testing.assert_allclose(
                np.nan_to_num(gv), np.nan_to_num(rv), rtol=0,
                atol=tol * np.nanmax(np.abs(rv)), err_msg=name)


def _load(pkg, path):
    m = JxMCA() if pkg == 'jax' else TxMCA(device='cpu')
    m.load_analysis(str(path / 'info.xmca'))
    return m


CASES = [(c, t) for c in ('std', 'rot', 'cplx') for t in (None, 6)]


@pytest.mark.parametrize('case,truncate', CASES)
def test_jax_saved_loads_in_port(tmp_path, case, truncate):
    _solved_jax(case, truncate).save_analysis(str(tmp_path))
    ref, got = _load('jax', tmp_path), _load('torch', tmp_path)
    assert got._analysis == ref._analysis
    # both packages name the loaded fields by their keys
    assert got._field_names == ref._field_names == {'left': 'left',
                                                    'right': 'right'}
    assert not got._complexify_pending
    _same_getters(_getters(got), _getters(ref))
    # the loaded model runs Rule-N (the +-1 pipeline)
    null = _values(got.rule_n(4, n_modes=3, seed=1))
    assert null.shape[0] == 3 and null.shape[1] >= 3
    assert np.isfinite(null).all()


def _info_lines(path):
    return [line for line in (path / 'info.xmca').read_text().splitlines()
            if not line.startswith('created')]


def _same_info(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if g == r:
            continue
        key, gv = g.split(':', 1)
        rkey, rv = r.split(':', 1)
        assert key == rkey and g.index(':') == r.index(':')
        np.testing.assert_allclose(float(gv), float(rv), rtol=1e-12,
                                   err_msg=key)


@pytest.mark.parametrize('case,truncate', CASES)
def test_port_saved_loads_in_jax(tmp_path, case, truncate):
    jm = _solved_jax(case, truncate)
    tm = _port_twin(jm)
    jm.save_analysis(str(tmp_path / 'j'))
    tm.save_analysis(str(tmp_path / 't'))
    _same_info(_info_lines(tmp_path / 't'), _info_lines(tmp_path / 'j'))
    assert sorted(os.listdir(tmp_path / 't')) == sorted(
        os.listdir(tmp_path / 'j')) == sorted(FILES + ('info.xmca',))
    for name in FILES:
        g = t_open(str(tmp_path / 't' / name))
        r = j_open(str(tmp_path / 'j' / name))
        assert g.dims == r.dims and g.name == r.name
        assert g.values.dtype == r.values.dtype
        np.testing.assert_allclose(g.values, r.values, rtol=0,
                                   atol=TOL * np.nanmax(np.abs(r.values)))
        for d in r.dims:
            np.testing.assert_array_equal(_values(g.coords[d]),
                                          _values(r.coords[d]))
    got, ref = _load('jax', tmp_path / 't'), _load('jax', tmp_path / 'j')
    assert got._analysis == ref._analysis
    _same_getters(_getters(got), _getters(ref))


@pytest.mark.parametrize('case', ['std', 'rot', 'cplx'])
def test_array_level_load(tmp_path, case):
    """``MCA.load_analysis`` from host arrays (what ``xMCA`` reads from
    the files) against JAX's."""
    jm = _solved_jax(case, None)
    jm.save_analysis(str(tmp_path))
    fields = {k: _values(v).real
              for k, v in jm.fields(original_scale=True).items()}
    eofs = {k: _values(v) for k, v in jm.eofs(rotated=False).items()}
    ref, got = JMCA(), TMCA(device='cpu')
    for m in (ref, got):
        m.load_analysis(str(tmp_path / 'info.xmca'), fields=fields,
                        eofs=eofs, singular_values=_values(
                            jm.singular_values()))
    assert got._analysis == ref._analysis
    _same_getters(_getters(got), _getters(ref))


def test_extend_exp_loads_alike(tmp_path):
    """JAX saves ``extend : exp``; both packages load it as ``False`` and
    complexify without extension."""
    jm = _solved_jax('cplx', None, extend='exp')
    jm.save_analysis(str(tmp_path))
    assert any(line.startswith('extend') and 'exp' in line
               for line in _info_lines(tmp_path))
    ref, got = _load('jax', tmp_path), _load('torch', tmp_path)
    assert ref._analysis['extend'] is False
    assert got._analysis['extend'] is False
    _same_getters(_getters(got), _getters(ref))


def test_summary_matches_jax(tmp_path, capsys):
    jm = _solved_jax('rot', None)
    jm.save_analysis(str(tmp_path))
    out = []
    for m in (jm, _port_twin(jm), _load('jax', tmp_path),
              _load('torch', tmp_path)):
        m.summary()
        out.append(capsys.readouterr().out)
    assert out[1] == out[0] and out[3] == out[2]
    assert 'is_rotated: \'True\'' in out[0]


def _weight(xr, kind, coords):
    n_lat, n_lon = GRID
    rng = np.random.default_rng(7)
    if kind == 'time':
        return xr.DataArray(rng.uniform(0.5, 2, N_OBS), dims=('time',),
                            coords={'time': coords['time']})
    if kind == 'full':
        return xr.DataArray(rng.uniform(0.5, 2, (N_OBS, n_lat, n_lon)),
                            dims=('time', 'lat', 'lon'), coords=coords)
    if kind == 'short':
        return xr.DataArray(np.ones(N_OBS - 3), dims=('time',))
    return xr.DataArray(np.ones((N_OBS, 2)), dims=('time', 'member'))


@pytest.mark.parametrize('kind', ['time', 'full'])
def test_host_weights_match_jax(kind):
    """Weights that are not a spatial vector take the host path in both
    packages: the same weighted fields and the same spectrum."""
    _, coords = _arrays()
    models = {}
    for pkg, xr in (('jax', jxr), ('torch', txr)):
        m = _xmodel(pkg)
        m.apply_weights(left=_weight(xr, kind, coords),
                        right=_weight(xr, 'time', coords))
        models[pkg] = m
    got, ref = models['torch'], models['jax']
    assert str(got._fields['left'].dtype) == 'torch.float64'
    assert ref._fields['left'].dtype == np.float64
    for k in ('left', 'right'):
        rv = _values(ref.fields()[k])
        np.testing.assert_allclose(_values(got.fields()[k]), rv, rtol=0,
                                   atol=TOL * np.nanmax(np.abs(rv)))
    for m in (got, ref):
        m.solve()
    np.testing.assert_allclose(_values(got.singular_values(5)),
                               _values(ref.singular_values(5)), rtol=1e-9)


@pytest.mark.parametrize('kind', ['short', 'extra-dim'])
def test_mismatched_weights_raise_like_jax(kind):
    _, coords = _arrays()
    with pytest.raises(ValueError) as ref:
        _xmodel('jax').apply_weights(left=_weight(jxr, kind, coords))
    with pytest.raises(ValueError, match=re.escape(str(ref.value))):
        _xmodel('torch').apply_weights(left=_weight(txr, kind, coords))
