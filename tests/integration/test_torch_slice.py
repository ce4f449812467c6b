"""The port's main path end to end against the JAX package on CPU.

``xMCA -> set_solver(truncate=4) -> normalize -> apply_coslat ->
solve(complexify=True) -> rotate(4) -> rule_n(64)`` at 64 steps x (8 x 20)
cells, float64, through both packages' public APIs.  The JAX model is
configured for the accelerator Rule-N path the port always runs
(generated +-1 surrogates, 1e-4 rotation tolerance, 6 ensemble subspace
iterations).  The two packages draw different random bits, so Rule-N is
compared statistically: the null q95 of each mode within 5% (JAX's own
seed-to-seed spread at 64 runs is ~1%).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from xmca_tpu.compat import xr
from xmca_tpu_torch.compat import xr as txr
from xmca_tpu.core.fastpath import hilbert_imag_matrix
from xmca_tpu.xarray import xMCA as JxMCA
from xmca_tpu_torch.utils.state import install_state, to_state
from xmca_tpu_torch.xarray import xMCA as TxMCA

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_OBS, N_LAT, N_LON, K = 64, 8, 20, 4


def _fields(xr=xr):
    """Two fields as DataArrays of the package whose ``xr`` is given (each
    package takes its own labeled type; both are real xarray's when it
    is installed)."""
    t = np.arange(N_OBS, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None] / N_OBS)
    p = N_LAT * N_LON
    coords = {'time': t, 'lat': np.linspace(-60, 60, N_LAT),
              'lon': np.linspace(0, 359, N_LON)}
    out = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        data = modes @ r.standard_normal((8, p)) + r.standard_normal(
            (N_OBS, p))
        out.append(xr.DataArray(data.reshape(N_OBS, N_LAT, N_LON),
                                dims=('time', 'lat', 'lon'), coords=coords))
    return out


def _prepare(model):
    model.set_solver(truncate=K)
    model.normalize()
    model.apply_coslat()
    return model


@pytest.fixture(scope='module')
def solved():
    left, right = _fields()
    jm = _prepare(JxMCA(left, right))
    jm.set_solver(spectrum='fast', surrogate_source='generated',
                  surrogate_gen_dist='rademacher8', ensemble_tol=1e-4,
                  ensemble_subspace_iters=6)
    tm = _prepare(TxMCA(*_fields(txr), device='cpu'))
    jm.solve(complexify=True)
    tm.solve(complexify=True)
    return jm, tm


def test_solve_matches_jax(solved):
    """Spectrum and exact totals: 1e-6 relative (f64; the start blocks
    differ, and 12 subspace iterations converge both to ~1e-10)."""
    jm, tm = solved
    assert tm._complexify_pending
    np.testing.assert_allclose(tm.singular_values().values,
                               jm.singular_values().values, rtol=1e-6)
    for key in ('total_covariance', 'total_squared_covariance'):
        np.testing.assert_allclose(tm._analysis[key], jm._analysis[key],
                                   rtol=1e-6)
    np.testing.assert_allclose(tm.explained_variance().values,
                               jm.explained_variance().values, rtol=1e-6)
    np.testing.assert_allclose(tm.rule_north(), jm.rule_north(), rtol=1e-6)
    for k in ('left', 'right'):
        np.testing.assert_allclose(tm._field_stds[k], jm._field_stds[k],
                                   rtol=1e-12)


def test_rotate_and_rule_n_match_jax(solved):
    """Rotated variances to 1e-5; Rule-N null q95 within 5%."""
    jm, tm = solved
    jm.rotate(K)
    tm.rotate(K)
    np.testing.assert_allclose(tm.variance().values, jm.variance().values,
                               rtol=1e-5)
    np.testing.assert_allclose(tm.norm()['left'].values,
                               jm.norm()['left'].values, rtol=1e-5)
    # both return ('mode', 'run') DataArrays
    null_t = tm.rule_n(64, seed=7).values
    null_j = jm.rule_n(64, seed=7, disable_progress=True).values
    assert null_t.shape[0] == K and null_t.shape[1] >= int(0.9 * 64)
    assert np.isfinite(null_t).all()
    np.testing.assert_allclose(np.quantile(null_t, 0.95, axis=1),
                               np.quantile(null_j, 0.95, axis=1),
                               rtol=0.05)


def test_state_carry_over_round_trip():
    """JAX solve -> port eofs/pcs/reconstructed_fields == JAX's (1e-9;
    the port builds the deferred Z itself) and port rotate == JAX rotate
    (1e-5), and the port's state installed back into a JAX model reads
    back unchanged."""
    from xmca_tpu.array import MCA as JMCA
    from xmca_tpu_torch.array import MCA as TMCA
    left, right = _fields()
    jm = _prepare(JxMCA(left, right))
    jm.solve(complexify=True)
    tm = TMCA(device='cpu')
    H = hilbert_imag_matrix(N_OBS, np.float64)
    install_state(tm, to_state(jm), hilbert=H)
    np.testing.assert_array_equal(tm._hilbert_operator(N_OBS, tm._hilbert
                                                       .dtype).numpy(), H)
    np.testing.assert_allclose(tm.singular_values(), jm.singular_values()
                               .values, rtol=0)
    assert tm._complexify_pending and jm._complexify_pending
    for got, ref in ((tm.eofs(K), jm.eofs(K)), (tm.pcs(K), jm.pcs(K)),
                     (tm.reconstructed_fields(original_scale=False),
                      jm.reconstructed_fields(original_scale=False))):
        for k in ('left', 'right'):
            ref_k = ref[k].values
            np.testing.assert_allclose(got[k], ref_k, rtol=0,
                                       atol=1e-9 * np.abs(ref_k).max())
    assert not tm._complexify_pending
    jm.rotate(K)
    tm.rotate(K)
    np.testing.assert_allclose(tm.variance(), jm.variance().values,
                               rtol=1e-5)
    assert np.isfinite(tm.rule_n(8, seed=3)).all()

    back = JMCA()
    state = to_state(tm)
    install_state(back, state)
    again = to_state(back)
    for name in ('_singular_values', '_variance', '_var_idx',
                 '_rotation_matrix'):
        np.testing.assert_array_equal(again[name], state[name])
    for k in ('left', 'right'):
        np.testing.assert_array_equal(again['_V'][k], state['_V'][k])
        np.testing.assert_array_equal(again['_fields'][k],
                                      state['_fields'][k])
    assert again['_analysis'] == state['_analysis']
    for name in ('_complexify_pending', '_solver_method'):
        assert again[name] == state[name]
    np.testing.assert_allclose(back.variance(), tm.variance(), rtol=0)


def test_port_imports_no_jax(tmp_path):
    """The port loads no module of JAX and none of the JAX package: it
    keeps its own copies of what it needs (version, compat with netCDF,
    text, tools, viz).  Every module of the package is imported, then the
    ones save/load and the plots import lazily (h5py, matplotlib, yaml)
    are driven on a small model, and a chunk-backed model streams one of
    the saved files (``netcdf_chunks``) through an extended solve."""
    code = (
        'import importlib, pkgutil, sys, os\n'
        'import matplotlib\n'
        'matplotlib.use("Agg")\n'
        'import numpy as np, xmca_tpu_torch\n'
        'names = [m.name for m in pkgutil.walk_packages('
        'xmca_tpu_torch.__path__, "xmca_tpu_torch.")]\n'
        'for name in names:\n'
        '    importlib.import_module(name)\n'
        'from xmca_tpu_torch.xarray import xMCA, DataArray\n'
        'rng = np.random.default_rng(0)\n'
        'c = {"time": np.arange(20.), "lat": np.linspace(-30, 30, 3), '
        '"lon": np.linspace(0, 300, 4)}\n'
        'das = [DataArray(rng.standard_normal((20, 3, 4)), '
        'dims=("time", "lat", "lon"), coords=c) for _ in range(2)]\n'
        'm = xMCA(*das, device="cpu")\n'
        'm.solve()\n'
        'd = sys.argv[1]\n'
        'm.save_analysis(d)\n'
        'xMCA(device="cpu").load_analysis(os.path.join(d, "info.xmca"))\n'
        'm.save_plot(1, path=os.path.join(d, "m.png"))\n'
        'm.summary()\n'
        'from xmca_tpu_torch.compat import netcdf_chunks\n'
        'load, n, shape, dims, co = netcdf_chunks(os.path.join(d, '
        '"left.nc"), max_chunk_bytes=200, return_coords=True)\n'
        's = xMCA.from_chunks(load, load, coords=co, device="cpu")\n'
        's.set_solver(truncate=2)\n'
        's.solve(complexify=True, extend="theta", period=2)\n'
        's.pcs(2)\n'
        'print(len(names), sorted(m for m in sys.modules if '
        'm.split(".")[0] in ("xmca_tpu", "jax", "jaxlib")))\n')
    out = subprocess.run([sys.executable, '-c', code, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         check=True)
    n_modules, loaded = out.stdout.strip().splitlines()[-1].split(' ', 1)
    assert int(n_modules) >= 25 and loaded == '[]'


def test_cuda_device_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    left, right = _fields(txr)
    with pytest.raises(RuntimeError):
        TxMCA(left, right)
