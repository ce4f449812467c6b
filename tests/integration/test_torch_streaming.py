"""The port's out-of-core models (``core/streaming.py``,
``MCA.from_chunks``, ``xMCA.from_chunks``) on CPU, float64.

Each case of the JAX package's ``tests/integration/test_streaming_api.py``
and ``tests/unit/test_streaming.py`` but the streamed bootstrap, for the
port: the chunk loaders read a read-only on-disk memmap, and the port's
chunk-backed model is held against

* the port's own in-memory model of the same data at the tolerances of
  those files (the same start block, so only the summation order
  differs), and
* the JAX package's chunk-backed model on the same loaders: spectra,
  totals and Grams to 1e-9, vectors to 1e-8 after per-mode unit-factor
  alignment (the packages draw different start blocks; the subspace
  iteration converges past both).

Bootstrapping a chunk-backed model solved with extension raises JAX's
``RuntimeError``; the streamed bootstrap itself is held by
``test_torch_streaming_boot.py``.
"""
import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from tests.conftest import align_modes
from xmca_tpu.array import MCA as JMCA
from xmca_tpu.xarray import xMCA as JxMCA
from xmca_tpu.core import streaming as jstream
from xmca_tpu_torch.array import MCA
from xmca_tpu_torch.compat import xr
from xmca_tpu_torch.core import fastpath as fp
from xmca_tpu_torch.core import streaming as ts
from xmca_tpu_torch.xarray import xMCA

N_OBS, N_LAT, N_LON = 128, 20, 35
P = N_LAT * N_LON
K = 6
DEV = 'cpu'
COORDS = {'time': np.arange(N_OBS), 'lat': np.linspace(-50, 50, N_LAT),
          'lon': np.linspace(0, 340, N_LON)}


@pytest.fixture(scope='module')
def disk_fields(tmp_path_factory):
    rng = np.random.default_rng(21)
    base = rng.standard_normal((N_OBS, 6))
    root = tmp_path_factory.mktemp('torch_chunks')
    out = {}
    for name, seed, off in (('left', 1, 1.5), ('right', 2, -0.7)):
        r = np.random.default_rng(seed)
        data = (base @ r.standard_normal((6, P))
                + 0.3 * r.standard_normal((N_OBS, P)) + off)
        out[name] = (_to_disk(root / f'{name}.dat', data),
                     data.reshape(N_OBS, N_LAT, N_LON))
    return out


def _to_disk(path, data):
    mm = np.memmap(path, dtype=np.float64, mode='w+', shape=(N_OBS, P))
    mm[:] = data
    mm.flush()
    return path


def _loader(path, chunk):
    """A fresh pass over the read-only memmap in (N_OBS, <= chunk)
    slabs (views of the file, never copies)."""
    def chunks():
        mm = np.memmap(path, dtype=np.float64, mode='r', shape=(N_OBS, P))
        for s in range(0, P, chunk):
            yield mm[:, s:s + chunk]
    return chunks


def _from_chunks(cls, disk, chunk=97, right=True, **kw):
    return cls.from_chunks(
        _loader(disk['left'][0], chunk),
        _loader(disk['right'][0], chunk) if right else None,
        n_observations=N_OBS, left_shape=(N_LAT, N_LON),
        right_shape=(N_LAT, N_LON) if right else None, **kw)


def _streamed(disk, complexify=False, chunk=97, solve=True, **solve_kw):
    m = _from_chunks(MCA, disk, chunk, device=DEV)
    m.set_solver(truncate=K)
    if solve:
        m.solve(complexify=complexify, **solve_kw)
    return m


def _jax_streamed(disk, complexify=False, chunk=97, **solve_kw):
    m = _from_chunks(JMCA, disk, chunk)
    m.set_solver(truncate=K)
    m.solve(complexify=complexify, **solve_kw)
    return m


def _in_memory(disk, complexify=False, **solve_kw):
    m = MCA(disk['left'][1], disk['right'][1], device=DEV)
    m.set_solver(truncate=K)
    m.solve(complexify=complexify, **solve_kw)
    return m


def _aligned(got, ref, atol):
    """Vectors equal to ``ref`` after a unit factor per mode (last axis)."""
    g = np.asarray(got).reshape(-1, np.shape(got)[-1])
    r = np.asarray(ref).reshape(-1, np.shape(ref)[-1])
    assert_allclose(align_modes(g, r), r, atol=atol)


def _vs_jax(ms, js, n=K, rotated=False):
    """The port's chunk-backed model against JAX's: spectrum and totals to
    1e-9, EOFs and PCs to 1e-8 after alignment."""
    assert_allclose(ms.singular_values(), js.singular_values(), rtol=1e-9)
    for key in ('total_covariance', 'total_squared_covariance'):
        assert ms._analysis[key] == pytest.approx(js._analysis[key],
                                                  rel=1e-9)
    for getter in ('eofs', 'pcs'):
        got = getattr(ms, getter)(n, rotated=rotated)
        ref = getattr(js, getter)(n, rotated=rotated)
        for k in ref:
            _aligned(got[k], ref[k], 1e-8)


# --------------------------------------------- tests/unit/test_streaming.py
@pytest.fixture(scope='module')
def raw_xy():
    rng = np.random.default_rng(11)
    base = rng.standard_normal((128, 6))
    Xl = base @ rng.standard_normal((6, 700)) \
        + 0.3 * rng.standard_normal((128, 700)) + 1.5
    Xr = base @ rng.standard_normal((6, 500)) \
        + 0.3 * rng.standard_normal((128, 500)) - 0.7
    return Xl, Xr                       # deliberately uncentered


def _omega(n, k, dtype, seed):
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return fp.start_block(n, k, dtype, gen)


def test_streamed_gram_is_exactly_centered(raw_xy):
    import jax.numpy as jnp
    Xl, _ = raw_xy
    G, p, mean, std, keep = ts.streamed_gram(
        ts.chunks_from_array(Xl, 64), Xl.shape[0], device=DEV)
    assert p == Xl.shape[1] and keep.all() and G.dtype == torch.float64
    Xc = Xl - Xl.mean(0)
    ref = Xc @ Xc.T
    assert_allclose(G.numpy(), ref, atol=1e-10 * abs(ref).max())
    assert_allclose(mean, Xl.mean(0), atol=1e-12)
    assert_allclose(std, Xl.std(0), atol=1e-12)
    Gj = jstream.streamed_gram(jstream.chunks_from_array(Xl, 64),
                               Xl.shape[0], jnp.float64)[0]
    assert_allclose(G.numpy(), np.asarray(Gj), atol=1e-12 * abs(ref).max())


@pytest.mark.parametrize('chunk', [64, 129, 700])
def test_streamed_matches_in_memory_real(raw_xy, chunk):
    Xl, Xr = raw_xy
    res = ts.streamed_mca(lambda: ts.chunks_from_array(Xl, chunk),
                          lambda: ts.chunks_from_array(Xr, chunk),
                          Xl.shape[0], K, seed=2, device=DEV)
    Xlc = torch.as_tensor(Xl - Xl.mean(0))
    Xrc = torch.as_tensor(Xr - Xr.mean(0))
    s, Vl, Vr, _, _ = fp.fast_solve_truncated_totals(
        Xlc, Xrc, _omega(128, K, torch.float64, 2), n_modes=K, n_iter=12)
    assert_allclose(res.svals, s.numpy(), rtol=1e-10)
    assert_allclose(res.V_left.numpy(), Vl.numpy(), atol=1e-9)
    assert_allclose(res.V_right.numpy(), Vr.numpy(), atol=1e-9)
    assert res.total_covariance > 0 and res.total_squared_covariance > 0
    assert_allclose(res.scores_left.numpy(), (Xlc @ Vl).numpy(), atol=1e-9)
    assert_allclose(res.scores_right.numpy(), (Xrc @ Vr).numpy(),
                    atol=1e-9)


@pytest.mark.parametrize('bivariate', [True, False])
def test_streamed_matches_in_memory_complex(raw_xy, bivariate):
    """Analytic streamed solve (the fold) == the in-memory analytic
    kernel; the PC accumulator == ``Xz V``."""
    Xl, Xr = raw_xy
    if not bivariate:
        Xr = Xl
    n = Xl.shape[0]
    res = ts.streamed_mca(
        lambda: ts.chunks_from_array(Xl, 96),
        (lambda: ts.chunks_from_array(Xr, 96)) if bivariate else None,
        n, K, complexify=True, seed=3, device=DEV)
    H = fp.hilbert_operator(n, torch.float64)
    Xlc = torch.as_tensor(Xl - Xl.mean(0))
    Xrc = torch.as_tensor(Xr - Xr.mean(0))
    s, Vl, Vr, _, _ = fp.fast_solve_truncated_totals_analytic(
        Xlc, Xrc, H, _omega(n, K, torch.complex128, 3), n_modes=K,
        n_iter=12)
    assert_allclose(res.svals, s.numpy(), rtol=1e-9)
    # a complex vector's phase follows roundoff: aligned, as JAX's test
    _aligned(res.V_left.numpy(), Vl.numpy(), 1e-8)
    assert res.V_left.is_complex() and res.V_right.is_complex()
    if not bivariate:
        assert res.V_left is res.V_right
    Xz = Xlc + 1j * (H @ Xlc)
    V = res.V_left.to(Vl.dtype)
    assert_allclose(res.scores_left.numpy(), (Xz @ V).numpy(), atol=1e-8)
    assert_allclose(res.scores_pre['left'].numpy(),
                    (Xlc.to(V.dtype) @ V).numpy(), atol=1e-8)


def test_streamed_pca(raw_xy):
    Xl, _ = raw_xy
    res = ts.streamed_mca(lambda: ts.chunks_from_array(Xl, 128), None,
                          Xl.shape[0], 4, device=DEV)
    assert res.V_left is res.V_right
    assert res.svals.shape == (4,) and np.isfinite(res.svals).all()


def test_streamed_large_mean_float32_stable(raw_xy):
    """Kelvin-scale means (~300) with unit variance in float32: per-chunk
    centering stays stable (a raw Gram with a rank-1 correction would
    cancel to a NaN Cholesky)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((128, 5))
    X = (base @ rng.standard_normal((5, 600))
         + 0.3 * rng.standard_normal((128, 600)) + 300.0)
    res = ts.streamed_mca(
        lambda: ts.chunks_from_array(X.astype(np.float32), 144), None,
        X.shape[0], 4, complexify=True, seed=4, device=DEV)
    assert res.grams['left'].dtype == torch.float32
    assert np.isfinite(res.svals).all()
    assert torch.isfinite(res.V_left.abs()).all()
    H = fp.hilbert_operator(128, torch.float64)
    Xc = torch.as_tensor(X - X.mean(0))
    M, _, _ = fp.analytic_reduced_kernel(Xc, Xc, H)
    s_ref = torch.linalg.svdvals(M)[:4].numpy()
    assert_allclose(res.svals, s_ref, rtol=2e-3)
    assert_allclose(res.means['left'], X.mean(0), rtol=1e-5)


# ------------------------------------ tests/integration/test_streaming_api
def test_streamed_public_solve_matches_in_memory(disk_fields):
    ms, mm = _streamed(disk_fields), _in_memory(disk_fields)
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-9)
    for key in ('total_covariance', 'total_squared_covariance'):
        assert ms._analysis[key] == pytest.approx(mm._analysis[key],
                                                  rel=1e-9)
    for getter in ('eofs', 'pcs'):
        got, ref = (getattr(m, getter)(K, rotated=False) for m in (ms, mm))
        for k in ('left', 'right'):
            assert_allclose(got[k], ref[k], atol=1e-8)
    _vs_jax(ms, _jax_streamed(disk_fields))


def test_streamed_public_rotate_and_rulen(disk_fields):
    ms, mm = _streamed(disk_fields), _in_memory(disk_fields)
    js = _jax_streamed(disk_fields)
    for m in (ms, mm, js):
        m.rotate(4)
    assert_allclose(ms.variance(), mm.variance(), rtol=1e-8)
    assert_allclose(ms.variance(), js.variance(), rtol=1e-8)
    assert_allclose(ms.eofs(4)['left'], mm.eofs(4)['left'], atol=1e-7)
    # the rule_n rescaling consumes the exact streamed totals
    surr = ms.rule_n(4, seed=5)
    assert np.isfinite(surr).all() and surr.shape[0] == 4
    assert_allclose(surr, mm.rule_n(4, seed=5), rtol=1e-8)


def test_streamed_rotated_rulen_in_column_blocks(disk_fields, monkeypatch):
    """A rotated chunk-backed model's Rule-N, its +-1 fields cast to f32
    in 96-column blocks for the back-projection (P = 700 of 768 padded
    columns: 8 blocks a field, the last 28 columns and 68 of pad), equals
    the in-memory model's under the same budget."""
    ms, mm = _streamed(disk_fields), _in_memory(disk_fields)
    for m in (ms, mm):
        m.rotate(4)
    monkeypatch.setattr(fp, '_PROJECT_BYTES', 4 * 128 * 96)
    widths = []
    inner = fp._pm1_blocks

    def counted(X, stop):
        for c0, block in inner(X, stop):
            widths.append(block.shape[1])
            yield c0, block
    monkeypatch.setattr(fp, '_pm1_blocks', counted)
    surr = ms.rule_n(4, seed=5)
    # 4 runs x 2 fields x 8 blocks, the last of each 768 - 672 wide
    assert widths == 2 * 4 * ([96] * 8)
    assert np.isfinite(surr).all() and surr.shape == (4, 4)
    assert_allclose(surr, mm.rule_n(4, seed=5), rtol=1e-8)


def test_streamed_complex_solve_matches_in_memory(disk_fields):
    ms = _streamed(disk_fields, complexify=True)
    mm = _in_memory(disk_fields, complexify=True)
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-8)
    # the stream folds the analytic signal into the Gram, the in-memory
    # model transforms the data: a few 1e-6 apart on trailing modes
    for getter in ('eofs', 'pcs'):
        got, ref = (getattr(m, getter)(K, rotated=False) for m in (ms, mm))
        for k in ('left', 'right'):
            assert_allclose(got[k], ref[k], atol=1e-5)
    _vs_jax(ms, _jax_streamed(disk_fields, complexify=True))


def test_streamed_predict_matches_in_memory(disk_fields):
    ms, mm = _streamed(disk_fields), _in_memory(disk_fields)
    new = disk_fields['left'][1][:7]
    assert_allclose(ms.predict(left=new, n=4)['left'],
                    mm.predict(left=new, n=4)['left'], atol=1e-8)


def test_streamed_normalize_matches_in_memory(disk_fields):
    mm = MCA(disk_fields['left'][1], disk_fields['right'][1], device=DEV)
    mm.set_solver(truncate=K)
    mm.normalize()
    mm.solve()
    ms = _streamed(disk_fields, solve=False)
    ms.normalize()
    ms.solve()
    js = _from_chunks(JMCA, disk_fields)
    js.set_solver(truncate=K)
    js.normalize()
    js.solve()
    assert ms._analysis['is_normalized']
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-9)
    eof_s, eof_m = ms.eofs(K, rotated=False), mm.eofs(K, rotated=False)
    for k in ('left', 'right'):
        assert_allclose(eof_s[k], eof_m[k], atol=1e-8)
    # the raw stds (predict's scaling) are the ingestion-time ones
    assert_allclose(ms._field_stds['left'],
                    disk_fields['left'][1].reshape(N_OBS, -1).std(axis=0),
                    rtol=1e-10)
    _vs_jax(ms, js)


def test_streamed_apply_weights_matches_in_memory(disk_fields):
    w_left = 0.5 + np.random.default_rng(8).random(P)
    mm = MCA(disk_fields['left'][1], disk_fields['right'][1], device=DEV)
    mm.set_solver(truncate=K)
    mm.apply_weights(left=w_left, right=2.0)
    mm.solve()
    ms = _streamed(disk_fields)        # solved again below: re-streamed
    ms.apply_weights(left=w_left, right=2.0)
    ms.solve()
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-9)
    for getter in ('eofs', 'pcs'):
        got, ref = (getattr(m, getter)(K, rotated=False) for m in (ms, mm))
        for k in ('left', 'right'):
            assert_allclose(got[k], ref[k], atol=1e-8)
    # repeated calls multiply, like the resident multiply
    ms.apply_weights(left=3.0)
    assert_allclose(ms._stream_weights['left'], w_left * 3.0)
    with pytest.raises(ValueError, match='spatial'):
        ms.apply_weights(left=np.ones((N_OBS, P)))


@pytest.mark.parametrize('complexify', [False, True])
def test_streamed_fields_match_in_memory(disk_fields, complexify):
    ms = _streamed(disk_fields, complexify=complexify)
    mm = _in_memory(disk_fields, complexify=complexify)
    for orig in (False, True):
        fs, fm = ms.fields(original_scale=orig), mm.fields(original_scale=orig)
        for k in ('left', 'right'):
            assert_allclose(fs[k], fm[k], atol=1e-6 if complexify else 1e-9)


@pytest.mark.parametrize('complexify', [False, True])
def test_streamed_patterns_match_in_memory(disk_fields, complexify):
    ms = _streamed(disk_fields, complexify=complexify)
    mm = _in_memory(disk_fields, complexify=complexify)
    ms.rotate(4)
    mm.rotate(4)
    shift = 0.4 if complexify else 0
    got = ms.homogeneous_patterns(3, phase_shift=shift) \
        + ms.heterogeneous_patterns(3)
    ref = mm.homogeneous_patterns(3, phase_shift=shift) \
        + mm.heterogeneous_patterns(3)
    for g, r in zip(got, ref):
        for k in ('left', 'right'):
            assert_allclose(g[k], r[k], atol=5e-6)
    assert (np.abs(got[0]['left']) <= 1 + 1e-12).all()


@pytest.mark.parametrize('complexify', [False, True])
def test_streamed_reconstruction_matches_in_memory(disk_fields, complexify):
    ms = _streamed(disk_fields, complexify=complexify)
    mm = _in_memory(disk_fields, complexify=complexify)
    ms.rotate(4)
    mm.rotate(4)
    for mode, orig in ((3, True), (slice(2, 4), False)):
        rs = ms.reconstructed_fields(mode, original_scale=orig)
        rm = mm.reconstructed_fields(mode, original_scale=orig)
        for k in ('left', 'right'):
            assert_allclose(rs[k], rm[k], atol=1e-6)


def test_streamed_nan_columns_in_result_layer(disk_fields, tmp_path):
    """Streamed patterns, reconstructions and fields scatter NaN columns
    as the resident model does."""
    data = disk_fields['left'][1].reshape(N_OBS, P).copy()
    data[:, [5, 60]] = np.nan
    ms = MCA.from_chunks(_loader(_to_disk(tmp_path / 'nan.dat', data), 97),
                         None, n_observations=N_OBS,
                         left_shape=(N_LAT, N_LON), device=DEV)
    mm = MCA(data.reshape(N_OBS, N_LAT, N_LON), device=DEV)
    for m in (ms, mm):
        m.set_solver(truncate=K)
        m.solve()
    hs, hm = ms.homogeneous_patterns(3)[0], mm.homogeneous_patterns(3)[0]
    assert_allclose(hs['left'], hm['left'], atol=5e-6)
    assert np.isnan(hs['left'].reshape(P, 3)[[5, 60]]).all()
    assert_allclose(ms.reconstructed_fields(3)['left'],
                    mm.reconstructed_fields(3)['left'], atol=1e-6)
    assert_allclose(ms.fields()['left'], mm.fields()['left'], atol=1e-9)


def test_streamed_xmca_coslat_matches_in_memory(disk_fields):
    das = {k: xr.DataArray(disk_fields[k][1], dims=('time', 'lat', 'lon'),
                           coords=COORDS, name=k) for k in ('left', 'right')}
    mm = xMCA(das['left'], das['right'], device=DEV)
    ms = xMCA.from_chunks(_loader(disk_fields['left'][0], 128),
                          _loader(disk_fields['right'][0], 128),
                          coords=COORDS, device=DEV)
    js = JxMCA.from_chunks(_loader(disk_fields['left'][0], 128),
                           _loader(disk_fields['right'][0], 128),
                           coords=COORDS)
    for m in (mm, ms, js):
        m.set_solver(truncate=K)
        m.apply_coslat()
        m.solve()
    assert ms._analysis['is_coslat_corrected']
    assert_allclose(ms.singular_values().values,
                    mm.singular_values().values, rtol=1e-9)
    assert_allclose(ms.singular_values().values,
                    np.asarray(js.singular_values().values), rtol=1e-9)
    eof_s, eof_m = ms.eofs(3), mm.eofs(3)
    for k in ('left', 'right'):
        assert_allclose(eof_s[k].values, eof_m[k].values, atol=1e-8)
    # the reconstruction folds the coslat inverse back in
    assert_allclose(ms.reconstructed_fields(3)['left'].values,
                    mm.reconstructed_fields(3)['left'].values, atol=1e-6)
    # original_scale undoes sqrt(cos(lat)), the weight had an epsilon in
    # the root: as in memory (and in the JAX package)
    assert_allclose(ms.fields(original_scale=True)['left'].values,
                    mm.fields(original_scale=True)['left'].values,
                    atol=1e-9)


def _streamed_xmca(disk, **solve_kw):
    m = xMCA.from_chunks(_loader(disk['left'][0], 128),
                         _loader(disk['right'][0], 128), coords=COORDS,
                         device=DEV)
    m.set_solver(truncate=K)
    m.solve(**solve_kw)
    return m


def test_streamed_save_load_roundtrip(disk_fields, tmp_path):
    """``save_analysis`` of a chunk-backed model writes its fields by the
    streamed pass; both packages load the files."""
    ms = _streamed_xmca(disk_fields)
    path = str(tmp_path / 'analysis')
    ms.save_analysis(path=path)
    info = os.path.join(path, 'info.xmca')
    eof_s = ms.eofs(3, rotated=False)
    for loaded in (xMCA(device=DEV), JxMCA()):
        loaded.load_analysis(info)
        assert_allclose(np.asarray(loaded.singular_values().values),
                        ms.singular_values().values, rtol=1e-6)
        eof_2 = loaded.eofs(3, rotated=False)
        for k in ('left', 'right'):
            assert_allclose(np.asarray(eof_2[k].values), eof_s[k].values,
                            atol=1e-6)


def test_streamed_nan_columns_match_in_memory(disk_fields, tmp_path):
    """NaN columns (whole, or a single NaN) drop exactly from the stream:
    the solve equals the in-memory one, and the EOF grids carry NaN."""
    data = {k: disk_fields[k][1].reshape(N_OBS, P).copy()
            for k in ('left', 'right')}
    data['left'][:, [3, 41]] = np.nan
    data['left'][0, 100] = np.nan
    data['right'][:, 7] = np.nan
    paths = {k: _to_disk(tmp_path / f'{k}_nan.dat', data[k]) for k in data}
    loaders = [_loader(paths[k], 97) for k in ('left', 'right')]
    ms = MCA.from_chunks(*loaders, n_observations=N_OBS,
                         left_shape=(N_LAT, N_LON),
                         right_shape=(N_LAT, N_LON), device=DEV)
    js = JMCA.from_chunks(*loaders, n_observations=N_OBS,
                          left_shape=(N_LAT, N_LON),
                          right_shape=(N_LAT, N_LON))
    mm = MCA(*(data[k].reshape(N_OBS, N_LAT, N_LON)
               for k in ('left', 'right')), device=DEV)
    for m in (ms, js, mm):
        m.set_solver(truncate=K)
        m.solve()
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-9)
    for getter in ('eofs', 'pcs'):
        got, ref = (getattr(m, getter)(K, rotated=False) for m in (ms, mm))
        for k in ('left', 'right'):
            assert_allclose(got[k], ref[k], atol=1e-8)
    flat = ms.eofs(K, rotated=False)['left'].reshape(P, K)
    assert np.isnan(flat[[3, 41, 100]]).all() and np.isfinite(flat[0]).all()
    _vs_jax(ms, js)


def test_streamed_all_nan_field_raises():
    def all_nan():
        yield np.full((N_OBS, 50), np.nan)
    for m in (MCA.from_chunks(all_nan, None, n_observations=N_OBS,
                              left_shape=(50,), device=DEV),
              JMCA.from_chunks(all_nan, None, n_observations=N_OBS,
                               left_shape=(50,))):
        with pytest.raises(RuntimeError, match='no NaN-free columns'):
            m.solve()


@pytest.mark.parametrize('extend,period', [('exp', 1), ('theta', 4)])
def test_streamed_extend_matches_in_memory(disk_fields, extend, period):
    """Boundary extension streams: each chunk carries its columns' full
    series, so the per-chunk extension and complex Gram equal the
    resident extended solve."""
    kw = dict(complexify=True, extend=extend, period=period)
    ms, mm = _streamed(disk_fields, **kw), _in_memory(disk_fields, **kw)
    js = _jax_streamed(disk_fields, **kw)
    assert ms._analysis['extend'] == extend
    assert_allclose(ms.singular_values(), mm.singular_values(), rtol=1e-7)
    # the chunked complex Gram differs from the one-product Gram by ~1 ulp;
    # the Cholesky of the near-singular complexified Gram and the subspace
    # iteration amplify that on the vectors (JAX's file: 2e-4)
    for getter in ('eofs', 'pcs'):
        got, ref = (getattr(m, getter)(K, rotated=False) for m in (ms, mm))
        for k in ('left', 'right'):
            assert_allclose(got[k], ref[k], atol=2e-4)
    _vs_jax(ms, js)
    for m in (ms, mm, js):
        m.rotate(3)
    assert_allclose(ms.variance(), mm.variance(), rtol=1e-4)
    assert_allclose(ms.variance(), js.variance(), rtol=1e-8)
    assert_allclose(ms.eofs(3)['left'], mm.eofs(3)['left'], atol=2e-4)
    # fields() reads the loaders again with the extended complexification
    fs, fm = ms.fields(), mm.fields()
    for k in ('left', 'right'):
        assert_allclose(fs[k], fm[k], atol=1e-6)


@pytest.mark.parametrize('extend', ['exp', False])
def test_streamed_bootstrap_runs_unless_extended(disk_fields, extend):
    """JAX's ``RuntimeError`` for an extended chunk-backed model; any other
    bootstraps (``tests/integration/test_torch_streaming_boot.py`` holds
    its results)."""
    m = _from_chunks(MCA, disk_fields, 128, right=False, device=DEV)
    m.set_solver(truncate=K)
    m.solve(complexify=True, extend=extend)
    if extend:
        j = _from_chunks(JMCA, disk_fields, 128, right=False)
        j.set_solver(truncate=K)
        j.solve(complexify=True, extend=extend)
        with pytest.raises(RuntimeError, match='extend') as ref:
            j.bootstrapping(2, n_modes=2, disable_progress=True)
        with pytest.raises(RuntimeError) as got:
            m.bootstrapping(2, n_modes=2)
        assert str(got.value) == str(ref.value)
    else:
        out = m.bootstrapping(2, n_modes=2)
        assert out.shape == (2, 2) and np.isfinite(out).all()


def test_streamed_xmca_wraps_labeled_results(disk_fields):
    m = _streamed_xmca(disk_fields)
    eofs = m.eofs(3)
    assert tuple(eofs['left'].dims) == ('lat', 'lon', 'mode')
    assert list(np.asarray(eofs['left'].coords['mode'].values)) == [1, 2, 3]
    assert m.pcs(3)['left'].values.shape == (N_OBS, 3)
    assert np.isfinite(m.singular_values().values).all()


def test_chunks_are_never_written(disk_fields):
    """The passes work on the chunks in place, on copies: neither a
    writable array a loader yields nor the read-only memmap changes (a
    write into a read-only memmap would raise)."""
    data = disk_fields['left'][1].reshape(N_OBS, P).copy()
    before = data.copy()
    m = MCA.from_chunks(lambda: ts.chunks_from_array(data, 97),
                        _loader(disk_fields['right'][0], 97),
                        n_observations=N_OBS, left_shape=(N_LAT, N_LON),
                        right_shape=(N_LAT, N_LON), device=DEV)
    m.set_solver(truncate=K)
    m.normalize()
    m.apply_weights(left=2.0)
    m.solve(complexify=True, extend='exp')
    m.fields(original_scale=True)
    m.homogeneous_patterns(2)
    np.testing.assert_array_equal(data, before)


def test_streamed_truncate_keeps_its_score_state(disk_fields):
    """``truncate`` cuts a chunk-backed model's score accumulators with its
    singular vectors: its unrotated PCs and EOFs stay those of the
    in-memory model truncated alike (the rotated-basis getters after a
    truncation below the rank raise in both, as in the JAX package)."""
    ms, mm = _streamed(disk_fields), _in_memory(disk_fields)
    for m in (ms, mm):
        m.truncate(4)
    assert ms._stream_scores['left'].shape[1] == 4
    assert ms._stream_scores_pre['right'].shape[1] == 4
    for getter in ('pcs', 'eofs'):
        got, ref = (getattr(m, getter)(rotated=False) for m in (ms, mm))
        for k in ref:
            assert got[k].shape[-1] == 4
            assert_allclose(got[k], ref[k], atol=1e-8)


def test_streamed_xmca_weights_match_in_memory(disk_fields):
    """A labeled spatial weight on a chunk-backed ``xMCA`` is evaluated on
    the full grid and applied per chunk; a time-varying one is refused."""
    rng = np.random.default_rng(4)
    w = xr.DataArray(0.5 + rng.random(N_LON), dims=('lon',),
                     coords={'lon': COORDS['lon']})
    das = [xr.DataArray(disk_fields[k][1], dims=('time', 'lat', 'lon'),
                        coords=COORDS) for k in ('left', 'right')]
    mm = xMCA(*das, device=DEV)
    ms = xMCA.from_chunks(_loader(disk_fields['left'][0], 97),
                          _loader(disk_fields['right'][0], 97),
                          coords=COORDS, device=DEV)
    for m in (mm, ms):
        m.set_solver(truncate=K)
        m.apply_weights(left=w)
        m.solve()
    assert_allclose(ms.singular_values().values,
                    mm.singular_values().values, rtol=1e-9)
    assert_allclose(ms.eofs(3)['left'].values, mm.eofs(3)['left'].values,
                    atol=1e-8)
    with pytest.raises(ValueError, match='spatial'):
        ms.apply_weights(right=xr.DataArray(np.ones(N_OBS), dims=('time',),
                                            coords={'time': COORDS['time']}))
    with pytest.raises(KeyError):
        ms.apply_weights(middle=w)
