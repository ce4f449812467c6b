"""The port's streamed bootstrap (``stats/streaming_boot.py``,
``MCA._bootstrap_modes_streamed``) on CPU, float64.

* Every case of the JAX package's ``test_streamed_bootstrap_matches_in_
  memory`` and ``test_streamed_bootstrap_preprocessed``, for the port: a
  chunk-backed model against the port's in-memory model of the same data
  (read-only memmap loaders of ``test_torch_streaming.py``), same seed, so
  the same draws run for run, at JAX's bounds (rtol 2e-4, atol 1e-6); also
  with NaN columns and for ``xMCA`` with coslat weights.
* The port's streamed bootstrap against JAX's: both packages'
  ``_block_indices`` return one numpy-seeded index array (the packages'
  generators differ), so only the subspace start blocks differ and the
  iteration converges past both: unrotated spectra held to 1e-8, rotated
  variances to 1e-6 relative (the time axis reaches ~5e-15); the space
  axis to 1e-7 (it reaches 1.5e-8 unrotated, 3e-10 rotated), since the
  JAX package weights columns by the f32 square root of its f32 counts.
  Each counts pass against JAX's on the same loaders, f64 counts and
  deflation stacks to 1e-10; ``deflated_gram`` and ``_center_gram`` on
  the same inputs to 1e-10.
* The passes a bootstrap reads, counted by the loaders: none for the
  unrotated time axis, one a field a batch of rotated runs, a counts and
  a projection pass for a rotated space-axis batch.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from tests.integration.test_torch_streaming import (  # noqa: F401
    COORDS, DEV, K, N_LAT, N_LON, N_OBS, P, _from_chunks, _loader,
    _to_disk, disk_fields)
from xmca_tpu.array import MCA as JMCA
from xmca_tpu.stats import significance as jsig
from xmca_tpu.stats import streaming_boot as jboot
from xmca_tpu_torch.array import MCA
from xmca_tpu_torch.compat import xr
from xmca_tpu_torch.core import fastpath as tfast
from xmca_tpu_torch.stats import streaming_boot as tboot
from xmca_tpu_torch.xarray import xMCA

BOOT_TOL = dict(rtol=2e-4, atol=1e-6)      # JAX's streamed-vs-resident
JAX_TOL = {'unrotated': 1e-8, 'rotated': 1e-6}


def _solved(model, complexify=False, rotated=True, prep=None):
    model.set_solver(truncate=K, ensemble_tol=1e-8)
    if prep is not None:
        prep(model)
    model.solve(complexify=complexify)
    if rotated:
        model.rotate(3)
    return model


def _pair(disk, complexify=False, rotated=True, prep=None):
    """(chunk-backed, in-memory) port models of the same data."""
    ms = _from_chunks(MCA, disk, device=DEV)
    mm = MCA(disk['left'][1], disk['right'][1], device=DEV)
    return (_solved(ms, complexify, rotated, prep),
            _solved(mm, complexify, rotated, prep))


# ------------------------------------- streamed against in-memory (port)
@pytest.mark.parametrize('config', [
    # (complexify, rotated, kwargs): JAX's eight cases
    (False, False, dict(n_modes=4, seed=7)),
    (False, True, dict(n_modes=3, seed=3)),
    (True, True, dict(n_modes=3, seed=11, on_left=True, on_right=True,
                      block_size=4)),
    (False, True, dict(n_modes=3, seed=5, strategy='iterative')),
    (False, True, dict(n_modes=3, seed=9, axis=1, on_left=True,
                       on_right=True)),
    (True, True, dict(n_modes=3, seed=4, axis=1, on_left=False,
                      on_right=True, block_size=4)),
    (False, True, dict(n_modes=3, seed=6, axis=1, strategy='iterative')),
    (False, True, dict(n_modes=3, seed=8, replace=False, block_size=8)),
])
def test_streamed_bootstrap_matches_in_memory(disk_fields, config):
    complexify, rotated, kwargs = config
    ms, mm = _pair(disk_fields, complexify, rotated)
    bs = ms.bootstrapping(3, disable_progress=True, **kwargs)
    br = mm.bootstrapping(3, disable_progress=True, **kwargs)
    assert bs.shape == br.shape and (bs != 0).all()
    assert_allclose(bs, br, **BOOT_TOL)


def test_streamed_bootstrap_preprocessed(disk_fields):
    """Normalize and weights flow through the streamed Gram resampler."""
    w = 0.5 + np.random.default_rng(1).random(P)

    def prep(m):
        m.normalize()
        m.apply_weights(left=w, right=2.0)

    ms, mm = _pair(disk_fields, prep=prep)
    bs = ms.bootstrapping(3, n_modes=3, seed=13)
    br = mm.bootstrapping(3, n_modes=3, seed=13)
    assert_allclose(bs, br, **BOOT_TOL)


@pytest.mark.parametrize('kwargs', [
    dict(n_modes=3, seed=2, block_size=4, strategy='iterative'),
    dict(n_modes=3, seed=3, axis=1, on_left=True, on_right=True),
    dict(n_modes=2, seed=4, axis=1, strategy='iterative'),
])
def test_streamed_bootstrap_nan_columns(disk_fields, tmp_path, kwargs):
    """NaN columns drop out of the draws, the counts layout and the
    projections as they drop out of the in-memory fields."""
    data = {k: disk_fields[k][1].reshape(N_OBS, P).copy()
            for k in ('left', 'right')}
    data['left'][:, [3, 41, 600]] = np.nan
    data['right'][:, 7] = np.nan
    data['right'][0, 100] = np.nan
    paths = {k: _to_disk(tmp_path / f'{k}.dat', data[k]) for k in data}
    ms = MCA.from_chunks(_loader(paths['left'], 97),
                         _loader(paths['right'], 97), n_observations=N_OBS,
                         left_shape=P, right_shape=P, device=DEV)
    mm = MCA(data['left'], data['right'], device=DEV)
    for m in (ms, mm):
        _solved(m)
    assert_allclose(ms.bootstrapping(3, **kwargs),
                    mm.bootstrapping(3, **kwargs), **BOOT_TOL)


def test_streamed_xmca_coslat_bootstrap(disk_fields):
    das = [xr.DataArray(disk_fields[k][1], dims=('time', 'lat', 'lon'),
                        coords=COORDS) for k in ('left', 'right')]
    mm = xMCA(*das, device=DEV)
    ms = xMCA.from_chunks(_loader(disk_fields['left'][0], 128),
                          _loader(disk_fields['right'][0], 128),
                          coords=COORDS, device=DEV)
    for m in (mm, ms):
        m.apply_coslat()
        _solved(m, complexify=True)
    got, ref = (np.asarray(m.bootstrapping(2, n_modes=3, block_size=8,
                                           seed=5).values) for m in (ms, mm))
    assert_allclose(got, ref, **BOOT_TOL)


# --------------------------------------------------------- against JAX
def _inject(monkeypatch, seed):
    """One numpy-seeded moving-block index array per axis length, for
    both packages' ``_block_indices``; JAX's ensemble functions are
    traced afresh (their cache would keep the patched draw)."""
    rng = np.random.default_rng(seed)
    table = {}

    def indices(n_total, block_size, replace):
        if n_total not in table:
            n_blocks = n_total // block_size
            blocks = (rng.integers(0, n_blocks, n_blocks) if replace
                      else rng.permutation(n_blocks))
            table[n_total] = (blocks[:, None] * block_size
                              + np.arange(block_size)[None, :]).reshape(-1)
        return table[n_total]

    import jax.numpy as jnp
    monkeypatch.setattr(jsig, '_ENSEMBLE_FN_CACHE', {})
    monkeypatch.setattr(jboot, '_block_indices',
                        lambda key, n, b, r: jnp.asarray(indices(n, b, r)))
    monkeypatch.setattr(tboot, '_block_indices',
                        lambda gen, n, b, r: torch.as_tensor(indices(n, b, r)))


def _spy(monkeypatch, module, store):
    """Keep the arguments of every call of ``module``'s counts pass and
    the counts-weighted Grams it returns (as numpy)."""
    inner = module._counts_gram_pass

    def spy(*args, **kw):
        G = inner(*args, **kw)
        store.append((args, np.asarray(G)))
        return G
    monkeypatch.setattr(module, '_counts_gram_pass', spy)


@pytest.mark.parametrize('complexify,rotated,kwargs', [
    (False, False, dict(n_modes=4)),
    (True, False, dict(n_modes=3, block_size=4)),
    (True, True, dict(n_modes=3, block_size=4, on_right=True)),
    (False, True, dict(n_modes=3, strategy='iterative')),
    (False, False, dict(n_modes=3, axis=1, on_left=True, on_right=True)),
    (True, True, dict(n_modes=3, axis=1, on_left=False, on_right=True,
                      block_size=4)),
    (False, True, dict(n_modes=2, axis=1, strategy='iterative')),
])
def test_streamed_bootstrap_matches_jax(disk_fields, monkeypatch, complexify,
                                        rotated, kwargs):
    """The JAX package keeps its column counts in float32 and weights each
    column by their f32 square root (rounded to 6e-8), so its space-axis
    Grams are 1.6e-8 off, and its spectra 1.5e-8 (the port's counts pass
    is exact in f64: ``test_counts_gram_matches_jax``); the space axis's
    unrotated spectra are held at 1e-7."""
    _inject(monkeypatch, 3)
    grams = {'jax': [], 'port': []}
    _spy(monkeypatch, jboot, grams['jax'])
    _spy(monkeypatch, tboot, grams['port'])
    ms = _solved(_from_chunks(MCA, disk_fields, device=DEV), complexify,
                 rotated)
    js = _solved(_from_chunks(JMCA, disk_fields), complexify, rotated)
    got = ms.bootstrapping(2, seed=1, **kwargs)
    ref = np.asarray(js.bootstrapping(2, seed=1, disable_progress=True,
                                      **kwargs))
    assert got.shape == ref.shape and (ref != 0).all()
    tol = JAX_TOL['rotated' if rotated else 'unrotated']
    if kwargs.get('axis') == 1:
        tol = max(tol, 1e-7)
    assert_allclose(got, ref, rtol=tol)
    assert len(grams['port']) == len(grams['jax'])
    for (_, g), (_, r) in zip(grams['port'], grams['jax']):
        assert_allclose(g, r, rtol=0, atol=1e-7 * np.abs(r).max())


@pytest.mark.parametrize('kwargs', [
    dict(axis=1, on_left=True, on_right=True),
    dict(axis=1, strategy='iterative', block_size=4),
])
def test_counts_gram_matches_jax(disk_fields, monkeypatch, kwargs):
    """Each counts pass of the port (normalized, weighted, and deflated
    chunk by chunk in an iterative round) against the JAX package's
    ``_counts_gram_pass`` on the same loaders, counts (in f64) and
    deflation stacks."""
    import jax.numpy as jnp
    calls = []
    _spy(monkeypatch, tboot, calls)
    w = 0.5 + np.random.default_rng(2).random(P)

    def prep(m):
        m.normalize()
        m.apply_weights(left=w, right=3.0)
    m = _solved(_from_chunks(MCA, disk_fields, device=DEV), prep=prep)
    m.bootstrapping(2, n_modes=2, seed=4, **kwargs)
    assert len(calls) == (2 if kwargs.get('strategy') else 1)
    for (su, sources, counts), G in calls:
        deflate = su.S_st['left'] is not None

        def stack(t):
            return jnp.zeros((0, 0)) if t is None else jnp.asarray(t.numpy())
        ref = jboot._counts_gram_pass(
            [(k, su.loaders[k], base) for k, base in sources],
            jnp.asarray(counts.numpy()), N_OBS, counts.shape[0],
            weights=su.weights, normalize=True, dtype=np.float64, mesh=None,
            S_st={k: stack(v) for k, v in su.S_st.items()},
            Wf_st={k: stack(v) for k, v in su.Wf_st.items()},
            deflate=deflate)
        ref = np.asarray(ref)
        assert_allclose(G, ref, rtol=0, atol=1e-10 * np.abs(ref).max())


def test_deflated_and_centered_grams_match_jax():
    rng = np.random.default_rng(5)
    n, p, k = 40, 90, 3
    X = rng.standard_normal((n, p))
    G = X @ X.T

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    XcW, S, W = cplx(n, k), cplx(n, k), cplx(p, k)
    for args in ((G, XcW, S, W), (G, XcW.real, S.real, W.real)):
        got = tboot.deflated_gram(*(torch.as_tensor(a) for a in args))
        ref = np.asarray(jboot.deflated_gram(*args))
        assert_allclose(got.numpy(), ref, rtol=0,
                        atol=1e-10 * np.abs(ref).max())
    Gs = G[rng.integers(0, n, n)][:, rng.integers(0, n, n)]
    assert_allclose(tfast._center_gram(torch.as_tensor(Gs)).numpy(),
                    np.asarray(jboot._center_gram(Gs)), rtol=0,
                    atol=1e-10 * np.abs(Gs).max())


# ----------------------------------------------------- passes per batch
def _counting(disk):
    """A chunk-backed port model whose loaders count their passes."""
    passes = {'left': 0, 'right': 0}

    def counted(k):
        inner = _loader(disk[k][0], 97)

        def chunks():
            passes[k] += 1
            return inner()
        return chunks
    m = MCA.from_chunks(counted('left'), counted('right'),
                        n_observations=N_OBS, left_shape=P, right_shape=P,
                        device=DEV)
    return m, passes


@pytest.mark.parametrize('rotated,n_runs,batch,kwargs,expected', [
    (False, 5, None, dict(), (0, 0)),
    (True, 5, None, dict(), (1, 1)),
    (True, 5, 2, dict(), (3, 3)),
    (True, 2, None, dict(strategy='iterative'), (3, 3)),
    (True, 2, None, dict(axis=1, on_left=True, on_right=True), (2, 2)),
    (True, 2, None, dict(axis=1, on_left=False, on_right=True), (1, 2)),
    (False, 2, None, dict(axis=1), (1, 0)),
])
def test_streamed_bootstrap_passes(disk_fields, rotated, n_runs, batch,
                                   kwargs, expected):
    """JAX's pass counts: none for unrotated time-axis runs, one a field
    per batch of rotated ones (per round when iterative), a counts pass
    over the resampled fields and a projection pass over every field for
    a rotated space-axis batch."""
    m, passes = _counting(disk_fields)
    _solved(m, complexify=True, rotated=rotated)
    if batch is not None:
        m.set_solver(batch_size=batch)
    before = dict(passes)
    out = m.bootstrapping(n_runs, n_modes=3, seed=2, **kwargs)
    assert np.isfinite(out).all() and (out != 0).all()
    assert (passes['left'] - before['left'],
            passes['right'] - before['right']) == expected
