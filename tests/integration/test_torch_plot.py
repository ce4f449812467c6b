"""The port's ``plot`` / ``save_plot`` against the JAX package (matplotlib's
Agg backend, no cartopy here).

Each model holds the JAX model's solution (``utils.state``), so the two
figures draw the same numbers: the port's ``_mode_content`` (what a mode
figure shows) equals JAX's, and its figure has JAX's panel layout (axes
positions, titles, labels, colorbars) and draws JAX's arrays (PC lines,
EOF/amplitude and phase images or meshes), to 1e-9 of each array's
largest entry, for real and complexified, one- and two-field models of
both APIs and both orientations of the map figure; ``save_plot`` writes a
PNG.
"""
import matplotlib
matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from xmca_tpu.array import MCA as JMCA  # noqa: E402
from xmca_tpu.compat import xr as jxr  # noqa: E402
from xmca_tpu.viz import plot as jplot  # noqa: E402
from xmca_tpu.xarray import xMCA as JxMCA  # noqa: E402
from xmca_tpu_torch.array import MCA as TMCA  # noqa: E402
from xmca_tpu_torch.compat import xr as txr  # noqa: E402
from xmca_tpu_torch.utils.state import install_state, to_state  # noqa: E402
from xmca_tpu_torch.viz import plot as tplot  # noqa: E402
from xmca_tpu_torch.xarray import xMCA as TxMCA  # noqa: E402

N_OBS, GRID = 40, (5, 8)
TOL = 1e-9


def _pair(api, n_fields, cplx, n_rot):
    n_lat, n_lon = GRID
    t = np.arange(N_OBS, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 4)[None] / N_OBS)
    arrays = []
    for seed in (1, 2)[:n_fields]:
        r = np.random.default_rng(seed)
        data = modes @ r.standard_normal((3, n_lat * n_lon)) \
            + r.standard_normal((N_OBS, n_lat * n_lon))
        arrays.append(data.reshape(N_OBS, n_lat, n_lon))
    coords = {'time': t, 'lat': np.linspace(-60, 60, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    if api == 'mca':
        jm, tm = JMCA(*arrays), TMCA(*arrays, device='cpu')
    else:
        jm = JxMCA(*[jxr.DataArray(a, dims=('time', 'lat', 'lon'),
                                   coords=coords) for a in arrays])
        tm = TxMCA(*[txr.DataArray(a, dims=('time', 'lat', 'lon'),
                                   coords=coords) for a in arrays],
                   device='cpu')
    jm.solve(complexify=cplx)
    if n_rot:
        jm.rotate(n_rot)
    install_state(tm, to_state(jm))
    return jm, tm


def _close(got, ref, what):
    got, ref = np.ma.filled(np.ma.asarray(got, dtype=float), np.nan), \
        np.ma.filled(np.ma.asarray(ref, dtype=float), np.nan)
    assert got.shape == ref.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), what)
    scale = np.nanmax(np.abs(ref)) if np.isfinite(ref).any() else 1.0
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                               rtol=0, atol=TOL * max(scale, 1.0),
                               err_msg=what)


def _same_figure(got, ref):
    """Panel layout, texts and drawn arrays of two figures."""
    assert len(got.axes) == len(ref.axes)
    assert [f._suptitle and f._suptitle.get_text() for f in (got, ref)] \
        == [ref._suptitle and ref._suptitle.get_text()] * 2
    for i, (g, r) in enumerate(zip(got.axes, ref.axes)):
        np.testing.assert_allclose(g.get_position().bounds,
                                   r.get_position().bounds, atol=1e-12)
        for fn in ('get_title', 'get_xlabel', 'get_ylabel'):
            assert getattr(g, fn)() == getattr(r, fn)(), (i, fn)
        assert g.xaxis.get_visible() == r.xaxis.get_visible()
        assert [t.get_text() for t in g.get_xticklabels()] == \
            [t.get_text() for t in r.get_xticklabels()]
        for kind in ('lines', 'images', 'collections'):
            ga, ra = getattr(g, kind), getattr(r, kind)
            assert len(ga) == len(ra), (i, kind)
            for a, b in zip(ga, ra):
                if kind == 'lines':
                    _close(a.get_ydata(), b.get_ydata(), (i, kind))
                elif a.get_array() is not None:
                    _close(a.get_array(), b.get_array(), (i, kind))


FLAVOURS = [('std', False, 0, 1), ('cplx', True, 0, 2),
            ('varmx', False, 3, 3)]


@pytest.mark.parametrize('n_fields', [1, 2])
@pytest.mark.parametrize('flavour,cplx,n_rot,mode', FLAVOURS)
def test_mode_content_and_array_plot(n_fields, flavour, cplx, n_rot, mode):
    jm, tm = _pair('mca', n_fields, cplx, n_rot)
    got = tplot._mode_content(tm, mode, 0.2, 0.3)
    ref = jplot._mode_content(jm, mode, 0.2, 0.3)
    assert set(got) == set(ref)
    assert got['explained'] == pytest.approx(ref['explained'], rel=1e-12)
    for key in ('is_complex', 'map_kind', 'map_range'):
        assert got[key] == ref[key]
    for key in ('series', 'maps', 'phase'):
        assert list(got[key]) == list(ref[key])
        for k in ref[key]:
            _close(got[key][k], ref[key][k], (key, k))
    figs = []
    for m in (tm, jm):
        m.plot(mode, threshold=0.2, phase_shift=0.3)
        figs.append(plt.gcf())
    _same_figure(*figs)
    plt.close('all')


@pytest.mark.parametrize('n_fields', [1, 2])
@pytest.mark.parametrize('flavour,cplx,n_rot,mode', FLAVOURS)
def test_xarray_plot(n_fields, flavour, cplx, n_rot, mode):
    jm, tm = _pair('xmca', n_fields, cplx, n_rot)
    (gfig, gaxes), (rfig, raxes) = (m.plot(mode, threshold=0.1)
                                    for m in (tm, jm))
    assert {k: sorted(v) for k, v in gaxes.items()} == \
        {k: sorted(v) for k, v in raxes.items()}
    _same_figure(gfig, rfig)
    plt.close('all')


def test_xarray_plot_vertical():
    jm, tm = _pair('xmca', 2, True, 0)
    figs = [m.plot(1, orientation='vertical')[0] for m in (tm, jm)]
    _same_figure(*figs)
    plt.close('all')


@pytest.mark.parametrize('api', ['mca', 'xmca'])
def test_save_plot_writes_png(tmp_path, api):
    _, tm = _pair(api, 2, False, 0)
    out = tmp_path / 'mode1.png'
    tm.save_plot(1, path=str(out))
    assert out.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'
    plt.close('all')
