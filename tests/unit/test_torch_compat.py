"""The port's own copies of the JAX package's dependency-free modules.

``xmca_tpu_torch.compat.xarray_lite``, ``compat.netcdf``,
``compat.open_dataarray``, ``utils.text``, ``tools.xarray`` and
``version`` stand in for their ``xmca_tpu`` originals (the port imports
nothing of the JAX package).  Each copy is held against its original on
the same inputs: the parts ``xMCA`` uses (construction, ``.values``,
``.dims``, ``.coords`` and the dimension-broadcast product of
``_weight_columns``), netCDF files written by either package and read by
both (real, complex, NaN, coordinate attributes), the out-of-core loader
``compat.netcdf_chunks`` over a file with a ``_FillValue``, the text
helpers (and ``tools.text``, which re-exports them), ``DataArray.plot``'s
artists on an Agg canvas, the
longitude wrap and map extent (the port's ``get_extent`` raises its
``KeyError``; the original returns None), and the version string.
"""
import numpy as np
import pytest

from xmca_tpu import version as jax_version
from xmca_tpu.compat import xarray_lite as jax_lite
from xmca_tpu_torch import version as port_version
from xmca_tpu_torch.compat import xarray_lite as port_lite


def _make(lite, rng):
    data = rng.standard_normal((6, 4, 5))
    coords = {'time': np.arange(6.0), 'lat': np.linspace(-60, 60, 4),
              'lon': (np.linspace(0, 359, 5), {'units': 'degrees_east'})}
    return lite.DataArray(data, dims=('time', 'lat', 'lon'), coords=coords,
                          name='sst', attrs={'source': 'test'})


def _same(a, b):
    np.testing.assert_array_equal(a.values, b.values)
    assert a.dims == b.dims and a.name == b.name and a.attrs == b.attrs
    assert list(a.coords) == list(b.coords)
    for k in a.coords:
        np.testing.assert_array_equal(a.coords[k].values, b.coords[k].values)
        assert a.coords[k].dims == b.coords[k].dims
        # as text: a NaN _FillValue read from a file is not equal to itself
        assert ({n: str(v) for n, v in a.coords[k].attrs.items()}
                == {n: str(v) for n, v in b.coords[k].attrs.items()})


def test_construction_values_dims_coords():
    jda = _make(jax_lite, np.random.default_rng(0))
    tda = _make(port_lite, np.random.default_rng(0))
    _same(tda, jda)
    assert tda.shape == jda.shape and tda.dtype == jda.dtype
    _same(port_lite.DataArray(tda), jax_lite.DataArray(jda))


@pytest.mark.parametrize('weight_dims', [('lat',), ('lon',), ('lat', 'lon'),
                                         ('lon', 'lat')])
def test_weight_broadcast_product(weight_dims):
    """``template * weight`` as ``xMCA._weight_columns`` forms it: a
    spatial template of ones times a weight on some of its dims, in any
    order; and the coslat weight built by ufuncs from a coordinate."""
    rng = np.random.default_rng(1)
    shape = {'lat': 4, 'lon': 5}
    w = rng.standard_normal(tuple(shape[d] for d in weight_dims))
    coords = {'lat': np.linspace(-60, 60, 4), 'lon': np.linspace(0, 359, 5)}
    out = []
    for lite in (jax_lite, port_lite):
        template = lite.DataArray(np.ones((4, 5)), dims=('lat', 'lon'),
                                  coords=coords)
        weight = lite.DataArray(w, dims=weight_dims)
        field = _make(lite, np.random.default_rng(2))
        coslat = np.sqrt(np.cos(np.deg2rad(field.coords['lat'])) + 1e-6)
        out.append((template * weight, template * coslat))
    for t, j in zip(out[1], out[0]):
        _same(t, j)


def test_refusals_match():
    for lite in (jax_lite, port_lite):
        with pytest.raises(ValueError):
            lite.DataArray(np.ones((2, 3)), dims=('a',))
        with pytest.raises(ValueError):
            lite.DataArray(np.ones((2, 3)), dims=('a', 'b'),
                           coords={'a': np.arange(3)})


def test_version_strings_equal():
    assert port_version.__version__ == jax_version.__version__
    import xmca_tpu_torch
    assert xmca_tpu_torch.__version__ == jax_version.__version__


# ------------------------------------------------------- netCDF and text
def _netcdf_case(lite, kind):
    rng = np.random.default_rng(5)
    values = rng.standard_normal((6, 4, 3))
    if kind == 'complex':
        values = values + 1j * rng.standard_normal((6, 4, 3))
    values[0, 1, 2] = np.nan
    coords = {'lat': np.linspace(-60, 60, 4),
              'lon': (np.linspace(0, 359, 3), {'units': 'degrees_east'})}
    if kind == 'no-time-coord':
        return lite.DataArray(values, dims=('time', 'lat', 'lon'),
                              coords=coords, name='sst eofs',
                              attrs={'is_complex': 'False', 'rank': '3'})
    coords['time'] = np.arange(6.0)
    return lite.DataArray(values, dims=('time', 'lat', 'lon'),
                          coords=coords, name='sst', attrs={'a': 1})


@pytest.mark.parametrize('kind', ['real', 'complex', 'no-time-coord'])
def test_netcdf_round_trips_between_packages(tmp_path, kind):
    """A file written by either package's lite ``to_netcdf`` (the h5py
    writer) reads the same in both ``open_dataarray`` functions."""
    from xmca_tpu.compat import open_dataarray as j_open
    from xmca_tpu_torch.compat import open_dataarray as t_open
    for writer, lite in (('jax', jax_lite), ('port', port_lite)):
        path = str(tmp_path / (writer + '.nc'))
        _netcdf_case(lite, kind).to_netcdf(path)
        ref, got = j_open(path), t_open(path)
        _same(got, ref)
        assert got.values.dtype == ref.values.dtype
    _same(t_open(str(tmp_path / 'port.nc')), j_open(str(tmp_path / 'jax.nc')))


def test_text_helpers_match():
    from xmca_tpu.utils import text as jtext
    from xmca_tpu_torch.utils import text as ttext
    for s in ('Sea Surface Temperature', 'sst', 'A b C d'):
        assert ttext.secure_str(s) == jtext.secure_str(s)
        assert ttext.boldify_str(s) == jtext.boldify_str(s)
    long = ' '.join(['word'] * 60)
    assert ttext.wrap_str(long) == jtext.wrap_str(long)
    assert ttext.wrap_str(long, width=30) == jtext.wrap_str(long, width=30)


def test_tools_text_entry_points_match():
    """``tools.text`` re-exports the three helpers, as the JAX package's
    ``tools/text.py`` does."""
    from xmca_tpu.tools import text as jtext
    from xmca_tpu_torch.tools import text as ttext
    long = ' '.join(['word'] * 60)
    for s in ('Sea Surface Temperature', 'sst', long):
        assert ttext.secure_str(s) == jtext.secure_str(s)
        assert ttext.boldify_str(s) == jtext.boldify_str(s)
        assert ttext.wrap_str(s) == jtext.wrap_str(s)
        assert ttext.wrap_str(s, width=30) == jtext.wrap_str(s, width=30)


def _artist_state(artist):
    """What a drawn 1-D line or 2-D mesh holds: its data, its extent."""
    if hasattr(artist, 'get_xydata'):
        return [np.asarray(artist.get_xydata())]
    return [np.asarray(artist.get_array()),
            np.asarray(artist.get_coordinates())]


@pytest.mark.parametrize('case', ['1d', '1d_complex', '1d_no_coord', '2d',
                                  '2d_no_coords'])
def test_dataarray_plot_matches(case):
    """``DataArray.plot`` of the port's lite copy draws the artists the
    JAX package's copy draws (Agg canvas), kwargs passed through."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(3)
    if case.startswith('1d'):
        data = rng.standard_normal(7)
        if case == '1d_complex':
            data = data + 1j * rng.standard_normal(7)
        dims = ('time',)
        coords = {} if case == '1d_no_coord' else {'time': np.arange(7.0) * 2}
        kw = {'color': 'k', 'transform': None}
    else:
        data = rng.standard_normal((4, 5))
        dims = ('lat', 'lon')
        coords = ({} if case == '2d_no_coords' else
                  {'lat': np.linspace(-60, 60, 4),
                   'lon': np.linspace(0, 359, 5)})
        kw = {'cmap': 'RdBu_r', 'add_colorbar': False, 'vmin': -1.0}
    drawn = []
    for lite in (jax_lite, port_lite):
        fig, ax = plt.subplots()
        da = lite.DataArray(data, dims=dims, coords=coords)
        out = da.plot(ax=ax, **dict(kw))
        artist = out[0] if isinstance(out, list) else out
        fig.canvas.draw()
        drawn.append((type(artist), _artist_state(artist),
                      len(ax.get_children())))
        plt.close(fig)
    (jt, js, jn), (tt, ts, tn) = drawn
    assert tt is jt and tn == jn
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a, b)
    # no ax: both draw on the current axes
    fig = plt.figure()
    out = port_lite.DataArray(data, dims=dims, coords=coords).plot()
    assert (out[0] if isinstance(out, list) else out).axes is plt.gca()
    plt.close(fig)


def test_dataarray_plot_refuses_3d():
    data = np.zeros((2, 3, 4))
    for lite in (jax_lite, port_lite):
        with pytest.raises(ValueError,
                           match='can only plot 1-D or 2-D DataArrays'):
            lite.DataArray(data, dims=('time', 'lat', 'lon')).plot()


def test_xarray_tools_match():
    from xmca_tpu.tools import xarray as jtools
    from xmca_tpu_torch.tools import xarray as ttools
    out = []
    for lite, tools in ((jax_lite, jtools), (port_lite, ttools)):
        da = lite.DataArray(np.arange(12.0).reshape(3, 4), dims=('lat', 'lon'),
                            coords={'lat': np.array([-10.0, 0.0, 10.0]),
                                    'lon': np.array([0.0, 90.0, 200.0,
                                                     350.0])})
        tools.is_DataArray(da)
        with pytest.raises(TypeError):
            tools.is_DataArray(np.ones(3))
        out.append((tools.wrap_lon_to_180(da), tools.get_extent(da, 10)))
    _same(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
    bare = port_lite.DataArray(np.ones((2, 2)), dims=('y', 'x'))
    assert jtools.get_extent(jax_lite.DataArray(np.ones((2, 2)),
                                                dims=('y', 'x'))) is None
    with pytest.raises(KeyError, match='lon'):
        ttools.get_extent(bare)


@pytest.mark.parametrize('max_chunk_bytes', [800, 2 ** 20],
                         ids=['slabs', 'one-slab'])
def test_netcdf_chunks_match(tmp_path, max_chunk_bytes):
    """``netcdf_chunks`` over a (time, lat, lon) file written by the port's
    h5py writer, with a ``_FillValue`` and a NaN: the same slabs (in f64
    and cast to f32), shapes, dims and coordinates as the JAX package's,
    in several slabs and in one; the loader reads afresh each call."""
    from xmca_tpu.compat import netcdf_chunks as j_chunks
    from xmca_tpu_torch.compat import netcdf_chunks as t_chunks
    from xmca_tpu_torch.compat.netcdf import write_dataarray
    rng = np.random.default_rng(7)
    values = rng.standard_normal((12, 5, 4))
    values[3, 1, 2] = -999.0
    values[0, 4, 0] = np.nan
    path = str(tmp_path / 'field.nc')
    write_dataarray(path, 'sst', values, ('time', 'lat', 'lon'),
                    coords={'time': np.arange(12.0),
                            'lat': np.linspace(-40, 40, 5)},
                    attrs={'_FillValue': -999.0})
    for dtype in (None, np.float32):
        kw = dict(max_chunk_bytes=max_chunk_bytes, dtype=dtype,
                  return_coords=True)
        got, ref = t_chunks(path, **kw), j_chunks(path, **kw)
        assert got[1:4] == ref[1:4] == (12, (5, 4), ('time', 'lat', 'lon'))
        assert sorted(got[4]) == sorted(ref[4])
        for d in ref[4]:
            np.testing.assert_array_equal(got[4][d], ref[4][d])
        for _ in range(2):
            slabs, ref_slabs = list(got[0]()), list(ref[0]())
            assert len(slabs) == len(ref_slabs)
            assert (len(slabs) > 1) == (max_chunk_bytes < 2 ** 20)
            for a, b in zip(slabs, ref_slabs):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        full = np.concatenate(slabs, axis=1)
        assert np.isnan(full[3, 1 * 4 + 2]) and np.isnan(full[0, 16])
    loader, n_obs, shape = t_chunks(path)
    assert (n_obs, shape) == (12, (5, 4))
