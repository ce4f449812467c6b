"""The port's own copies of the JAX package's dependency-free modules.

``xmca_tpu_torch.compat.xarray_lite`` and ``xmca_tpu_torch.version``
stand in for ``xmca_tpu.compat.xarray_lite`` and ``xmca_tpu.version``
(the port imports nothing of the JAX package).  Both copies are held
against their originals on the same numpy inputs: the parts ``xMCA``
uses (construction, ``.values``, ``.dims``, ``.coords`` and the
dimension-broadcast product of ``_weight_columns``) and the version
string.
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
        assert a.coords[k].attrs == b.coords[k].attrs


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
