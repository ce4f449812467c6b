"""Labeled-array helpers: the port's own copy of
``xmca_tpu/tools/xarray.py`` (the port imports nothing of the JAX
package).

One deliberate difference: ``get_extent`` raises its ``KeyError`` for a
DataArray without ``lon``/``lat`` coordinates, where the JAX package
builds the error, drops it and returns None.
"""
import numpy as np

from xmca_tpu_torch.compat import xr


def is_DataArray(data):
    """Raise TypeError unless `data` is a DataArray (reference semantics)."""
    if isinstance(data, xr.DataArray):
        pass
    else:
        raise TypeError("Data format has to be xarray.DatArray.")


def wrap_lon_to_180(da, lon='lon'):
    """Wrap longitude coordinates of a DataArray to -180..179 and sort."""
    da = da.assign_coords(lon=(((da[lon] + 180) % 360) - 180))
    return da.sortby(lon)


def get_extent(data_array, central_longitude=0):
    """Map extent [east, west, south, north] of a DataArray."""
    if not all(c in data_array.coords for c in ('lon', 'lat')):
        raise KeyError("Spatial coordinates need to be called `lon` and "
                       "`lat`.")
    data_array = wrap_lon_to_180(data_array)
    east = float(np.min(data_array.coords['lon'].values)) \
        + central_longitude + 0.001
    west = float(np.max(data_array.coords['lon'].values)) \
        + central_longitude - 0.001
    south = float(np.min(data_array.coords['lat'].values))
    north = float(np.max(data_array.coords['lat'].values))
    return [east, west, south, north]
