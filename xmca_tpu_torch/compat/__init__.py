"""Optional dependencies of the port.

``xr`` resolves to the real :mod:`xarray` package when it is installed,
and to the port's :mod:`xmca_tpu_torch.compat.xarray_lite` otherwise.
``xMCA`` is written against the subset the two share.
"""

try:
    import xarray as xr  # noqa: F401
    HAS_XARRAY = True
except ImportError:  # pragma: no cover - depends on environment
    from xmca_tpu_torch.compat import xarray_lite as xr  # noqa: F401
    HAS_XARRAY = False


def open_dataarray(path, engine=None, **kwargs):
    """Open a single-variable netCDF file with whatever backend is available.

    Prefers real xarray (netcdf4/h5netcdf engines); falls back to the
    port's h5py-based reader, which reads the netCDF4/HDF5 layout that
    ``save_analysis`` writes, complex data in h5netcdf's
    ``invalid_netcdf`` mode included.
    """
    if HAS_XARRAY:
        try:
            return xr.open_dataarray(path, engine=engine, **kwargs)
        except (ValueError, ImportError, OSError):
            pass
    from xmca_tpu_torch.compat import xarray_lite
    return xarray_lite.open_dataarray(path)


def netcdf_chunks(path, **kwargs):
    """Out-of-core chunk loader over a netCDF variable, for
    ``MCA.from_chunks`` / ``xMCA.from_chunks``: see
    :func:`xmca_tpu_torch.compat.netcdf.netcdf_chunks`."""
    from xmca_tpu_torch.compat.netcdf import netcdf_chunks as _chunks
    return _chunks(path, **kwargs)
