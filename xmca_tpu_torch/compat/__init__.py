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
