"""Minimal netCDF4 (HDF5-based) single-variable reader/writer built on h5py.

The port's own copy of ``xmca_tpu/compat/netcdf.py``'s reader, writer and
out-of-core chunk loader (the port imports nothing of the JAX package).
netCDF4 files are
HDF5 files with the dimension-scales convention, and this is the subset
``save_analysis``/``load_analysis`` need, on h5py alone:

* one main data variable per file (how the analyses are saved),
* named dimensions via HDF5 dimension scales (``CLASS=DIMENSION_SCALE``),
* coordinate variables (a dimension scale that carries data),
* string attributes,
* complex values stored as the native HDF5 compound type (identical on-disk
  representation to h5netcdf's ``invalid_netcdf=True`` mode).

h5py is imported inside the functions, so the module imports without it.
"""
import numpy as np

_PHONY_NAME = 'This is a netCDF dimension but not a netCDF variable.'

# attribute names that belong to the HDF5/netCDF plumbing, not to user data
_INTERNAL_ATTRS = (
    'CLASS', 'NAME', 'DIMENSION_LIST', 'REFERENCE_LIST', '_Netcdf4Dimid',
    '_Netcdf4Coordinates', '_NCProperties',
)


def _decode(value):
    if isinstance(value, bytes):
        return value.decode('utf-8', 'replace')
    if isinstance(value, np.bytes_):
        return bytes(value).decode('utf-8', 'replace')
    return value


def _is_dimension_scale(ds):
    return _decode(ds.attrs.get('CLASS', b'')) == 'DIMENSION_SCALE'


def _find_main_dataset(h):
    """The single data variable of a one-variable netCDF file (its
    dimension scales are the coordinates)."""
    import h5py
    main, scales = None, {}
    for name, ds in h.items():
        if not isinstance(ds, h5py.Dataset):
            continue
        if _is_dimension_scale(ds):
            scales[name] = ds
        else:
            main = (name, ds)
    if main is None:
        # file contains only coordinate-like variables; pick largest
        name = max(scales, key=lambda k: scales[k].size)
        main = (name, scales.pop(name))
    return main, scales


def _dataset_dims(ds):
    """Dimension names of a dataset via its attached dimension scales."""
    dims = []
    for i, dim in enumerate(ds.dims):
        label = None
        try:
            if len(dim) > 0:
                scale_name = dim[0].name.lstrip('/')
                if not scale_name.startswith(_PHONY_NAME):
                    label = scale_name.split('/')[-1]
        except Exception:
            label = None
        dims.append(label if label is not None else 'dim_%d' % i)
    return tuple(dims)


def netcdf_chunks(path, *, max_chunk_bytes=256 * 2 ** 20, dtype=None,
                  return_coords=False):
    """Out-of-core chunk loader over a netCDF variable.

    Returns ``(loader, n_observations, spatial_shape)`` for
    :meth:`xmca_tpu_torch.array.MCA.from_chunks` /
    :meth:`xmca_tpu_torch.xarray.xMCA.from_chunks`: ``loader()`` yields
    ``(n_observations, p_chunk)`` slabs read lazily from disk.  The
    variable is laid out time first (``(time, *spatial)``); slabs split
    the leading spatial axis so each stays under ``max_chunk_bytes``.
    ``_FillValue`` entries become NaN per slab (the streamed solve drops
    NaN columns).  With ``return_coords=True`` the ``dims`` (names) and
    ``coords`` (name -> values, ``arange`` where the file stores none)
    follow, as ``xMCA.from_chunks`` takes them.
    """
    import h5py

    with h5py.File(path, 'r') as h:
        (_, ds), scales = _find_main_dataset(h)
        shape = ds.shape
        fill = ds.attrs.get('_FillValue', None)
        dims = _dataset_dims(ds)
        coords = {}
        if return_coords:
            for i, d in enumerate(dims):
                if d in scales and scales[d].shape != ():
                    coords[d] = np.asarray(scales[d][()])
                else:
                    coords[d] = np.arange(shape[i])
    if len(shape) < 2:
        raise ValueError(
            'netcdf_chunks needs a (time, *spatial) variable; '
            'got shape {:}'.format(shape))
    n_obs = int(shape[0])
    spatial_shape = tuple(int(s) for s in shape[1:])
    out_dtype = np.dtype(dtype) if dtype is not None else None
    inner = int(np.prod(spatial_shape[1:], dtype=np.int64)) or 1
    itemsize = (out_dtype or np.dtype(np.float64)).itemsize
    rows = max(1, int(max_chunk_bytes // (n_obs * inner * itemsize)))

    def loader():
        with h5py.File(path, 'r') as h:
            (_, ds), _scales = _find_main_dataset(h)
            for s in range(0, spatial_shape[0], rows):
                slab = np.asarray(ds[:, s:s + rows])
                # mask at the file's dtype: after a cast the equality
                # with the stored _FillValue could not match
                if (fill is not None
                        and np.issubdtype(slab.dtype, np.floating)
                        and not np.isnan(fill)):
                    slab = np.where(slab == fill, np.nan, slab)
                if out_dtype is not None:
                    slab = slab.astype(out_dtype)
                yield slab.reshape(n_obs, -1)

    if return_coords:
        return loader, n_obs, spatial_shape, dims, coords
    return loader, n_obs, spatial_shape


def read_dataarray(path):
    """Read a single-variable netCDF4/HDF5 file.

    Returns
    -------
    dict with keys ``name`` (str), ``values`` (ndarray), ``dims`` (tuple of
    str), ``coords`` (dict name -> (values, attrs)), ``attrs`` (dict).
    """
    import h5py

    with h5py.File(path, 'r') as h:
        main, scales = _find_main_dataset(h)
        name, ds = main
        values = ds[()]

        # resolve dimension names from attached dimension scales
        dims = list(_dataset_dims(ds))

        coords = {}
        for scale_name, sds in scales.items():
            if scale_name in dims and sds.shape != ():
                nc_name = _decode(sds.attrs.get('NAME', scale_name))
                if nc_name.startswith(_PHONY_NAME):
                    continue  # dimension without coordinate data
                cattrs = {
                    k: _decode(v) for k, v in sds.attrs.items()
                    if k not in _INTERNAL_ATTRS and not k.startswith('_Netcdf')
                }
                coords[scale_name] = (sds[()], cattrs)

        attrs = {
            k: _decode(v) for k, v in ds.attrs.items()
            if k not in _INTERNAL_ATTRS
        }
        # apply _FillValue -> NaN masking like xarray does on read
        fill = attrs.pop('_FillValue', None)
        if fill is not None and np.issubdtype(values.dtype, np.floating):
            if not np.isnan(fill):
                values = np.where(values == fill, np.nan, values)

        return {
            'name': name,
            'values': values,
            'dims': tuple(dims),
            'coords': coords,
            'attrs': attrs,
        }


def write_dataarray(path, name, values, dims, coords=None, attrs=None):
    """Write a single data variable with named dims/coords to netCDF4/HDF5.

    ``coords`` maps dim name -> array (or (array, attrs) tuple).  Complex
    dtypes are written natively (h5netcdf ``invalid_netcdf=True`` layout).
    """
    import h5py

    coords = coords or {}
    attrs = attrs or {}
    values = np.asarray(values)

    with h5py.File(path, 'w') as h:
        scale_dss = {}
        for i, dim in enumerate(dims):
            if dim in coords:
                cval = coords[dim]
                cattrs = {}
                if isinstance(cval, tuple):
                    cval, cattrs = cval
                cval = np.asarray(cval)
                sds = h.create_dataset(dim, data=cval)
                if np.issubdtype(cval.dtype, np.floating):
                    sds.attrs['_FillValue'] = cval.dtype.type(np.nan)
                for k, v in cattrs.items():
                    sds.attrs[k] = v
                sds.make_scale(dim)
            else:
                # netCDF dimension without coordinate variable
                sds = h.create_dataset(dim, shape=(values.shape[i],),
                                       dtype='f4')
                sds.make_scale(
                    '%s%10d' % (_PHONY_NAME + ' ' * 9, values.shape[i])
                )
            sds.attrs['_Netcdf4Dimid'] = np.int32(i)
            scale_dss[dim] = sds

        ds = h.create_dataset(name, data=values)
        if np.issubdtype(values.dtype, np.floating):
            ds.attrs['_FillValue'] = values.dtype.type(np.nan)
        for i, dim in enumerate(dims):
            ds.dims[i].attach_scale(scale_dss[dim])
        for k, v in attrs.items():
            ds.attrs[k] = v
