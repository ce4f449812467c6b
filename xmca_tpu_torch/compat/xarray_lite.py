"""A minimal, dependency-free stand-in for ``xarray.DataArray``.

The port's own copy of ``xmca_tpu/compat/xarray_lite.py`` (the port
imports nothing of the JAX package), cut to what ``xMCA`` and its users
need while xarray is not installed:

* named dimensions + 1-D coordinate variables + attrs + name,
* dimension-aligned broadcasting for arithmetic and numpy ufuncs
  (``field * weight`` where ``weight`` has dims ``('lat',)``),
* reductions over named dims, ``isel`` (positional), ``sel``
  (label-based, inclusive slices), numpy-style ``[]`` indexing, ``where``,
* netCDF round trips via :mod:`xmca_tpu_torch.compat.netcdf` (h5py),
* ``sortby`` / ``assign_coords`` used by ``tools.xarray``,
* ``plot``: a line for 1-D, ``pcolormesh`` for 2-D (matplotlib).

If real xarray is installed, :mod:`xmca_tpu_torch.compat` prefers it;
this module is the fallback, NOT a general xarray replacement.
"""
import numpy as np

__all__ = ['DataArray', 'open_dataarray']


class Coordinates(dict):
    """dict of coordinate name -> 1-D DataArray."""

    def __getitem__(self, key):
        try:
            return dict.__getitem__(self, key)
        except KeyError:
            raise KeyError(
                "coordinate %r not found (have %s)" % (key, list(self))
            )


def _coord_values(value):
    """Normalize a coords entry to (ndarray, attrs)."""
    if isinstance(value, DataArray):
        return np.asarray(value.values), dict(value.attrs)
    if (isinstance(value, tuple) and len(value) == 2
            and isinstance(value[1], dict)):
        return np.asarray(value[0]), dict(value[1])
    if isinstance(value, range):
        value = list(value)
    return np.asarray(value), {}


class DataArray:
    __slots__ = ('values', 'dims', 'coords', 'name', 'attrs')

    # win ufunc dispatch against ndarray operands
    __array_priority__ = 100

    def __init__(self, data, dims=None, coords=None, name=None, attrs=None):
        if isinstance(data, DataArray):
            if dims is None:
                dims = data.dims
            if coords is None:
                coords = data.coords
            if name is None:
                name = data.name
            if attrs is None:
                attrs = data.attrs
            data = data.values
        self.values = np.asarray(data)
        if dims is None:
            dims = tuple('dim_%d' % i for i in range(self.values.ndim))
        self.dims = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                'dims %s do not match data ndim %d'
                % (self.dims, self.values.ndim)
            )
        self.coords = Coordinates()
        if coords is not None:
            items = coords.items() if hasattr(coords, 'items') else coords
            for cname, cval in items:
                vals, cattrs = _coord_values(cval)
                if cname in self.dims:
                    axis = self.dims.index(cname)
                    if vals.shape != (self.values.shape[axis],):
                        raise ValueError(
                            'coordinate %r has shape %s, expected (%d,)'
                            % (cname, vals.shape, self.values.shape[axis])
                        )
                self.coords[cname] = DataArray(
                    vals, dims=(cname,), name=cname, attrs=cattrs
                )
        self.name = name
        self.attrs = dict(attrs) if attrs else {}

    # ------------------------------------------------------------------ meta
    @property
    def data(self):
        return self.values

    @property
    def shape(self):
        return self.values.shape

    @property
    def size(self):
        return self.values.size

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def real(self):
        return self._with_values(self.values.real)

    @property
    def imag(self):
        return self._with_values(self.values.imag)

    def conjugate(self):
        return self._with_values(self.values.conjugate())

    conj = conjugate

    def _with_values(self, values, dims=None, coords=None):
        out = DataArray.__new__(DataArray)
        out.values = np.asarray(values)
        out.dims = self.dims if dims is None else tuple(dims)
        out.coords = Coordinates(self.coords if coords is None else coords)
        out.name = self.name
        out.attrs = dict(self.attrs)
        return out

    def copy(self):
        return DataArray(self.values.copy(), dims=self.dims,
                         coords=self.coords, name=self.name, attrs=self.attrs)

    def __repr__(self):
        return ('<xmca_tpu_torch.DataArray %r %s>\n%r\nCoordinates: %s'
                % (self.name, dict(zip(self.dims, self.shape)),
                   self.values, list(self.coords)))

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.values)
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return arr

    def item(self):
        return self.values.item()

    def __float__(self):
        return float(self.values)

    def __int__(self):
        return int(self.values)

    def __bool__(self):
        return bool(self.values)

    # ------------------------------------------------------------ arithmetic
    def _binary_op(self, other, op, reflexive=False):
        if isinstance(other, DataArray):
            self_v, other_v, dims, coords = _align(self, other)
        else:
            self_v, other_v = self.values, np.asarray(other)
            dims, coords = self.dims, self.coords
            if other_v.ndim > self_v.ndim:
                return NotImplemented
        a, b = (other_v, self_v) if reflexive else (self_v, other_v)
        out = self._with_values(op(a, b))
        out.dims = dims
        out.coords = Coordinates(coords)
        return out

    def __add__(self, o):
        return self._binary_op(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binary_op(o, lambda a, b: a + b, True)

    def __sub__(self, o):
        return self._binary_op(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binary_op(o, lambda a, b: a - b, True)

    def __mul__(self, o):
        return self._binary_op(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binary_op(o, lambda a, b: a * b, True)

    def __truediv__(self, o):
        return self._binary_op(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binary_op(o, lambda a, b: a / b, True)

    def __pow__(self, o):
        return self._binary_op(o, lambda a, b: a ** b)

    def __mod__(self, o):
        return self._binary_op(o, lambda a, b: a % b)

    def __neg__(self):
        return self._with_values(-self.values)

    def __abs__(self):
        return self._with_values(np.abs(self.values))

    def __lt__(self, o):
        return self._binary_op(o, lambda a, b: a < b)

    def __le__(self, o):
        return self._binary_op(o, lambda a, b: a <= b)

    def __gt__(self, o):
        return self._binary_op(o, lambda a, b: a > b)

    def __ge__(self, o):
        return self._binary_op(o, lambda a, b: a >= b)

    def __eq__(self, o):
        return self._binary_op(o, lambda a, b: a == b)

    def __ne__(self, o):
        return self._binary_op(o, lambda a, b: a != b)

    __hash__ = None

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != '__call__' or kwargs.get('out') is not None:
            return NotImplemented
        das = [x for x in inputs if isinstance(x, DataArray)]
        base = das[0]
        if len(das) == 2:
            av, bv, dims, coords = _align(das[0], das[1])
            vals = {id(das[0]): av, id(das[1]): bv}
            arrays = [vals[id(x)] if isinstance(x, DataArray)
                      else np.asarray(x) for x in inputs]
            out = base._with_values(ufunc(*arrays, **kwargs))
            out.dims = dims
            out.coords = Coordinates(coords)
            return out
        arrays = [x.values if isinstance(x, DataArray) else x for x in inputs]
        return base._with_values(ufunc(*arrays, **kwargs))

    # ----------------------------------------------------------- reductions
    def _reduce(self, fn, dim=None, **kwargs):
        if dim is None:
            return fn(self.values, **kwargs)
        axes = tuple(self.dims.index(d)
                     for d in ((dim,) if isinstance(dim, str) else dim))
        res = fn(self.values, axis=axes, **kwargs)
        new_dims = tuple(d for i, d in enumerate(self.dims) if i not in axes)
        coords = {k: v for k, v in self.coords.items() if k in new_dims}
        return DataArray(res, dims=new_dims, coords=coords,
                         name=self.name, attrs=self.attrs)

    def mean(self, dim=None, **kw):
        return self._reduce(np.nanmean if kw.pop('skipna', False)
                            else np.mean, dim, **kw)

    def std(self, dim=None, **kw):
        return self._reduce(np.std, dim, **kw)

    def sum(self, dim=None, **kw):
        return self._reduce(np.sum, dim, **kw)

    def min(self, dim=None, **kw):
        return self._reduce(np.min, dim, **kw)

    def max(self, dim=None, **kw):
        return self._reduce(np.max, dim, **kw)

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key):
        if isinstance(key, str):
            return self.coords[key]
        if not isinstance(key, tuple):
            key = (key,)
        # expand Ellipsis
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            n_explicit = len([k for k in key if k is not Ellipsis])
            fill = (slice(None),) * (self.ndim - n_explicit)
            key = key[:i] + fill + key[i + 1:]
        key = key + (slice(None),) * (self.ndim - len(key))

        values = self.values[key]
        new_dims = []
        coords = {}
        for d, k in zip(self.dims, key):
            if isinstance(k, (int, np.integer)):
                continue
            new_dims.append(d)
            if d in self.coords:
                coords[d] = DataArray(
                    self.coords[d].values[k], dims=(d,), name=d,
                    attrs=self.coords[d].attrs
                )
        return DataArray(values, dims=new_dims, coords=coords,
                         name=self.name, attrs=self.attrs)

    def isel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {}, **kwargs)
        key = tuple(indexers.get(d, slice(None)) for d in self.dims)
        return self[key]

    def sel(self, indexers=None, **kwargs):
        indexers = dict(indexers or {}, **kwargs)
        key = []
        for d in self.dims:
            if d not in indexers:
                key.append(slice(None))
                continue
            sel = indexers[d]
            cvals = self.coords[d].values
            if isinstance(sel, slice):
                # label-based inclusive slice (xarray semantics)
                mask = np.ones(len(cvals), dtype=bool)
                if sel.start is not None:
                    mask &= cvals >= sel.start
                if sel.stop is not None:
                    mask &= cvals <= sel.stop
                idx = np.nonzero(mask)[0]
                key.append(slice(idx[0], idx[-1] + 1) if idx.size
                           else slice(0, 0))
            else:
                matches = np.nonzero(cvals == sel)[0]
                if matches.size == 0:
                    raise KeyError(
                        'label %r not found in coordinate %r' % (sel, d)
                    )
                key.append(int(matches[0]))
        return self[tuple(key)]

    def where(self, cond, other=np.nan):
        cond_v = cond.values if isinstance(cond, DataArray) else cond
        return self._with_values(np.where(cond_v, self.values, other))

    def sortby(self, dim):
        if isinstance(dim, DataArray):
            dim = dim.name if dim.name is not None else dim.dims[0]
        order = np.argsort(self.coords[dim].values, kind='stable')
        key = tuple(order if d == dim else slice(None) for d in self.dims)
        return self[key]

    def assign_coords(self, coords=None, **kwargs):
        coords = dict(coords or {}, **kwargs)
        new = self.copy()
        for cname, cval in coords.items():
            vals, cattrs = _coord_values(cval)
            new.coords[cname] = DataArray(vals, dims=(cname,), name=cname,
                                          attrs=cattrs)
        return new

    # --------------------------------------------------------------- output
    def to_netcdf(self, path, engine=None, invalid_netcdf=None,
                  *args, **kwargs):
        from xmca_tpu_torch.compat import netcdf
        coords = {
            d: (self.coords[d].values, self.coords[d].attrs)
            for d in self.dims if d in self.coords
        }
        attrs = {k: str(v) for k, v in self.attrs.items()}
        netcdf.write_dataarray(
            path, self.name or 'data', self.values, self.dims,
            coords=coords, attrs=attrs,
        )

    def plot(self, ax=None, **kwargs):
        """Minimal matplotlib plotting: line for 1-D, pcolormesh for 2-D
        (matplotlib is imported here, at the first plot)."""
        import matplotlib.pyplot as plt
        if ax is None:
            ax = plt.gca()
        kwargs.pop('transform', None)
        kwargs.pop('add_colorbar', None)
        if self.ndim == 1:
            x = (self.coords[self.dims[0]].values
                 if self.dims[0] in self.coords
                 else np.arange(self.shape[0]))
            return ax.plot(x, self.values.real, **kwargs)
        if self.ndim == 2:
            ydim, xdim = self.dims
            x = (self.coords[xdim].values if xdim in self.coords
                 else np.arange(self.shape[1]))
            y = (self.coords[ydim].values if ydim in self.coords
                 else np.arange(self.shape[0]))
            return ax.pcolormesh(x, y, self.values.real, **kwargs)
        raise ValueError('can only plot 1-D or 2-D DataArrays')



def _align(a, b):
    """Broadcast two DataArrays by dimension name (xarray-style).

    Result dims: a's dims, followed by any extra dims of b.
    """
    dims = list(a.dims) + [d for d in b.dims if d not in a.dims]
    av = _expand(a, dims)
    bv = _expand(b, dims)
    coords = Coordinates()
    for src in (b, a):  # a's coords win
        for cname, cval in src.coords.items():
            if cname in dims:
                coords[cname] = cval
    return av, bv, tuple(dims), coords


def _expand(da, dims):
    """Reshape values of `da` so its axes line up with `dims`."""
    shape = [1] * len(dims)
    src = da.values
    # move axes of da into the order of `dims`
    order = sorted(range(da.ndim), key=lambda i: dims.index(da.dims[i]))
    src = np.transpose(src, order)
    j = 0
    for i, d in enumerate(dims):
        if d in da.dims:
            shape[i] = src.shape[j]
            j += 1
    return src.reshape(shape)


def open_dataarray(path, engine=None, **kwargs):
    """Open a single-variable netCDF file as a (lite) DataArray."""
    from xmca_tpu_torch.compat import netcdf
    raw = netcdf.read_dataarray(path)
    coords = {k: (v[0], v[1]) for k, v in raw['coords'].items()}
    return DataArray(raw['values'], dims=raw['dims'], coords=coords,
                     name=raw['name'], attrs=raw['attrs'])
