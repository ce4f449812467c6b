"""``xMCA`` on torch tensors — the labeled-array main-path subset.

Counterpart of ``xmca_tpu/api/xarray.py``: the constructor captures
dims/coords, ``apply_coslat`` weights by sqrt(cos(latitude)), and the
spectrum getters come back as DataArrays with a 1-based ``mode``
coordinate.  Works with real xarray when installed, else with
:mod:`xmca_tpu_torch.compat.xarray_lite`.
"""
import numpy as np

from xmca_tpu_torch.compat import xr
from xmca_tpu_torch.api.array import MCA, _not_ported

# the labeled array type xMCA takes: xarray's when it is installed, else
# the built-in lite version with the same subset API
DataArray = xr.DataArray


def _is_dataarray(obj):
    try:
        import xarray as _real_xr
        if isinstance(obj, _real_xr.DataArray):
            return True
    except ImportError:
        pass
    from xmca_tpu_torch.compat.xarray_lite import DataArray as _LiteDA
    return isinstance(obj, _LiteDA)


class xMCA(MCA):
    """MCA of one or two ``xarray.DataArray`` fields (dims ``time``,
    ``lat``, ``lon``) on a torch device."""

    def __init__(self, *fields, device='cuda'):
        if len(fields) > 2:
            raise ValueError('Too many fields. Pass 1 or 2 fields.')
        if not all(_is_dataarray(f) for f in fields):
            raise TypeError(
                'One or more fields are not `xarray.DataArray`. '
                'Please provide `xarray.DataArray` only.'
            )
        keys = ['left', 'right']
        self._field_dims = {}
        self._field_coords = {}
        for key, field in zip(keys, fields):
            self._field_dims[key] = field.dims
            self._field_coords[key] = field.coords
        super().__init__(*[np.asarray(f.values) for f in fields],
                         device=device)

    # ----------------------------------------------------------- weighting
    def _weight_columns(self, k, weight):
        """A weight evaluated on field `k`'s spatial grid, packed onto
        the kept (non-NaN) columns; None if it is not purely spatial."""
        spatial_dims = tuple(self._field_dims[k][1:])
        coords = {d: self._field_coords[k][d] for d in spatial_dims
                  if d in self._field_coords[k]}
        template = xr.DataArray(np.ones(self._fields_spatial_shape[k]),
                                dims=spatial_dims, coords=coords)
        try:
            w = np.asarray((template * weight).values)
        except (ValueError, TypeError):
            return None
        if w.shape != tuple(self._fields_spatial_shape[k]):
            return None
        return w.reshape(-1)[self._no_nan_index[k]]

    def apply_weights(self, **weights):
        """Multiply fields by spatial (dim-broadcast) DataArray weights."""
        for k, weight in weights.items():
            if k not in self._fields:
                raise KeyError('Key `{:}` not found. Please use `left` or '
                               '`right`'.format(k))
            cols = self._weight_columns(k, weight)
            if cols is None:
                raise _not_ported('non-spatial (time-varying) weights')
            MCA.apply_weights(self, **{k: cols})

    def apply_coslat(self):
        """Apply sqrt(cos(latitude)) area weighting."""
        weights = {}
        for key in self._keys:
            lat = self._field_coords[key]['lat']
            weights[key] = np.sqrt(np.cos(np.deg2rad(lat)) + 1e-6)
        self.apply_weights(**weights)
        self._analysis['is_coslat_corrected'] = True

    # ----------------------------------------------------- wrapped getters
    def _attrs(self):
        return {k: str(v) for k, v in self._analysis.items()}

    def _mode_coord(self, n, length):
        slc = self._get_slice(n)
        return list(range(slc.start + 1, slc.stop + 1))[:length]

    def _wrap_modes(self, values, n, name):
        return xr.DataArray(
            values, dims=['mode'],
            coords={'mode': self._mode_coord(n, len(values))},
            name=name, attrs=self._attrs(),
        )

    def singular_values(self, n=None):
        """Return the first `n` singular values."""
        return self._wrap_modes(super().singular_values(n), n,
                                'singular values')

    def norm(self, n=None, sorted=True):
        """L2 norm of the first `n` singular vectors per field."""
        return {
            k: self._wrap_modes(v, n, ' '.join([self._field_names[k],
                                                'norm']))
            for k, v in super().norm(n=n, sorted=sorted).items()
        }

    def variance(self, n=None, sorted=True):
        """Variance of the first `n` singular vectors."""
        return self._wrap_modes(super().variance(n=n, sorted=sorted), n,
                                'variance')

    def explained_variance(self, n=None):
        """Covariance fraction (%) of the first `n` modes."""
        return self._wrap_modes(super().explained_variance(n), n,
                                'covariance fraction')
