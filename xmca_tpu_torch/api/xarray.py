"""``xMCA`` on torch tensors — the labeled-array API.

Counterpart of ``xmca_tpu/api/xarray.py``: the constructor captures
dims/coords, ``apply_coslat`` weights by sqrt(cos(latitude)), and every
result comes back as a DataArray with a 1-based ``mode`` coordinate (and
the field's own ``time``/``lat``/``lon`` coordinates).  Works with real
xarray when installed, else with :mod:`xmca_tpu_torch.compat.xarray_lite`.
"""
import numpy as np

from xmca_tpu_torch.compat import xr
from xmca_tpu_torch.api.array import MCA, _host_to, _not_ported

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

    # ------------------------------------------------------------- scaling
    def _coslat_weights_full(self, k):
        """sqrt(cos(lat)) weights on the FULL grid of field `k`,
        flattened.  No epsilon, unlike ``apply_coslat``'s weights: the
        reference scales new data and undoes the weighting with these."""
        lat = self._field_coords[k]['lat']
        lat = np.asarray(getattr(lat, 'values', lat), dtype=np.float64)
        coslat = np.sqrt(np.cos(np.deg2rad(lat)))
        weights = np.ones(self._fields_spatial_shape[k]) \
            * coslat.reshape(coslat.size, 1)
        return weights.flatten()

    def _coslat_weights(self, k):
        """sqrt(cos(lat)) weights on the packed columns of field `k`."""
        return self._coslat_weights_full(k)[self._no_nan_index[k]]

    def _scale_X(self, data_dict):
        """Center / normalize / coslat-weight new data, per field."""
        scaled = super()._scale_X(data_dict)
        if self._analysis['is_coslat_corrected']:
            scaled = {k: f * _host_to(self._coslat_weights(k), f, real=True)
                      for k, f in scaled.items()}
        return scaled

    def _inverse_scale_vectors(self, key):
        """Adds the coslat un-weighting to the base per-column inverse."""
        colmul, coladd = super()._inverse_scale_vectors(key)
        if self._analysis['is_coslat_corrected']:
            inv_w = 1.0 / self._coslat_weights(key)
            colmul = inv_w if colmul is None else colmul * inv_w
        return colmul, coladd

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

    def _wrap_temporal(self, key, values, n, name):
        return xr.DataArray(
            values, dims=['time', 'mode'],
            coords={'time': self._field_coords[key]['time'],
                    'mode': self._mode_coord(n, values.shape[-1])},
            name=name, attrs=self._attrs(),
        )

    def _wrap_spatial(self, key, values, n, name):
        coords = self._field_coords[key]
        return xr.DataArray(
            values, dims=['lat', 'lon', 'mode'],
            coords={'lon': coords['lon'], 'lat': coords['lat'],
                    'mode': self._mode_coord(n, values.shape[-1])},
            name=name, attrs=self._attrs(),
        )

    def _wrap_each(self, wrap, maps, n, what):
        return {k: wrap(k, v, n, ' '.join([self._field_names[k], what]))
                for k, v in maps.items()}

    def fields(self, original_scale=False):
        """Return the input fields as labeled DataArrays."""
        fields = super().fields(original_scale)
        return {k: xr.DataArray(f, dims=self._field_dims[k],
                                coords=self._field_coords[k],
                                name=self._field_names[k])
                for k, f in fields.items()}

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

    def scf(self, n=None):
        """Squared covariance fraction (%) of the first `n` modes."""
        return self._wrap_modes(super().scf(n), n,
                                'squared covariance fraction')

    def pcs(self, n=None, scaling='None', phase_shift=0, rotated=True):
        """First `n` PCs as ('time', 'mode') DataArrays."""
        return self._wrap_each(
            self._wrap_temporal,
            super().pcs(n, scaling, phase_shift, rotated), n, 'pcs')

    def eofs(self, n=None, scaling='None', phase_shift=0, rotated=True):
        """First `n` EOFs as ('lat', 'lon', 'mode') DataArrays."""
        return self._wrap_each(
            self._wrap_spatial,
            super().eofs(n, scaling, phase_shift, rotated), n, 'eofs')

    def spatial_amplitude(self, n=None, scaling='None', rotated=True):
        """Spatial amplitude fields of the first `n` EOFs."""
        return self._wrap_each(
            self._wrap_spatial,
            super().spatial_amplitude(n, scaling, rotated), n,
            'spatial amplitude')

    def spatial_phase(self, n=None, phase_shift=0, rotated=True):
        """Spatial phase fields of the first `n` EOFs."""
        return self._wrap_each(
            self._wrap_spatial,
            super().spatial_phase(n, phase_shift=phase_shift,
                                  rotated=rotated), n, 'spatial phase')

    def temporal_amplitude(self, n=None, scaling='None', rotated=True):
        """Temporal amplitude series of the first `n` PCs."""
        return self._wrap_each(
            self._wrap_temporal,
            super().temporal_amplitude(n, scaling, rotated), n,
            'temporal amplitude')

    def temporal_phase(self, n=None, phase_shift=0, rotated=True):
        """Temporal phase series of the first `n` PCs."""
        return self._wrap_each(
            self._wrap_temporal,
            super().temporal_phase(n, phase_shift=phase_shift,
                                   rotated=rotated), n, 'temporal phase')

    def _wrap_patterns(self, pats, pvals, n, what):
        return (self._wrap_each(self._wrap_spatial, pats, n,
                                what + ' patterns'),
                self._wrap_each(self._wrap_spatial, pvals, n,
                                'pvalues ' + what + ' patterns'))

    def homogeneous_patterns(self, n=None, phase_shift=0):
        """Homogeneous correlation maps + p-values as DataArrays."""
        return self._wrap_patterns(
            *super().homogeneous_patterns(n=n, phase_shift=phase_shift), n,
            'homogeneous')

    def heterogeneous_patterns(self, n=None, phase_shift=0):
        """Heterogeneous correlation maps + p-values as DataArrays."""
        return self._wrap_patterns(
            *super().heterogeneous_patterns(n=n, phase_shift=phase_shift),
            n, 'heterogeneous')

    def reconstructed_fields(self, mode=slice(1, None),
                             original_scale=True):
        """Reconstruct the original input fields from selected modes."""
        rec = super().reconstructed_fields(mode=mode,
                                           original_scale=original_scale)
        return {k: xr.DataArray(f, dims=self._field_dims[k],
                                coords=self._field_coords[k],
                                name='reconstructed_{:}_field'.format(k))
                for k, f in rec.items()}

    def predict(self, left=None, right=None, n=None, scaling='None',
                phase_shift=0):
        """Predict PCs of new labeled data by projection."""
        data = dict(zip(self._keys, [left, right]))
        try:
            values = {k: d if d is None else np.asarray(d.values)
                      for k, d in data.items()}
        except AttributeError as err:
            raise ValueError(
                'Please provide `xr.DataArray` to `left` and `right`'
            ) from err
        pcs_new = super().predict(values['left'], values.get('right'), n,
                                  scaling, phase_shift)
        return {
            k: xr.DataArray(
                pc, dims=('time', 'mode'),
                coords={'time': data[k].coords['time'],
                        'mode': list(range(1, pc.shape[1] + 1))})
            for k, pc in pcs_new.items()
        }

    # --------------------------------------------------------- significance
    def _wrap_runs(self, values, n, attrs=None):
        """An (n_modes, n_runs) ensemble as a ('mode', 'run') DataArray
        with 1-based coordinates."""
        return xr.DataArray(
            values, dims=['mode', 'run'],
            coords={'mode': self._mode_coord(n, values.shape[0]),
                    'run': np.arange(1, values.shape[1] + 1)},
            name='singular values', attrs=attrs,
        )

    def rule_n(self, n_runs, n_modes=None, seed=None,
               disable_progress=False):
        """Rule-N surrogate spectra as a ('mode', 'run') DataArray."""
        return self._wrap_runs(super().rule_n(
            n_runs, n_modes, seed=seed, disable_progress=disable_progress),
            n_modes)

    def rule_north(self, n=None):
        """North's rule-of-thumb uncertainties as a DataArray."""
        uncertainties = super().rule_north(n=n)
        return xr.DataArray(
            uncertainties, dims=['mode'],
            coords={'mode': self._mode_coord(n, len(uncertainties))},
            attrs=self._attrs(), name='singular values',
        )

    def bootstrapping(self, n_runs, n_modes=20, axis=0, on_left=True,
                      on_right=False, block_size=1, replace=True,
                      strategy='standard', disable_progress=False,
                      seed=None):
        """Bootstrap spectra as a ('mode', 'run') DataArray; ``axis`` is
        honoured (the reference's wrapper always resamples time)."""
        return self._wrap_runs(super().bootstrapping(
            n_runs=n_runs, n_modes=n_modes, axis=axis, on_left=on_left,
            on_right=on_right, block_size=block_size, replace=replace,
            strategy=strategy, disable_progress=disable_progress,
            seed=seed), n_modes, attrs=self._attrs())
