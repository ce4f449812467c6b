"""``xMCA`` on torch tensors — the labeled-array API.

Counterpart of ``xmca_tpu/api/xarray.py``: the constructor captures
dims/coords, ``apply_coslat`` weights by sqrt(cos(latitude)), and every
result comes back as a DataArray with a 1-based ``mode`` coordinate (and
the field's own ``time``/``lat``/``lon`` coordinates).  ``save_analysis``
writes the JAX package's on-disk format (``info.xmca`` plus netCDF files)
and ``load_analysis`` reads it, whichever package wrote it; ``plot`` draws
maps (cartopy when it is importable).  ``xMCA.from_chunks`` builds a
chunk-backed (out-of-core) model from chunk loaders and coordinates.  A
mesh set with ``set_solver(mesh=...)`` runs as in :class:`MCA`; on it
``save_analysis`` is written by rank 0.
Works with real xarray when installed, else with
:mod:`xmca_tpu_torch.compat.xarray_lite`.
"""
import os

import numpy as np
import torch

from xmca_tpu_torch.compat import xr, open_dataarray
from xmca_tpu_torch.api.array import MCA, _host_to
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.utils import trace
from xmca_tpu_torch.utils.text import secure_str

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

    @classmethod
    def from_chunks(cls, left, right=None, *, coords, right_coords=None,
                    dims=('time', 'lat', 'lon'), device='cuda'):
        """A chunk-backed (out-of-core) labeled model: ``left``/``right``
        are chunk loaders as in :meth:`MCA.from_chunks`; ``coords`` (and
        ``right_coords`` when the grids differ) map every dim in ``dims``
        to its coordinate values, whose lengths give the fields' shapes.
        Results come back labeled as the in-memory model's do."""
        rcoords = coords if right_coords is None else right_coords
        spatial = tuple(dims[1:])
        model = super().from_chunks(
            left, right,
            n_observations=int(np.asarray(coords[dims[0]]).size),
            left_shape=tuple(int(np.asarray(coords[d]).size)
                             for d in spatial),
            right_shape=tuple(int(np.asarray(rcoords[d]).size)
                              for d in spatial) if right is not None
            else None,
            device=device)
        model._field_dims = {}
        model._field_coords = {}
        for key, c in (('left', coords), ('right', rcoords)):
            if key in model._keys:
                model._field_dims[key] = tuple(dims)
                model._field_coords[key] = {d: np.asarray(c[d])
                                            for d in dims}
        return model

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

    def _stream_inverse_colmul(self, key):
        """The coslat inverse a chunk-backed ``fields(original_scale=True)``
        undoes (the first factor of the inverse scaling)."""
        if self._analysis['is_coslat_corrected']:
            return 1.0 / self._coslat_weights_full(key)
        return None

    def _scale_X(self, data_dict):
        """Center / normalize / coslat-weight new data, per field."""
        scaled = super()._scale_X(data_dict)
        if self._analysis['is_coslat_corrected']:
            scaled = {k: f * _host_to(self._local(k, self._coslat_weights(k)),
                                      f, real=True)
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

    def _apply_weights_host(self, k, weight):
        """Weights that are not a per-column spatial vector (time-varying,
        or a full (time, lat, lon) grid): the field is copied to the host,
        multiplied there, re-packed and uploaded again in its own dtype
        (the JAX package's semantics)."""
        field = self.fields()[k]
        new_field = np.asarray((field * weight).data)
        try:
            new_field = new_field.reshape(
                self._n_observations[k], self._n_variables[k])
            new_field = new_field[:, self._no_nan_index[k]]
        except ValueError as err:
            raise ValueError(
                'Error for {:} weights. Mismatch between dimensions '
                'of weights ({:}) and original field ({:}).'
                .format(k, np.shape(weight), field.shape)
            ) from err
        dtype = self._fields[k].dtype
        self._fields[k] = torch.as_tensor(
            np.ascontiguousarray(self._local(k, new_field)),
            device=self._device).to(dtype)

    def _weight_grid(self, k, weight):
        """A weight evaluated on field `k`'s full spatial grid (no
        packing): a chunk-backed model's chunks carry every column."""
        spatial_dims = tuple(self._field_dims[k][1:])
        coords = {d: self._field_coords[k][d] for d in spatial_dims
                  if d in self._field_coords[k]}
        template = xr.DataArray(np.ones(self._fields_spatial_shape[k]),
                                dims=spatial_dims, coords=coords)
        try:
            w = np.asarray((template * weight).values)
        except (ValueError, TypeError):
            w = None
        if w is None or w.shape != tuple(self._fields_spatial_shape[k]):
            raise ValueError(
                'chunk-backed models support spatial (per-column) '
                'weights only: weights for the {:} field must '
                'broadcast to the spatial shape {:}.'.format(
                    k, self._fields_spatial_shape[k]))
        return w

    def apply_weights(self, **weights):
        """Multiply fields by (dim-broadcast) DataArray weights: spatial
        weights as a per-column multiply on the device, any other weight
        through :meth:`_apply_weights_host`.  A chunk-backed model records
        spatial weights on its full grid for the streamed passes."""
        if self._is_chunk_backed():
            for k, weight in weights.items():
                if k not in self._keys:
                    raise KeyError('Key `{:}` not found. Please use `left` '
                                   'or `right`'.format(k))
                MCA.apply_weights(self, **{k: self._weight_grid(k, weight)})
            return
        for k, weight in weights.items():
            if k not in self._fields:
                raise KeyError('Key `{:}` not found. Please use `left` or '
                               '`right`'.format(k))
            cols = self._weight_columns(k, weight)
            if cols is None:
                self._nan_guard_dirty = True
                self._apply_weights_host(k, weight)
            else:
                MCA.apply_weights(self, **{k: cols})

    @trace.spanned('apply_coslat')
    def apply_coslat(self):
        """Apply sqrt(cos(latitude)) area weighting."""
        weights = {}
        for key in self._keys:
            lat = self._field_coords[key]['lat']
            if not _is_dataarray(lat):
                # a chunk-backed model's coordinates are plain arrays:
                # label the weight so it broadcasts along 'lat'
                lat = xr.DataArray(np.asarray(lat), dims=('lat',))
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

    # ------------------------------------------------------------ save/load
    def _save_data(self, data, path, engine='h5netcdf', *args, **kwargs):
        file_name = secure_str('.'.join([data.name, 'nc']))
        output_path = os.path.join(path, file_name)
        try:
            data.to_netcdf(path=output_path, engine=engine,
                           invalid_netcdf=engine == 'h5netcdf', *args,
                           **kwargs)
        except (ImportError, ValueError):
            # no h5netcdf/netcdf4 backend: the built-in h5py writer
            from xmca_tpu_torch.compat.xarray_lite import DataArray as LiteDA
            LiteDA(
                np.asarray(data.values), dims=data.dims,
                coords={d: np.asarray(data.coords[d].values)
                        for d in data.dims if d in data.coords},
                name=data.name, attrs=dict(data.attrs),
            ).to_netcdf(output_path)

    def save_analysis(self, path=None, engine='h5netcdf'):
        """Save the analysis: the ``info.xmca`` manifest, the singular
        values, each field's unrotated EOFs and its original-scale fields
        (real part), as netCDF files in the JAX package's layout.  On a
        mesh every rank gathers the arrays, rank 0 writes them and the
        others wait for it."""
        analysis_path = self._get_analysis_path(path)
        fields = self.fields(original_scale=True)
        eofs = self.eofs(rotated=False)
        if _mesh.is_writer(self._mesh):
            self._create_analysis_path(analysis_path)
            self._create_info_file(analysis_path)
            self._save_data(self.singular_values(), analysis_path, engine)
            for key in self._keys:
                self._save_data(eofs[key], analysis_path, engine)
                # the complex parts are recomputed on load
                self._save_data(fields[key].real, analysis_path, engine)
        _mesh.barrier(self._mesh)

    def load_analysis(self, path, engine='h5netcdf'):
        """Load an analysis saved by ``save_analysis`` (of this package
        or of the JAX package: the same files) from its ``info.xmca`` at
        ``path``; the coslat weights are applied again after the array
        load, in the JAX package's order."""
        self._set_info_from_file(path)
        path_folder, _ = os.path.split(path)
        file_names = self._get_file_names(format='nc')
        singular_values = np.asarray(open_dataarray(
            os.path.join(path_folder, file_names['singular']),
            engine=engine).data)
        keys = (['left', 'right'] if self._analysis['is_bivariate']
                else ['left'])
        fields, eofs = {}, {}
        self._field_coords = {}
        self._field_dims = {}
        for key in keys:
            eofs[key] = np.asarray(open_dataarray(
                os.path.join(path_folder, file_names['eofs'][key]),
                engine=engine).data)
            da = open_dataarray(
                os.path.join(path_folder, file_names['fields'][key]),
                engine=engine)
            self._field_coords[key] = da.coords
            self._field_dims[key] = da.dims
            fields[key] = np.asarray(da.data)
        super().load_analysis(path=path, fields=fields, eofs=eofs,
                              singular_values=singular_values)
        if self._analysis['is_coslat_corrected']:
            self.apply_coslat()

    # -------------------------------------------------------------- display
    def plot(self, mode, threshold=0, phase_shift=0, cmap_eof=None,
             cmap_phase=None, figsize=(8.3, 5.0), resolution='110m',
             projection=None, orientation='horizontal', land=True):
        """Map plot of `mode` (cartopy when available); returns
        ``(fig, axes)``."""
        from xmca_tpu_torch.viz.plot import plot_xmca_mode
        return plot_xmca_mode(
            self, mode, threshold=threshold, phase_shift=phase_shift,
            cmap_eof=cmap_eof, cmap_phase=cmap_phase, figsize=figsize,
            resolution=resolution, projection=projection,
            orientation=orientation, land=land,
        )

    def save_plot(self, mode, path=None, plot_kwargs={}, save_kwargs={}):
        """Create and save a plot of `mode` to disk."""
        import matplotlib.pyplot as plt
        output = 'mode{:}.png'.format(mode) if path is None else path
        fig, axes = self.plot(mode=mode, **plot_kwargs)
        fig.subplots_adjust(left=0.06)
        plt.savefig(output, **save_kwargs)
