"""``MCA`` on torch tensors — the in-memory ndarray API.

Counterpart of ``xmca_tpu/api/array.py``: construction and ingestion,
``set_solver``, ``apply_weights``, ``normalize``, the exact dense and the
truncated ``solve``, ``rotate``, the result getters (spectrum, EOFs, PCs,
amplitude and phase, correlation patterns, reconstruction, ``predict``,
``truncate``, rotation and correlation matrices, ``fields``), ``rule_n``,
``rule_north``, ``bootstrapping``, ``summary``, ``plot``/``save_plot``
and ``load_analysis`` (the array half of save/load; ``xMCA`` writes the
files).  Fields and singular vectors live on the device named at
construction (``'cuda'`` by default); every product runs there and only a
getter's final result is copied to numpy.  ``solve(complexify=True,
extend='exp'|'theta')`` complexifies with boundary extension, and
``MCA.from_chunks`` builds a chunk-backed (out-of-core) model whose data
streams through the device (``core.streaming``; its bootstrap:
``stats.streaming_boot``).  ``set_solver(mesh=...)`` runs the model on a
device mesh (:mod:`xmca_tpu_torch.parallel.mesh`, one process a device):
``solve`` shards the fields' packed columns over the 'space' axis and
the Monte-Carlo methods split their runs over the ensemble axis; getters
that return a space axis gather it once, where they copy to numpy.
``bootstrapping`` runs every combination the JAX package runs on a
mesh: a column resample (``axis=1``) of sharded fields keeps each rank's
draws on its own columns, and runs split over the sharded space axis
itself gather the fields once (its docstring says what each costs).

The Monte-Carlo methods run the accelerator configuration of the JAX
package on every device (its branch for ``jax.default_backend() ==
'tpu'``); ``rule_n``'s docstring tables it.  Bootstrapping: the fast
spectrum (``set_solver(spectrum='exact')`` picks the dense one) and
rotation tolerance 1e-4 with the convergence-gated polar.

Under a profiler (:mod:`xmca_tpu_torch.utils.trace`) the constructor's
ingest (``ingest`` a field: ``ingest.copy``, ``ingest.scan``,
``ingest.moments``), ``normalize``, ``solve``, ``rotate`` (its
``iterations``), ``rule_n`` and ``bootstrapping`` record spans, and every
blocking read or copy is a ``sync`` site.
"""
import cmath
import os
from datetime import datetime

import numpy as np
import torch

from xmca_tpu_torch.version import __version__
from xmca_tpu_torch.utils.text import secure_str, wrap_str
from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core import preprocess as _pre
from xmca_tpu_torch.core import solver as _solver
from xmca_tpu_torch.core.rotation import promax as _promax
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.stats import significance as _sig
from xmca_tpu_torch.utils import trace
from xmca_tpu_torch.utils.device import resolve_device

_HILBERT_MATMUL_MAX_N = 8192


def _np(x, site='result'):
    return trace.to_host(x.detach(), site).resolve_conj().numpy()


def _torch_dtype(dtype):
    """A torch floating dtype from a torch dtype, a numpy dtype or a name
    ('bfloat16', 'float32', ...)."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
        out = getattr(torch, name, None)
        if not isinstance(out, torch.dtype):
            raise TypeError('data type {!r} not understood'.format(dtype))
    if not out.is_floating_point:
        raise ValueError('surrogate_dtype must be a real floating dtype, not '
                         '{}'.format(out))
    return out


def _host_to(x, like, real=False, site='host.copy'):
    """Host array ``x`` as a tensor on ``like``'s device, in ``like``'s
    dtype (its real dtype when ``real``)."""
    t = trace.to_device(np.ascontiguousarray(x), like.device, site)
    return t.to(like.real.dtype if real else like.dtype)


def _nan_fill(dtype):
    return complex(np.nan, np.nan) if dtype.is_complex else float('nan')


# ---------------------------------------------------------------------------
# Mode-space products: scale the singular vectors by sqrt(s), mix them
# through the rotation matrix, order them by variance, project the data
# through them.  Plain tensor algebra on the model's device (f32 with TF32
# off on the card); `order` is a LongTensor, `keep` a slice.
# ---------------------------------------------------------------------------

def _loadings(V, col_w, R, inv_norm, order, pool):
    """Rotated spatial vectors: ``((V sqrt(s)) R / norm)``, variance-ordered."""
    return ((V[:, :pool] * col_w) @ R * inv_norm)[:, order]


def _scores(XV, whiten):
    """Unrotated PC series from the raw scores ``X V``: ``(X V) /
    sqrt(s)``."""
    return XV * whiten


def _scores_rotated(XV, whiten, R_it, order):
    """Rotated PC series: ``((X V) / sqrt(s)) R^-T``, variance-ordered."""
    return (_scores(XV, whiten) @ R_it)[:, order]


def _reconstruct_factors(XV, V, whiten, R_it, col_w, R, inv_norm, norm_keep,
                         order, pool, keep):
    """Rank-k factors ``(S, W)`` of the mode-subset reconstruction
    ``real(S W^H)``: the eigen-scaled rotated PCs (n_obs, k) and the
    rotated spatial vectors (p, k)."""
    S = _scores_rotated(XV, whiten, R_it, order)[:, keep] * norm_keep
    W = _loadings(V, col_w, R, inv_norm, order, pool)[:, keep]
    return S, W


def _real_factors(S, W):
    """Real factors ``(A, B)`` with ``A B^T = real(S W^H)``: the real
    and imaginary blocks stacked side by side, so the product is ONE real
    matmul."""
    if S.is_complex():
        return (torch.cat([S.real, S.imag], dim=1),
                torch.cat([W.real, W.imag], dim=1))
    return S, W


def _pattern_series(XsV, whiten, R_it, order, cos_p, sin_p, keep):
    """The centered, phase-shifted real rotated PCs a correlation map
    correlates against, from the raw scores ``Xs V``."""
    S = _scores_rotated(XsV, whiten, R_it, order)[:, keep]
    if S.is_complex():
        S = S.real * cos_p - S.imag * sin_p
    return S - S.mean(dim=0)


def _pattern(X, Sc):
    """Pearson correlation maps of real(X) against the centered series
    ``Sc``."""
    Xr = X.real
    Xc = Xr - Xr.mean(dim=0)
    den = (torch.linalg.norm(Xc, dim=0)[:, None]
           * torch.linalg.norm(Sc, dim=0)[None, :])
    return (Xc.T @ Sc) / den


class MCA:
    """MCA/PCA of one or two ``numpy.ndarray`` fields (time first) on a
    torch device."""

    def __init__(self, *fields, device='cuda'):
        if len(fields) > 2:
            raise ValueError('Too many fields. Pass 1 or 2 fields.')
        if len(fields) == 2 and fields[0].shape[0] != fields[1].shape[0]:
            raise ValueError(
                'Time dimensions of given fields are different. '
                'Time series should have same time lengths.'
            )
        if not all(isinstance(f, np.ndarray) for f in fields):
            raise TypeError(
                'One or more fields are not `numpy.ndarray`. '
                'Please provide `numpy.ndarray` only.'
            )
        self._device = resolve_device(device)
        self._keys = ['left', 'right'][:max(1, len(fields))]
        self._fields = {}
        self._complexify_pending = False
        self._shape = {}
        self._field_names = {}
        self._field_means = {}
        self._field_stds = {}
        self._fields_spatial_shape = {}
        self._n_variables = {}
        self._no_nan_index = {}
        self._n_observations = {}
        self._hilbert = None
        # a chunk-backed model's loaders and column weights (from_chunks)
        self._chunk_loaders = None
        self._stream_weights = {}
        # a chunk-backed solve's precision
        self._stream_dtype = None
        # the device mesh (set_solver), and per field the global packed
        # columns this rank holds once the fields are sharded over its
        # 'space' axis (None: unsharded)
        self._mesh = None
        self._ensemble_axis = 'ensemble'
        self._shard_cols = None
        # a chunk-backed model's own columns on a space mesh (from_chunks)
        self._stream_own = None

        data = dict(zip(self._keys, fields))
        self._set_field_meta(data)
        self._fields = self._ingest(data)

        self._analysis = {
            'version': __version__,
            'is_bivariate': len(self._fields) > 1,
            'is_normalized': False,
            'is_coslat_corrected': False,
            'method': 'pca',
            'is_complex': False,
            'extend': False,
            'theta_period': 365,
            'is_rotated': False,
            'n_rot': 0,
            'power': 0,
            'is_truncated': False,
            'is_truncated_at': 0,
            'rank': 0,
            'total_covariance': 0.0,
            'total_squared_covariance': 0.0,
        }
        self._analysis['method'] = self._get_method_id()

        self._solver_method = 'gram'
        self._subspace_iters = 12
        self._solver_truncate = None
        self._solver_seed = 0
        self._ensemble_spectrum = 'fast'
        self._ensemble_tol = None
        self._ensemble_subspace_iters = None
        self._ensemble_batch_size = None
        self._ensemble_runs_per_dispatch = None
        self._surrogate_dtype = None
        self._surrogate_source = None          # auto (see rule_n)
        self._surrogate_gen_dist = None        # auto (see rule_n)
        self._rotate_iterations = None
        self._rule_n_iterations = None
        # set when a host multiplier may have put NaN into the fields;
        # arms solve's all-NaN guard
        self._nan_guard_dirty = False

    # ------------------------------------------------------------ ingestion
    def _set_field_meta(self, data):
        """Shapes and names of the (time, *space) fields in ``data``; each
        field is named by its key."""
        for k, f in data.items():
            self._shape[k] = f.shape
            self._n_observations[k] = f.shape[0]
            self._fields_spatial_shape[k] = f.shape[1:]
            self._n_variables[k] = int(np.prod(f.shape[1:]))
            self._field_names[k] = k

    def _ingest(self, data):
        """Upload each field once; NaN scans, means and stds run on the
        device and come back as small host vectors."""
        packed = {}
        for k, f in data.items():
            with trace.span('ingest', field=k):
                packed[k] = self._ingest_field(k, f)
        return packed

    def _ingest_field(self, k, f):
        """Field ``k``'s upload, its NaN scan (NaN columns dropped) and
        its moments: the centered packed field on the device."""
        with trace.span('ingest.copy', bytes=f.nbytes):
            d = trace.to_device(f.reshape(f.shape[0], -1), self._device,
                                'ingest.copy')
            if not (d.is_floating_point() or d.is_complex()):
                # integer and bool fields solve in float32, as chunks do
                # (core.streaming.stream_dtype) and as jnp.mean promotes
                # them on the JAX package's device
                d = d.to(torch.float32)
        with trace.span('ingest.scan'):
            nan = torch.isnan(d)
            if trace.to_host(nan.all(dim=1).any(), 'ingest.nan', bool):
                raise ValueError(
                    'One or more fields contain NaN time steps. '
                    'Please remove these prior to analysis.'
                )
            nan_cols = trace.to_host(nan.any(dim=0), 'ingest.nan').numpy()
            self._no_nan_index[k] = ~nan_cols
            if nan_cols.any():
                keep = trace.to_device(np.nonzero(~nan_cols)[0],
                                       self._device, 'ingest.keep')
                d = d[:, keep]
        with trace.span('ingest.moments'):
            mean = d.mean(dim=0)
            self._field_means[k] = trace.to_host(
                mean, 'ingest.moments').numpy()
            self._field_stds[k] = trace.to_host(
                d.std(dim=0, correction=0), 'ingest.moments').numpy()
            return d - mean

    def _get_method_id(self):
        return 'mca' if self._analysis['is_bivariate'] else 'pca'

    # --------------------------------------------------------------- config
    def set_solver(self, method=None, batch_size=None, mesh=None,
                   ensemble_axis='ensemble', spectrum=None,
                   subspace_iters=None, truncate=None, seed=None,
                   surrogate_dtype=None, surrogate_source=None,
                   surrogate_gen_dist=None, ensemble_tol=None,
                   ensemble_subspace_iters=None, runs_per_dispatch=None):
        """Configure the solver; the keys of the JAX API.

        ``method``: the exact solve's field decomposition, 'gram'
        (default: eigendecompose the small Gram matrix) or 'svd' (a
        direct dense SVD).
        ``truncate``: solve only the leading modes with the matmul-only
        subspace pipeline (exact totals); without it ``solve`` runs the
        exact dense solver.
        ``seed``: seed of the truncated solve's subspace start block.
        ``subspace_iters``: power iterations of the truncated solve and of
        each bootstrap run (default 12).
        ``spectrum``: 'fast' (default; the chol/subspace pipeline) or
        'exact' (dense factorizations) for Monte-Carlo runs.
        ``ensemble_tol``: rotation tolerance inside Rule-N and bootstrap
        runs; ``ensemble_subspace_iters``: Rule-N's power iterations.
        ``surrogate_source`` ('generated' or 'draw'), ``surrogate_gen_dist``
        ('normal16', 'normal32', 'rademacher', 'rademacher8' or
        'rademacher1') and ``surrogate_dtype`` (the 'draw' fields' dtype:
        a torch or numpy dtype or its name) pick Rule-N's surrogates;
        ``rule_n`` tables what each unset key resolves to.
        ``batch_size``: the runs of a chunk-backed model's bootstrap batch,
        each batch one set of passes over the loaders (default: 16 runs);
        elsewhere, as ``runs_per_dispatch`` everywhere, accepted and
        stored with no effect: the port solves one ensemble run at a
        time, and the results do not depend on them in the JAX package
        either.
        ``mesh``: a ``DeviceMesh`` from
        :func:`xmca_tpu_torch.parallel.make_mesh` (every rank of it runs
        the same calls).  The next ``solve`` shards each field's packed
        columns over its 'space' axis (the packed width must divide by
        the shard count; a chunk-backed model shards every chunk), and
        ``rule_n`` and ``bootstrapping`` split their runs over
        ``ensemble_axis`` (default 'ensemble'; a chunk-backed model's
        bootstrap always splits over 'ensemble', as the JAX package's
        streamed bootstrap does).
        """
        if mesh is not None:
            self._mesh = mesh
        self._ensemble_axis = ensemble_axis
        if surrogate_dtype is not None:
            self._surrogate_dtype = _torch_dtype(surrogate_dtype)
        if method is not None:
            if method not in ('gram', 'svd'):
                raise ValueError("method must be 'gram' or 'svd'")
            self._solver_method = method
        if batch_size is not None:
            self._ensemble_batch_size = batch_size
        if spectrum is not None:
            if spectrum not in ('exact', 'fast'):
                raise ValueError("spectrum must be 'exact' or 'fast'")
            self._ensemble_spectrum = spectrum
        if subspace_iters is not None:
            self._subspace_iters = int(subspace_iters)
        if ensemble_subspace_iters is not None:
            self._ensemble_subspace_iters = int(ensemble_subspace_iters)
        if truncate is not None:
            self._solver_truncate = int(truncate)
        if seed is not None:
            self._solver_seed = int(seed)
        if surrogate_source is not None:
            if surrogate_source not in ('draw', 'generated'):
                raise ValueError(
                    "surrogate_source must be 'draw' or 'generated'")
            self._surrogate_source = surrogate_source
        if surrogate_gen_dist is not None:
            if surrogate_gen_dist not in ('normal16', 'normal32',
                                          'rademacher', 'rademacher8',
                                          'rademacher1'):
                raise ValueError(
                    "surrogate_gen_dist must be 'normal16', "
                    "'normal32', 'rademacher', 'rademacher8' or "
                    "'rademacher1'")
            self._surrogate_gen_dist = surrogate_gen_dist
        if ensemble_tol is not None:
            self._ensemble_tol = float(ensemble_tol)
        if runs_per_dispatch is not None:
            self._ensemble_runs_per_dispatch = int(runs_per_dispatch)

    def set_field_names(self, left='left', right='right'):
        """Set names of the left/right field, used in plots and save files."""
        self._field_names['left'] = left
        self._field_names['right'] = right

    # ------------------------------------------------- out-of-core ingestion
    @classmethod
    def from_chunks(cls, left, right=None, *, n_observations, left_shape,
                    right_shape=None, device='cuda'):
        """A chunk-backed model of fields larger than the device's memory
        (or the host's).

        ``left``, ``right``: callables returning a fresh iterable of host
        ``(n_observations, p_chunk)`` arrays that together hold the
        field's columns in order (reads of a memmap, a zarr or netCDF
        store: :func:`xmca_tpu_torch.compat.netcdf_chunks`); each solve
        reads every field twice.  ``left_shape``, ``right_shape``: the
        spatial shapes (or flat column counts).  ``solve`` streams the
        data through ``device`` in those chunks (``set_solver(truncate=k)``
        sets the mode count, default 20), plain, complexified or with
        boundary extension; ``normalize``, ``apply_weights`` and coslat
        apply per chunk in every pass.  The getters read the score
        accumulators of the solve; ``fields``, the correlation patterns
        and ``save_analysis`` read the loaders again.  A chunk's columns
        with a NaN are dropped, as in memory.  ``bootstrapping`` resamples
        the solve's Grams: the time axis reads the loaders once per batch
        of rotated runs, or not at all, the space axis once or twice.
        """
        model = cls(device=device)
        model._keys = ['left'] if right is None else ['left', 'right']
        loaders = {'left': left}
        shapes = {'left': left_shape, 'right': right_shape}
        if right is not None:
            loaders['right'] = right
        for k in model._keys:
            sshape = shapes[k]
            if sshape is None:
                raise ValueError(
                    'spatial shape of the %s field is required' % k)
            sshape = ((int(sshape),) if np.isscalar(sshape)
                      else tuple(int(x) for x in sshape))
            model._shape[k] = (int(n_observations),) + sshape
            model._n_observations[k] = int(n_observations)
            model._fields_spatial_shape[k] = sshape
            model._n_variables[k] = int(np.prod(sshape))
            model._field_names[k] = k
            model._no_nan_index[k] = np.ones(model._n_variables[k], bool)
        model._chunk_loaders = loaders
        model._analysis['is_bivariate'] = len(model._keys) == 2
        model._analysis['method'] = model._get_method_id()
        return model

    def _is_chunk_backed(self):
        return self._chunk_loaders is not None

    def _require_resident_fields(self, what):
        if self._is_chunk_backed():
            raise RuntimeError(
                '`{:}` needs the full data matrix and is not available '
                'for chunk-backed (out-of-core) models.'.format(what))

    # ----------------------------------------------------------- the mesh
    def _space(self):
        """The space context of the model's sharded data: the mesh when
        the fields are sharded over its 'space' axis, else none."""
        return _mesh.space_context(self._mesh if self._shard_cols else None)

    def _packed_width(self, key):
        """The global packed (NaN-free) column count of field ``key``."""
        return int(np.count_nonzero(self._no_nan_index[key]))

    def _local(self, key, vec):
        """This rank's columns of a host per-column vector over the
        packed columns (the vector itself when unsharded)."""
        if not self._shard_cols:
            return vec
        vec = np.asarray(vec)
        if vec.ndim and vec.shape[-1] == self._packed_width(key):
            return vec[..., self._shard_cols[key]]
        return vec

    def _gather(self, key, x):
        """The full packed stack of rows of ``x`` (rows over field
        ``key``'s packed columns, this rank's block of them when
        sharded)."""
        if not self._shard_cols:
            return x
        return _mesh.gather_rows(x, self._shard_cols[key],
                                 self._packed_width(key), self._mesh)

    def _shard_fields(self):
        """Keep this rank's block of each field's packed columns (once;
        only on a mesh with a 'space' axis of more than one shard)."""
        if self._shard_cols or _mesh.axis_size(
                self._mesh, _mesh.SPACE_AXIS) == 1:
            return
        self._fields = {k: _mesh.distribute_array(f, self._mesh).contiguous()
                        for k, f in self._fields.items()}
        self._shard_cols = {
            k: _mesh.distribute_array(np.arange(self._packed_width(k)),
                                      self._mesh, axis=0)
            for k in self._keys}

    def _shard_solution(self):
        """:meth:`_shard_fields` for a solution installed whole (a load,
        a carried state): the singular vectors keep the rank's rows."""
        if self._shard_cols:
            return
        self._shard_fields()
        if self._shard_cols:
            self._V = {k: v[torch.as_tensor(self._shard_cols[k],
                                            device=self._device)]
                       for k, v in self._V.items()}

    def _stream_transform(self):
        """``(weights, normalize)``: the column scaling every streamed pass
        applies to a chunk-backed model's chunks."""
        return self._stream_weights, bool(self._analysis['is_normalized'])

    def _stream_inverse_colmul(self, key):
        """A full-width per-column inverse the streamed ``original_scale``
        applies: none here (generic weights are never undone); ``xMCA``
        returns the coslat inverse."""
        return None

    def _conform_stream_weights(self, key, w):
        """A chunk-backed model's weight as a scalar or a full-width
        per-column vector (chunks carry every column; the passes drop the
        NaN ones)."""
        w = np.asarray(w, dtype=np.float64)
        if w.ndim == 0:
            return float(w)
        if w.size == self._n_variables[key]:
            return w.reshape(-1)
        try:
            return np.broadcast_to(
                w, self._fields_spatial_shape[key]).reshape(-1).copy()
        except ValueError:
            raise ValueError(
                'chunk-backed models support spatial (per-column) '
                'weights only: weights for the {:} field must be a '
                'scalar or broadcast to the spatial shape {:} '
                '(got shape {:}).'.format(
                    key, self._fields_spatial_shape[key], w.shape))

    # -------------------------------------------------------- preprocessing
    def apply_weights(self, left=None, right=None):
        """Multiply the packed (time, space) fields by weights that
        broadcast against them.  A chunk-backed model records a spatial
        (per-column) weight, applied per chunk in every streamed pass;
        repeated calls multiply."""
        if self._is_chunk_backed():
            for k, w in (('left', left), ('right', right)):
                if w is None or k not in self._keys:
                    continue
                w = self._conform_stream_weights(k, w)
                prev = self._stream_weights.get(k)
                self._stream_weights[k] = w if prev is None else prev * w
            return
        for k, w in (('left', left), ('right', right)):
            if w is None or k not in self._fields:
                continue
            w = np.asarray(w)
            if not np.issubdtype(w.dtype, np.number) or np.isnan(w).any():
                self._nan_guard_dirty = True
            w = self._local(k, w)
            f = self._fields[k]
            self._fields[k] = f * trace.to_device(
                w, self._device, 'weights.copy', dtype=f.dtype)

    @trace.spanned('normalize')
    def normalize(self):
        """Divide each time series by its standard deviation (on a
        chunk-backed model, by its chunk's std in every streamed pass)."""
        for k in ([] if self._is_chunk_backed() else self._keys):
            f = self._fields[k]
            stds = np.asarray(self._field_stds[k])
            if (stds == 0).any() or np.isnan(stds).any():
                # zero-std columns divide to NaN, as in the reference
                self._nan_guard_dirty = True
            self._fields[k] = _pre.standardize(
                f, trace.to_device(self._local(k, stds), self._device,
                                   'normalize.stds', dtype=f.dtype))
        self._analysis['is_normalized'] = True
        self._analysis['is_coslat_corrected'] = False
        self._analysis['method'] = self._get_method_id()

    def _scale_X(self, data_dict):
        """Center (and normalize, if flagged) new data, per field
        (tensors on the device)."""
        scaled = {}
        for k, field in data_dict.items():
            field = field - _host_to(self._local(k, self._field_means[k]),
                                     field, real=True)
            if self._analysis['is_normalized']:
                field = field / _host_to(
                    self._local(k, self._field_stds[k]), field, real=True)
            scaled[k] = field
        return scaled

    def _inverse_scale_vectors(self, key):
        """The inverse of the model's scaling as per-column host vectors
        over the kept columns, ``X * colmul + coladd``; ``colmul`` is None
        when it is the identity."""
        colmul = (np.asarray(self._field_stds[key])
                  if self._analysis['is_normalized'] else None)
        return colmul, np.asarray(self._field_means[key])

    def _scale_X_inverse(self, data_dict):
        """Undo the model's scaling of packed fields (tensors)."""
        scaled = {}
        for k, field in data_dict.items():
            colmul, coladd = self._inverse_scale_vectors(k)
            if colmul is not None:
                field = field * _host_to(colmul, field, real=True)
            scaled[k] = field + _host_to(coladd, field, real=True)
        return scaled

    # ------------------------------------------------------------ raw views
    def _ensure_complex_fields(self):
        """Materialize a deferred Hilbert complexification.

        A truncated analytic-fold solve leaves the REAL fields resident:
        rotate, rule_n and the spectrum getters never need ``Z``.  The
        first consumer of the complex fields (pcs, patterns,
        reconstruction, ``fields()``, a re-solve) builds it here once; each
        real field is freed as its ``Z`` replaces it.
        """
        if not self._complexify_pending:
            return
        self._complexify_pending = False
        for k in self._keys:
            self._fields[k] = _pre.complexify(self._fields[k])

    def _can_defer_complexify(self, extend):
        """True when the coming complexified solve runs the analytic fold
        on the real fields (the wide truncated regime), so ``Z`` need not
        exist yet."""
        if extend or self._solver_truncate is None or not self._fields:
            return False
        n_obs = self._n_observations['left']
        if n_obs > _HILBERT_MATMUL_MAX_N:
            return False
        return min(self._packed_width(k) for k in self._keys) >= n_obs

    def _get_X(self, original_scale=False):
        """The packed fields on the device (complex ones materialized),
        their space shards gathered."""
        self._require_resident_fields('fields')
        self._ensure_complex_fields()
        X = {k: self._gather(k, f.T).T for k, f in self._fields.items()}
        if original_scale:
            X = self._scale_X_inverse(X)
        return X

    def _get_X_dev(self, real=False):
        """The packed fields on the device; with ``real`` their real parts,
        and a deferred complexification stays deferred (no Z is built)."""
        self._require_resident_fields('bootstrapping')
        if not (real and self._complexify_pending):
            self._ensure_complex_fields()
        if not real:
            return dict(self._fields)
        return {k: f.real if f.is_complex() else f
                for k, f in self._fields.items()}

    def _get_fields(self, original_scale=False):
        n_obs = self._n_observations['left']
        if self._is_chunk_backed():
            return self._get_fields_streamed(original_scale)
        fields = {}
        for k, X in self._get_X(original_scale=original_scale).items():
            full = torch.full((n_obs, self._n_variables[k]),
                              _nan_fill(X.dtype), dtype=X.dtype,
                              device=X.device)
            full[:, torch.as_tensor(self._no_nan_index[k],
                                    device=X.device)] = X
            fields[k] = _np(full).reshape(
                (n_obs,) + tuple(self._fields_spatial_shape[k]))
        return fields

    def _get_fields_streamed(self, original_scale):
        """A chunk-backed model's fields: the loaders read once with the
        model's per-chunk transform, into full-size host arrays."""
        from xmca_tpu_torch.core.streaming import streamed_fields
        weights, normalize = self._stream_transform()
        n_obs = self._n_observations['left']
        fields = {}
        for k in self._keys:
            full = streamed_fields(
                self._chunk_loaders[k], n_obs,
                complexify=self._analysis['is_complex'],
                extend=self._analysis['extend'],
                period=self._analysis['theta_period'],
                weights=weights.get(k), normalize=normalize,
                original_scale=original_scale,
                inv_colmul=(self._stream_inverse_colmul(k)
                            if original_scale else None),
                dtype=self._stream_dtype,
                device=self._device, mesh=self._mesh)
            full[:, ~self._no_nan_index[k]] = np.nan
            fields[k] = full.reshape(
                (n_obs,) + tuple(self._fields_spatial_shape[k]))
        return fields

    def fields(self, original_scale=False):
        """Return `left` (and `right`) input fields on their original grid."""
        return self._get_fields(original_scale)

    # ---------------------------------------------------------------- solve
    def _hilbert_operator(self, n_obs, dtype):
        """The real Hilbert operator H (``analytic(x) = x + iHx``) in
        ``dtype``, built on the device; the model keeps the last one."""
        H = self._hilbert
        if H is None or H.shape[0] != n_obs or H.dtype != dtype:
            H = self._hilbert = _fast.hilbert_operator(n_obs, dtype,
                                                       self._device)
        return H

    def _start_block(self, m, k, dtype):
        gen = torch.Generator(device=self._device)
        gen.manual_seed(self._solver_seed)
        return _fast.start_block(m, k, dtype, gen)

    @trace.spanned('solve')
    def solve(self, complexify=False, extend=False, period=1):
        """Perform the MCA / PCA, complexified (Hilbert) when
        ``complexify=True``; with ``extend`` ('exp' or 'theta') each
        field is forecast and backcast (``period``: the exponential
        decay's e-folding time, or the theta method's season) before its
        analytic signal is taken.

        Without ``set_solver(truncate=k)`` this is the exact dense solve
        (per-field Gram or SVD decompositions and one kernel SVD).  A
        truncated solve of fields at least as wide as they are long runs
        the matmul-only subspace pipeline; when complexified without
        extension and at most ``_HILBERT_MATMUL_MAX_N`` steps long (the
        JAX package's branch point) it folds the Hilbert operator into the
        real fields' Grams and leaves ``Z`` to its first consumer; longer
        or extended records build ``Z`` first.  Narrower fields take the
        exact pipeline.  A chunk-backed model streams (``from_chunks``).
        """
        if complexify and extend:
            _pre.check_extension(extend)
        if self._is_chunk_backed():
            return self._solve_streamed(complexify, extend, period)
        if not self._fields or any(f.numel() == 0
                                   for f in self._fields.values()):
            raise RuntimeError('Fields are empty. Did you forget to load '
                               'data?')
        # the reference's guard, np.isnan(X).all(): packed fields hold no
        # NaN, so only a NaN weight or a zero-std normalize can make one
        # all NaN; raise before any result is installed
        if self._nan_guard_dirty:
            with self._space():
                empty = any(_mesh.space_all(bool(torch.isnan(f).all()),
                                            f.device)
                            for f in self._fields.values())
            if empty:
                raise RuntimeError('Fields are empty. Did you forget to '
                                   'load data?')
        # a re-solve runs on the complexified fields (the solve mutates
        # the stored data); when this solve defers again, the fold reads
        # only the real part, which is analytic(real(Z)) == Z's
        will_defer = complexify and self._can_defer_complexify(extend)
        if not will_defer:
            self._ensure_complex_fields()
        self._analysis['is_complex'] = complexify
        self._analysis['extend'] = extend
        self._analysis['theta_period'] = period
        if will_defer:
            self._complexify_pending = True
        elif complexify:
            for k in self._keys:
                self._fields[k] = _pre.complexify(
                    self._fields[k], extend=extend, period=period)

        # a space mesh shards the (weighted, complexified) packed columns
        self._shard_fields()
        fields = [self._fields[k] for k in self._keys]
        with self._space():
            if self._solver_truncate is not None:
                svals, Vs, totals = self._solve_truncated(fields)
            else:
                s, Vs = _solver.solve(fields, method=self._solver_method)
                svals = _np(s)
                totals = (float(svals.sum()), float((svals ** 2).sum()))
        self._install_solution(svals, Vs, totals)

    def _solve_truncated(self, fields):
        """Leading-k solve: ``(svals, [V per field], (total_cov,
        total_sq))`` with exact totals."""
        Xl = fields[0]
        Xr = fields[-1]
        Xr_arg = Xr if len(fields) == 2 else None
        n_obs = Xl.shape[0]
        p_l, p_r = (self._packed_width(k) for k in (self._keys[0],
                                                   self._keys[-1]))
        k = min(self._solver_truncate, n_obs, p_l, p_r)
        if min(p_l, p_r) < n_obs:
            # small-space regime: the temporal Grams are rank deficient
            # beyond the jitter, so the Cholesky reduction is invalid; the
            # exact pipeline is cheap here
            s_full = _np(_solver.solve_svals(Xl, Xr_arg,
                                             method=self._solver_method))
            s, Vl, Vr = _solver.solve_truncated(
                Xl, Xr_arg, n_modes=k, method=self._solver_method)
            totals = (float(s_full.sum()), float((s_full ** 2).sum()))
        elif self._complexify_pending:
            real = Xl.real.dtype
            H = self._hilbert_operator(n_obs, real)
            omega = self._start_block(n_obs, k, _fast._complex_dtype(real))
            s, Vl, Vr, total_cov, total_sq = \
                _fast.fast_solve_truncated_totals_analytic(
                    Xl.real, Xr.real, H, omega, n_modes=k,
                    n_iter=self._subspace_iters)
            totals = (trace.to_host(total_cov, 'solve.totals', float),
                      trace.to_host(total_sq, 'solve.totals', float))
        else:
            omega = self._start_block(n_obs, k, Xl.dtype)
            s, Vl, Vr, total_cov, total_sq = \
                _fast.fast_solve_truncated_totals(
                    Xl, Xr, omega, n_modes=k, n_iter=self._subspace_iters)
            totals = (trace.to_host(total_cov, 'solve.totals', float),
                      trace.to_host(total_sq, 'solve.totals', float))
        return _np(s, 'solve.svals'), [Vl, Vr][:len(fields)], totals

    def _solve_streamed(self, complexify, extend, period):
        """The out-of-core solve of a chunk-backed model: each field
        streams through the device twice (``core.streaming.streamed_mca``),
        and the column statistics, the NaN mask, the score accumulators
        and the Grams it returns become the model's state, so the result
        layer runs as on an in-memory truncated solve."""
        from xmca_tpu_torch.core.streaming import streamed_mca
        self._analysis['is_complex'] = complexify
        self._analysis['extend'] = extend
        self._analysis['theta_period'] = period
        loaders = self._chunk_loaders
        weights, normalize = self._stream_transform()
        res = streamed_mca(
            loaders['left'], loaders.get('right'),
            self._n_observations['left'], self._solver_truncate or 20,
            complexify=complexify, extend=extend, period=period,
            seed=self._solver_seed, n_iter=self._subspace_iters,
            device=self._device, weights=weights, normalize=normalize,
            mesh=self._mesh)
        self._shard_cols = res.cols
        self._stream_own = res.own
        self._field_means = {k: res.means[k] for k in self._keys}
        self._field_stds = {k: res.stds[k] for k in self._keys}
        self._no_nan_index = {k: res.keep[k] for k in self._keys}
        self._stream_scores = dict(zip(self._keys, (res.scores_left,
                                                    res.scores_right)))
        # the streamed bootstrap's working set: the centered Grams and the
        # pre-Hilbert scores
        self._stream_grams = {k: res.grams[k] for k in self._keys}
        self._stream_scores_pre = {k: res.scores_pre[k] for k in self._keys}
        self._stream_dtype = res.grams['left'].real.dtype
        self._install_solution(
            res.svals, [res.V_left, res.V_right][:len(self._keys)],
            (res.total_covariance, res.total_squared_covariance))
        self._analysis['is_truncated'] = True

    def _install_solution(self, svals, Vs, totals):
        self._V = dict(zip(self._keys, Vs))
        self._singular_values = svals
        self._variance = svals
        self._var_idx = np.argsort(svals)[::-1]
        self._norm = {k: np.sqrt(svals) for k in self._keys}
        self._analysis['total_covariance'] = totals[0]
        self._analysis['total_squared_covariance'] = totals[1]
        self._analysis['rank'] = len(svals)
        if self._solver_truncate is not None:
            self._analysis['is_truncated'] = True
        self._analysis['is_truncated_at'] = len(svals)
        self._analysis['is_rotated'] = False
        self._analysis['n_rot'] = len(svals)
        self._analysis['power'] = 0
        self._rotation_matrix = np.eye(len(svals))
        self._correlation_matrix = np.eye(len(svals))

    # --------------------------------------------------------------- rotate
    @trace.spanned('rotate')
    def rotate(self, n_rot, power=1, tol=1e-8):
        """Varimax (``power=1``) / Promax rotation of the leading
        ``n_rot`` modes; raises if the fixed point does not converge.

        A non-integer ``power`` is the Procrustes target's exponent as
        given (the JAX package's ``rotate`` truncates it to an integer
        but stores it, and its ``rule_n`` and ``bootstrapping`` run the
        float).  More modes than the solve kept raise ``ValueError``
        before anything changes."""
        if n_rot < 2:
            raise ValueError('`n_rot` must be > 1')
        if power < 1:
            raise ValueError('`power` must be >=1')
        kept = int(self._singular_values.size)
        if n_rot > kept:
            raise ValueError(
                '`n_rot` ({:}) exceeds the {:} modes the solve kept; '
                'rotate at most {:} modes, or solve for more '
                '(set_solver(truncate=...))'.format(n_rot, kept, kept))
        sqrt_s = np.sqrt(self._get_svals(n_rot))
        Vl = self._V['left']
        cols = [Vl[:, :n_rot]]
        if self._analysis['is_bivariate']:
            cols.append(self._V['right'][:, :n_rot])
        L = torch.cat(cols, dim=0) * _host_to(sqrt_s, Vl, real=True,
                                              site='rotate.weights')[None, :]
        with self._space():
            L_rot, R, Phi, converged, n_iter = _promax(
                L, power=power, max_iter=1000, tol=tol)
            n_left = Vl.shape[0]
            if self._analysis['is_bivariate']:
                norm = {'left': _mesh.col_norm(L_rot[:n_left]),
                        'right': _mesh.col_norm(L_rot[n_left:])}
            else:
                both = _mesh.col_norm(L_rot)
                norm = {'left': both, 'right': both}
        self._rotate_iterations = n_iter
        trace.annotate(iterations=n_iter)
        if not converged:
            raise RuntimeError(
                'Rotation process did not converge. Try decreasing the '
                'tolerance. Invalid NaN entries also might be a problem.'
            )
        norm = {k: _np(v) for k, v in norm.items()}
        variance = norm['left'] * norm['right']
        self._norm = {k: norm[k] for k in self._keys}
        self._variance = variance
        self._var_idx = np.argsort(variance)[::-1]
        self._rotation_matrix = _np(R)
        self._correlation_matrix = _np(Phi)
        self._analysis['is_rotated'] = True
        self._analysis['n_rot'] = n_rot
        self._analysis['power'] = power

    def rotation_matrix(self, inverse_transpose=False):
        """Return the rotation matrix (identity if unrotated)."""
        try:
            R = self._rotation_matrix
        except AttributeError:
            R = np.eye(len(self.singular_values()))
        # orthogonal rotations satisfy R == pinv(R)^H
        if inverse_transpose and self._analysis['power'] > 1:
            R = np.linalg.pinv(R).conjugate().T
        return R

    def correlation_matrix(self):
        """Return the PC correlation matrix (identity unless oblique)."""
        try:
            var_idx = self._var_idx
            return self._correlation_matrix[var_idx, :][:, var_idx]
        except AttributeError:
            return np.eye(len(self.singular_values()))

    # -------------------------------------------------------------- getters
    def _get_slice(self, spec):
        """1-based, inclusive mode spec -> 0-based slice (``None``: all)."""
        rank = self._analysis['rank']
        if spec is None:
            return slice(0, rank)
        if isinstance(spec, slice):
            lo = 0 if spec.start is None else max(0, spec.start - 1)
            hi = rank if spec.stop is None else min(spec.stop, rank)
            return slice(lo, hi, spec.step)
        if np.issubdtype(type(spec), np.integer):
            return slice(0, spec)
        raise ValueError('Invalid type {:}. Must be either int or slice.'
                         .format(type(spec)))

    def _mode_pool(self, spec, rotated):
        """Mode count entering the mode-space products: a rotated result
        mixes all ``n_rot`` rotated modes (the requested slice applies
        after the mixing); an unrotated one touches only the requested
        columns (``None`` = all)."""
        if rotated:
            return self._analysis['n_rot']
        if isinstance(spec, slice):
            return spec.stop
        return spec

    def _get_min_mode(self, n=None, rotated=False):
        """The smallest of the rank, ``n`` and (rotated) ``n_rot``."""
        n_modes = [self._analysis['rank']]
        if n is not None:
            n_modes.append(n)
        if rotated:
            n_modes.append(self._analysis['n_rot'])
        return int(np.min(n_modes))

    def _basis(self):
        """The device-resident singular vectors."""
        try:
            return self._V
        except AttributeError:
            raise RuntimeError('Cannot retrieve singular vectors. '
                               'Please call the method `solve` first.')

    def _order(self):
        """The variance order of the modes as a LongTensor."""
        return torch.as_tensor(np.ascontiguousarray(self._var_idx),
                               device=self._device)

    def _get_svals(self, n=None):
        try:
            return self._singular_values[self._get_slice(n)]
        except AttributeError:
            raise RuntimeError('Cannot retrieve singular values. '
                               'Please call the method `solve` first.')

    def _get_norm(self, n=None, sorted=True):
        try:
            norms = self._norm
        except AttributeError:
            raise RuntimeError('Cannot retrieve field norms. '
                               'Please call the method `solve` first.')
        keep = self._get_slice(n)
        if sorted:
            return {k: v[self._var_idx][keep] for k, v in norms.items()}
        return {k: v[keep] for k, v in norms.items()}

    def _get_variance(self, n=None, sorted=True):
        norms = self._get_norm(n=n, sorted=sorted)
        if self._analysis['is_bivariate']:
            return norms['left'] * norms['right']
        return norms['left'] ** 2

    def _rotation_weights(self, pool):
        """(sqrt(s), 1/sqrt(s)) over the mode pool — the column weights
        every mode-space product needs."""
        roots = np.sqrt(self._get_svals(pool))
        return roots, 1.0 / roots

    def _get_V(self, n=None, rotated=True):
        """Spatial singular vectors as host numpy; rotated ones are mixed
        on the device and only the pool's columns are copied."""
        pool = self._mode_pool(n, rotated)
        keep = self._get_slice(n)
        basis = self._basis()
        if not rotated:
            return {k: _np(self._gather(k, basis[k][:, :pool]))[:, keep]
                    for k in self._keys}
        col_w, _ = self._rotation_weights(pool)
        norm = self._get_norm(pool, sorted=False)
        R = self.rotation_matrix()
        out = {}
        for k in self._keys:
            V = basis[k]
            out[k] = _np(self._gather(k, _loadings(
                V, _host_to(col_w, V, real=True), _host_to(R, V),
                _host_to(1.0 / norm[k], V, real=True), self._order(),
                pool)))[:, keep]
        return out

    def _raw_scores(self, key, pool):
        """``X V`` over the first ``pool`` modes on the device: the stored
        field projected through its singular vectors, or the score
        accumulator a chunk-backed solve filled (its data is not
        resident)."""
        V = self._basis()[key][:, :pool]
        if self._is_chunk_backed():
            return self._stream_scores[key][:, :pool]
        self._ensure_complex_fields()
        with self._space():
            return _mesh.space_sum(self._fields[key] @ V)

    def _get_U(self, n=None, rotated=True):
        """PC time series: the stored fields projected through the
        singular vectors, whitened by sqrt(s) (and mixed through R^-T
        when rotated), on the device."""
        pool = self._mode_pool(n, rotated)
        keep = self._get_slice(n)
        _, whiten = self._rotation_weights(pool)
        out = {}
        for k in self._keys:
            XV = self._raw_scores(k, pool)
            w = _host_to(whiten, XV, real=True)
            if rotated:
                R_it = self.rotation_matrix(inverse_transpose=True)
                S = _scores_rotated(XV, w, _host_to(R_it, XV),
                                    self._order())
            else:
                S = _scores(XV, w)
            out[k] = _np(S)[:, keep]
        return out

    @staticmethod
    def _rescale_modes(arr, scaling, eigen_norm, ref=None, axes=None):
        """The shared mode-scaling ladder (None / eigen / max / std).

        ``ref`` supplies the max/std statistics (default ``arr`` itself;
        ``predict`` normalizes new PCs by the training PCs').  ``axes``
        picks the reduction axes; the default reduces every non-mode axis
        (PC series), and EOF grids pass the reference's literal
        ``(0, 1)``."""
        if scaling == 'None':
            return arr
        if scaling == 'eigen':
            return arr * eigen_norm
        if scaling not in ('max', 'std'):
            raise ValueError(
                'The scaling option {:} is not valid. Please choose '
                'one of the following: None, eigen, std, max'
                .format(scaling)
            )
        stats_src = (arr if ref is None else ref).real
        if axes is None:
            axes = tuple(range(stats_src.ndim - 1))
        if scaling == 'max':
            return arr / np.nanmax(np.abs(stats_src), axis=axes)
        return arr / np.nanstd(stats_src, axis=axes)

    def _shift_phase(self, arr, phase_shift):
        """Rotate a complex result by a global phase (no-op for real
        analyses)."""
        if self._analysis['is_complex']:
            return arr * cmath.rect(1, phase_shift)
        return arr

    def _get_eofs(self, n=None, scaling='None', phase_shift=0,
                  rotated=True):
        V = self._get_V(n, rotated=rotated)
        grids = self._scatter_to_grid(V)
        # the reference keys the eigen scaling by the *returned* mode
        # count here, not by the requested spec (unlike _get_pcs)
        count = V['left'].shape[1]
        return {
            k: self._rescale_modes(
                self._shift_phase(grid, phase_shift), scaling,
                self._get_norm(count, sorted=True)[k], axes=(0, 1),
            )
            for k, grid in grids.items()
        }

    def _get_pcs(self, n=None, scaling='None', phase_shift=0,
                 rotated=True):
        return {
            k: self._rescale_modes(
                self._shift_phase(series, phase_shift), scaling,
                self._get_norm(n, sorted=True)[k],
            )
            for k, series in self._get_U(n, rotated=rotated).items()
        }

    def singular_values(self, n=None):
        """Return the first `n` singular values."""
        return self._get_svals(n)

    def norm(self, n=None, sorted=True):
        """Return the L2 norm of the first `n` singular vectors."""
        return self._get_norm(n=n, sorted=sorted)

    def variance(self, n=None, sorted=True):
        """Return the variance of the first `n` singular vectors."""
        return self._get_variance(n=n, sorted=sorted)

    def scf(self, n=None):
        """Squared covariance fraction (%) of the first `n` modes."""
        variance = self._variance[self._var_idx][:n]
        return (variance ** 2
                / self._analysis['total_squared_covariance'] * 100)

    def explained_variance(self, n=None):
        """Covariance fraction (%) of the first `n` modes."""
        return (self._get_variance(n=n, sorted=True)
                / self._analysis['total_covariance'] * 100)

    def pcs(self, n=None, scaling='None', phase_shift=0, rotated=True):
        """Return the first `n` PCs (scaling: None/eigen/max/std)."""
        return self._get_pcs(n, scaling, phase_shift, rotated)

    def eofs(self, n=None, scaling='None', phase_shift=0, rotated=True):
        """Return the first `n` EOFs (scaling: None/eigen/max/std)."""
        return self._get_eofs(n, scaling, phase_shift, rotated)

    def spatial_amplitude(self, n=None, scaling='None', rotated=True):
        """Spatial amplitude fields of the first `n` EOFs."""
        amplitudes = {}
        for key, eof in self.eofs(n, scaling='None', rotated=rotated).items():
            amp = np.sqrt(eof * eof.conjugate()).real
            if scaling == 'max':
                amp = amp / np.nanmax(amp, axis=(0, 1))
            amplitudes[key] = amp
        return amplitudes

    def spatial_phase(self, n=None, phase_shift=0, rotated=True):
        """Spatial phase fields of the first `n` EOFs."""
        eofs = self.eofs(n, phase_shift=phase_shift, rotated=rotated)
        return {key: np.arctan2(eof.imag, eof.real).real
                for key, eof in eofs.items()}

    def temporal_amplitude(self, n=None, scaling='None', rotated=True):
        """Temporal amplitude series of the first `n` PCs."""
        amplitudes = {}
        for key, pc in self.pcs(n, scaling='None', rotated=rotated).items():
            amp = np.sqrt(pc * pc.conjugate()).real
            if scaling == 'max':
                amp = amp / np.nanmax(amp, axis=0)
            amplitudes[key] = amp
        return amplitudes

    def temporal_phase(self, n=None, phase_shift=0, rotated=True):
        """Temporal phase series of the first `n` PCs."""
        pcs = self.pcs(n, phase_shift=phase_shift, rotated=rotated)
        return {key: np.arctan2(pc.imag, pc.real).real
                for key, pc in pcs.items()}

    # --------------------------------------------- correlation pattern maps
    @staticmethod
    def _corr_pvalues(r, n_obs):
        """Two-sided p-values of Pearson correlations:
        2 * BetaCDF(-|r|; a=b=n/2-1, loc=-1, scale=2) via the regularized
        incomplete beta function (on the host), evaluated in float64 and
        returned in ``r``'s dtype: scipy's float32 ``betainc`` is off by
        up to ~3e-3 near p = 1 at a = 127."""
        from scipy.special import betainc
        a = n_obs / 2.0 - 1.0
        x = np.clip((1.0 - np.abs(np.asarray(r, np.float64))) / 2.0, 0, 1)
        return (2 * betainc(a, a, x)).astype(r.dtype)

    def _scatter_to_grid(self, data):
        """Re-insert NaN columns and reshape (n_vars, modes) maps to grid."""
        out = {}
        for k, arr in data.items():
            n_modes = arr.shape[1]
            full = np.zeros([self._n_variables[k], n_modes],
                            dtype=arr.dtype) * np.nan
            full[self._no_nan_index[k], :] = arr
            out[k] = full.reshape(
                tuple(self._fields_spatial_shape[k]) + (n_modes,))
        return out

    def _correlation_maps(self, pairs, n, phase_shift):
        """Correlation maps field-vs-PCs for ``pairs`` of (field key,
        PC-source key): projection, rotation, phase shift, centering and
        the (p, k) contraction on the device; p-values on the host.  A
        chunk-backed model correlates its PCs (from the solve's score
        accumulators) with one streamed pass over the field."""
        from xmca_tpu_torch.core.streaming import streamed_patterns
        pool = self._mode_pool(n, True)
        keep = self._get_slice(n)
        _, whiten = self._rotation_weights(pool)
        R_it = self.rotation_matrix(inverse_transpose=True)
        if self._analysis['is_complex']:
            cos_p, sin_p = np.cos(phase_shift), np.sin(phase_shift)
        else:
            cos_p, sin_p = 1.0, 0.0
        weights, normalize = self._stream_transform()
        r, p = {}, {}
        for key, source in pairs:
            XsV = self._raw_scores(source, pool)
            Sc = _pattern_series(XsV, _host_to(whiten, XsV, real=True),
                                 _host_to(R_it, XsV), self._order(), cos_p,
                                 sin_p, keep)
            if self._is_chunk_backed():
                rmap = streamed_patterns(
                    self._chunk_loaders[key], self._n_observations[key], Sc,
                    torch.linalg.norm(Sc, dim=0), weights=weights.get(key),
                    normalize=normalize, dtype=self._stream_dtype,
                    device=self._device,
                    mesh=self._mesh)[self._no_nan_index[key]]
            else:
                rmap = _np(self._gather(key, _pattern(self._fields[key],
                                                      Sc)))
            r[key] = rmap
            p[key] = self._corr_pvalues(rmap, self._n_observations[key])
        return self._scatter_to_grid(r), self._scatter_to_grid(p)

    def homogeneous_patterns(self, n=None, phase_shift=0):
        """Correlation maps of each field with its own PCs (+ p-values)."""
        return self._correlation_maps([(k, k) for k in self._keys], n,
                                      phase_shift)

    def heterogeneous_patterns(self, n=None, phase_shift=0):
        """Correlation maps of each field with the *other* field's PCs."""
        other = dict(zip(self._keys, self._keys[::-1]))
        try:
            pairs = [(k, other[k]) for k in self._keys]
        except KeyError:
            raise KeyError(
                'Key not found. Two fields needed for heterogenous maps.'
            )
        return self._correlation_maps(pairs, n, phase_shift)

    # ------------------------------------------------------- reconstruction
    def _reconstruct_factors_dev(self, key, mode):
        """Device rank-k factors ``(S, W)`` of the mode-subset
        reconstruction of field ``key``."""
        pool = self._analysis['n_rot']
        keep = self._get_slice(mode)
        V = self._basis()[key]
        col_w, whiten = self._rotation_weights(pool)
        return _reconstruct_factors(
            self._raw_scores(key, pool), V, _host_to(whiten, V, real=True),
            _host_to(self.rotation_matrix(inverse_transpose=True), V),
            _host_to(col_w, V, real=True),
            _host_to(self.rotation_matrix(), V),
            _host_to(1.0 / self._get_norm(pool, sorted=False)[key], V,
                     real=True),
            _host_to(self._get_norm(mode, sorted=True)[key], V, real=True),
            self._order(), pool, keep)

    def _reconstructed_fields(self, mode=None, original_scale=True):
        """Full-grid reconstruction ``real(S W^H)`` as ONE real product
        per field on the device, copied to the host once.

        ``real(S W^H) = Re(S) Re(W)^T + Im(S) Im(W)^T`` (stacked real
        factor blocks); the inverse column scaling folds into ``W`` and
        the mean add becomes a ones-column of ``A`` against the means
        column of ``B``; dropped (NaN) columns are NaN rows of ``B``, so
        the product writes the NaN-masked full grid directly."""
        rec = {}
        for k in self._keys:
            A, B = _real_factors(*self._reconstruct_factors_dev(k, mode))
            B = self._gather(k, B)
            if original_scale:
                colmul, coladd = self._inverse_scale_vectors(k)
                if colmul is not None:
                    B = B * _host_to(colmul, B)[:, None]
                A = torch.cat([A, torch.ones_like(A[:, :1])], dim=1)
                B = torch.cat([B, _host_to(coladd, B)[:, None]], dim=1)
            idx = self._no_nan_index[k]
            if not idx.all():
                full = torch.full((self._n_variables[k], B.shape[1]),
                                  float('nan'), dtype=B.dtype,
                                  device=B.device)
                full[torch.as_tensor(idx, device=B.device)] = B
                B = full
            rec[k] = _np(A @ B.T).reshape(
                (-1,) + tuple(self._fields_spatial_shape[k]))
        return rec

    def reconstructed_fields(self, mode=None, original_scale=True):
        """Reconstruct input fields from a subset of modes."""
        return self._reconstructed_fields(mode=mode,
                                          original_scale=original_scale)

    def _reconstructed_X_dev(self, key, mode=None, gathered=False):
        """The scaled, packed mode-subset reconstruction ``real(S W^H)``
        of field ``key`` on the device (the iterative bootstrap's
        deflation): this rank's columns of a sharded model, all of them
        when ``gathered``."""
        A, B = _real_factors(*self._reconstruct_factors_dev(key, mode))
        if gathered:
            B = self._gather(key, B)
        return A @ B.T

    # ----------------------------------------------------------- prediction
    def _conform_new_data(self, key, arr):
        """Pack new data onto the solved grid (flatten the space axes,
        drop the training NaN columns), upload it in the model's
        precision and apply the training scaling."""
        try:
            flat = arr.reshape(arr.shape[0], self._n_variables[key])
            flat = flat[:, self._no_nan_index[key]]
            if self._shard_cols:
                flat = flat[:, self._shard_cols[key]]
        except ValueError as err:
            if arr.ndim != len(self._shape[key]):
                msg = (
                    'Error in {:} field. Dimension of new data ({:}) '
                    'and the original field ({:}) do not match. '
                    'Did you forget the time dimension?'
                ).format(key, arr.ndim, len(self._shape[key]))
            elif arr.shape[1:] != self._field_means[key].shape:
                msg = (
                    'Error in {:} field. Spatial dimensions of new '
                    'data {:} and the original field {:} do not match.'
                ).format(key, arr.shape[1:], self._shape[key][1:])
            else:
                msg = 'Dimension mismatch in {:} field.'.format(key)
            raise ValueError(msg) from err
        real = self._basis()[key].real.dtype
        t = torch.as_tensor(np.ascontiguousarray(flat), device=self._device)
        t = t.to(_fast._complex_dtype(real) if t.is_complex() else real)
        return self._scale_X({key: t})[key]

    def predict(self, left=None, right=None, n=None, scaling='None',
                phase_shift=0):
        """Project new data onto the singular vectors to predict its PCs
        (unrotated projection, whitening, rotation mixing and variance
        ordering on the device)."""
        new_data = {k: d for k, d in zip(self._keys, (left, right))
                    if d is not None}
        basis = self._basis()
        R_it = self.rotation_matrix(inverse_transpose=True)
        pool = R_it.shape[0]
        _, whiten = self._rotation_weights(pool)
        count = pool if n is None else n
        predicted = {}
        for k, arr in new_data.items():
            packed = self._conform_new_data(k, arr)
            dtype = torch.promote_types(packed.dtype, basis[k].dtype)
            packed, V = packed.to(dtype), basis[k].to(dtype)
            with self._space():
                XV = _mesh.space_sum(packed @ V[:, :pool])
            scores = _np(_scores_rotated(
                XV, _host_to(whiten, V, real=True),
                _host_to(R_it, V), self._order()))[:, :count]
            scores = self._shift_phase(scores, phase_shift)
            ref = (self._get_pcs(count, 'None', phase_shift)[k]
                   if scaling in ('max', 'std') else None)
            predicted[k] = self._rescale_modes(
                scores, scaling, self._get_norm(count, sorted=True)[k],
                ref=ref)
        return predicted

    # ----------------------------------------------------------- truncation
    def truncate(self, n):
        """Truncate the solution to the first `n` modes."""
        if self._analysis['is_rotated'] & (n < self._analysis['n_rot']):
            raise ValueError(
                'Cannot truncte rotated solution. Please ensure '
                '`n` > `n_rot`'
            )
        if n < self._singular_values.size:
            self._singular_values = self._singular_values[:n]
            # copies, so the dropped columns' memory is freed
            self._V = {k: v[:, :n].clone() for k, v in self._V.items()}
            if self._is_chunk_backed():
                self._stream_scores = {
                    k: v[:, :n].clone() for k, v in self._stream_scores.items()}
                self._stream_scores_pre = {
                    k: v[:, :n].clone()
                    for k, v in self._stream_scores_pre.items()}
            self._analysis['is_truncated'] = True
            self._analysis['is_truncated_at'] = n

    # --------------------------------------------------------- significance
    def _rule_n_config(self, n_modes=None):
        """The keyword arguments ``rule_n`` passes to
        ``stats.significance.rule_n_spectra``, every unset key resolved as
        the table in :meth:`rule_n` says."""
        m, n = self._n_observations, self._n_variables
        spectrum = self._ensemble_spectrum
        source = self._surrogate_source
        if source is None:
            source = 'generated' if spectrum == 'fast' else 'draw'
        generated = source == 'generated'
        if self._surrogate_dtype is not None:
            dtype = self._surrogate_dtype
        elif spectrum == 'fast':
            dtype = torch.bfloat16
        elif self._is_chunk_backed():
            dtype = self._stream_dtype
        else:
            dtype = self._fields[self._keys[0]].real.dtype
        n_modes_fast = None
        if spectrum == 'fast':
            n_modes_fast = min(self._get_slice(n_modes).stop,
                               min(m.values()), min(n.values()))
        tol = self._ensemble_tol
        if tol is None:
            tol = 1e-4 if generated else 1e-8
        iters = self._ensemble_subspace_iters
        if iters is None:
            iters = 6 if generated else self._subspace_iters
        return dict(
            complexify=self._analysis['is_complex'],
            rotated=self._analysis['is_rotated'],
            n_rot=self._analysis['n_rot'],
            power=max(1, self._analysis['power']), tol=tol,
            polar_method='ns14' if generated and tol >= 1e-4 else 'ns',
            dtype=dtype, method=self._solver_method, spectrum=spectrum,
            n_modes_fast=n_modes_fast, subspace_iters=iters,
            surrogate_source=source,
            surrogate_dist=self._surrogate_gen_dist or (
                'rademacher8' if generated else 'normal16'),
        )

    @trace.spanned('rule_n')
    def rule_n(self, n_runs, n_modes=None, seed=None,
               disable_progress=False):
        """Rule N (Overland & Preisendorfer 1982): the spectra of
        ``n_runs`` surrogate noise fields with the model's shapes, solved
        (and rotated) like the model and rescaled to its total; returns
        an (n_modes, n_kept_runs) array (runs whose rotation did not
        converge are dropped).  ``disable_progress`` is accepted for the
        JAX API; the port shows no progress bar.

        The configuration is the JAX package's on a TPU, on every
        device.  A key left unset in ``set_solver`` resolves so:

        ==========================  =================  ==================
        key                         'generated'        'draw'
        ==========================  =================  ==================
        ``surrogate_source``        spectrum 'fast'    spectrum 'exact'
        ``surrogate_gen_dist``      'rademacher8'      (unused)
        ``ensemble_tol``            1e-4               1e-8
        polar (not a key)           'ns14' if tol >=   'ns'
                                    1e-4, else 'ns'
        ``ensemble_subspace_iters`` 6                  ``subspace_iters``
        ``surrogate_dtype``         (unused)           bf16 under spectrum
                                                       'fast', else the
                                                       fields' real dtype
        ==========================  =================  ==================

        'generated' runs the fast spectrum only (another raises
        ``ValueError``): 'rademacher8' and 'rademacher1' (one draw in
        the port) on the draw and syrk kernels, 'normal16', 'normal32'
        and 'rademacher' on fields from the field kernel.  'draw' runs
        Gaussian fields through the fast or the exact spectrum.
        """
        cfg = self._rule_n_config(n_modes)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        H = None
        if cfg['complexify'] and cfg['spectrum'] == 'fast':
            # the Hilbert operator feeds the n x n algebra: f32 for
            # generated and bf16 draws
            h_dtype = cfg['dtype']
            if (cfg['surrogate_source'] == 'generated'
                    or h_dtype.itemsize < 4):
                h_dtype = torch.float32
            H = self._hilbert_operator(self._n_observations['left'],
                                       h_dtype)
        spectra, totals, n_iter = _sig.rule_n_spectra(
            self._n_observations['left'],
            tuple(self._n_variables[k] for k in self._keys), n_runs,
            seed=seed, device=self._device, H=H, mesh=self._mesh,
            ensemble_axis=self._ensemble_axis, **cfg)
        self._rule_n_iterations = n_iter
        if spectra.shape[0] == 0:
            raise RuntimeError(
                'Rule N: all {:d} surrogate runs failed to converge; '
                'no null distribution available.'.format(n_runs))
        svals = spectra.T
        # truncated, unrotated: the exact total of the solve is the
        # reference scale; rotated: the n_rot-mode rotated totals
        if (self._analysis['is_truncated']
                and not self._analysis['is_rotated']):
            ref_total = self._analysis['total_covariance']
        else:
            ref_total = self._get_variance().sum()
        svals = svals / (totals[None, :] / ref_total)
        return svals[self._get_slice(n_modes)]

    def rule_north(self, n=None):
        """North's rule-of-thumb uncertainties of the singular values."""
        return _sig.rule_north_uncertainty(
            self._get_svals(n), self._n_observations['left'],
            self._analysis['is_complex'],
        )

    @trace.spanned('bootstrapping')
    def bootstrapping(self, n_runs, n_modes=20, axis=0, on_left=True,
                      on_right=False, block_size=1, replace=True,
                      strategy='standard', disable_progress=False,
                      seed=None):
        """Monte-Carlo (moving-block) bootstrapping of the model; returns
        an (n_modes, n_runs) array of variance spectra, zero where a run's
        rotation did not converge.

        ``strategy='iterative'`` runs the Winkler scheme: round ``mode``
        resamples the fields minus their reconstruction from the leading
        ``mode`` modes.  Every run resamples the model's fields afresh
        (the reference resamples its previous resample); a model solved
        with boundary extension re-centers, re-extends and complexifies
        each resample.  A chunk-backed model resamples in Gram space
        (``stats.streaming_boot``) with the same draws as an in-memory
        model of the same data, run for run; one solved with extension
        raises the JAX package's ``RuntimeError``.
        ``disable_progress`` is accepted for the JAX API; the port shows
        no progress bar.

        On a mesh whose 'space' axis shards the fields, every rank
        resamples its own columns: ``axis=0`` its rows of them, ``axis=1``
        the draws (the same on every rank) that fall on them, so a rank
        holds about its share of each resample and every Gram and
        rotation criterion sums over the space group (a collective a
        contraction, as the sharded solve).  With ``ensemble_axis`` set
        to that space axis each rank instead gathers the whole fields
        once a call (one all-reduce a field: a copy of the packed fields
        a rank, real even for a complexified model, plus a run's
        resample) and runs its share of whole runs with no collective in
        them; every rank gets every run back.
        """
        if strategy not in ('standard', 'iterative'):
            raise ValueError(
                "strategy must be 'standard' or 'iterative'")
        n_modes_max = self._get_min_mode(n_modes, rotated=True)
        var_surr = np.zeros([n_modes_max, n_runs])
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        n_mode_iters = min(n_modes, n_modes_max)
        tol = 1e-4 if self._ensemble_tol is None else self._ensemble_tol
        self._bootstrap_modes(var_surr, n_mode_iters, n_runs, strategy,
                              axis, on_left, on_right, block_size, replace,
                              n_modes_max, seed, tol)
        return var_surr

    def _bootstrap_modes(self, var_surr, n_mode_iters, n_runs, strategy,
                         axis, on_left, on_right, block_size, replace,
                         n_modes_max, seed, tol):
        """The bootstrap rounds on the resident fields (a chunk-backed
        model's in :meth:`_bootstrap_modes_streamed`): one for 'standard',
        one per mode for 'iterative'."""
        if self._is_chunk_backed():
            return self._bootstrap_modes_streamed(
                var_surr, n_mode_iters, n_runs, strategy, axis, on_left,
                on_right, block_size, replace, n_modes_max, seed, tol)
        complexify = self._analysis['is_complex']
        extend = self._analysis['extend'] if complexify else False
        H = None
        X = self._get_X_dev(real=True)
        # runs split over the space axis the fields are sharded on: each
        # rank gathers the whole fields once and runs its share of whole
        # runs outside the space context
        whole = bool(self._shard_cols) and (
            self._ensemble_axis == _mesh.SPACE_AXIS)
        if whole:
            with self._space():
                X = {k: _mesh.space_gather_cols(x)[0] for k, x in X.items()}
        for mode in range(n_mode_iters):
            X_surr = X
            if strategy == 'iterative':
                # deflate the leading modes on the device (each rank its
                # columns, or the gathered whole)
                X_surr = {k: x - self._reconstructed_X_dev(k, mode,
                                                           gathered=whole)
                          for k, x in X_surr.items()}
            if (complexify and not extend
                    and self._ensemble_spectrum == 'fast'):
                lead = X_surr[self._keys[0]]
                H = self._hilbert_operator(lead.shape[0], lead.dtype)
            with (_mesh.space_context(None) if whole else self._space()):
                spectra, converged = _sig.bootstrap_spectra(
                    [X_surr[k] for k in self._keys], n_runs,
                    n_modes_max - mode, mesh=self._mesh,
                    ensemble_axis=self._ensemble_axis,
                    axis=axis, on_left=on_left, on_right=on_right,
                    block_size=block_size, replace=replace,
                    complexify=complexify, extend=extend,
                    period=self._analysis['theta_period'],
                    rotated=self._analysis['is_rotated'],
                    n_rot=self._analysis['n_rot'],
                    power=max(1, self._analysis['power']), tol=tol,
                    method=self._solver_method, seed=seed + mode,
                    spectrum=self._ensemble_spectrum,
                    subspace_iters=self._subspace_iters, hilbert_H=H,
                )
            # a run whose rotation did not converge leaves its rows as
            # they were (the reference skips it)
            var_surr[mode:, converged] = spectra[converged].T
            if strategy == 'standard':
                break

    def _bootstrap_modes_streamed(self, var_surr, n_mode_iters, n_runs,
                                  strategy, axis, on_left, on_right,
                                  block_size, replace, n_modes_max, seed,
                                  tol):
        """The bootstrap rounds of a chunk-backed model, in Gram space
        (``stats.streaming_boot``): the time axis resamples the stored
        Grams (a rotated batch adds one projection pass per field), the
        space axis makes one counts pass per batch.  An iterative round
        deflates in mode space: the stored Grams by
        :func:`deflated_gram`, from the pre-Hilbert score accumulators
        ``Xc V`` mixed like the loadings (``Xc W``) and the rank-k
        reconstruction factors; the passes deflate chunk by chunk."""
        from xmca_tpu_torch.stats.streaming_boot import (
            bootstrap_spectra_streamed, deflated_gram)
        if self._analysis['extend']:
            # the resampled rows change every boundary forecast, so an
            # extended surrogate's Gram is no index algebra on the stored
            # one (the JAX package's error, word for word)
            raise RuntimeError(
                'bootstrapping of chunk-backed models solved with '
                'boundary extension (extend=\'exp\'/\'theta\') is not '
                'supported: re-solve without extend, or use an '
                'in-memory model.')
        weights, normalize = self._stream_transform()
        dtype = self._stream_dtype
        n_obs = self._n_observations['left']
        complexify = self._analysis['is_complex']
        H = self._hilbert_operator(n_obs, dtype) if complexify else None
        grams, pre = self._stream_grams, self._stream_scores_pre
        pool = self._analysis['n_rot']
        col_w, _ = self._rotation_weights(pool)
        inv_norm = {k: 1.0 / v
                    for k, v in self._get_norm(pool, sorted=False).items()}
        R = self.rotation_matrix()
        for mode in range(n_mode_iters):
            deflate, g_iter = None, grams
            if strategy == 'iterative' and mode > 0:
                deflate, g_iter = {}, {}
                for k in self._keys:
                    S, W = self._reconstruct_factors_dev(k, mode)
                    P = pre[k]
                    XcW = _loadings(
                        P, _host_to(col_w, P, real=True), _host_to(R, P),
                        _host_to(inv_norm[k], P, real=True), self._order(),
                        pool)[:, :mode]
                    deflate[k] = (S, W)
                    with self._space():
                        g_iter[k] = deflated_gram(grams[k], XcW, S, W)
            spectra, converged = bootstrap_spectra_streamed(
                self._chunk_loaders, self._no_nan_index, g_iter, n_obs,
                n_runs, n_modes_max - mode, weights=weights,
                normalize=normalize, axis=axis, on_left=on_left,
                on_right=on_right, block_size=block_size, replace=replace,
                complexify=complexify, H=H,
                rotated=self._analysis['is_rotated'],
                n_rot=self._analysis['n_rot'],
                power=max(1, self._analysis['power']), tol=tol,
                seed=seed + mode, batch_size=self._ensemble_batch_size,
                subspace_iters=self._subspace_iters, dtype=dtype,
                device=self._device, deflate=deflate, mesh=self._mesh,
                # the JAX package's streamed bootstrap takes no ensemble
                # axis: its runs split over the mesh's 'ensemble' axis
                ensemble_axis=_mesh.ENSEMBLE_AXIS, own=self._stream_own)
            var_surr[mode:, converged] = spectra[converged].T
            if strategy == 'standard':
                break

    # ----------------------------------------------------------- save/load
    def _get_analysis_path(self, path=None):
        if path is None:
            name_folder = secure_str('_'.join(self._field_names.values()))
            path = os.path.join(os.getcwd(), 'xmca', name_folder)
        elif not os.path.isabs(path):
            path = os.path.abspath(path)
        return path

    def _create_analysis_path(self, path):
        path = self._get_analysis_path(path)
        if not os.path.exists(path):
            os.makedirs(path)

    def _create_info_file(self, path):
        """Write the human-readable ``info.xmca`` manifest, line for line
        the JAX package's (and the original xmca's) layout."""
        sep_line = '\n#' + '-' * 79
        now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        file_header = (
            'This file contains information neccessary to load stored '
            'analysisdata from xmca module.'
        )
        with open(os.path.join(path, 'info.xmca'), 'w+') as file:
            file.write(wrap_str(file_header))
            file.write('\n# To load this analysis use:')
            file.write('\n# from xmca.xarray import xMCA')
            file.write('\n# mca = xMCA()')
            file.write('\n# mca.load_analysis(PATH_TO_THIS_FILE)')
            file.write('\n')
            file.write(sep_line)
            file.write(sep_line)
            file.write('\n{:<20} : {:<57}'.format('created', now))
            file.write(sep_line)
            for key, name in self._field_names.items():
                file.write('\n{:<20} : {:<57}'.format(key, str(name)))
            file.write(sep_line)
            for key, info in self._analysis.items():
                if key in ['is_bivariate', 'is_complex', 'is_rotated',
                           'is_truncated']:
                    file.write(sep_line)
                file.write('\n{:<20} : {:<57}'.format(key, str(info)))

    def _get_file_names(self, format):
        fields = {}
        eofs = {}
        for key, variable in self._field_names.items():
            variable = secure_str(variable)
            fields[key] = '.'.join([variable, format])
            eofs[key] = '.'.join(['_'.join([variable, 'eofs']), format])
        return {
            'fields': fields,
            'eofs': eofs,
            'pcs': {},
            'singular': '.'.join(['singular_values', format]),
            'norm': {},
        }

    def _save_data(self, data_array, path, *args, **kwargs):
        raise NotImplementedError('only works for `xarray`')

    def _set_analysis(self, key, value):
        """Set ``_analysis[key]`` from its text in ``info.xmca``, cast by
        the type of the fresh model's value: a bool is ``value ==
        'True'``, so an ``extend`` of 'exp' or 'theta' loads as False
        (the JAX package does the same)."""
        try:
            key_type = type(self._analysis[key])
        except KeyError:
            raise KeyError("Key `{}` not found in info file.".format(key))
        if key_type == bool:
            self._analysis[key] = (value == 'True')
        else:
            self._analysis[key] = key_type(value)

    def _set_info_from_file(self, path):
        with open(path, 'r') as info_file:
            for line in info_file.readlines():
                if line[0] != '#':
                    key = line.split(':')[0].rstrip()
                    if key in ['left', 'right']:
                        self._field_names[key] = line.split(':')[1].strip()
                    if key in self._analysis.keys():
                        self._set_analysis(key, line.split(':')[1].strip())

    def load_analysis(self, path, fields=None, eofs=None,
                      singular_values=None):
        """Rebuild a model saved with ``save_analysis`` from its
        ``info.xmca`` at ``path`` and the saved arrays: ``fields`` (the
        original-scale fields, time first), ``eofs`` (the unrotated EOF
        grids, modes last) and ``singular_values``, numpy, keyed by
        'left'/'right'.

        As in the JAX package, normalization, complexification and the
        rotation are recomputed from them: the fields go to the device
        once, are centered and normalized there and complexified at once
        (never deferred), the EOFs become the singular vectors on the
        device, and a rotated analysis is rotated again.  The truncated
        solve's extra state is not restored.
        """
        self._set_info_from_file(path)
        self._keys = (['left', 'right'] if self._analysis['is_bivariate']
                      else ['left'])
        self._complexify_pending = False
        self._hilbert = None
        self._shard_cols = None
        data = {k: np.asarray(fields[k]) for k in self._keys}
        # the names read above give way to the keys, as in the JAX package
        # (its field metadata is set after the info file)
        self._set_field_meta(data)
        self._fields = self._ingest(data)
        if self._analysis['is_normalized']:
            self.normalize()
        if self._analysis['is_complex']:
            for k in self._keys:
                self._fields[k] = _pre.complexify(
                    self._fields[k], extend=self._analysis['extend'],
                    period=self._analysis['theta_period'])

        svals = np.asarray(singular_values)
        self._singular_values = svals
        self._variance = svals
        self._var_idx = np.argsort(svals)[::-1]
        self._norm = {}
        self._V = {}
        for k in self._keys:
            self._norm[k] = np.sqrt(svals)
            eofs_2d = np.asarray(eofs[k]).reshape(self._n_variables[k], -1)
            keep = ~np.isnan(eofs_2d).any(axis=1)
            self._V[k] = torch.as_tensor(
                np.ascontiguousarray(eofs_2d[keep]), device=self._device)
        # on a space mesh each rank keeps its block of columns and rows
        self._shard_solution()
        n = len(svals)
        self._rotation_matrix = np.eye(n)
        self._correlation_matrix = np.eye(n)
        if self._analysis['is_rotated']:
            self.rotate(self._analysis['n_rot'], self._analysis['power'])

    # -------------------------------------------------------------- display
    def summary(self):
        """Print meta information of the performed analysis (YAML)."""
        import yaml
        strings_only = {k: str(v) for k, v in self._analysis.items()}
        print(yaml.dump(strings_only, sort_keys=False,
                        default_flow_style=False))

    def plot(self, mode, threshold=0, phase_shift=0, cmap_eof=None,
             cmap_phase=None, figsize=(8.3, 5.0)):
        """Plot PCs/EOFs (and phase, if complex) of `mode` (matplotlib)."""
        from xmca_tpu_torch.viz.plot import plot_mca_mode
        return plot_mca_mode(
            self, mode, threshold=threshold, phase_shift=phase_shift,
            cmap_eof=cmap_eof, cmap_phase=cmap_phase, figsize=figsize,
        )

    def save_plot(self, mode, path=None, plot_kwargs={}, save_kwargs={}):
        """Create and save a plot of `mode` to disk."""
        import matplotlib.pyplot as plt
        output = 'mode{:}.png'.format(mode) if path is None else path
        self.plot(mode=mode, **plot_kwargs)
        fig = plt.gcf()
        fig.subplots_adjust(left=0.06)
        plt.savefig(output, **save_kwargs)
