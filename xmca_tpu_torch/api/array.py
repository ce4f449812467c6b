"""``MCA`` on torch tensors — the main-path subset of the ndarray API.

Counterpart of ``xmca_tpu/api/array.py``: construction and ingestion,
``set_solver``, ``apply_weights``, ``normalize``, the truncated
(matmul-only) ``solve``, ``rotate``, the spectrum getters, ``rule_n`` and
``rule_north``.  Fields live on the device named at construction
(``'cuda'`` by default); every option the port does not implement yet
raises ``NotImplementedError`` instead of running something else.

Rule-N always runs the accelerator configuration of the JAX package:
generated +-1 surrogates (draw and syrk kernels), the fast spectrum,
``grade='fast'``, rotation tolerance 1e-4 with the 14-step Newton-Schulz
polar, and 6 subspace iterations.
"""
import numpy as np
import torch

from xmca_tpu_torch.version import __version__
from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core import preprocess as _pre
from xmca_tpu_torch.core.rotation import promax as _promax
from xmca_tpu_torch.stats import significance as _sig
from xmca_tpu_torch.utils.device import resolve_device

_HILBERT_MATMUL_MAX_N = 8192


def _not_ported(what):
    return NotImplementedError(
        '{} is not ported to xmca_tpu_torch yet (see ROADMAP.md, queue 1)'
        .format(what))


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

        data = dict(zip(self._keys, fields))
        for k, f in data.items():
            self._shape[k] = f.shape
            self._n_observations[k] = f.shape[0]
            self._fields_spatial_shape[k] = f.shape[1:]
            self._n_variables[k] = int(np.prod(f.shape[1:]))
            self._field_names[k] = k
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

        self._subspace_iters = 12
        self._solver_truncate = None
        self._solver_seed = 0
        self._ensemble_tol = None
        self._ensemble_subspace_iters = None
        self._rotate_iterations = None
        self._rule_n_iterations = None

    # ------------------------------------------------------------ ingestion
    def _ingest(self, data):
        """Upload each field once; NaN scans, means and stds run on the
        device and come back as small host vectors."""
        packed = {}
        for k, f in data.items():
            d = torch.as_tensor(f.reshape(f.shape[0], -1),
                                device=self._device)
            nan = torch.isnan(d)
            if bool(nan.all(dim=1).any()):
                raise ValueError(
                    'One or more fields contain NaN time steps. '
                    'Please remove these prior to analysis.'
                )
            nan_cols = nan.any(dim=0).cpu().numpy()
            self._no_nan_index[k] = ~nan_cols
            if nan_cols.any():
                keep = torch.as_tensor(np.nonzero(~nan_cols)[0],
                                       device=self._device)
                d = d[:, keep]
            mean = d.mean(dim=0)
            self._field_means[k] = mean.cpu().numpy()
            self._field_stds[k] = d.std(dim=0, correction=0).cpu().numpy()
            packed[k] = d - mean
        return packed

    def _get_method_id(self):
        return 'mca' if self._analysis['is_bivariate'] else 'pca'

    # --------------------------------------------------------------- config
    def set_solver(self, truncate=None, seed=None, subspace_iters=None,
                   spectrum=None, surrogate_source=None,
                   surrogate_gen_dist=None, ensemble_tol=None,
                   ensemble_subspace_iters=None):
        """Configure the solver (the main-path keys of the JAX API).

        ``truncate``: solve the leading modes with the matmul-only
        pipeline (required: the exact dense solver is not ported yet).
        ``seed``: seed of the solve's subspace start block.
        ``subspace_iters``: the solve's power iterations (default 12).
        ``ensemble_tol`` / ``ensemble_subspace_iters``: Rule-N's rotation
        tolerance (default 1e-4) and power iterations (default 6).
        ``spectrum``, ``surrogate_source`` and ``surrogate_gen_dist``
        accept only the one configuration the port runs ('fast',
        'generated', 'rademacher8').
        """
        for name, value, ported in (
                ('spectrum', spectrum, 'fast'),
                ('surrogate_source', surrogate_source, 'generated'),
                ('surrogate_gen_dist', surrogate_gen_dist, 'rademacher8')):
            if value is not None and value != ported:
                raise _not_ported('set_solver({}={!r})'.format(name, value))
        if truncate is not None:
            self._solver_truncate = int(truncate)
        if seed is not None:
            self._solver_seed = int(seed)
        if subspace_iters is not None:
            self._subspace_iters = int(subspace_iters)
        if ensemble_tol is not None:
            self._ensemble_tol = float(ensemble_tol)
        if ensemble_subspace_iters is not None:
            self._ensemble_subspace_iters = int(ensemble_subspace_iters)

    # -------------------------------------------------------- preprocessing
    def apply_weights(self, left=None, right=None):
        """Multiply the packed (time, space) fields by weights that
        broadcast against them."""
        for k, w in (('left', left), ('right', right)):
            if w is None or k not in self._fields:
                continue
            f = self._fields[k]
            self._fields[k] = f * torch.as_tensor(np.asarray(w),
                                                  device=self._device,
                                                  dtype=f.dtype)

    def normalize(self):
        """Divide each time series by its standard deviation."""
        for k in self._keys:
            f = self._fields[k]
            self._fields[k] = _pre.standardize(
                f, torch.as_tensor(self._field_stds[k], device=self._device,
                                   dtype=f.dtype))
        self._analysis['is_normalized'] = True
        self._analysis['is_coslat_corrected'] = False
        self._analysis['method'] = self._get_method_id()

    # ---------------------------------------------------------------- solve
    def _hilbert_operator(self, n_obs, dtype):
        """The real Hilbert operator H (``analytic(x) = x + iHx``),
        kept on the device once per model."""
        if self._hilbert is None or self._hilbert.shape[0] != n_obs:
            self._hilbert = torch.tensor(
                _fast.hilbert_imag_matrix(n_obs, np.float64),
                device=self._device)
        return self._hilbert.to(dtype)

    def _start_block(self, m, k, dtype):
        gen = torch.Generator(device=self._device)
        gen.manual_seed(self._solver_seed)
        return _fast.start_block(m, k, dtype, gen)

    def solve(self, complexify=False, extend=False, period=1):
        """Truncated MCA (``set_solver(truncate=k)``), complexified
        through the analytic fold when ``complexify=True``.

        The complex fields are never built: the fields stay real and the
        solve folds the Hilbert operator into their Grams.
        """
        if self._solver_truncate is None:
            raise _not_ported('solve() without set_solver(truncate=k) '
                              '(the exact dense solver)')
        if extend:
            raise _not_ported('solve(extend={!r})'.format(extend))
        if self._complexify_pending:
            raise _not_ported('re-solving a complexified model')
        if not self._fields or any(f.numel() == 0
                                   for f in self._fields.values()):
            raise RuntimeError('Fields are empty. Did you forget to load '
                               'data?')
        Xl = self._fields['left']
        Xr = self._fields[self._keys[-1]]
        n_obs = Xl.shape[0]
        if min(Xl.shape[1], Xr.shape[1]) < n_obs:
            raise _not_ported('the truncated solve of fields with fewer '
                              'columns than time steps')
        if complexify and n_obs > _HILBERT_MATMUL_MAX_N:
            raise _not_ported('complexify with more than {} time steps'
                              .format(_HILBERT_MATMUL_MAX_N))
        k = min(self._solver_truncate, n_obs, Xl.shape[1], Xr.shape[1])

        if complexify:
            H = self._hilbert_operator(n_obs, Xl.dtype)
            omega = self._start_block(n_obs, k, _fast._complex_dtype(
                Xl.dtype))
            s, Vl, Vr, total_cov, total_sq = \
                _fast.fast_solve_truncated_totals_analytic(
                    Xl, Xr, H, omega, n_modes=k,
                    n_iter=self._subspace_iters)
            self._complexify_pending = True
        else:
            omega = self._start_block(n_obs, k, Xl.dtype)
            s, Vl, Vr, total_cov, total_sq = \
                _fast.fast_solve_truncated_totals(
                    Xl, Xr, omega, n_modes=k, n_iter=self._subspace_iters)
        svals = s.cpu().numpy()
        self._install_solution(
            svals, dict(zip(self._keys, (Vl, Vr))),
            (float(total_cov), float(total_sq)), complexify)

    def _install_solution(self, svals, V, totals, complexify):
        self._analysis['is_complex'] = complexify
        self._analysis['extend'] = False
        self._V = V
        self._singular_values = svals
        self._variance = svals
        self._var_idx = np.argsort(svals)[::-1]
        self._norm = {k: np.sqrt(svals) for k in self._keys}
        self._analysis['total_covariance'] = totals[0]
        self._analysis['total_squared_covariance'] = totals[1]
        self._analysis['rank'] = len(svals)
        self._analysis['is_truncated'] = True
        self._analysis['is_truncated_at'] = len(svals)
        self._analysis['is_rotated'] = False
        self._analysis['n_rot'] = len(svals)
        self._analysis['power'] = 0
        self._rotation_matrix = np.eye(len(svals))
        self._correlation_matrix = np.eye(len(svals))

    # --------------------------------------------------------------- rotate
    def rotate(self, n_rot, power=1, tol=1e-8):
        """Varimax (``power=1``) / Promax rotation of the leading
        ``n_rot`` modes; raises if the fixed point does not converge."""
        if n_rot < 2:
            raise ValueError('`n_rot` must be > 1')
        if power < 1:
            raise ValueError('`power` must be >=1')
        sqrt_s = np.sqrt(self._get_svals(n_rot))
        Vl = self._V['left']
        real = Vl.real.dtype
        cols = [Vl[:, :n_rot]]
        if self._analysis['is_bivariate']:
            cols.append(self._V['right'][:, :n_rot])
        L = torch.cat(cols, dim=0) * torch.as_tensor(
            sqrt_s, device=Vl.device, dtype=real)[None, :]
        L_rot, R, Phi, converged, n_iter = _promax(
            L, power=power, max_iter=1000, tol=tol)
        self._rotate_iterations = n_iter
        if not converged:
            raise RuntimeError(
                'Rotation process did not converge. Try decreasing the '
                'tolerance. Invalid NaN entries also might be a problem.'
            )
        n_left = Vl.shape[0]
        if self._analysis['is_bivariate']:
            norm = {'left': torch.linalg.norm(L_rot[:n_left], dim=0),
                    'right': torch.linalg.norm(L_rot[n_left:], dim=0)}
        else:
            both = torch.linalg.norm(L_rot, dim=0)
            norm = {'left': both, 'right': both}
        norm = {k: v.cpu().numpy() for k, v in norm.items()}
        variance = norm['left'] * norm['right']
        self._norm = {k: norm[k] for k in self._keys}
        self._variance = variance
        self._var_idx = np.argsort(variance)[::-1]
        self._rotation_matrix = R.cpu().numpy()
        self._correlation_matrix = Phi.cpu().numpy()
        self._analysis['is_rotated'] = True
        self._analysis['n_rot'] = n_rot
        self._analysis['power'] = power

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

    def singular_values(self, n=None):
        """Return the first `n` singular values."""
        return self._get_svals(n)

    def norm(self, n=None, sorted=True):
        """Return the L2 norm of the first `n` singular vectors."""
        return self._get_norm(n=n, sorted=sorted)

    def variance(self, n=None, sorted=True):
        """Return the variance of the first `n` singular vectors."""
        return self._get_variance(n=n, sorted=sorted)

    def explained_variance(self, n=None):
        """Covariance fraction (%) of the first `n` modes."""
        return (self._get_variance(n=n, sorted=True)
                / self._analysis['total_covariance'] * 100)

    # --------------------------------------------------------- significance
    def rule_n(self, n_runs, n_modes=None, seed=None):
        """Rule N (Overland & Preisendorfer 1982) from generated +-1
        surrogates; returns an (n_modes, n_kept_runs) array."""
        m = self._n_observations
        n = self._n_variables
        slc = self._get_slice(n_modes)
        n_modes_fast = min(slc.stop, min(m.values()), min(n.values()))
        tol = 1e-4 if self._ensemble_tol is None else self._ensemble_tol
        polar = 'ns14' if tol >= 1e-4 else 'ns'
        iters = (6 if self._ensemble_subspace_iters is None
                 else self._ensemble_subspace_iters)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        H = None
        if self._analysis['is_complex']:
            H = self._hilbert_operator(m['left'], torch.float32)
        spectra, totals, n_iter = _sig.rule_n_generated(
            m['left'], tuple(n[k] for k in self._keys), n_runs,
            complexify=self._analysis['is_complex'],
            rotated=self._analysis['is_rotated'],
            n_rot=self._analysis['n_rot'],
            power=max(1, self._analysis['power']), tol=tol, seed=seed,
            n_modes_fast=n_modes_fast, subspace_iters=iters,
            polar_method=polar, device=self._device, H=H,
        )
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
