"""Rule-N, bootstrapping and North's rule on tensors.

Counterpart of ``xmca_tpu/stats/significance.py``.

Rule-N (:func:`rule_n_spectra`) runs one of two surrogate sources, one
run after another on one device, with the JAX package's seed plumbing:
run ``r`` of seed ``s`` uses ``s_r = (s * 2654435761 + r) mod 2^32``.
Its subspace start block comes from a CPU ``torch.Generator`` seeded
with ``s_r``, so a generated run on the card and on the CPU solves the
same inputs.

* ``'generated'`` (:func:`rule_n_generated`): +-1 draws
  ('rademacher8', 'rademacher1') come from the draw kernel with seeds
  ``2 s_r`` and ``2 s_r + 1``, their Grams from the syrk kernel
  (``core.fastpath.fast_surrogate_variance_tri``); 'normal16',
  'normal32' and 'rademacher' fields are materialized by the field
  kernel with the same seeds and solved by :func:`_surrogate_variance`
  with the fast spectrum.
* ``'draw'``: Gaussian fields from a ``torch.Generator`` on the device
  seeded with ``s_r ^ DRAW_SALT`` (the model's dtype, or bf16), solved
  by :func:`_surrogate_variance` with the fast or the exact spectrum.

Bootstrapping resamples the model's own (centered, preprocessed) fields
in moving blocks, by one of two routes (:func:`bootstrap_spectra`).  A
time resample with the fast spectrum and no extension runs in Gram
space (``'stored'``): each field's Gram is formed once a call, a run
takes its resample's centered Gram by index algebra on it and
back-projects through the fields in place, as the chunk-backed
bootstrap (:mod:`xmca_tpu_torch.stats.streaming_boot`) does with the
Grams it stores.  Every other request (extension, a column resample,
the exact spectrum) takes the data route (``'data'``): each run gathers
its resample and solves it with :func:`_surrogate_variance`; a model
solved with boundary extension re-centers, re-extends and complexifies
each resample first.  Each run draws its
block indices, then its subspace start block, from a CPU
``torch.Generator`` seeded with its run seed, so the card and the CPU
resample identically.  The JAX package's vmapped batches are XLA
scheduling and have no counterpart here.

With a ``mesh`` (:mod:`xmca_tpu_torch.parallel.mesh`) the runs are split
over its ``ensemble_axis``: each rank runs a contiguous share of the run
seeds and the runs are gathered in run order (as float64: each rank's
values upcast exactly) before the non-converged ones are dropped, so the
result is the unsharded one run for run.  Rule-N's surrogate fields are
whole on every rank; a bootstrap resamples the model's fields, which a
'space' axis shards by columns: a time resample takes each rank's rows
of its own columns, a column resample each rank's draws on its own
columns (:func:`bootstrap_spectra`).

Under a profiler (:mod:`xmca_tpu_torch.utils.trace`) each run of
:func:`rule_n_generated` and :func:`bootstrap_spectra` is a ``run`` span
(its ``seed``) holding ``start`` (the start block drawn on the host and
copied), for a bootstrap ``resample``, and the solve's stages, a
bootstrap's ``gram`` with its ``route``; the stored route's Grams of a
call are one ``gram`` span outside its runs.  The runs' results come to
the host in ``collect``.
"""
import numpy as np
import torch

from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core.preprocess import complexify as _complexify
from xmca_tpu_torch.core.solver import solve_rotated_variance, solve_svals
from xmca_tpu_torch.parallel import mesh as _mesh
from xmca_tpu_torch.utils import trace

__all__ = ['run_seeds', 'rule_n_spectra', 'rule_n_generated',
           'rule_north_uncertainty', 'bootstrap_spectra']

# salts the 'draw' fields' generator seed: their stream stays apart from
# the start block's, drawn from the run seed itself
DRAW_SALT = 0x44524157           # 'DRAW'
# generated distributions drawn as +-1 int8 and solved with the triangle
# Gram; the draw kernel spends one random bit per element, so in the port
# 'rademacher1' is the same draw as 'rademacher8' (the JAX package's two
# differ only in their random-bit budget)
_PM1_INT8 = ('rademacher8', 'rademacher1')


def run_seeds(seed, n_runs):
    """Per-run uint32 seeds, as the JAX package derives them."""
    base = (int(seed) * 2654435761) % (2 ** 32)
    return [(base + r) % (2 ** 32) for r in range(n_runs)]


def _start_block(s, k, n_obs, complexify, device):
    """Run ``s``'s subspace start block, drawn on the CPU from a generator
    seeded with ``s`` and copied to ``device``."""
    return _drawn_start(torch.Generator().manual_seed(s), n_obs, k,
                        torch.complex64 if complexify else torch.float32,
                        device)


def _drawn_start(gen, n_obs, k, dtype, device):
    """:func:`core.fastpath.start_block` drawn on the CPU from ``gen`` and
    copied to ``device``."""
    with trace.span('start') as span:
        omega = _fast.start_block(n_obs, k, dtype, gen)
        span.set(bytes=omega.numel() * omega.element_size())
        return trace.to_device(omega, device, 'start.copy')


def _run_row(var, total, conv, n_iter):
    """One Rule-N run as a float64 row: its spectrum, total, converged
    flag and iteration count (-1: not reported)."""
    tail = torch.tensor([float(total), float(bool(conv)),
                         -1.0 if n_iter is None else float(n_iter)],
                        dtype=torch.float64)
    return torch.cat([var.detach().to(torch.float64).cpu(), tail])


def _collect_ensemble(one_run, seeds, mesh, axis):
    """:func:`_collect` of every run, split over a mesh's ensemble; the
    gathered spectra and totals come back in the dtype of this rank's
    runs (exact: they were upcast from it)."""
    if _mesh.axis_size(mesh, axis) == 1:
        return _collect(one_run(s) for s in seeds)
    dtype = []

    def row(s):
        var, total, conv, n_iter = one_run(s)
        dtype[:] = [var.dtype]
        return _run_row(var, total, conv, n_iter)

    rows = _mesh.ensemble_map(lambda ss: [row(s) for s in ss], seeds, mesh,
                              axis)
    cast = dtype[0] if dtype else torch.float64
    return _collect((r[:-3].to(cast), r[-3].to(cast), bool(r[-2]),
                     None if r[-1] < 0 else int(r[-1])) for r in rows)


def _collect(runs):
    """``(spectra, totals, n_iter)`` as numpy from per-run ``(variance,
    total, converged, n_iter)``: the runs that did not converge are
    dropped from the first two; ``n_iter`` holds every run's rotation
    iteration count, or is None where the solve does not report it."""
    runs = list(runs)
    with trace.span('collect'):
        keep = np.asarray([bool(r[2]) for r in runs], dtype=bool)
        spectra = trace.to_host(torch.stack([r[0] for r in runs]),
                                'collect').numpy()
        totals = trace.to_host(torch.stack([torch.as_tensor(r[1])
                                            for r in runs]),
                               'collect').numpy()
    iters = [r[3] for r in runs]
    iters = None if any(i is None for i in iters) else np.asarray(iters)
    return spectra[keep], totals[keep], iters


def rule_n_spectra(n_obs, n_vars, n_runs, *, complexify=False,
                   rotated=False, n_rot=0, power=1, tol=1e-8,
                   dtype=torch.float32, method='gram', seed=None,
                   spectrum='fast', n_modes_fast=None, subspace_iters=12,
                   surrogate_source='generated',
                   surrogate_dist='rademacher8', polar_method='ns',
                   device='cpu', H=None, grade='fast', mesh=None,
                   ensemble_axis='ensemble'):
    """Rule-N surrogate spectra (Overland & Preisendorfer 1982) of
    ``n_runs`` pairs of (n_obs, p_i) surrogate fields, with the keys of
    the JAX package's ``rule_n_spectra``.

    ``surrogate_source='generated'`` runs :func:`rule_n_generated` (the
    fast spectrum only: another raises the JAX package's ``ValueError``);
    ``'draw'`` draws each run's Gaussian fields in ``dtype`` from a
    ``torch.Generator`` on ``device`` seeded with the run seed xor
    ``DRAW_SALT`` and solves them with :func:`_surrogate_variance` and
    ``spectrum`` ('fast' or 'exact'; the fast one from the run's start
    block).
    ``H`` is the Hilbert operator of the fast complexified spectrum.
    ``mesh`` splits the runs over its ``ensemble_axis``.

    Returns ``(spectra, totals, n_iter)`` as numpy: spectra
    (n_kept_runs, n_modes), non-converged runs dropped; the per-run
    rescaling totals; every run's rotation iteration count, or None
    where the solve does not report one.
    """
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    n_vars = tuple(int(p) for p in n_vars)
    if surrogate_source == 'generated':
        if spectrum != 'fast':
            raise ValueError(
                "surrogate_source='generated' requires "
                "spectrum='fast' (set_solver(spectrum='fast'))"
            )
        return rule_n_generated(
            n_obs, n_vars, n_runs, complexify=complexify, rotated=rotated,
            n_rot=n_rot, power=power, tol=tol, seed=seed,
            n_modes_fast=n_modes_fast, subspace_iters=subspace_iters,
            polar_method=polar_method, device=device, H=H, grade=grade,
            dist=surrogate_dist, mesh=mesh, ensemble_axis=ensemble_axis)
    if surrogate_source != 'draw':
        raise ValueError("surrogate_source must be 'draw' or 'generated'")
    k = n_rot if rotated else n_modes_fast

    def one_run(s):
        gen = torch.Generator(device=device).manual_seed(s ^ DRAW_SALT)
        fields = [torch.randn((n_obs, p), generator=gen, dtype=dtype,
                              device=device) for p in n_vars]
        omega = None
        if spectrum == 'fast':
            omega = _start_block(s, k, n_obs, complexify, device)
        var, total, conv = _surrogate_variance(
            fields, complexify, rotated, n_rot, power, tol, method,
            spectrum=spectrum, n_modes_fast=n_modes_fast,
            subspace_iters=subspace_iters, omega=omega, hilbert_H=H,
            polar_method=polar_method)
        return var, total, conv, None

    with _mesh.space_context(None):
        return _collect_ensemble(one_run, run_seeds(seed, n_runs), mesh,
                                 ensemble_axis)


def rule_n_generated(n_obs, n_vars, n_runs, *, complexify, rotated, n_rot,
                     power, tol, seed, n_modes_fast, subspace_iters,
                     polar_method, device, H=None, grade='fast',
                     dist='rademacher8', mesh=None, ensemble_axis='ensemble'):
    """Rule-N surrogate spectra from generated fields of distribution
    ``dist``.

    'rademacher8' and 'rademacher1' (the same +-1 draw here) run
    ``core.fastpath.fast_surrogate_variance_tri`` (the draw and syrk
    kernels, ``grade``); 'normal16', 'normal32' and 'rademacher'
    materialize each (n_obs, p_i) bf16 field with the field kernel
    (``ops.surrogate.surrogate_field``, seed ``2 s_r + i`` mod 2^32) and
    solve it with :func:`_surrogate_variance` and the fast spectrum.
    ``mesh`` splits the runs over its ``ensemble_axis``.  Returns
    ``(spectra, totals, n_iter)`` as :func:`rule_n_spectra` does.
    """
    from xmca_tpu_torch.ops.surrogate import GEN_DISTS, surrogate_field

    if dist not in _PM1_INT8 and dist not in GEN_DISTS:
        raise ValueError('unknown surrogate distribution: {!r}'.format(dist))
    n_vars = tuple(int(p) for p in n_vars)
    k = n_rot if rotated else n_modes_fast

    def one_run(s):
        with trace.span('run', seed=s):
            omega = _start_block(s, k, n_obs, complexify, device)
            if dist in _PM1_INT8:
                return _fast.fast_surrogate_variance_tri(
                    s, omega, n_obs, n_vars, H=H, complexify=complexify,
                    rotated=rotated, n_rot=k, power=power, tol=tol,
                    n_iter=subspace_iters, polar_method=polar_method,
                    grade=grade)
            fields = [surrogate_field((2 * s + i) & 0xFFFFFFFF, n_obs, p,
                                      dist, device)
                      for i, p in enumerate(n_vars)]
            var, total, conv = _surrogate_variance(
                fields, complexify, rotated, n_rot, power, tol, 'gram',
                spectrum='fast', n_modes_fast=n_modes_fast,
                subspace_iters=subspace_iters, omega=omega, hilbert_H=H,
                polar_method=polar_method)
            return var, total, conv, None

    with _mesh.space_context(None):
        return _collect_ensemble(one_run, run_seeds(seed, n_runs), mesh,
                                 ensemble_axis)


def rule_north_uncertainty(singular_values, n_obs, is_complex=False):
    """North's rule of thumb: ``err = s sqrt(2 / n_obs)``, times
    ``sqrt(2)`` for complex solutions (Horel 1984)."""
    err = np.asarray(singular_values) * np.sqrt(2.0 / n_obs)
    if is_complex:
        err = err * np.sqrt(2)
    return err


def _surrogate_variance(fields, complexify, rotated, n_rot, power, tol,
                        method, spectrum='exact', n_modes_fast=None,
                        subspace_iters=12, omega=None, hilbert_H=None,
                        polar_method='ns'):
    """``(variance, total, converged)`` of one ensemble solve of
    ``fields`` (one or two, time first; centered here).

    ``spectrum='fast'``: the chol-reduced kernel and a subspace iteration
    from the start block ``omega`` (:mod:`xmca_tpu_torch.core.fastpath`);
    complexified real fields with a Hilbert operator ``hilbert_H`` take
    the analytic fold and never build ``Z``.  ``spectrum='exact'``: the
    dense pipeline of :mod:`xmca_tpu_torch.core.solver` on the
    (FFT-)complexified fields.  The total is the full-spectrum sum
    (unrotated; the nuclear norm in fast mode) or the sum over the
    ``n_rot`` rotated modes; ``converged`` is a Python bool.

    bf16 fields are centered with an f32 mean rounded back to bf16, as the
    JAX package centers them, and their data-sized products accumulate in
    f32 (``core.fastpath._data_dot``); the FFT complexification and the
    exact spectrum take them upcast to f32.
    """
    fields = [f - f.mean(dim=0, dtype=torch.float32).to(f.dtype)
              if f.dtype == torch.bfloat16 else f - f.mean(dim=0)
              for f in fields]
    bivariate = len(fields) == 2
    Xl = fields[0]
    Xr = fields[1] if bivariate else None
    if (spectrum == 'fast' and complexify and hilbert_H is not None
            and not Xl.is_complex()):
        if rotated:
            var, conv = _fast.fast_rotated_variance_analytic(
                Xl, Xr, hilbert_H, omega, n_rot=n_rot, power=power,
                tol=tol, n_iter=subspace_iters, bivariate=bivariate,
                polar_method=polar_method)
            return var, torch.sum(var), conv
        svals, total = _fast.fast_spectrum_analytic(
            Xl, Xr if bivariate else Xl, hilbert_H, omega, k=n_modes_fast,
            n_iter=subspace_iters)
        return svals, total, True
    if complexify or spectrum != 'fast':
        fields = [f.to(torch.float32) if f.dtype == torch.bfloat16 else f
                  for f in fields]
    if complexify:
        fields = [_complexify(f) for f in fields]
    Xl = fields[0]
    Xr = fields[1] if bivariate else None
    if rotated:
        if spectrum == 'fast':
            var, conv = _fast.fast_rotated_variance(
                Xl, Xr, omega, n_rot=n_rot, power=power, tol=tol,
                n_iter=subspace_iters, bivariate=bivariate,
                polar_method=polar_method)
        else:
            var, conv = solve_rotated_variance(
                Xl, Xr, n_rot=n_rot, power=power, tol=tol, method=method,
                bivariate=bivariate)
        return var, torch.sum(var), bool(conv)
    if spectrum == 'fast':
        svals, total = _fast.fast_spectrum(
            Xl, Xr if bivariate else Xl, omega, k=n_modes_fast,
            n_iter=subspace_iters)
        return svals, total, True
    svals = solve_svals(Xl, Xr, method=method)
    return svals, torch.sum(svals), True


def _block_indices(generator, n_total, block_size, replace):
    """Moving-block bootstrap indices into an axis of ``n_total``: the
    ``n_total // block_size`` blocks drawn with (``randint``) or without
    (``randperm``) replacement from ``generator``, each expanded to its
    ``block_size`` consecutive indices (a CPU LongTensor)."""
    n_blocks = n_total // block_size
    if replace:
        blocks = torch.randint(0, n_blocks, (n_blocks,), generator=generator)
    else:
        blocks = torch.randperm(n_blocks, generator=generator)
    return (blocks[:, None] * block_size
            + torch.arange(block_size)[None, :]).reshape(-1)


def _space_draws(widths, device):
    """``(sizes, local)`` for a column resample of a pool of fields side
    by side, of which this rank holds blocks of ``widths`` columns: the
    fields' global widths, and the map from draws over the pool to the
    draws that fall on this rank's columns, as positions in its blocks
    side by side, in draw order (repeats kept); outside a space context,
    the widths and the draws themselves."""
    lo, sizes = _mesh.space_offsets(widths, device)
    if not _mesh.space_sharded():
        return sizes, lambda idx: idx
    pos, base = [], 0
    for start, width, size in zip(lo, widths, sizes):
        pos.append(base + start + torch.arange(width, device=device))
        base += size
    return sizes, _mesh.draws_on_rank(torch.cat(pos), base)


def _gram_route(axis, spectrum, complexify, extend, hilbert_H):
    """True where a bootstrap solves each time resample from the fields'
    Grams (``'stored'``): the fast spectrum of a time resample without
    extension, complexified by the analytic fold (``hilbert_H``) or not
    at all.  An extension's boundary forecast changes with each
    resample, a column resample weights columns and the exact spectrum
    solves the data: those take the data route."""
    return (axis == 0 and spectrum == 'fast' and not (complexify and extend)
            and (not complexify or hilbert_H is not None))


def bootstrap_spectra(fields, n_runs, n_out_modes, *, axis=0, on_left=True,
                      on_right=False, block_size=1, replace=True,
                      complexify=False, extend=False, period=1,
                      rotated=False, n_rot=0, power=1, tol=1e-8,
                      method='gram', seed=None, spectrum='exact',
                      subspace_iters=12, hilbert_H=None, mesh=None,
                      ensemble_axis='ensemble'):
    """One round of (moving-block) bootstrap spectra of ``fields``.

    Each run resamples the given fields (not the previous run's
    resample): ``axis=0`` resamples time steps, jointly when both fields
    are resampled; ``axis=1`` resamples columns, of the concatenated
    fields when both are.  It then solves (and rotates) the resample
    with the convergence-gated polar, by one of two routes, counted per
    run in ``trace.counters()['gram_routes']``:

    * ``'stored'``, a time resample with the fast spectrum, unextended
      (:func:`_gram_route`): the Gram ``G = X X^H`` of each field as
      given is formed once a call, and a run that draws the rows ``idx``
      takes the Gram of its re-centered resample ``C P X`` as
      ``C G[idx][:, idx] C`` (``C G C`` for a side it does not resample,
      factored once a call), then the same fold, jitter and Cholesky as
      the data route (``core.fastpath.centered_factor``).  A rotated run
      back-projects with ``(C P X)^T S = X^T (P^T C S)``, reading the
      fields in place; an unrotated run reads no data.  No data-sized
      tensor is made.
    * ``'data'``, every other request: each run gathers its resample and
      solves it with :func:`_surrogate_variance` (centering it; the fast
      chol/subspace pipeline or the exact one).  With ``complexify`` and
      ``extend`` ('exp'/'theta', ``period``) each resample is
      re-centered, extended and complexified, then solved as complex
      fields.

    ``hilbert_H`` is the model's Hilbert operator (the fast complexified
    spectrum without extension needs it).

    ``mesh`` splits the runs over its ``ensemble_axis``.  Inside a space
    context (:func:`xmca_tpu_torch.parallel.mesh.space_context`) the
    ``fields`` are this rank's column blocks (the model's shards) and
    every contraction sums over the space group: the stored route's
    Grams once a call, the data route's a run.  A column
    resample (``axis=1``) draws the same global indices on every rank,
    and each rank keeps the draws that fall on its own columns (repeats
    kept, in draw order): its share of the resample, ``X_loc diag(c_loc)
    X_loc^T`` for its columns' draw counts ``c_loc``, as the chunk-backed
    bootstrap weighs them.  Every contraction and rotation criterion is
    a sum over columns, so the shares summed over the group are the
    resample's, up to the order of the sums.  A rank holds on average
    its share of the resampled width, as it holds its share of the
    fields; nothing is gathered.

    Returns ``(spectra (n_runs, n_out_modes), converged (n_runs,))`` as
    numpy; the rows of non-converged runs are to be dropped.
    """
    if axis not in (0, 1):
        raise ValueError('{:} not a valid axis. either 0 or 1.'.format(axis))
    if seed is None:
        seed = int(np.random.randint(0, 2 ** 31 - 1))
    bivariate = len(fields) == 2
    if on_right and not bivariate:
        raise ValueError(
            'No bootstrapping possible. There is no right field. '
            'Set `on_right=False`.'
        )
    n_obs = int(fields[0].shape[0])
    device = fields[0].device
    real = fields[0].real.dtype
    k = n_rot if rotated else n_out_modes
    # the resampled pool: its fields and, for a column resample, their
    # global widths (this rank's blocks summed over a space group)
    pool = ([0, 1] if on_left and on_right
            else [0] if on_left else [1] if on_right else [])
    if axis == 1 and pool:
        widths, local = _space_draws([fields[i].shape[1] for i in pool],
                                     device)

    def _check(length):
        if length % block_size != 0:
            raise ValueError(
                'Length of data array ({:}) must be a multiple of block '
                'size {:}'.format(length, block_size)
            )

    if pool:
        _check(n_obs if axis == 0 else sum(widths))

    def indices(gen, n_total):
        idx = _block_indices(gen, n_total, block_size, replace)
        trace.annotate(bytes=idx.numel() * idx.element_size())
        return trace.to_device(idx, device, 'resample.copy')

    @trace.spanned('resample')
    def resample(gen, fs):
        if not pool:
            return fs
        if axis == 0:
            idx = indices(gen, n_obs)
            return [f[idx] if i in pool else f for i, f in enumerate(fs)]
        idx = indices(gen, sum(widths))
        src = (fs[pool[0]] if len(pool) == 1
               else torch.cat([fs[i] for i in pool], dim=1))
        draws = (idx[:widths[0]], idx[widths[0]:]) if len(pool) == 2 else (
            idx,)
        out = list(fs)
        for i, d in zip(pool, draws):
            out[i] = src[:, local(d)]
        return out

    @trace.spanned('resample')
    def draw_rows(gen):
        return indices(gen, n_obs) if pool else None

    def start(gen):
        return _drawn_start(gen, n_obs, k, real, device)

    def data_run(gen):
        fs = resample(gen, list(fields))
        cplx = complexify
        if complexify and extend:
            fs = [_complexify(f - f.mean(dim=0), extend=extend,
                              period=period) for f in fs]
            cplx = False
        omega = start(gen) if spectrum == 'fast' else None
        var, _, conv = _surrogate_variance(
            fs, cplx, rotated, n_rot, power, tol, method,
            spectrum=spectrum, n_modes_fast=n_out_modes,
            subspace_iters=subspace_iters, omega=omega, hilbert_H=hilbert_H,
            # resamples of REAL data can have a large mode-variance
            # spread: the convergence-gated polar, as in the JAX package
            polar_method='ns-gated')
        return var, conv

    route, run = 'data', data_run
    if _gram_route(axis, spectrum, complexify, extend, hilbert_H):
        route, run = 'stored', _stored_runs(
            fields, pool, draw_rows, start, k,
            hilbert_H if complexify else None, rotated, power, tol,
            subspace_iters)

    @trace.spanned('run')
    def one_run(s):
        trace.annotate(seed=s)
        trace.count('gram_routes', route)
        var, conv = run(torch.Generator().manual_seed(s))
        flag = torch.tensor([float(bool(conv))], dtype=torch.float64)
        return torch.cat([var[:n_out_modes].to(torch.float64),
                          trace.to_device(flag, var.device, 'run.converged')])

    rows = torch.stack(list(_mesh.ensemble_map(
        lambda ss: [one_run(s) for s in ss], run_seeds(seed, n_runs), mesh,
        ensemble_axis)))
    with trace.span('collect'):
        rows = trace.to_host(rows, 'collect').numpy()
    return rows[:, :-1], rows[:, -1] > 0.5


def _resample_weights(L, T_side, H, dtype, idx=None):
    """One side's projection weights of a resample: ``Z = L^-H T`` (the
    analytic stack with ``H``, ``core.fastpath._recover``) in ``dtype``,
    centered (``C Z``) and, with the rows ``idx`` of a time resample,
    scattered to ``P^T C Z``: each duplicated draw adds its row."""
    Z = _fast._recover(L, T_side, H).to(dtype)
    Y = Z - Z.mean(dim=0)
    if idx is None:
        return Y
    return torch.zeros_like(Y).index_add_(0, idx, Y)


def _time_resample_runs(grams, pool, widths, eps, H, k, n_iter, dtype):
    """The Gram-space time resample of the in-memory bootstrap
    (:func:`_stored_runs`) and the chunk-backed one
    (:mod:`xmca_tpu_torch.stats.streaming_boot`).

    ``grams``: the fields' Grams as given (one for a univariate model);
    ``pool``: the sides a run resamples; ``widths``, ``eps``: the sides'
    widths and input precision; ``H``: the Hilbert operator of the
    analytic fold, None for fields solved as given.  Factors the sides no
    run resamples now and returns ``run(idx, omega, finish)``: the factor
    of ``C G[idx][:, idx] C`` for the rows ``idx``, the reduction for
    ``k`` modes from ``omega`` (``route='stored'``), then ``finish(s,
    weight)`` while the run's n x n state is alive; ``weight(i)`` makes
    side i's :func:`_resample_weights` in ``dtype``.
    """
    fixed = [None if i in pool else _fast.centered_factor(G, w, eps, H)
             for i, (G, w) in enumerate(zip(grams, widths))]
    dof = grams[0].shape[0] - 1

    def run(idx, omega, finish):
        def factors():
            Ls = [_fast.centered_factor(grams[i][idx][:, idx], widths[i],
                                        eps, H) if L is None else L
                  for i, L in enumerate(fixed)]
            return Ls[0], Ls[-1]

        La, Lb, _, U, s, V = _fast._chol_reduce(factors, dof, omega, k,
                                                n_iter, form=False,
                                                route='stored')

        def weight(i):
            return _resample_weights((La, Lb)[i], (U, V)[i], H, dtype,
                                     idx if fixed[i] is None else None)

        return finish(s, weight)

    return run


def _stored_runs(fields, pool, draw_rows, start, k, H, rotated, power, tol,
                 subspace_iters):
    """The run of :func:`bootstrap_spectra`'s stored route: forms each
    field's Gram now (a ``gram`` span of the call, outside its runs) and
    factors every side no run resamples (:func:`_time_resample_runs`);
    returns ``run(gen)`` -> ``(variance, converged)`` of one time
    resample drawn from ``gen``.

    ``draw_rows(gen)`` and ``start(gen)`` draw a run's block indices
    (None where ``pool`` is empty) and its start block for ``k`` modes;
    ``H`` is the Hilbert operator of the analytic fold, None for fields
    solved as given.  A univariate model's one field stands on both
    sides.
    """
    sides = fields[:2]

    with trace.span('gram', route='stored'):
        grams = [_mesh.space_sum(_fast._data_dot(f, f.mH)) for f in sides]
        widths = [_mesh.space_total(f.shape[1], f.device) for f in sides]
        time_run = _time_resample_runs(grams, pool, widths,
                                       _fast._eps(sides[0].dtype), H, k,
                                       subspace_iters, sides[0].dtype)

    @trace.spanned('project')
    def back_project(i, weight):
        """``(C P X_i)^T S`` as ``X_i^T (P^T C S)``, the weights ``P^T C
        S`` of side i made here."""
        V = _fast._data_dot(sides[i].mH, weight(i))
        return V if H is None else _fast.combine_analytic_projection(V)

    def finish(s, weight):
        if not rotated:
            return s, True
        Vs = [back_project(i, weight) for i in range(len(sides))]
        var, conv, _ = _fast._rotated_variance(
            Vs[0], Vs[1] if len(Vs) == 2 else None, s, power, tol,
            'ns-gated')
        return var, conv

    def run(gen):
        idx = draw_rows(gen)
        omega = start(gen)
        return time_run(idx, omega, finish)

    return run
