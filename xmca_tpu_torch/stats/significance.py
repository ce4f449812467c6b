"""Rule-N, bootstrapping and North's rule on tensors.

Counterpart of ``xmca_tpu/stats/significance.py``.

Rule-N runs the generated-surrogate path: each run draws its +-1 fields
with the draw kernel, forms their Grams with the syrk kernel and solves /
rotates them (``core.fastpath.fast_surrogate_variance_tri``).  Runs go
one after another on one device, with the JAX package's seed plumbing:
run ``r`` of seed ``s`` uses ``(s * 2654435761 + r) mod 2^32``, and its
fields the seeds ``2 s_r`` and ``2 s_r + 1``.

Bootstrapping resamples the model's own (centered, preprocessed) fields
in moving blocks and solves each resample with :func:`_surrogate_variance`
(the fast chol/subspace pipeline or the exact one).  Each run draws its
block indices, then its subspace start block, from a CPU
``torch.Generator`` seeded with its run seed, so the card and the CPU
resample identically.  The JAX package's vmapped batches are XLA
scheduling and have no counterpart here.
"""
import numpy as np
import torch

from xmca_tpu_torch.core import fastpath as _fast
from xmca_tpu_torch.core.preprocess import complexify as _complexify
from xmca_tpu_torch.core.solver import solve_rotated_variance, solve_svals

__all__ = ['run_seeds', 'rule_n_generated', 'rule_north_uncertainty',
           'bootstrap_spectra']


def run_seeds(seed, n_runs):
    """Per-run uint32 seeds, as the JAX package derives them."""
    base = (int(seed) * 2654435761) % (2 ** 32)
    return [(base + r) % (2 ** 32) for r in range(n_runs)]


def rule_n_generated(n_obs, n_vars, n_runs, *, complexify, rotated, n_rot,
                     power, tol, seed, n_modes_fast, subspace_iters,
                     polar_method, device, H=None, grade='fast'):
    """Rule-N surrogate spectra from generated +-1 fields.

    Returns ``(spectra, totals, n_iter)`` as numpy: spectra
    (n_kept_runs, n_modes) with non-converged runs dropped, the per-run
    rescaling totals, and every run's rotation iteration count (kept or
    not).  Each run's subspace start block comes from a
    ``torch.Generator`` seeded with the run seed.
    """
    n_vars = tuple(int(p) for p in n_vars)
    k = n_rot if rotated else n_modes_fast
    spectra, totals, keep, iters = [], [], [], []
    for s in run_seeds(seed, n_runs):
        gen = torch.Generator(device=device).manual_seed(s)
        omega = _fast.start_block(
            n_obs, k, torch.complex64 if complexify else torch.float32, gen)
        var, total, conv, n_it = _fast.fast_surrogate_variance_tri(
            s, omega, n_obs, n_vars, H=H, complexify=complexify,
            rotated=rotated, n_rot=k, power=power, tol=tol,
            n_iter=subspace_iters, polar_method=polar_method, grade=grade,
        )
        spectra.append(var)
        totals.append(total)
        keep.append(bool(conv))
        iters.append(n_it)
    spectra = torch.stack(spectra).cpu().numpy()
    totals = torch.stack(totals).cpu().numpy()
    keep = np.asarray(keep, dtype=bool)
    return spectra[keep], totals[keep], np.asarray(iters)


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
    """
    fields = [f - f.mean(dim=0) for f in fields]
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


def bootstrap_spectra(fields, n_runs, n_out_modes, *, axis=0, on_left=True,
                      on_right=False, block_size=1, replace=True,
                      complexify=False, rotated=False, n_rot=0, power=1,
                      tol=1e-8, method='gram', seed=None, spectrum='exact',
                      subspace_iters=12, hilbert_H=None):
    """One round of (moving-block) bootstrap spectra of ``fields``.

    Each run resamples the given fields (not the previous run's
    resample): ``axis=0`` resamples time steps, jointly when both fields
    are resampled; ``axis=1`` resamples columns, of the concatenated
    fields when both are.  It then solves (and rotates) the resample with
    :func:`_surrogate_variance` and the convergence-gated polar.
    ``hilbert_H`` is the model's Hilbert operator (the fast complexified
    spectrum needs it).

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

    def _check(length):
        if length % block_size != 0:
            raise ValueError(
                'Length of data array ({:}) must be a multiple of block '
                'size {:}'.format(length, block_size)
            )

    if on_left or on_right:
        if axis == 0:
            _check(fields[0].shape[0])
        elif on_left and on_right:
            _check(sum(f.shape[1] for f in fields))
        else:
            _check(fields[0].shape[1] if on_left else fields[1].shape[1])

    n_obs = int(fields[0].shape[0])
    device = fields[0].device
    real = fields[0].real.dtype

    def resample(gen, fs):
        if not (on_left or on_right):
            return fs
        if axis == 0:
            idx = _block_indices(gen, n_obs, block_size, replace).to(device)
            return [f[idx] if (i == 0 and on_left) or (i == 1 and on_right)
                    else f for i, f in enumerate(fs)]
        if on_left and on_right:
            w = fs[0].shape[1]
            idx = _block_indices(gen, w + fs[1].shape[1], block_size,
                                 replace).to(device)
            mixed = torch.cat(fs, dim=1)[:, idx]
            return [mixed[:, :w], mixed[:, w:]]
        i = 0 if on_left else 1
        idx = _block_indices(gen, fs[i].shape[1], block_size,
                             replace).to(device)
        return [f[:, idx] if j == i else f for j, f in enumerate(fs)]

    spectra, converged = [], []
    for s in run_seeds(seed, n_runs):
        gen = torch.Generator().manual_seed(s)
        fs = resample(gen, list(fields))
        omega = None
        if spectrum == 'fast':
            k = n_rot if rotated else n_out_modes
            omega = _fast.start_block(n_obs, k, real, gen).to(device)
        var, _, conv = _surrogate_variance(
            fs, complexify, rotated, n_rot, power, tol, method,
            spectrum=spectrum, n_modes_fast=n_out_modes,
            subspace_iters=subspace_iters, omega=omega, hilbert_H=hilbert_H,
            # resamples of REAL data can have a large mode-variance
            # spread: the convergence-gated polar, as in the JAX package
            polar_method='ns-gated')
        spectra.append(var[:n_out_modes].to(torch.float64))
        converged.append(conv)
    return (torch.stack(spectra).cpu().numpy(),
            np.asarray(converged, dtype=bool))
