"""Rule-N and North's rule on tensors.

Counterpart of the generated-surrogate Rule-N path of
``xmca_tpu/stats/significance.py``: each run draws its +-1 fields with
the draw kernel, forms their Grams with the syrk kernel and solves /
rotates them (``core.fastpath.fast_surrogate_variance_tri``).
Runs go one after another on one device, with the JAX package's seed
plumbing: run ``r`` of seed ``s`` uses ``(s * 2654435761 + r) mod 2^32``,
and its fields the seeds ``2 s_r`` and ``2 s_r + 1``.
"""
import numpy as np
import torch

from xmca_tpu_torch.core import fastpath as _fast

__all__ = ['run_seeds', 'rule_n_generated', 'rule_north_uncertainty']


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
