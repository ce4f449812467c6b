"""``xMCA.bootstrapping(runs_per_call, seed=..., **kwargs)`` calls on a
model solved with boundary extension; the unit of work is a bootstrap
run.

The model is ``pipeline`` with the configuration's top-level
``extension`` added to its ``solve``: ``xMCA(left, right)`` ->
``set_solver(**set_solver, seed=derive(seed, MODEL))`` -> ``normalize()``
-> ``apply_coslat()`` -> ``solve(**solve, **extension)`` ->
``rotate(**rotate)``.  The shared fit (:meth:`perfbench.calls.Calls.fit`)
passes ``solve`` as it stands, and the check's guard
(:func:`perfbench.checks.follow`) takes no extension there, so this
driver fits the model itself, in its first call: a warm-up of one run
(a run's shapes are the same in every call), whose time falls in
set-up.  A window call never fits; one that would raises.

Each call also keeps, run by run, the singular values the program's
rotation starts from (``xmca_tpu_torch.utils.trace.keeping``, site
``'rotated_svals'``); a package without that site cannot run the cell,
and its first call raises before the fit.

The check draws runs from the window's calls and computes each again
(:func:`perfbench.reference.theta.boot_run`): the moving-block resample
of the left field in time, both fields re-extended by the theta method
and complexified, solved and rotated.  ``boot_gap`` is the widest
relative gap of a run's rotated variances, ``svals_gap`` the widest gap
of its singular values ahead of the rotation over the leading one
(:func:`lead_gap`): a rotation stopping a step apart moves the first
(up to 2.4e-3) and not the second, which every run of the TF32 control
moves.  A run the reference does not converge on, one the
program drops (zero), or one that is not finite, is not correct.  The
reference follows ``axis=0``, ``strategy='standard'``, the left field
resampled with replacement, on a complexified, rotated model extended
by 'theta'.
"""
import sys
import time

import numpy as np
import torch

from perfbench.calls import MODEL, WARMUP, derive
from perfbench.checks import rel, show
from perfbench.drivers import bootstrapping as _boot
from perfbench.reference import mca, theta

NEEDS_MODEL = False
COMPARED = ('boot_gap', 'svals_gap')
# the program's site that keeps each run's singular values
KEPT = 'rotated_svals'
per_call = _boot.per_call


def blank(c, seed):
    recs = _boot.blank(c, seed)
    for rec in recs:
        rec['svals'] = np.full((c.n_modes, rec['n_runs']), np.nan)
    return recs


def fit(c):
    """The extended model of the cell's fields (pair 0)."""
    from xmca_tpu_torch.xarray import xMCA
    p = c.config['pipeline']
    m = xMCA(*c.fields[0], device=c.device)
    m.set_solver(seed=derive(c.seed, MODEL), **p['set_solver'])
    if p.get('normalize'):
        m.normalize()
    if p.get('apply_coslat'):
        m.apply_coslat()
    m.solve(**p['solve'], **c.config['extension'])
    if p.get('rotate'):
        m.rotate(**p['rotate'])
    return m


def call(c, seed):
    from xmca_tpu_torch.utils import trace
    if not hasattr(trace, 'keeping'):
        raise RuntimeError('boot_extended: this package keeps no singular '
                           'values of a run (trace.keeping), which the '
                           'check compares')
    runs = per_call(c.traffic)
    if c.model is None:
        warmups = {derive(c.seed, WARMUP, k)
                   for k in range(int(c.traffic.get('warmup_calls', 1)))}
        if seed not in warmups:
            raise RuntimeError('boot_extended: a window call would fit the '
                               'model; the first call must be a warm-up')
        t0 = time.perf_counter()
        c.model = fit(c)
        print('boot_extended: fit {:.4f} s (host clock, in the warm-up)'
              .format(time.perf_counter() - t0), file=sys.stderr)
        runs = 1
    with trace.keeping(KEPT) as kept:
        out = c.model.bootstrapping(runs, seed=seed, **c.traffic['kwargs'])
    svals = np.full((c.n_modes, runs), np.nan)
    if len(kept) == runs:
        got = torch.stack([v[:c.n_modes] for v in kept], dim=1)
        svals[:got.shape[0]] = got.to(torch.float64).cpu().numpy()
    return runs, [{'seed': seed, 'n_runs': runs,
                   'out': np.asarray(out.values), 'svals': svals}]


def reference_run(ref, rec, r):
    """``(rotated variances, converged, singular values)`` of run ``r``
    of a record."""
    kw = ref.tr['kwargs']
    for key, values in _boot.FOLLOWED.items():
        if kw.get(key, values[0]) not in values:
            raise ValueError('the bootstrap reference follows {}={!r}'
                             .format(key, values[0]))
    ext = ref.cfg['extension']
    if ext.get('extend') != 'theta':
        raise ValueError('the extension reference follows extend=theta')
    if not ref.complexify or ref.rotate_tol is None:
        raise ValueError('the bootstrap reference needs a complexified, '
                         'rotated model')
    if 'fields' not in ref.cache:
        ref.cache['fields'] = ref.fields()
    s = mca.run_seeds(rec['seed'], rec['n_runs'])[r]
    t0 = time.perf_counter()
    var, conv, right, svals = theta.boot_run(
        ref.cache['fields'], s, kw['block_size'], int(ext['period']),
        ref.dt, right=ref.cache.get('right'), k=ref.k,
        n_iter=ref.cfg['subspace_iters'], tol=ref.cfg['bootstrap']['tol'])
    ref.cache['right'] = right
    print('reference run {:.3f} s'.format(time.perf_counter() - t0),
          file=sys.stderr)
    return var, conv, svals


def fill(ref, rec, r):
    var, _, svals = reference_run(ref, rec, r)
    rec['out'][:, r] = var[:rec['out'].shape[0]]
    rec['svals'][:, r] = svals[:rec['svals'].shape[0]]


def compare(ref, records, picks):
    boot_gap = svals_gap = 0.0
    notes = []
    for ci, r in picks:
        rec = records[ci]
        want, conv, want_s = reference_run(ref, rec, r)
        got = rec['out'][:, r]
        got_s = np.sort(rec['svals'][:, r])[::-1]
        if not conv:
            notes.append('call {} run {}: the reference did not '
                         'converge'.format(ci, r))
            continue
        if not np.any(got):
            notes.append('call {} run {} was dropped'.format(ci, r))
            continue
        if not (np.all(np.isfinite(got)) and np.all(np.isfinite(got_s))):
            notes.append('call {} run {} is not finite'.format(ci, r))
            continue
        want, want_s = want[:len(got)], want_s[:len(got_s)]
        show('call {} run {}'.format(ci, r), variance=(got, want))
        boot_gap = max(boot_gap, rel(got, want))
        svals_gap = max(svals_gap, lead_gap(got_s, want_s,
                                            'call {} run {}'.format(ci, r)))
    return {'boot_gap': boot_gap, 'svals_gap': svals_gap}, notes


def lead_gap(got, ref, what=None):
    """The widest gap of singular values ``got`` from ``ref`` over the
    leading one of ``ref``.  A perturbation E of a matrix moves each of
    its singular values by at most ||E||_2 (Weyl), so roundoff of the
    reduced kernel moves every mode by about as much, and a trailing
    mode's own relative gap grows as its value falls: measured against
    the leading value, the gap is the same for every mode."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    gaps = np.abs(got - ref) / abs(ref[0])
    if what is not None:
        print('reading {} svals over the lead: {}'.format(what, ' '.join(
            '{:.2e}'.format(g) for g in gaps)), file=sys.stderr)
    return float(np.max(gaps))
