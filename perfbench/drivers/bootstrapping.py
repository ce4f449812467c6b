"""``xMCA.bootstrapping(runs_per_call, seed=..., **kwargs)`` calls on
the model fitted in set-up; the unit of work is a bootstrap run.

The check draws runs from the window's calls and computes each again:
the moving-block resample of the left field in time, its solve and
varimax (:func:`perfbench.reference.mca.boot_run`).  ``boot_gap`` is
the widest relative gap of a run's rotated variances.  A run the
reference converges on and the program drops (zero), or one that is
not finite, is not correct.  The reference follows ``axis=0``,
``strategy='standard'``, the left field resampled with replacement, on
a complexified, rotated model.
"""
import sys
import time

import numpy as np

from perfbench.checks import rel, show
from perfbench.reference import mca

NEEDS_MODEL = True
COMPARED = ('boot_gap',)
# bootstrapping()'s keys and the values the reference follows
FOLLOWED = {'axis': (0,), 'strategy': ('standard',), 'on_left': (True,),
            'on_right': (False,), 'replace': (True,)}


def per_call(traffic):
    return int(traffic['runs_per_call'])


def call(c, seed):
    runs = per_call(c.traffic)
    out = c.model.bootstrapping(runs, seed=seed, **c.traffic['kwargs'])
    return runs, [{'seed': seed, 'n_runs': runs,
                   'out': np.asarray(out.values)}]


def blank(c, seed):
    runs = per_call(c.traffic)
    return [{'seed': seed, 'n_runs': runs,
             'out': np.full((c.traffic['kwargs']['n_modes'], runs),
                            np.nan)}]


def reference_run(ref, rec, r):
    """``(rotated variances, converged)`` of run ``r`` of a record."""
    kw = ref.tr['kwargs']
    for key, values in FOLLOWED.items():
        if kw.get(key, values[0]) not in values:
            raise ValueError('the bootstrap reference follows {}={!r}'
                             .format(key, values[0]))
    if ref.A is None or ref.rotate_tol is None:
        raise ValueError('the bootstrap reference needs a complexified, '
                         'rotated model')
    if 'fields' not in ref.cache:
        ref.cache['fields'] = ref.fields()
    s = mca.run_seeds(rec['seed'], rec['n_runs'])[r]
    t0 = time.perf_counter()
    var, conv, G = mca.boot_run(
        ref.cache['fields'], s, kw['block_size'], ref.dt, ref.A,
        right_gram=ref.cache.get('right_gram'), k=ref.k,
        n_iter=ref.cfg['subspace_iters'], tol=ref.cfg['bootstrap']['tol'])
    ref.cache['right_gram'] = G
    print('reference run {:.3f} s'.format(time.perf_counter() - t0),
          file=sys.stderr)
    return var, conv


def fill(ref, rec, r):
    var = reference_run(ref, rec, r)[0]
    rec['out'][:, r] = var[:rec['out'].shape[0]]


def compare(ref, records, picks):
    boot_gap = 0.0
    notes = []
    for ci, r in picks:
        rec = records[ci]
        want, conv = reference_run(ref, rec, r)
        got = rec['out'][:, r]
        if not conv:
            notes.append('call {} run {}: the reference did not '
                         'converge'.format(ci, r))
            continue
        if not np.any(got):
            notes.append('call {} run {} was dropped'.format(ci, r))
            continue
        if not np.all(np.isfinite(got)):
            notes.append('call {} run {} is not finite'.format(ci, r))
            continue
        show('call {} run {}'.format(ci, r), variance=(got, want[:len(got)]))
        boot_gap = max(boot_gap, rel(got, want[:len(got)]))
    return {'boot_gap': boot_gap}, notes
