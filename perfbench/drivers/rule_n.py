"""``xMCA.rule_n(runs_per_call, seed=...)`` calls on the model fitted in
set-up; the unit of work is a Rule-N run.

The check draws runs from the window's calls and computes each again:
two +-1 surrogate fields from the frozen draw, the model's solve and
varimax (:func:`perfbench.reference.mca.rulen_run`), rescaled to the
reference model's rotated total.  ``run_gap`` is the widest relative
gap over the modes between a run's spectrum over its sum and the
reference run's; ``scale_gap`` the relative gap between the run's sum
and the reference model's rotated total.  A call that dropped a run, a
run that is not finite, or one the reference does not converge on is
not correct.  The reference follows the package's default +-1
surrogates ('generated', spectrum 'fast'; the configuration's
``rule_n`` lists them) on a rotated model.
"""
import sys
import time

import numpy as np

from perfbench.calls import MODEL, derive
from perfbench.checks import rel, show
from perfbench.reference import mca

NEEDS_MODEL = True
COMPARED = ('run_gap', 'scale_gap')


def per_call(traffic):
    return int(traffic['runs_per_call'])


def call(c, seed):
    runs = per_call(c.traffic)
    out = c.model.rule_n(runs, seed=seed)
    return runs, [{'seed': seed, 'n_runs': runs,
                   'out': np.asarray(out.values)}]


def blank(c, seed):
    runs = per_call(c.traffic)
    return [{'seed': seed, 'n_runs': runs,
             'out': np.full((c.n_modes, runs), np.nan)}]


def model_total(ref):
    """The reference model's rotated total, which each run is rescaled
    to."""
    if 'total' not in ref.cache:
        if ref.rotate_tol is None:
            raise ValueError('the Rule-N reference needs a rotated model')
        model = ref.fit(derive(ref.c.seed, MODEL), with_total=False)
        ref.cache['total'] = float(np.sum(model['variance']))
    return ref.cache['total']


def reference_run(ref, rec, r):
    """``(spectrum rescaled to the model's total, converged)`` of run
    ``r`` of a record."""
    e = ref.cfg['rule_n']
    s = mca.run_seeds(rec['seed'], rec['n_runs'])[r]
    t0 = time.perf_counter()
    var, conv = mca.rulen_run(s, ref.n, (ref.p, ref.p), ref.dt, ref.device,
                              ref.A, k=ref.k, n_iter=e['subspace_iters'],
                              tol=e['tol'], jitter_rel=e['jitter_rel'])
    print('reference run {:.3f} s'.format(time.perf_counter() - t0),
          file=sys.stderr)
    return var / var.sum() * model_total(ref), conv


def fill(ref, rec, r):
    rec['out'][:, r] = reference_run(ref, rec, r)[0]


def compare(ref, records, picks):
    total = model_total(ref)
    run_gap = scale_gap = 0.0
    notes = []
    for ci, r in picks:
        rec = records[ci]
        out = rec['out']
        if out.shape[1] != rec['n_runs']:
            notes.append('call {} kept {} of {} runs'.format(
                ci, out.shape[1], rec['n_runs']))
            continue
        want, conv = reference_run(ref, rec, r)
        if not conv:
            notes.append('call {} run {}: the reference did not '
                         'converge'.format(ci, r))
            continue
        got = out[:, r]
        if not np.all(np.isfinite(got)):
            notes.append('call {} run {} is not finite'.format(ci, r))
            continue
        show('call {} run {}'.format(ci, r),
             spectrum=(got / got.sum(), want / want.sum()))
        run_gap = max(run_gap, rel(got / got.sum(), want / want.sum()))
        scale_gap = max(scale_gap, abs(float(got.sum()) - total) / total)
    return {'run_gap': run_gap, 'scale_gap': scale_gap}, notes
