"""``xMCA.rule_n(runs_per_call, seed=...)`` calls on an unrotated model
fitted in set-up; the unit of work is a Rule-N run.  The calls, their
records and what a record holds are the rotated driver's
(:mod:`perfbench.drivers.rule_n`).

An unrotated run's spectrum is the top singular values of its reduced
kernel ``M``, and the package rescales it by the model's total (the
solve's nuclear norm) over the run's own total, ``M``'s nuclear norm by
a Newton-Schulz iteration on a 1e-4 schedule.  The check draws runs from
the window's calls and computes each again
(:func:`perfbench.reference.rulen_unrot.rulen_unrot_run`), with the
exact nuclear norms of the run's ``M`` and of the reference model's
(:func:`perfbench.reference.mca.fit`, unrotated).  ``run_gap`` is the
widest relative gap over the modes between a run's spectrum over its sum
and the reference run's; ``scale_gap`` the relative gap between the
run's rescaled sum, which holds the iterative total, and the reference
run's, which holds the exact one.  A call that dropped a run, or a run
that is not finite, is not correct.
"""
import sys
import time

import numpy as np

from perfbench.calls import MODEL, derive
from perfbench.checks import rel, show
from perfbench.drivers.rule_n import (NEEDS_MODEL, blank,  # noqa: F401
                                      call, per_call)
from perfbench.reference.mca import run_seeds
from perfbench.reference.rulen_unrot import rulen_unrot_run

COMPARED = ('run_gap', 'scale_gap')


def model_total(ref):
    """The reference model's exact total, the nuclear norm of its reduced
    kernel, which each run is rescaled by."""
    if 'total' not in ref.cache:
        if ref.rotate_tol is not None:
            raise ValueError('the unrotated Rule-N reference needs an '
                             'unrotated model')
        ref.cache['total'] = ref.fit(derive(ref.c.seed, MODEL),
                                     with_total=True)['total']
    return ref.cache['total']


def reference_run(ref, rec, r):
    """Run ``r`` of a record: its top singular values times the model's
    total over the run's own."""
    e = ref.cfg['rule_n']
    s = run_seeds(rec['seed'], rec['n_runs'])[r]
    t0 = time.perf_counter()
    vals, total = rulen_unrot_run(s, ref.n, (ref.p, ref.p), ref.dt,
                                  ref.device, ref.A, k=ref.k,
                                  n_iter=e['subspace_iters'],
                                  jitter_rel=e['jitter_rel'])
    print('reference run {:.3f} s'.format(time.perf_counter() - t0),
          file=sys.stderr)
    return vals * (model_total(ref) / total)


def fill(ref, rec, r):
    rec['out'][:, r] = reference_run(ref, rec, r)


def compare(ref, records, picks):
    run_gap = scale_gap = 0.0
    notes = []
    for ci, r in picks:
        rec = records[ci]
        out = rec['out']
        if out.shape[1] != rec['n_runs']:
            notes.append('call {} kept {} of {} runs'.format(
                ci, out.shape[1], rec['n_runs']))
            continue
        got = out[:, r]
        if not np.all(np.isfinite(got)):
            notes.append('call {} run {} is not finite'.format(ci, r))
            continue
        want = reference_run(ref, rec, r)
        show('call {} run {}'.format(ci, r),
             spectrum=(got / got.sum(), want / want.sum()))
        run_gap = max(run_gap, rel(got / got.sum(), want / want.sum()))
        scale_gap = max(scale_gap, rel(got.sum(), want.sum()))
    return {'run_gap': run_gap, 'scale_gap': scale_gap}, notes
