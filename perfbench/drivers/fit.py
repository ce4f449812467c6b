"""Whole fits from host fields: each call fits every one of the
traffic's ``items`` pairs of fields once, in an order drawn from the
call's seed, the previous model freed before the next is built; the
unit of work is a fit.

The fields' values set how long the rotation iterates, so the items
are the same for every seed (fields and solver seeds from fixed seeds)
and every call does the same work.  The check draws fits from the
window's calls and computes each again (the reference's fit):
``svals_gap`` and ``variance_gap``, the widest relative gaps of the
singular values and the variances of the configuration's
``resolved_modes`` leading modes (the modes the fields carry; the rest
lie in the noise, which the configured subspace rounds do not
resolve), and ``total_gap``, that of the spectrum's total (from the
explained variance).  A fit that is not finite is not correct.
"""
import numpy as np

from perfbench.calls import ITEM, derive
from perfbench.checks import rel, show

NEEDS_MODEL = False
COMPARED = ('svals_gap', 'variance_gap', 'total_gap')


def field_seeds(c):
    return [derive(0, ITEM, i) for i in range(int(c.traffic['items']))]


def per_call(traffic):
    return None


def _order(c, seed):
    rng = np.random.default_rng([abs(int(seed)), ITEM])
    return [int(i) for i in rng.permutation(int(c.traffic['items']))]


def call(c, seed):
    k = c.n_modes
    records = []
    for i in _order(c, seed):
        c.model = None               # the old model is freed first
        m = c.fit(derive(0, ITEM, i), item=i)
        records.append({'seed': derive(0, ITEM, i), 'item': i,
                        'svals': np.asarray(m.singular_values(k).values),
                        'variance': np.asarray(m.variance(k).values),
                        'explained': np.asarray(
                            m.explained_variance(k).values)})
        c.model = m
    return len(records), records


def blank(c, seed):
    return [{'seed': derive(0, ITEM, i), 'item': i, 'svals': None,
             'variance': None, 'explained': None} for i in _order(c, seed)]


def reference_fit(ref, rec):
    """The reference's fit of a record's item (computed once a check:
    every fit of an item is the same computation)."""
    key = ('fit', rec['item'], rec['seed'])
    if key not in ref.cache:
        ref.cache[key] = ref.fit(rec['seed'], item=rec['item'])
    return ref.cache[key]


def fill(ref, rec, r):
    m = reference_fit(ref, rec)
    rec.update(svals=m['svals'], variance=m['variance'],
               explained=m['variance'] / m['total'] * 100.0)


def compare(ref, records, picks):
    gaps = {'svals_gap': 0.0, 'variance_gap': 0.0, 'total_gap': 0.0}
    lead = slice(0, int(ref.cfg['resolved_modes']))
    notes = []
    for ci, _ in picks:
        rec = records[ci]
        if not all(np.all(np.isfinite(rec[k])) for k in
                   ('svals', 'variance', 'explained')):
            notes.append('fit {} is not finite'.format(ci))
            continue
        m = reference_fit(ref, rec)
        total = rec['variance'] / rec['explained'] * 100.0
        show('fit {}'.format(ci), svals=(rec['svals'], m['svals']),
             variance=(rec['variance'], m['variance']))
        gaps['svals_gap'] = max(gaps['svals_gap'], rel(
            rec['svals'][lead], m['svals'][lead]))
        gaps['variance_gap'] = max(gaps['variance_gap'], rel(
            rec['variance'][lead], m['variance'][lead]))
        gaps['total_gap'] = max(gaps['total_gap'], rel(total, m['total']))
    return gaps, notes
