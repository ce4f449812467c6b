"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
of the window's answers, drawn from the run's seed, is computed again by
the reference (:mod:`perfbench.reference`) from the same inputs, and
each compared number is held to its limit from the workload file
(``workloads/<cell>.json``, ``check.limits``).  What is compared is the
cell's driver's (``drivers/<name>.py``: ``compare``); this module draws
the sample and gives the driver the reference's view of the cell.
``precision`` runs the reference in float64 or, for the control, in
float32 with TF32 products.
"""
import contextlib
import sys
import time

import numpy as np
import torch

from perfbench.reference import mca

SAMPLE_KEY = 0xC4EC


@contextlib.contextmanager
def precision(name):
    """``'float64'`` or ``'tf32'`` (float32 with TF32 products); yields
    the real dtype."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = name == 'tf32'
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield torch.float32 if tf32 else torch.float64
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def samples(records, seed, count, per_call):
    """``[(record index, run index or None), ...]``: ``count`` answers
    drawn from the seed, in distinct records while there are enough of
    them (``per_call``: runs a record holds, or None for one answer)."""
    rng = np.random.default_rng([abs(int(seed)), SAMPLE_KEY])
    if not records:
        return []
    calls = rng.permutation(len(records))
    out = []
    for i in range(count):
        ci = int(calls[i % len(calls)])
        r = None if per_call is None else int(rng.integers(per_call))
        out.append((ci, r))
    return out


def show(what, **pairs):
    """Each mode's relative gap of each pair ``(got, ref)``, on standard
    error: the readings a limit is set from."""
    for name, (got, ref) in pairs.items():
        gaps = np.abs(np.asarray(got, np.float64) - ref) / np.abs(ref)
        print('reading {} {}: {}'.format(what, name, ' '.join(
            '{:.2e}'.format(g) for g in gaps)), file=sys.stderr)


def rel(got, ref):
    """The widest relative gap of ``got`` from ``ref``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


# the pipeline's keys the reference follows; another is refused, so
# that a configuration the reference does not compute is never judged
_PIPELINE = {'set_solver': {'truncate'}, 'solve': {'complexify'},
             'rotate': {'n_rot', 'power', 'tol'}}


def follow(pipe):
    """Raise ``ValueError`` for a pipeline the reference does not
    compute."""
    for key, allowed in _PIPELINE.items():
        extra = set(pipe.get(key) or {}) - allowed
        if extra:
            raise ValueError('the reference does not follow {}({})'
                             .format(key, ', '.join(sorted(extra))))
    if (pipe.get('rotate') or {}).get('power', 1) != 1:
        raise ValueError('the reference rotates by varimax only')


class Reference:
    """The reference's view of a cell: its configuration, its inputs as
    the pipeline prepares them, the model's fit, and a ``cache`` for
    what a driver computes once a check."""

    def __init__(self, calls, dt, device):
        self.c = calls
        self.cfg, self.tr = calls.config, calls.traffic
        self.pipe = self.cfg['pipeline']
        follow(self.pipe)
        rot = self.pipe.get('rotate')
        self.dt, self.device = dt, device
        self.n = self.cfg['n_obs']
        self.p = self.cfg['n_lat'] * self.cfg['n_lon']
        self.k = calls.n_modes
        self.rotate_tol = rot.get('tol', 1e-8) if rot else None
        self.complexify = bool(self.pipe['solve'].get('complexify'))
        self.cache = {}
        self._A = None

    @property
    def A(self):
        """The analytic-signal matrix, or None for a real solve."""
        if self.complexify and self._A is None:
            self._A = mca.analytic_matrix(self.n, self.dt, self.device)
        return self._A

    def fields(self, item=0):
        """The prepared left and right fields of pair ``item``."""
        return [mca.Field(h, self.c.lat, self.dt, self.device,
                          normalize=bool(self.pipe.get('normalize')),
                          coslat=bool(self.pipe.get('apply_coslat')))
                for h in self.c.host[item]]

    def fit(self, solver_seed, item=0, with_total=True):
        t0 = time.perf_counter()
        out = mca.fit(self.fields(item), solver_seed, self.c.device,
                      self.dt, self.device, k=self.k,
                      n_iter=self.cfg['subspace_iters'],
                      tol=self.rotate_tol, A=self.A, with_total=with_total)
        print('reference fit {:.3f} s'.format(time.perf_counter() - t0),
              file=sys.stderr)
        return out


def compare(calls, records, seed, check, device):
    """``(numbers, notes)``: each compared number as ``{name: value}``
    and any answer that could not be compared, as text (each one makes
    the run not correct)."""
    drv = calls.driver
    picks = samples(records, seed, int(check['samples']),
                    drv.per_call(calls.traffic))
    with precision('float64') as dt:
        return drv.compare(Reference(calls, dt, device), records, picks)
