"""The one traffic generator: closed-loop public calls of the package.

A traffic file (``traffic/<name>.json``) is data: the name of a driver
(``drivers/<driver>.py``) and its parameters.  This module does what
every cell shares: it draws the fields, builds the model through the
configuration's pipeline, warms up and sends the window's calls, one at
a time, each with a new seed derived from the run's seed.  The driver
says what one call is, what it records, and how the check recomputes
it (see :mod:`perfbench.drivers`).

A fit passes the configuration's ``pipeline`` to the public calls as it
stands: ``xMCA(left, right)`` -> ``set_solver(**set_solver, seed=...)``
-> ``normalize()`` (if true) -> ``apply_coslat()`` (if true) ->
``solve(**solve)`` -> ``rotate(**rotate)`` (if given).
"""
import importlib
import time

import numpy as np


def derive(seed, *keys):
    """A 31-bit seed derived from the run's seed and ``keys`` (whole
    numbers; the same arguments give the same seed)."""
    words = [abs(int(seed)), int(seed < 0)] + [int(k) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1)[0] >> 1)


# keys of derive(): the model's solver seed, the warm-up calls, the
# window's calls, and fixed items of a driver (fields that every seed
# shares)
MODEL, WARMUP, CALL, ITEM = 1, 2, 3, 4


def driver(name):
    """The driver module ``perfbench/drivers/<name>.py``."""
    return importlib.import_module('perfbench.drivers.' + name)


def _sync(device):
    import torch
    if str(device).startswith('cuda'):
        torch.cuda.synchronize()


class Calls:
    """A cell's inputs, its fitted model and its calls.

    ``spans``, when given, collects the host seconds of each stage of a
    fit (each ending in a device synchronize, which untraced runs do not
    add)."""

    def __init__(self, config, traffic, seed, device='cuda'):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.driver = driver(traffic['driver'])
        self.model = None
        self.records = []
        self.spans = None
        self.host = None
        # host seconds of each step of the set-up
        self.setup_walls = {}

    @property
    def n_modes(self):
        """The modes a fit keeps: the rotated ones, else the truncation."""
        p = self.config['pipeline']
        if p.get('rotate'):
            return int(p['rotate']['n_rot'])
        return int(p['set_solver']['truncate'])

    # -------------------------------------------------------------- set-up
    def field_seeds(self):
        """The field seed of each pair of fields the calls use: the
        driver's, else the run's seed."""
        own = getattr(self.driver, 'field_seeds', None)
        return own(self) if own else [self.seed]

    def make_fields(self):
        """The cell's pairs of fields, drawn on the device from their
        seeds and kept as the host DataArrays a user passes
        (``self.host[i]``, ``self.fields[i]``: pair i)."""
        from perfbench.fields import coords, host_fields
        from xmca_tpu_torch.xarray import DataArray
        c = self.config
        crd = coords(c)
        self.host, self.fields = [], []
        for s in self.field_seeds():
            pair = host_fields(c['n_obs'], c['n_lat'], c['n_lon'], s,
                               self.device)
            self.host.append(pair)
            self.fields.append([DataArray(h, dims=('time', 'lat', 'lon'),
                                          coords=crd) for h in pair])
        self.lat = crd['lat']

    def _stage(self, name, fn):
        if self.spans is None:
            return fn()
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def fit(self, solver_seed, item=0):
        """One fit of the host fields of pair ``item`` through the
        configuration's pipeline; returns the model."""
        from xmca_tpu_torch.xarray import xMCA
        p = self.config['pipeline']
        m = self._stage('ingest', lambda: xMCA(*self.fields[item],
                                               device=self.device))

        def solve():
            m.set_solver(seed=solver_seed, **p['set_solver'])
            if p.get('normalize'):
                m.normalize()
            if p.get('apply_coslat'):
                m.apply_coslat()
            m.solve(**p['solve'])
        self._stage('solve', solve)
        if p.get('rotate'):
            self._stage('rotate', lambda: m.rotate(**p['rotate']))
        return m

    def setup(self):
        """Fields, the model (where the driver calls a fitted one) and
        the warm-up calls, which use seeds the window never uses."""
        def step(name, fn):
            t0 = time.perf_counter()
            fn()
            _sync(self.device)
            self.setup_walls[name] = time.perf_counter() - t0

        step('fields', self.make_fields)
        if self.driver.NEEDS_MODEL:
            self.model_seed = derive(self.seed, MODEL)
            step('fit', lambda: setattr(self, 'model',
                                        self.fit(self.model_seed)))
        for k in range(int(self.traffic.get('warmup_calls', 1))):
            step('warm-up {}'.format(k), lambda: self._call(
                derive(self.seed, WARMUP, k), record=False))

    # --------------------------------------------------------------- calls
    def _call(self, s, record=True):
        units, records = self.driver.call(self, s)
        _sync(self.device)
        if record:
            self.records.extend(records)
        return units

    def call(self, k):
        """Window call ``k``; returns its units of work."""
        return self._call(derive(self.seed, CALL, k))

    def release(self):
        """Drop the model and the device's cached blocks (the fields'
        host arrays stay: the reference reads them)."""
        self.model = None
        if str(self.device).startswith('cuda'):
            import gc
            import torch
            gc.collect()
            torch.cuda.empty_cache()
