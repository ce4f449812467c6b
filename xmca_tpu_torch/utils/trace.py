"""Spans and counters of the port's work, for an operator's profile.

Spans are recorded while a ``torch.profiler.profile`` is active, and only
then: the gate is the profiler's own flag, so there is no setting to
turn on.  An operator profiles a block and reads what the port did in
it::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        model.rule_n(16)
    torch.cuda.synchronize()
    for s in trace.spans():
        print(s['name'], s['attrs'], s['device_ms'])
    print(trace.counters()['host_syncs'])

* :func:`span` (a context manager) and :func:`spanned` (a decorator)
  record a stage: its id, its parent (the innermost open span), its name,
  its start and end on ``time.perf_counter_ns()``, its attributes and, on
  a card, a pair of CUDA events on the current stream, whose distance is
  the stage's ``device_ms`` (read when :func:`spans` is called, once the
  stream has passed them; no synchronize is added).  With no profiler a
  span is one shared no-op object, and its whole cost is the gate check.
* :func:`to_host` and :func:`to_device` are the port's blocking reads of
  a device value (``float``, ``bool``, ``.cpu()``, ...) and its blocking
  copies of host data to a device, each named by a ``site``.  They return
  what the bare call returns, always count ``host_syncs[site]`` (and
  ``h2d_bytes[site]`` for copies), on every device alike, and under a
  profiler also record a leaf span ``sync`` with the attribute ``site``
  and no events.
* :func:`counters` holds every count of the port: kernel ``launches`` by
  kernel (``ops._build.launch_counts`` is a view of them), ``collectives``
  and ``collective_bytes`` by operation (``parallel.mesh.
  collective_counts``), ``host_syncs`` and ``h2d_bytes`` by site, and
  bootstrap runs by the route of their Grams (``gram_routes``:
  ``'stored'`` or ``'data'``, :func:`xmca_tpu_torch.stats.significance.
  bootstrap_spectra`) and the series that boundary extension forecasts
  or backcasts, by method (``forecast_columns``: ``'exp'`` or
  ``'theta'``, :func:`xmca_tpu_torch.core.preprocess.extend_field`), and
  the n x n tail's reductions by whether they form the reduced kernel
  (``reduced_kernels``: ``'formed'`` where a caller takes totals from it,
  ``'factored'`` where the subspace SVD applies it through its factors,
  :func:`xmca_tpu_torch.core.fastpath._chol_reduce`), and the
  Newton-Schulz steps of the nuclear-norm totals by schedule
  (``ns_steps``: ``'exact'`` for a solve's total, ``'surrogate'`` for an
  unrotated ensemble run's, :func:`xmca_tpu_torch.core.fastpath.
  _nuclear`).
  They count with or without a profiler.
* :func:`keeping` opens a list for the intermediate values a site hands
  :func:`keep` under a name, for a caller that checks them (a benchmark's
  comparison with a reference); with no list open, :func:`keep` does
  nothing.  Sites: ``'rotated_svals'``, the singular values of each
  truncated solve that a rotation follows, as the rotation takes them
  (:func:`xmca_tpu_torch.core.fastpath._rotated_variance`: a bootstrap
  or Rule-N run of a rotated model).

Span times convert to the Unix clock with :func:`unix_ns`, from an
anchor (``time.time_ns()`` read between two ``perf_counter_ns()`` reads)
taken at the first span after import or :func:`clear`; the profiler's
device events are on that clock too.  The buffer holds the spans of this
process, at most :data:`MAX_SPANS`; :func:`dropped` counts the rest.
Spans are kept for one thread: the port issues its work from one.
"""
import collections
import contextlib
import functools
import time

import numpy as np
import torch

__all__ = ['MAX_SPANS', 'enabled', 'span', 'spanned', 'annotate', 'add',
           'to_host', 'to_device', 'count', 'counts', 'counters',
           'reset_counters', 'keep', 'keeping', 'spans', 'clear', 'dropped',
           'unix_ns']

MAX_SPANS = 1_000_000

_KINDS = ('launches', 'collectives', 'collective_bytes', 'host_syncs',
          'h2d_bytes', 'gram_routes', 'forecast_columns', 'reduced_kernels',
          'ns_steps')
_COUNTERS = {kind: collections.Counter() for kind in _KINDS}

# the lists keeping() holds open, by name
_KEPT = {}

# True while a torch.profiler.profile (or the autograd profiler) runs
enabled = torch._C._autograd._profiler_enabled

_perf_ns = time.perf_counter_ns
# open spans, innermost last; closed span records; the next id; spans
# dropped past MAX_SPANS; the clock anchor (perf ns, unix ns)
_state = {'open': [], 'done': [], 'next': 0, 'dropped': 0, 'anchor': None}


class _Record:
    __slots__ = ('id', 'parent', 'name', 'start_ns', 'end_ns', 'attrs',
                 'events', 'device_ms')

    def __init__(self, name, attrs):
        st = _state
        if st['anchor'] is None:
            p0 = _perf_ns()
            unix = time.time_ns()
            st['anchor'] = ((p0 + _perf_ns()) // 2, unix)
        self.id = st['next']
        st['next'] += 1
        self.parent = st['open'][-1].id if st['open'] else None
        self.name = name
        self.attrs = attrs
        self.events = None
        self.device_ms = None
        self.end_ns = None
        self.start_ns = _perf_ns()

    def set(self, **attrs):
        """Add attributes to the span before it closes."""
        self.attrs.update(attrs)


def _keep(rec):
    if len(_state['done']) < MAX_SPANS:
        _state['done'].append(rec)
    else:
        _state['dropped'] += 1


class _Span(_Record):
    __slots__ = ()

    def __enter__(self):
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, end)
        _state['open'].append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self.end_ns = _perf_ns()
        _state['open'].pop()
        _keep(self)
        return False


class _Off:
    """The span of an unprofiled block: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


def span(name, **attrs):
    """``with span(name, **attrs) as s:`` records the block as a stage
    (``s.set(...)`` adds attributes); a no-op without a profiler."""
    if not enabled():
        return _OFF
    return _Span(name, attrs)


def spanned(name, **attrs):
    """Decorator: every call of the function is a :func:`span` ``name``
    with initial attributes ``attrs``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with _Span(name, dict(attrs)):
                return fn(*args, **kwargs)
        return traced
    return wrap


def annotate(**attrs):
    """Set attributes of the innermost open span (none open: nothing)."""
    if _state['open']:
        _state['open'][-1].attrs.update(attrs)


def add(key, n):
    """Add ``n`` to the attribute ``key`` of the innermost open span."""
    if _state['open']:
        attrs = _state['open'][-1].attrs
        attrs[key] = attrs.get(key, 0) + n


def _sync_span(site, start_ns):
    rec = _Record('sync', {'site': site})
    rec.start_ns = start_ns
    rec.end_ns = _perf_ns()
    _keep(rec)


def to_host(x, site, read=None):
    """``read(x)`` (``float``, ``bool``, ``int``, ``torch.Tensor.tolist``,
    ...) or, without ``read``, ``x.cpu()``: a blocking read of a device
    value at ``site``."""
    _COUNTERS['host_syncs'][site] += 1
    if not enabled():
        return x.cpu() if read is None else read(x)
    t0 = _perf_ns()
    out = x.cpu() if read is None else read(x)
    _sync_span(site, t0)
    return out


def to_device(x, device, site, dtype=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)`` of host data
    ``x`` (an array or a tensor): a blocking copy to ``device`` at
    ``site``, its source bytes counted."""
    _COUNTERS['host_syncs'][site] += 1
    _COUNTERS['h2d_bytes'][site] += (
        x.numel() * x.element_size() if isinstance(x, torch.Tensor)
        else np.asarray(x).nbytes)
    if not enabled():
        return torch.as_tensor(x, dtype=dtype, device=device)
    t0 = _perf_ns()
    out = torch.as_tensor(x, dtype=dtype, device=device)
    _sync_span(site, t0)
    return out


def count(kind, key, n=1):
    """Add ``n`` to the counter ``kind`` (one of :func:`counters`' keys)
    at ``key``."""
    _COUNTERS[kind][key] += n


def counts(kind):
    """The counter ``kind`` as a dict."""
    return dict(_COUNTERS[kind])


def counters():
    """Every counter: ``{kind: {key: count}}``."""
    return {kind: dict(c) for kind, c in _COUNTERS.items()}


def reset_counters(*kinds):
    """Zero the counters ``kinds`` (all of them when none is named)."""
    for kind in kinds or _KINDS:
        _COUNTERS[kind].clear()


def keep(name, x):
    """Append a detached copy of the tensor ``x`` to the list open under
    ``name`` (:func:`keeping`), if one is; a dict lookup otherwise."""
    kept = _KEPT.get(name)
    if kept is not None:
        kept.append(x.detach().clone())


@contextlib.contextmanager
def keeping(name):
    """``with keeping(name) as kept:`` collects in ``kept``, in order,
    the copies :func:`keep` makes under ``name`` inside the block; they
    stay where they were made (no read, no copy to the host)."""
    if name in _KEPT:
        raise RuntimeError('already keeping {!r}'.format(name))
    kept = _KEPT[name] = []
    try:
        yield kept
    finally:
        del _KEPT[name]


def _device_ms(rec):
    if rec.device_ms is None and rec.events is not None:
        start, end = rec.events
        if end.query():
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
    return rec.device_ms


def spans():
    """The closed spans of this process, oldest first, as dicts: ``id``,
    ``parent`` (an id or None), ``name``, ``start_ns`` and ``end_ns``
    (``perf_counter_ns``), ``attrs`` and ``device_ms`` (None off a card,
    for a ``sync`` and while the stream has not passed the span's end)."""
    return [{'id': r.id, 'parent': r.parent, 'name': r.name,
             'start_ns': r.start_ns, 'end_ns': r.end_ns,
             'attrs': dict(r.attrs), 'device_ms': _device_ms(r)}
            for r in _state['done']]


def clear():
    """Empty the buffer; the next span takes a new clock anchor."""
    _state['done'] = []
    _state['dropped'] = 0
    _state['anchor'] = None


def dropped():
    """Spans not kept since the last :func:`clear` (the buffer was
    full)."""
    return _state['dropped']


def unix_ns(t):
    """A span time (``perf_counter_ns``) on the Unix clock, in ns; None
    before the first span."""
    anchor = _state['anchor']
    if anchor is None:
        return None
    return t - anchor[0] + anchor[1]
