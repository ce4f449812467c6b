"""What the per-layer metrics of the program's own spans read
(``source: program_span``): the spans that ``xmca_tpu_torch.utils.trace``
records while a profiler runs, which the traced window's does.

The spans are on the host's ``perf_counter`` clock, which the package
converts to the Unix clock (``trace.unix_ns``).  The device trace keeps
each operation's ``ts`` in microseconds from a base the trace file names
but :class:`perfbench.trace.Activity` does not keep; the profiler puts
that base at a whole multiple of 7889238 s (a quarter of a year) or at
0, so :func:`analysis` takes the multiple that puts the device's first
operation inside the window's spans, give or take
:data:`BASE_SLACK_NS`.

The spans then go onto the device's clock.  The profiler stamps the
device's operations by a clock that can run off the host's at a steady
rate through a window (37 ppm in a traced Rule-N window on an H100, from
kernels stamped before their own launch calls), and the trace keeps no
launch calls to read that by.  The syncs do instead: each blocking read
or copy issues a copy between the host and the device and waits on it,
so its span holds that copy.  :func:`clock_fit` takes the offset and
the rate that put the most sync spans around a copy, and none where the
host's clock does as well.  A check follows: a sync returns once the stream
has drained, so no device operation that started before its end may end
after it, less :data:`CLOCK_SLACK_NS`.  Where the clock still wanders
the syncs there miss, so the check is local: an idle gap of the device
is read only where the syncs around it pass, the last one to end by the
gap's end and the first one to end after it.

Every reader returns None where the program records no spans (a program
without the trace module, or a trace with nothing in it).  Only
:func:`idle_after_sync` places spans on the device's clock; it also
returns None where no base fits or no gap has passing syncs around it.
The others read the spans' CUDA events, attributes, counts and host
times, which need no shared clock.
"""
import bisect
import sys

import numpy as np

QUARTER_NS = 7889238 * 10 ** 9
BASE_SLACK_NS = 10 ** 9
CLOCK_SLACK_NS = 50_000
# what clock_fit searches: rates (ppm) and offsets (ns) of the device's
# clock, over at most FIT_SYNCS syncs spread over the window
FIT_RATES_PPM = 500
FIT_OFFSETS_NS = 2_000_000
FIT_SYNCS = 4096

# the last analysis: (the activity it read, its result)
_last = [None, None]


def _program_spans():
    """``(spans, unix_ns)`` of the package's trace module, or None."""
    try:
        from xmca_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.spans(), trace.unix_ns


def find_base(first_op_ns, lo, hi):
    """The base (ns) that puts a device operation ``first_op_ns`` after
    its base inside ``[lo, hi]`` (Unix ns), give or take
    :data:`BASE_SLACK_NS`: 0 or a whole number of quarters; None if
    neither does."""
    lo, hi = lo - BASE_SLACK_NS, hi + BASE_SLACK_NS
    k = (lo - first_op_ns) // QUARTER_NS
    for base in (0, k * QUARTER_NS, (k + 1) * QUARTER_NS):
        if lo <= base + first_op_ns <= hi:
            return base
    return None


def device_intervals(activity, base):
    """Every device operation as ``(start, end)`` Unix ns, by start."""
    return [(base + round(1000 * s), base + round(1000 * (s + d)))
            for _, s, d in activity.ops]


def idle_gaps(ops):
    """The device's idle gaps ``(start, end)`` between consecutive
    operations, as :meth:`perfbench.trace.Activity.idle_gaps` finds
    them."""
    gaps, end = [], None
    for s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        if end is None or e > end:
            end = e
    return gaps


def clock_misses(ops, ends):
    """For each sync's end: by how much (ns) the latest end of the
    device operations that started before it passes it (negative: none
    does; None: no operation started before it)."""
    starts = [s for s, _ in ops]
    latest, top = [], None
    for _, e in ops:
        top = e if top is None else max(top, e)
        latest.append(top)
    out = []
    for e in ends:
        i = bisect.bisect_left(starts, e)
        out.append(latest[i - 1] - e if i else None)
    return out


def copies(activity, base):
    """The device's copies between host and device as ``(start, end)``
    Unix ns, by start."""
    return [(base + round(1000 * t), base + round(1000 * (t + d)))
            for n, t, d in activity.ops
            if n.startswith('Memcpy') and ('HtoD' in n or 'DtoH' in n)]


def spans_holding_copies(copy_starts, copy_ends, starts, ends):
    """How many spans ``[starts, ends]`` (arrays) hold a whole copy, of
    copies starting and ending at the sorted ``copy_starts`` and
    ``copy_ends``."""
    i = np.searchsorted(copy_starts, starts)
    j = np.minimum(i, len(copy_starts) - 1)
    return int(np.sum((i < len(copy_starts)) & (copy_ends[j] <= ends)))


def _best(values, score):
    """The value of ``values`` with the most ``score``: 0 where that
    ties with the most, else the median of the ties."""
    scores = np.array([score(v) for v in values])
    ties = values[scores == scores.max()]
    return 0.0 if np.any(ties == 0) else float(np.median(ties))


def clock_fit(copies, syncs, t0):
    """``(offset_ns, rate)`` that put a host time ``u`` (Unix ns) on the
    device's clock as ``u + offset_ns + rate * (u - t0)``, chosen so the
    most sync spans ``syncs`` (``(start, end)``) hold one of ``copies``;
    rates to :data:`FIT_RATES_PPM` and offsets to
    :data:`FIT_OFFSETS_NS`, each searched twice in turn."""
    if not copies or not syncs:
        return 0.0, 0.0
    cp = np.array(copies, dtype=np.float64) - t0
    sy = np.array(syncs, dtype=np.float64) - t0
    sy = sy[::max(1, len(sy) // FIT_SYNCS)]
    cs, ce, s, e = cp[:, 0], cp[:, 1], sy[:, 0], sy[:, 1]
    offset = rate = 0.0
    rates = np.arange(-FIT_RATES_PPM, FIT_RATES_PPM + 1) * 1e-6
    offsets = np.arange(-FIT_OFFSETS_NS, FIT_OFFSETS_NS + 1, 1000.0)
    for _ in range(2):
        rate = _best(rates, lambda r: spans_holding_copies(
            cs, ce, s + offset + r * s, e + offset + r * e))
        offset = _best(offsets, lambda o: spans_holding_copies(
            cs, ce, s + o + rate * s, e + o + rate * e))
    return offset, rate


def held_gaps(gaps, ends, passed):
    """The gaps ``(start, end)`` around which the clock held: the sync
    that ends last by the gap's end and the first to end after it (of
    those ending at ``ends``, sorted, with ``passed`` flags) both pass
    where they exist."""
    out = []
    for g in gaps:
        i = bisect.bisect_right(ends, g[1])
        if all(passed[j] for j in (i - 1, i) if 0 <= j < len(ends)):
            out.append(g)
    return out


def idle_share_after(gaps, ends):
    """Share (%) of the gaps' time in gaps inside which one of ``ends``
    falls; None without gaps."""
    ends = sorted(ends)
    total = hit = 0
    for g0, g1 in gaps:
        total += g1 - g0
        i = bisect.bisect_right(ends, g0)
        if i < len(ends) and ends[i] <= g1:
            hit += g1 - g0
    return 100.0 * hit / total if total else None


def analysis(ctx):
    """The window's spans, or None where there is nothing to read (see
    the module docstring).  Returns a dict: ``spans`` (the package's span
    dicts, each with ``ustart`` and ``uend``: Unix ns, on the device's
    clock where a base fits), ``by_id``, ``base`` (None where none fits),
    ``offset_ns`` and ``rate`` (:func:`clock_fit`), ``syncs_holding``
    (sync spans that hold a copy, before and after the fit), ``gaps``
    (the device's idle gaps around which the clock held), ``idle_ns``
    (all idle time between the window's device operations),
    ``syncs_checked`` (syncs after some device operation),
    ``syncs_missed`` (of those, the ones that end more than
    :data:`CLOCK_SLACK_NS` before an operation that started before their
    end ends) and ``largest_miss_ns``; prints the clock check once a
    window."""
    act = ctx['activity']
    if _last[0] is act:
        return _last[1]
    _last[:] = [act, _analyse(act)]
    return _last[1]


def _analyse(act):
    got = _program_spans()
    if got is None or not act.ops:
        return None
    spans, unix_ns = got
    if not spans:
        return None
    for s in spans:
        s['ustart'], s['uend'] = unix_ns(s['start_ns']), unix_ns(s['end_ns'])
    a = {'spans': spans, 'by_id': {s['id']: s for s in spans},
         'base': None, 'offset_ns': 0.0, 'rate': 0.0, 'syncs_holding': None,
         'gaps': [], 'idle_ns': 0, 'syncs_checked': 0, 'syncs_missed': 0,
         'largest_miss_ns': None}
    lo = min(s['ustart'] for s in spans)
    hi = max(s['uend'] for s in spans)
    base = find_base(round(1000 * act.ops[0][1]), lo, hi)
    if base is None:
        print('program spans: no base puts the first device op inside '
              'the spans', file=sys.stderr)
        return a
    ops = device_intervals(act, base)
    syncs = [s for s in spans if s['name'] == 'sync']
    cps = copies(act, base)
    t0 = ops[0][0]
    offset, rate = clock_fit(cps, [(s['ustart'], s['uend']) for s in syncs],
                             t0)
    before = [(s['ustart'], s['uend']) for s in syncs]
    for s in spans:
        for k in ('ustart', 'uend'):
            s[k] += round(offset + rate * (s[k] - t0))
    syncs.sort(key=lambda s: s['uend'])
    ends = [s['uend'] for s in syncs]
    misses = clock_misses(ops, ends)
    passed = [m is None or m <= CLOCK_SLACK_NS for m in misses]
    gaps = idle_gaps(ops)
    held = held_gaps(gaps, ends, passed)
    checked = [m for m in misses if m is not None]
    holding = [_holding(cps, sp) for sp in
               (before, [(s['ustart'], s['uend']) for s in syncs])]
    a.update(base=base, offset_ns=offset, rate=rate, syncs_holding=holding,
             gaps=held, idle_ns=sum(g1 - g0 for g0, g1 in gaps),
             syncs_checked=len(checked),
             syncs_missed=sum(not p for p in passed),
             largest_miss_ns=max(checked, default=None))
    largest = a['largest_miss_ns']
    print('program spans: {} ({} syncs), base {} quarters; clock fit: '
          'offset {:.1f} us, rate {:.1f} ppm, syncs holding a copy {} -> {}; '
          'clock check: {} of {} syncs after a device op within {} us, '
          'largest miss {} us; held around {:.6f} of {:.6f} s of idle '
          'gaps'.format(
              len(spans), len(syncs), base // QUARTER_NS, offset / 1e3,
              rate * 1e6, holding[0], holding[1],
              len(checked) - a['syncs_missed'], len(checked),
              CLOCK_SLACK_NS / 1e3, None if largest is None else largest / 1e3,
              1e-9 * sum(g1 - g0 for g0, g1 in held), 1e-9 * a['idle_ns']),
          file=sys.stderr)
    return a


def _holding(cps, syncs):
    """How many of ``syncs`` (``(start, end)``) hold one of ``cps``."""
    if not cps or not syncs:
        return 0
    cp, sy = np.array(cps), np.array(syncs)
    return spans_holding_copies(cp[:, 0], cp[:, 1], sy[:, 0], sy[:, 1])


def under_run(a, span, call):
    """True where ``span`` has an ancestor ``run`` under the span
    ``call`` (``rule_n``, ``bootstrapping``)."""
    by_id, p, run = a['by_id'], span['parent'], False
    while p is not None:
        s = by_id.get(p)
        if s is None:
            return False
        if s['name'] == 'run':
            run = True
        elif run and s['name'] == call:
            return True
        p = s['parent']
    return False


def device_ms_per_run(ctx, name, call):
    """Summed ``device_ms`` of the spans ``name`` under the runs of
    ``call``, over the runs."""
    a = analysis(ctx)
    if a is None or not ctx['units']:
        return None
    ms = [s['device_ms'] for s in a['spans'] if s['name'] == name
          and s['device_ms'] is not None and under_run(a, s, call)]
    return sum(ms) / ctx['units'] if ms else None


def attr_per_run(ctx, name, call, key):
    """Summed attribute ``key`` of the spans ``name`` under the runs of
    ``call``, over the runs."""
    a = analysis(ctx)
    if a is None or not ctx['units']:
        return None
    vals = [s['attrs'][key] for s in a['spans'] if s['name'] == name
            and key in s['attrs'] and under_run(a, s, call)]
    return sum(vals) / ctx['units'] if vals else None


def syncs_per_run(ctx):
    """The window's ``sync`` spans over its runs."""
    a = analysis(ctx)
    if a is None or not ctx['units']:
        return None
    return sum(s['name'] == 'sync' for s in a['spans']) / ctx['units']


def idle_after_sync(ctx):
    """Share (%) of the device's idle time (the gaps between its
    operations) in gaps inside which a ``sync`` span ends, over the gaps
    around which the clock held."""
    a = analysis(ctx)
    if a is None:
        return None
    return idle_share_after(a['gaps'], [s['uend'] for s in a['spans']
                                        if s['name'] == 'sync'])


def copy_gbps(ctx, name):
    """Summed ``bytes`` of the spans ``name`` over their summed host
    seconds, in GB/s."""
    a = analysis(ctx)
    if a is None:
        return None
    done = [s for s in a['spans'] if s['name'] == name
            and 'bytes' in s['attrs']]
    ns = sum(s['end_ns'] - s['start_ns'] for s in done)
    if not ns:
        return None
    return sum(s['attrs']['bytes'] for s in done) / ns
