"""The readers of the program's spans (``perfbench/program_trace.py``) on
a synthetic device trace and span tree: the base of the device clock,
the clock check around each idle gap, idle time after a sync and the
sums over runs."""
import pytest

from perfbench import program_trace as pt
from perfbench.harness import reader
from perfbench.trace import Activity

QUARTERS = 227
BASE = QUARTERS * pt.QUARTER_NS
# Unix ns of the window's first span: 1.5e12 us after the base
T0 = BASE + 1_500_000_000_000_000
# perf_counter ns -> Unix ns
SHIFT = T0 - 10_000


def _us(unix_ns):
    """A Unix time as the trace's microseconds after its base."""
    return (unix_ns - BASE) / 1000.0


def _activity(ops):
    """Kernels ``(name, start, end)`` in Unix ns."""
    return Activity.from_trace_events([
        {'ph': 'X', 'cat': 'kernel', 'name': n, 'ts': _us(s),
         'dur': (e - s) / 1000.0} for n, s, e in ops])


def _span(i, parent, name, start, end, attrs=None, device_ms=None):
    """A span dict as the package returns it, times given in Unix ns."""
    return {'id': i, 'parent': parent, 'name': name,
            'start_ns': start - SHIFT, 'end_ns': end - SHIFT,
            'attrs': dict(attrs or {}), 'device_ms': device_ms}


def _us_after(t):
    return T0 + 1000 * t


def _window():
    """One Rule-N call of one run: the run's project and varimax spans,
    a stray project span outside the run, and two syncs; the device runs
    kernels at 10-20, 50-60 and 90-100 us."""
    u = _us_after
    spans = [
        _span(2, 1, 'project', u(5), u(25), device_ms=3.0),
        _span(4, 3, 'sync', u(55), u(61), {'site': 'varimax.criterion'}),
        _span(3, 1, 'varimax', u(26), u(80), {'iterations': 5},
              device_ms=2.0),
        _span(1, 0, 'run', u(2), u(81), {'seed': 7}),
        _span(5, 0, 'project', u(82), u(84), device_ms=9.0),
        _span(6, 0, 'sync', u(85), u(101), {'site': 'collect'}),
        _span(0, None, 'rule_n', u(0), u(102)),
    ]
    ops = [('a', u(10), u(20)), ('b', u(50), u(60)), ('c', u(90), u(100))]
    return spans, _activity(ops)


@pytest.fixture
def program(monkeypatch):
    """Install spans as the package's: ``program(spans)``."""
    def install(spans):
        monkeypatch.setattr(pt, '_program_spans', lambda: (
            [dict(s) for s in spans], lambda t: t + SHIFT))
        monkeypatch.setattr(pt, '_last', [None, None])
    return install


def _ctx(activity, units=1):
    return {'activity': activity, 'units': units, 'window_s': 1e-4,
            'calls': 1, 'spans': {}, 'config': {}, 'traffic': {}}


def test_the_base_is_a_whole_number_of_quarters():
    first = 1_500_000_000_000_000
    assert pt.find_base(first, T0 - 10, T0 + 10) == BASE
    # a trace whose times are Unix microseconds already
    assert pt.find_base(T0, T0 - 10, T0 + 10) == 0
    # a device clock a little behind the spans' still finds its base
    assert pt.find_base(first - 1_500_000, T0 - 10, T0 + 10) == BASE
    assert pt.find_base(first + 10 ** 12, T0 - 10, T0 + 10) is None


def test_readers_over_a_span_tree(program):
    spans, act = _window()
    program(spans)
    ctx = _ctx(act)
    a = pt.analysis(ctx)
    assert a['base'] == BASE and a['syncs_checked'] == 2
    assert a['syncs_missed'] == 0 and a['idle_ns'] == 60_000
    assert a['gaps'] == [(_us_after(20), _us_after(50)),
                         (_us_after(60), _us_after(90))]
    # the first sync ends 1 us after kernel b: its miss is -1 us
    assert a['largest_miss_ns'] == -1000
    # the stray project span is not under a run
    assert reader('project_ms_per_run.rulen')(ctx) == 3.0
    assert reader('varimax_ms_per_run.rulen')(ctx) == 2.0
    assert reader('host_syncs_per_run.rulen')(ctx) == 2.0
    assert pt.attr_per_run(ctx, 'varimax', 'rule_n', 'iterations') == 5
    assert pt.attr_per_run(ctx, 'varimax', 'bootstrapping',
                           'iterations') is None
    # gaps 20-50 (the varimax read ends at 61: no) and 60-90 (it does)
    assert reader('idle_after_sync.rulen')(ctx) == pytest.approx(50.0)
    assert pt.analysis(ctx) is a


def test_units_divide_the_sums(program):
    spans, act = _window()
    program(spans)
    assert reader('project_ms_per_run.rulen')(_ctx(act, units=4)) == 0.75
    assert reader('project_ms_per_run.rulen')(_ctx(act, units=0)) is None


def test_idle_after_a_sync_counts_whole_gaps():
    gaps = [(0, 10), (20, 50), (60, 100)]
    assert pt.idle_share_after(gaps, [5, 7]) == pytest.approx(12.5)
    assert pt.idle_share_after(gaps, [10, 50]) == pytest.approx(50.0)
    assert pt.idle_share_after(gaps, [15, 55]) == 0.0
    assert pt.idle_share_after([], [1]) is None


def test_a_sync_that_ends_before_the_device_fails_the_clock(program):
    spans, _ = _window()
    u = _us_after
    # the criterion's read returns 89 us before kernel b, started before
    # it, ends
    act = _activity([('a', u(10), u(20)), ('b', u(50), u(150))])
    program(spans)
    ctx = _ctx(act)
    a = pt.analysis(ctx)
    # its gap, 20-50, lies before it: the clock is not read there
    assert a['gaps'] == [] and a['largest_miss_ns'] == 89_000
    assert a['syncs_missed'] == 1
    assert reader('idle_after_sync.rulen')(ctx) is None
    # what reads no shared clock still reads
    assert reader('project_ms_per_run.rulen')(ctx) == 3.0
    assert reader('host_syncs_per_run.rulen')(ctx) == 2.0


def test_idle_is_read_where_the_clock_held(program):
    """Two calls; in the second the device's times run 80 us late, so
    its read, which waited on a long kernel, ends 60 us before that
    kernel's stamped end: the gaps on either side of that read are left
    out, and only the first call's gap is read."""
    u = _us_after
    spans = [
        _span(1, 0, 'sync', u(25), u(31), {'site': 'collect'}),
        _span(4, 0, 'sync', u(52), u(55), {'site': 'collect'}),
        _span(0, None, 'rule_n', u(0), u(60)),
        _span(3, 2, 'sync', u(200), u(320), {'site': 'collect'}),
        _span(2, None, 'rule_n', u(100), u(500)),
    ]
    program(spans)
    # c ran 110-300 and d 330-340, stamped 80 us late
    act = _activity([('a', u(10), u(30)), ('b', u(40), u(50)),
                     ('c', u(190), u(380)), ('d', u(410), u(420))])
    ctx = _ctx(act)
    a = pt.analysis(ctx)
    assert a['gaps'] == [(u(30), u(40))]
    assert a['syncs_missed'] == 1 and a['largest_miss_ns'] == 60_000
    # the first call's gap 30-40 holds its read's end: all of its idle
    assert reader('idle_after_sync.rulen')(ctx) == 100.0


def test_held_gaps_need_passing_syncs_on_either_side():
    gaps = [(0, 10), (20, 30), (40, 50), (60, 70)]
    # syncs end at 5, 15 (pass), 35 (misses) and 55 (passes)
    held = pt.held_gaps(gaps, [5, 15, 35, 55], [True, True, False, True])
    assert held == [(0, 10), (60, 70)]
    # without syncs every gap is read; a window's first gap is judged by
    # the first sync alone
    assert pt.held_gaps(gaps, [], []) == gaps
    assert pt.held_gaps(gaps, [45], [True]) == gaps


def _drifting_window(rate):
    """Forty Rule-N runs 200 ms apart on a device whose clock runs
    ``rate`` fast from the window's first operation: a kernel, 10 ms
    idle, a kernel, then a read (150 us) that waits on the kernel and on
    its copy, and 50 ms idle after it.  Returns spans and activity."""
    u = _us_after
    spans, ops = [_span(0, None, 'rule_n', u(0), u(8_000_000))], []
    for i in range(40):
        t = 200_000 * i
        spans.append(_span(1 + i, 0, 'sync', u(t + 149_900),
                           u(t + 150_050), {'site': 'varimax.criterion'}))
        ops += [('k', u(t), u(t + 60_000)),
                ('k', u(t + 70_000), u(t + 150_000)),
                ('Memcpy DtoH (Device -> Pinned)', u(t + 150_010),
                 u(t + 150_020))]
    first = ops[0][1]
    stamp = [(n, s + round(rate * (s - first)), e + round(rate * (e - first)))
             for n, s, e in ops]
    act = Activity.from_trace_events([
        {'ph': 'X', 'cat': 'gpu_memcpy' if n.startswith('Memcpy')
         else 'kernel', 'name': n, 'ts': _us(s), 'dur': (e - s) / 1000.0}
        for n, s, e in stamp])
    return spans, act


@pytest.mark.parametrize('rate', [0.0, 37e-6, -120e-6, 400e-6])
def test_the_clock_fit_takes_out_a_drifting_device_clock(program, rate):
    """A device clock that runs off the host's at a steady rate (up to
    3.1 ms by the window's end here) is put back on it by the copies the
    syncs hold, and the idle after the reads reads as on a true clock."""
    spans, act = _drifting_window(rate)
    program(spans)
    ctx = _ctx(act)
    a = pt.analysis(ctx)
    # each read's span leaves its copy 140 us of play, 18 ppm over the
    # window: the rate is known to that
    assert a['rate'] == pytest.approx(rate, abs=18e-6)
    assert abs(a['offset_ns']) <= 140_000
    assert a['syncs_holding'][1] == 40 and a['syncs_missed'] == 0
    # 50 ms after each read of every 60 ms idle (the last one's tail
    # lies past the window's last operation)
    assert reader('idle_after_sync.rulen')(ctx) == pytest.approx(
        100.0 * (39 * 49.98) / (39 * 59.98 + 10.0), rel=1e-3)


def test_nothing_to_read_gives_nothing(program, monkeypatch):
    _, act = _window()
    program([])
    assert reader('host_syncs_per_run.boot')(_ctx(act)) is None
    spans, _ = _window()
    program(spans)
    assert reader('idle_after_sync.boot')(_ctx(_activity([]))) is None
    # a device op outside every span: no base fits, so nothing is put
    # on the device's clock
    program(spans)
    far = _ctx(_activity([('a', T0 + 10 ** 12, T0 + 10 ** 12 + 10)]))
    assert pt.analysis(far)['base'] is None
    assert reader('idle_after_sync.rulen')(far) is None
    assert reader('host_syncs_per_run.rulen')(far) == 2.0
    # a program without the trace module
    monkeypatch.setattr(pt, '_program_spans', lambda: None)
    monkeypatch.setattr(pt, '_last', [None, None])
    assert reader('gram_ms_per_run.boot')(_ctx(act)) is None


def test_ingest_rate_and_bootstrap_readers(program):
    u = _us_after
    spans = [
        _span(1, 0, 'ingest.copy', u(0), u(40), {'bytes': 80_000}),
        _span(2, 1, 'sync', u(1), u(40), {'site': 'ingest.copy'}),
        _span(3, 0, 'ingest.copy', u(41), u(81), {'bytes': 40_000}),
        _span(0, None, 'ingest', u(0), u(82)),
        _span(6, 5, 'gram', u(83), u(90), device_ms=4.0),
        _span(7, 5, 'varimax', u(90), u(95), {'iterations': 6}),
        _span(5, 4, 'run', u(82), u(96)),
        _span(4, None, 'bootstrapping', u(82), u(97)),
    ]
    program(spans)
    ctx = _ctx(_activity([('copy', u(0.5), u(39))]), units=2)
    # 120 kB over 80 us of host time
    assert reader('h2d_gbps.fit')(ctx) == pytest.approx(1.5)
    assert reader('gram_ms_per_run.boot')(ctx) == 2.0
    assert reader('varimax_iters_per_run.boot')(ctx) == 3.0
    assert reader('host_syncs_per_run.boot')(ctx) == 0.5
