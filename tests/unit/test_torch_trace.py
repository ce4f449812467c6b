"""The port's spans and counters (``xmca_tpu_torch.utils.trace``) on the
CPU.

* Without a profiler no span is recorded and no CUDA event is made, and
  every counter still counts.
* Under ``torch.profiler.profile`` a small rotated, complexified model's
  fit, ``rule_n(2)`` and ``bootstrapping(2)`` record the span tree: each
  ``run``'s parent is its call, each stage's parent a ``run``; the
  bootstrap's Grams of the call sit outside its runs, and every ``gram``
  span and the ``gram_routes`` counter name the stored route.
* The host syncs of a call follow from its ``varimax`` spans'
  ``iterations`` and ``polar_steps``, and repeat exactly.
* Every answer is bit-equal with the profiler on and off.
* A model solved with theta extension records, under each bootstrap
  ``run``, one ``extend`` span a field (its ``seasonal`` span and its
  two ``ses`` sweeps, grids 33 and 17) and its ``analytic`` span;
  ``forecast_columns`` counts four series a column a run (forecast and
  backcast of both fields), with or without a profiler, and the answers
  are bit-equal with the profiler on and off.
* ``ops._build.launch_counts`` and ``parallel.mesh.collective_counts``
  read as they did before they became views of the registry.
"""
import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmca_tpu_torch.compat import xr
from xmca_tpu_torch.ops import _build
from xmca_tpu_torch.parallel import mesh as tmesh
from xmca_tpu_torch.utils import trace
from xmca_tpu_torch.xarray import xMCA

N_OBS, GRID, N_ROT, RUNS = 64, (8, 20), 4, 2
RULE_N_STAGES = {'start', 'draw', 'gram', 'subspace', 'project', 'varimax'}
BOOT_STAGES = {'resample', 'start', 'gram', 'subspace', 'project',
               'varimax'}


def _fields():
    """Two float32 (time, lat, lon) fields with 8 shared sinusoidal modes
    plus noise, as DataArrays."""
    n_lat, n_lon = GRID
    t = np.arange(N_OBS, dtype=np.float64)
    modes = np.sin(2 * np.pi * t[:, None] * np.arange(1, 9)[None] / N_OBS)
    coords = {'time': t, 'lat': np.linspace(-60, 60, n_lat),
              'lon': np.linspace(0, 359, n_lon)}
    out = []
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        data = (modes @ r.standard_normal((8, n_lat * n_lon))
                + r.standard_normal((N_OBS, n_lat * n_lon)))
        out.append(xr.DataArray(
            data.reshape(N_OBS, n_lat, n_lon).astype(np.float32),
            dims=('time', 'lat', 'lon'), coords=coords))
    return out


def _fit():
    """The benchmark's pipeline at a small size: truncated complexified
    solve (the analytic fold) and varimax of 4 modes."""
    m = xMCA(*_fields(), device='cpu')
    m.set_solver(truncate=6, seed=3)
    m.normalize()
    m.apply_coslat()
    m.solve(complexify=True)
    m.rotate(N_ROT)
    return m


def _rule_n(m, seed=5):
    return np.asarray(m.rule_n(RUNS, seed=seed).values)


def _boot(m, seed=7):
    return np.asarray(m.bootstrapping(RUNS, n_modes=N_ROT, block_size=8,
                                      seed=seed).values)


def _answers(m):
    return {'svals': np.asarray(m.singular_values().values),
            'variance': np.asarray(m.variance().values),
            'eofs': np.asarray(m.eofs(N_ROT)['left'].values),
            'rule_n': _rule_n(m), 'boot': _boot(m)}


def _profiled(fn):
    """``fn()`` under a CPU-activity profile, from an empty buffer;
    returns its result and the spans it recorded."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.spans()


@pytest.fixture(scope='module')
def model():
    return _fit()


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    made = []

    class NoEvent:
        def __init__(self, *args, **kwargs):
            made.append(1)

    # as if a card were in use: a span would make its events now
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    monkeypatch.setattr(torch.cuda, 'Event', NoEvent)
    trace.clear()
    trace.reset_counters()
    assert not trace.enabled()
    assert trace.span('a') is trace.span('b', x=1)
    m = _fit()
    _rule_n(m)
    _boot(m)
    assert trace.spans() == [] and made == []
    syncs = trace.counters()['host_syncs']
    assert syncs['ingest.copy'] == 2 and syncs['collect'] == 3
    assert syncs['start.copy'] == 2 * RUNS
    # the bootstrap of a complexified model on the time axis: Gram space
    assert trace.counters()['gram_routes'] == {'stored': RUNS}
    assert trace.counters()['h2d_bytes']['ingest.copy'] == 2 * 4 * N_OBS * (
        GRID[0] * GRID[1])


def test_the_profiler_gates_the_spans():
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        with trace.span('outer', a=1) as s:
            s.set(b=2)
            with trace.span('inner'):
                trace.to_host(torch.ones(2).sum(), 'test.read', float)
            trace.add('steps', 3)
            trace.add('steps', 4)
    assert not trace.enabled()
    with trace.span('after'):
        pass
    got = {s['name']: s for s in trace.spans()}
    assert set(got) == {'outer', 'inner', 'sync'}
    assert got['outer']['attrs'] == {'a': 1, 'b': 2, 'steps': 7}
    assert got['inner']['parent'] == got['outer']['id']
    assert got['sync']['parent'] == got['inner']['id']
    assert got['sync']['attrs'] == {'site': 'test.read'}
    assert all(s['device_ms'] is None for s in got.values())
    for s in got.values():
        assert s['start_ns'] <= s['end_ns']
    # the Unix clock: the span ended within a second of now
    now = time.time_ns()
    assert 0 <= now - trace.unix_ns(got['outer']['end_ns']) < 1e9


def test_the_buffer_is_capped(monkeypatch):
    monkeypatch.setattr(trace, 'MAX_SPANS', 3)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with trace.span('s'):
                pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def _tree(spans, call):
    """The call's span, its runs and every span under a run (by run)."""
    by_id = {s['id']: s for s in spans}
    calls = [s for s in spans if s['name'] == call]
    assert len(calls) == 1
    runs = [s for s in spans if s['name'] == 'run']
    under = collections.defaultdict(list)
    for s in spans:
        p = s['parent']
        while p is not None and by_id[p]['name'] != 'run':
            p = by_id[p]['parent']
        if p is not None:
            under[p].append(s)
    return calls[0], runs, under


@pytest.mark.parametrize('call, stages', [('rule_n', RULE_N_STAGES),
                                          ('bootstrapping', BOOT_STAGES)])
def test_ensemble_calls_record_runs_and_stages(model, call, stages):
    fn = _rule_n if call == 'rule_n' else _boot
    _, spans = _profiled(lambda: fn(model))
    top, runs, under = _tree(spans, call)
    assert top['parent'] is None
    assert len(runs) == RUNS
    assert len({r['attrs']['seed'] for r in runs}) == RUNS
    for r in runs:
        assert r['parent'] == top['id']
        kids = [s for s in under[r['id']] if s['parent'] == r['id']]
        assert {s['name'] for s in kids} - {'sync'} == stages
        assert all(s['name'] in stages | {'sync'} for s in under[r['id']])
    collect = [s for s in spans if s['name'] == 'collect']
    assert len(collect) == 1 and collect[0]['parent'] == top['id']
    if call == 'bootstrapping':
        # a Gram span a run, and the call's own Grams outside its runs
        grams = [s for s in spans if s['name'] == 'gram']
        assert {s['attrs']['route'] for s in grams} == {'stored'}
        assert [s['parent'] for s in grams].count(top['id']) == 1
        assert len(grams) == RUNS + 1
    # a span closes after its children
    by_id = {s['id']: s for s in spans}
    for s in spans:
        if s['parent'] is not None:
            p = by_id[s['parent']]
            assert p['start_ns'] <= s['start_ns'] <= s['end_ns'] <= p[
                'end_ns']


def test_a_fit_records_its_stages():
    (m, spans) = _profiled(_fit)
    names = collections.Counter(s['name'] for s in spans)
    for name in ('normalize', 'apply_coslat', 'solve', 'rotate'):
        assert names[name] == 1
    by_id = {s['id']: s for s in spans}
    ingest = [s for s in spans if s['name'] == 'ingest']
    assert [s['attrs']['field'] for s in ingest] == ['left', 'right']
    for s in spans:
        if s['name'].startswith('ingest.'):
            assert by_id[s['parent']]['name'] == 'ingest'
    copies = [s for s in spans if s['name'] == 'ingest.copy']
    assert [s['attrs']['bytes'] for s in copies] == [
        4 * N_OBS * GRID[0] * GRID[1]] * 2
    solve = next(s for s in spans if s['name'] == 'solve')
    assert {s['name'] for s in spans if s['parent'] == solve['id']} >= {
        'gram', 'subspace', 'project', 'sync'}
    rotate = next(s for s in spans if s['name'] == 'rotate')
    varimax = next(s for s in spans if s['name'] == 'varimax')
    assert varimax['parent'] == rotate['id']
    assert (rotate['attrs']['iterations'] == varimax['attrs']['iterations']
            == m._rotate_iterations > 0)
    sites = {s['attrs']['site'] for s in spans if s['name'] == 'sync'}
    assert {'ingest.copy', 'ingest.nan', 'ingest.moments', 'solve.totals',
            'varimax.criterion'} <= sites


def _syncs_of(fn):
    trace.reset_counters('host_syncs')
    _, spans = _profiled(fn)
    syncs = trace.counts('host_syncs')
    assert sum(syncs.values()) == sum(s['name'] == 'sync' for s in spans)
    varimax = [s['attrs'] for s in spans if s['name'] == 'varimax']
    return syncs, varimax


def test_host_syncs_follow_the_varimax_spans(model):
    """Rule-N's 'ns14' polar reads nothing: a run reads its start block,
    the criterion once an iteration and its variances' finiteness, a
    call its spectra and totals.  The bootstrap's 'ns-gated' polar reads
    its defect once a step; a run copies its block indices, its start
    block and its converged flag, a call reads its rows."""
    counts = []
    for _ in range(2):
        syncs, varimax = _syncs_of(lambda: _rule_n(model))
        iters = sum(v['iterations'] for v in varimax)
        assert len(varimax) == RUNS and iters > 0
        assert all(v['polar_steps'] == 14 * v['iterations'] for v in varimax)
        assert sum(syncs.values()) == 2 * RUNS + iters + 2
        assert syncs == {'start.copy': RUNS, 'varimax.criterion': iters,
                         'variance.finite': RUNS, 'collect': 2}
        counts.append((syncs, varimax))
    assert counts[0] == counts[1]

    counts = []
    for _ in range(2):
        syncs, varimax = _syncs_of(lambda: _boot(model))
        iters = sum(v['iterations'] for v in varimax)
        steps = sum(v['polar_steps'] for v in varimax)
        assert len(varimax) == RUNS and steps >= iters > 0
        assert sum(syncs.values()) == 4 * RUNS + iters + steps + 1
        assert syncs == {'resample.copy': RUNS, 'start.copy': RUNS,
                         'varimax.criterion': iters, 'polar.defect': steps,
                         'variance.finite': RUNS, 'run.converged': RUNS,
                         'collect': 1}
        counts.append((syncs, varimax))
    assert counts[0] == counts[1]


def test_answers_are_bit_equal_with_and_without_a_profiler():
    plain = _answers(_fit())
    traced, spans = _profiled(lambda: _answers(_fit()))
    assert spans
    assert plain.keys() == traced.keys()
    for key in plain:
        np.testing.assert_array_equal(plain[key], traced[key], err_msg=key)


def _fit_extended():
    """The extended pipeline at a small size: theta (period 12) before
    the truncated complexified solve, varimax of 4 modes."""
    m = xMCA(*_fields(), device='cpu')
    m.set_solver(truncate=6, seed=3)
    m.normalize()
    m.apply_coslat()
    m.solve(complexify=True, extend='theta', period=12)
    m.rotate(N_ROT)
    return m


def _extended_answers():
    m = _fit_extended()
    return {'svals': np.asarray(m.singular_values().values),
            'variance': np.asarray(m.variance().values),
            'boot': _boot(m)}


def test_extension_records_its_stages_under_each_run():
    m = _fit_extended()
    p = GRID[0] * GRID[1]
    trace.reset_counters('forecast_columns', 'gram_routes')
    _, spans = _profiled(lambda: _boot(m))
    assert trace.counts('forecast_columns') == {'theta': 4 * p * RUNS}
    assert trace.counts('gram_routes') == {'data': RUNS}
    top, runs, under = _tree(spans, 'bootstrapping')
    by_id = {s['id']: s for s in spans}
    assert len(runs) == RUNS
    for r in runs:
        kids = [s for s in under[r['id']] if s['parent'] == r['id']]
        extend = [s for s in kids if s['name'] == 'extend']
        analytic = [s for s in kids if s['name'] == 'analytic']
        assert [s['attrs'] for s in extend] == [
            {'method': 'theta', 'columns': 2 * p, 'steps': N_OBS}] * 2
        assert [s['attrs'] for s in analytic] == [{'chunks': 1}] * 2
        for e in extend:
            inner = [s for s in spans if s['parent'] == e['id']]
            assert [s['name'] for s in inner] == ['seasonal', 'ses', 'ses']
            assert inner[0]['attrs'] == {'period': 12, 'columns': 2 * p}
            assert [s['attrs'] for s in inner[1:]] == [
                {'steps': N_OBS, 'grid': g, 'columns': 2 * p}
                for g in (33, 17)]
        # the counter and the spans count the same series
        assert sum(s['attrs']['columns'] for s in extend) == 4 * p
    ses = [s for s in spans if s['name'] == 'ses']
    assert len(ses) == 4 * RUNS
    assert all(by_id[by_id[s['parent']]['parent']]['name'] == 'run'
               for s in ses)
    # without a profiler the counter counts as much, and no span is kept
    trace.reset_counters('forecast_columns')
    trace.clear()
    _boot(m)
    assert trace.spans() == []
    assert trace.counts('forecast_columns') == {'theta': 4 * p * RUNS}


def test_extended_answers_are_bit_equal_with_and_without_a_profiler():
    plain = _extended_answers()
    traced, spans = _profiled(_extended_answers)
    assert {'extend', 'seasonal', 'ses', 'analytic'} <= {
        s['name'] for s in spans}
    for key in plain:
        np.testing.assert_array_equal(plain[key], traced[key], err_msg=key)


def test_keeping_collects_each_runs_singular_values(model):
    """``keep`` does nothing with no list open; inside ``keeping`` the
    rotation's site keeps one copy of its singular values a run, and the
    answers are bit-equal with and without it."""
    trace.keep('rotated_svals', torch.ones(3))
    plain = _boot(model)
    with trace.keeping('rotated_svals') as kept:
        with pytest.raises(RuntimeError):
            with trace.keeping('rotated_svals'):
                pass
        kept_boot = _boot(model)
    np.testing.assert_array_equal(plain, kept_boot)
    assert len(kept) == RUNS
    for s in kept:
        assert s.shape == (N_ROT,) and bool((s > 0).all())
        assert bool((s[:-1] >= s[1:]).all())
    _boot(model)
    assert len(kept) == RUNS


def test_launch_and_collective_counts_read_as_before():
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
    trace.count('launches', 'syrk')
    trace.count('launches', 'syrk')
    trace.count('launches', 'sign_field_sums')
    assert _build.launch_counts() == {'syrk': 2, 'sign_field_sums': 1}
    assert trace.counters()['launches'] == _build.launch_counts()
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}

    tmesh.reset_collective_counts()
    assert tmesh.collective_counts() == {}
    trace.count('collectives', 'all_reduce')
    trace.count('collective_bytes', 'all_reduce', 40)
    trace.count('collectives', 'all_reduce')
    trace.count('collective_bytes', 'all_reduce', 4)
    assert tmesh.collective_counts() == {'all_reduce': 2, 'bytes': 44}
    tmesh.reset_collective_counts()
    assert tmesh.collective_counts() == {}
    assert not hasattr(_build, 'LAUNCHES')
    assert not hasattr(tmesh, 'COLLECTIVES')


def test_copies_return_what_the_bare_calls_return():
    x = np.arange(6.0).reshape(2, 3)
    trace.reset_counters('host_syncs', 'h2d_bytes')
    t = trace.to_device(x, 'cpu', 'test.copy', dtype=torch.float32)
    ref = torch.as_tensor(x, dtype=torch.float32, device='cpu')
    assert t.dtype == ref.dtype and torch.equal(t, ref)
    src = torch.arange(4)
    assert trace.to_device(src, 'cpu', 'test.copy') is src
    assert trace.to_host(src.sum(), 'test.read', int) == 6
    assert torch.equal(trace.to_host(src, 'test.read'), src)
    assert trace.counts('host_syncs') == {'test.copy': 2, 'test.read': 2}
    assert trace.counts('h2d_bytes') == {'test.copy': 48 + 32}
