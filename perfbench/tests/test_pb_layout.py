"""Every file a cell needs is found by its name, and BENCHMARK.json keeps
to the benchmark's contract."""
import json
import os
import re

import pytest

from perfbench.calls import driver
from perfbench.harness import ROOT, Spec, reader

BENCH = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
CELLS = [w['name'] for w in BENCH['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'perfbench/run.py']
    assert BENCH['paths'] == ['perfbench']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    names = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    names += CELLS + [c['name'] for c in BENCH['configs']]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    e2e = {m['name'] for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in e2e and 0 < len(m['layer']) <= 200


def test_configs_hold_their_sources_and_cuts():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('perfbench/configs/')
        cfg = json.load(open(os.path.join(ROOT, c['file'])))
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert cfg['reduced'] == c['reduced']
        # every cut is a key of the file, beside the source's own value
        for key in c['reduced']:
            assert key in cfg and 'source_' + key in cfg
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', CELLS)
def test_every_cell_loads_by_name(cell):
    spec = Spec(cell)
    assert spec.entry['chips'] in (1, 4)
    assert 0 < len(spec.entry['why']) <= 200
    assert spec.traffic['rate_metric'] in {m['name']
                                           for m in spec.end_to_end}
    assert {'setup_s', 'peak_mem_gb'} <= {m['name']
                                          for m in spec.end_to_end}
    drv = driver(spec.traffic['driver'])
    assert set(spec.check['limits']) == set(drv.COMPARED)
    for fn in ('per_call', 'call', 'blank', 'fill', 'compare'):
        assert callable(getattr(drv, fn))
    assert spec.per_layer, 'a cell reports a per-layer metric'
    for m in spec.per_layer:
        assert callable(reader(m['name']))


def test_pairs_of_config_and_traffic_are_distinct():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(
        1, len(BENCH['workloads']) // 4)
