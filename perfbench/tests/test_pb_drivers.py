"""A tiny run of every cell on the CPU, driven as on the card but for
the look for a chip, judged against the reference: correct, with every
compared number below its limit and every metric the cell reports."""
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import tiny_spec
from perfbench.tests.test_pb_layout import CELLS


@pytest.mark.parametrize('cell', CELLS)
def test_tiny_run_is_correct(cell):
    spec = tiny_spec(cell)
    result, compared, notes = harness.run(spec, 2 ** 31 + 11, 0.2, False,
                                          time.perf_counter(), device='cpu')
    assert notes == []
    assert result['correct'], compared
    assert {k for k, _, _ in compared} == set(spec.check['limits'])
    assert set(result['metrics']) == {m['name'] for m in spec.end_to_end}
    assert result['attempted'] >= 1 and result['failed'] == 0


@pytest.mark.parametrize('cell', CELLS)
def test_same_seed_same_answers(cell):
    spec = tiny_spec(cell)
    from perfbench.calls import Calls
    runs = []
    for _ in range(2):
        calls = Calls(spec.config, spec.traffic, 2 ** 31 + 5, 'cpu')
        calls.setup()
        calls.call(0)
        runs.append(calls.records[0])
    for key, value in runs[0].items():
        assert (runs[1][key] == value).all() if hasattr(value, 'all') \
            else runs[1][key] == value


ROTATED = {'n_rot': 10, 'power': 1, 'tol': 1e-8}


@pytest.mark.parametrize('cell, complexify, rotate', [
    ('era5_025_2000.fit', False, None),
    ('era5_025_2000.fit', True, None),
    ('era5_025_2000.fit', False, ROTATED),
    ('era5_025_2000.rulen_rot', False, ROTATED),
])
def test_pipeline_passes_through_and_the_reference_follows(cell, complexify,
                                                           rotate):
    """A configuration's pipeline reaches the public calls as written (a
    real solve, no rotation), and the reference computes the same."""
    spec = tiny_spec(cell)
    spec.config['pipeline']['solve'] = {'complexify': complexify}
    spec.config['pipeline']['rotate'] = rotate
    result, compared, notes = harness.run(spec, 2 ** 31 + 11, 0.2, False,
                                          time.perf_counter(), device='cpu')
    assert notes == [] and result['correct'], compared


@pytest.mark.parametrize('cell, key, value', [
    ('era5_025_2000.rulen_rot', 'set_solver', {'truncate': 10,
                                               'surrogate_source': 'draw'}),
    ('era5_025_2000.fit', 'solve', {'complexify': True, 'extend': 'theta'}),
    ('era5_025_2000.fit', 'rotate', {'n_rot': 10, 'power': 4}),
])
def test_a_key_the_reference_does_not_follow_is_refused(cell, key, value):
    spec = tiny_spec(cell)
    spec.config['pipeline'][key] = value
    with pytest.raises(ValueError):
        harness.run(spec, 2 ** 31 + 11, 0.2, False, time.perf_counter(),
                    device='cpu')
