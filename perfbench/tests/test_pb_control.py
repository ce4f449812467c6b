"""The control on the card, at a size a test run holds: the reference
in the program's place in float32 with TF32 products reads far above
what the program reads, so the limits between them can tell the two
apart.  (At the cells' own sizes: ``perfbench/control.py``; the
readings are in PERF.md.)"""
import time

import pytest

from perfbench import harness
from perfbench.checks import compare
from perfbench.control import control_records
from perfbench.tests.test_pb_layout import CELLS

SMALL = dict(n_obs=520, n_lat=32, n_lon=64)


def _small(cell):
    spec = harness.Spec(cell)
    spec.config.update(SMALL)
    if 'runs_per_call' in spec.traffic:
        spec.traffic['runs_per_call'] = min(4, spec.traffic['runs_per_call'])
    return spec


@pytest.mark.cuda
@pytest.mark.parametrize('cell', CELLS)
def test_control_reads_above_the_program(card, cell):
    from perfbench.calls import Calls
    spec = _small(cell)
    seed = 2 ** 31 + 17
    _, program, _ = harness.run(spec, seed, 1.0, False, time.perf_counter(),
                                device=card)
    calls = Calls(spec.config, spec.traffic, seed, card)
    calls.make_fields()
    records = control_records(calls, seed, spec.check, 8, card)
    control, _ = compare(calls, records, seed, spec.check, card)
    assert any(control[k] > 3 * v for k, v, _ in program), (control,
                                                            program)
