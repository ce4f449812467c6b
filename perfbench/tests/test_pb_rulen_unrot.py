"""The unrotated Rule-N cell at a tiny size on the CPU: a clean run is
correct, and a run with the timed path broken underneath is not: the
leading value altered by 10% where the spectra are produced, every Gram
summed over half of its columns times two, or each run's Newton-Schulz
total taken with the last quarter of its schedule left out."""
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import tiny_spec
from perfbench.tests.test_pb_faults import alter_answer, drop_half

CELL = 'era5_025_2000_unrot.rulen_unrot'
SEED = 2 ** 31 + 13


def _run():
    return harness.run(tiny_spec(CELL), SEED, 0.2, False, time.perf_counter(),
                       device='cpu')


def test_a_clean_run_is_correct():
    result, compared, notes = _run()
    assert notes == [] and result['correct'], compared


def short_schedule(monkeypatch):
    """The surrogate schedule without its last quarter (15 of 20 steps)."""
    from xmca_tpu_torch.core import fastpath
    scales = fastpath._NS_SCALES_SURR
    monkeypatch.setattr(fastpath, '_NS_SCALES_SURR',
                        scales[:len(scales) - len(scales) // 4])


@pytest.mark.parametrize('fault', [
    lambda mp: alter_answer(mp, 'rule_n'),
    lambda mp: drop_half(mp, 'rule_n'),
    short_schedule], ids=['alter_answer', 'drop_half', 'short_schedule'])
def test_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, compared, notes = _run()
    assert not result['correct'], compared
    assert notes or any(v > lim for _, v, lim in compared)
