"""The measured window: a rate over all the work and all the time, the
last call being the last one that started before the deadline."""
import time

import pytest

from perfbench.harness import window


class Sleeper:
    """Calls that take ``wall`` seconds and do ``units`` of work each."""
    device = 'cpu'

    def __init__(self, wall, units=3):
        self.wall, self.units, self.started = wall, units, []

    def call(self, k):
        self.started.append(time.perf_counter())
        time.sleep(self.wall)
        return self.units


@pytest.mark.parametrize('seconds, wall', [(0.25, 0.1), (0.05, 0.12)])
def test_last_call_starts_before_the_deadline(seconds, wall):
    calls = Sleeper(wall)
    units, n, elapsed, walls, activity = window(calls, seconds)
    t0 = calls.started[0]
    assert activity is None and len(walls) == n == len(calls.started)
    # every call started before the deadline, and the next one would not
    assert all(s - t0 < seconds + 0.02 for s in calls.started)
    assert calls.started[-1] + wall >= t0 + seconds - 0.02
    # the partial last call is counted whole, with all of its time
    assert units == 3 * n
    assert elapsed >= n * wall
    assert elapsed / units == pytest.approx(sum(walls) / units, rel=0.2)


def test_one_call_at_least():
    calls = Sleeper(0.02)
    units, n, elapsed, _, _ = window(calls, 0.0)
    assert n == 1 and units == 3 and elapsed >= 0.02
