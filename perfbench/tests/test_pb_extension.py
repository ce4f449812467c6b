"""The readers of the extension layer's metrics on a synthetic span tree,
and the SES sweep's roofline count (``perfbench/roofline_ext.py``)."""
import pytest

from perfbench import roofline, roofline_ext
from perfbench.harness import reader
from perfbench.tests.test_pb_program_trace import (  # noqa: F401
    _activity, _ctx, _span, _us_after, program)

METRICS = ('extend_ms_per_run.theta_boot', 'ses_roofline.theta_boot',
           'forecast_cols_per_run.theta_boot')
P = 1038240


def _window():
    """One bootstrap call of one run at the cell's shape: two ``extend``
    spans (each a seasonal span and two sweeps) and two ``analytic``
    spans under the run, and a stray extension outside it (the fit's)."""
    u = _us_after
    spans = [_span(0, None, 'bootstrapping', u(0), u(100)),
             _span(1, 0, 'run', u(1), u(99), {'seed': 7})]
    i = 2
    for k in range(2):
        t = 2 + 40 * k
        ext = i
        spans.append(_span(ext, 1, 'extend', u(t), u(t + 30),
                           {'method': 'theta', 'columns': 2 * P,
                            'steps': 480}, device_ms=1500.0))
        spans.append(_span(ext + 1, ext, 'seasonal', u(t), u(t + 2),
                           {'period': 12, 'columns': 2 * P}, device_ms=100.0))
        for j, (grid, ms) in enumerate(((33, 900.0), (17, 450.0))):
            spans.append(_span(ext + 2 + j, ext, 'ses', u(t + 3 + 10 * j),
                               u(t + 12 + 10 * j),
                               {'steps': 480, 'grid': grid, 'columns': 2 * P},
                               device_ms=ms))
        spans.append(_span(ext + 4, 1, 'analytic', u(t + 31), u(t + 38),
                           {'chunks': 6}, device_ms=200.0))
        i += 5
    spans.append(_span(i, None, 'extend', u(101), u(110),
                       {'method': 'theta', 'columns': 2 * P, 'steps': 480},
                       device_ms=1800.0))
    return spans, _activity([('k', u(5), u(95))])


def test_extension_readers_over_a_span_tree(program):  # noqa: F811
    spans, act = _window()
    program(spans)
    ctx = _ctx(act, units=1)
    # the two extensions under the run; the fit's outside it is not read
    assert reader('extend_ms_per_run.theta_boot')(ctx) == 3000.0
    assert reader('forecast_cols_per_run.theta_boot')(ctx) == 4 * P
    least = 2 * (roofline_ext.ses_least_s(480, 33, 2 * P)
                 + roofline_ext.ses_least_s(480, 17, 2 * P))
    assert reader('ses_roofline.theta_boot')(ctx) == pytest.approx(
        100.0 * least / 2.7)
    # two runs halve the per-run readings, not the share
    ctx2 = _ctx(act, units=2)
    assert reader('extend_ms_per_run.theta_boot')(ctx2) == 1500.0
    assert reader('forecast_cols_per_run.theta_boot')(ctx2) == 2 * P


@pytest.mark.parametrize('metric', METRICS)
def test_readers_read_nothing_without_the_spans(program,  # noqa: F811
                                                metric):
    spans, act = _window()
    # the parent's program: the same calls without extension spans
    program([s for s in spans if s['name'] in ('bootstrapping', 'run')])
    assert reader(metric)(_ctx(act)) is None
    program([])
    assert reader(metric)(_ctx(act)) is None


def test_ses_roofline_counts_the_sweeps_work():
    T, G, C = 480, 33, 2 * P
    assert roofline_ext.ses_ops(T, G, C) == 6 * T * G * C
    assert roofline_ext.ses_bytes(T, C) == 4 * T * C
    # at the cell's shape the operations bound a sweep, not the bytes
    assert roofline_ext.ses_least_s(T, G, C) == pytest.approx(
        6 * T * G * C / 67e12)
    per_forecast = (roofline_ext.ses_least_s(T, 33, C)
                    + roofline_ext.ses_least_s(T, 17, C))
    assert per_forecast == pytest.approx(4.46e-3, rel=1e-2)
    # a one-point sweep reads more bytes than it computes
    assert roofline_ext.ses_least_s(T, 1, C) == pytest.approx(
        4 * T * C / roofline.PEAK_BYTES)
