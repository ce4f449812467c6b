"""The n x n tail's yardstick (``perfbench/roofline_tail.py``) and the two
readers of its spans, ``tail_ms_per_run.rulen`` and
``tail_roofline.rulen``, on a synthetic span tree."""
import pytest

from perfbench import program_trace as pt
from perfbench import roofline_tail as rt
from perfbench.harness import reader
from perfbench.tests.test_pb_program_trace import (SHIFT, _activity, _span,
                                                   _us_after)


@pytest.mark.parametrize('n, ms', [(2000, 1.5920398), (9132, 151.55199),
                                   (10958, 261.85316)])
def test_the_tail_counts_40_n_cubed_over_3_operations(n, ms):
    # per field a fold of 2 n^3 real multiply-adds and a Hermitian
    # Cholesky of n^3 / 6 complex ones, then one triangular product of
    # n^3 / 3
    assert rt.tail_ops(n) == pytest.approx(40 * n ** 3 / 3, rel=1e-12)
    assert rt.tail_ops(n) == pytest.approx(
        2 * (2 * 2 * n ** 3 + 8 * n ** 3 / 6) + 8 * n ** 3 / 3, rel=1e-12)
    assert rt.tail_bytes(n) == 20 * n * n
    least = rt.tail_least_s(n)
    assert least == pytest.approx(ms * 1e-3, rel=1e-6)
    # operations bound it at these lengths, not bytes
    assert least == rt.tail_ops(n) / rt.PEAK_F32_FLOPS
    assert rt.tail_bytes(n) / rt.PEAK_BYTES < least / 50


def test_bytes_bound_a_tiny_kernel():
    assert rt.tail_least_s(1) == rt.tail_bytes(1) / rt.PEAK_BYTES


@pytest.fixture
def program(monkeypatch):
    def install(spans):
        monkeypatch.setattr(pt, '_program_spans', lambda: (
            [dict(s) for s in spans], lambda t: t + SHIFT))
        monkeypatch.setattr(pt, '_last', [None, None])
    return install


def _ctx(units, n_obs=2000):
    u = _us_after
    return {'activity': _activity([('a', u(10), u(20))]), 'units': units,
            'window_s': 1e-4, 'calls': 1, 'spans': {},
            'config': {'n_obs': n_obs}, 'traffic': {}}


def _rule_n_run():
    """One Rule-N run: a draw-time gram span a field holding its fold,
    the reduction's gram span holding reduce, two recovers under the run;
    a stray fold outside every run."""
    u = _us_after
    return [
        _span(3, 2, 'fold', u(3), u(4), device_ms=0.5),
        _span(2, 1, 'gram', u(2), u(5), device_ms=1.0),
        _span(5, 4, 'fold', u(6), u(7), device_ms=0.5),
        _span(4, 1, 'gram', u(5), u(8), device_ms=1.0),
        _span(7, 6, 'reduce', u(9), u(11), device_ms=2.0),
        _span(6, 1, 'gram', u(8), u(12), device_ms=2.0),
        _span(9, 1, 'recover', u(13), u(14), device_ms=0.125),
        _span(10, 1, 'recover', u(15), u(16), device_ms=0.125),
        _span(1, 0, 'run', u(1), u(17), {'seed': 3}),
        _span(11, 0, 'fold', u(18), u(19), device_ms=7.0),
        _span(0, None, 'rule_n', u(0), u(20)),
    ]


def test_readers_sum_the_tail_spans_under_the_runs(program):
    program(_rule_n_run())
    ctx = _ctx(units=1)
    assert reader('tail_ms_per_run.rulen')(ctx) == pytest.approx(3.25)
    # the counted work (fold, reduce) took 3.0 ms
    assert reader('tail_roofline.rulen')(ctx) == pytest.approx(
        100 * rt.tail_least_s(2000) / 3.0e-3)
    assert reader('tail_ms_per_run.rulen')(_ctx(units=2)) == pytest.approx(
        1.625)
    assert reader('tail_roofline.rulen')(_ctx(units=0)) is None


def test_a_program_without_the_tail_spans_reads_nothing(program,
                                                        monkeypatch):
    # the spans of a program from before the tail's spans
    program([s for s in _rule_n_run()
             if s['name'] not in rt.TAIL_SPANS])
    assert reader('tail_ms_per_run.rulen')(_ctx(units=1)) is None
    assert reader('tail_roofline.rulen')(_ctx(units=1)) is None
    monkeypatch.setattr(pt, '_program_spans', lambda: None)
    monkeypatch.setattr(pt, '_last', [None, None])
    assert reader('tail_ms_per_run.rulen')(_ctx(units=1)) is None
    assert reader('tail_roofline.rulen')(_ctx(units=1)) is None
