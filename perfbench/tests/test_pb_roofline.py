"""The roofline arithmetic counts the logical problem, not a padding."""
import pytest

from perfbench import roofline


def test_gram_counts_the_logical_triangle():
    assert roofline.gram_ops(2000, 100000) == 2000 * 2001 / 2 * 100000 * 2
    assert roofline.gram_bytes(2000, 100000) == (2000 * 100000
                                                 + 2000 * 2001 / 2 * 4)


@pytest.mark.parametrize('n, p, ms', [(2000, 100000, 0.20222),
                                      (2000, 1038240, 2.09956),
                                      (14610, 100000, 10.7866)])
def test_pm1_gram_least_time_is_the_int8_operations(n, p, ms):
    least = roofline.pm1_gram_least_s(n, p)
    assert least == pytest.approx(ms * 1e-3, rel=1e-4)
    # operations bound it at these shapes, not bytes
    assert least == roofline.gram_ops(n, p) / roofline.PEAK_OPS['int8']


def test_logical_least_time_is_below_the_padded_one():
    # the program pads (2000, 100000) to (2048, 100096); the yardstick
    # must not move with a padding
    assert (roofline.pm1_gram_least_s(2000, 100000)
            < roofline.least_time_s(roofline.gram_ops(2048, 100096),
                                    roofline.gram_bytes(2048, 100096),
                                    'int8'))
    assert (roofline.pm1_gram_least_s(2000, 100000)
            / roofline.least_time_s(roofline.gram_ops(2048, 100096),
                                    roofline.gram_bytes(2048, 100096),
                                    'int8')) == pytest.approx(0.953, abs=1e-3)


def test_bytes_bound_a_short_wide_gram():
    n, p = 8, 10 ** 7
    assert roofline.pm1_gram_least_s(n, p) == (roofline.gram_bytes(n, p)
                                               / roofline.PEAK_BYTES)
