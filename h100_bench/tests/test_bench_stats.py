"""Rates are taken over every unit and the whole window; spreads as the
contract reads them."""
import statistics

import pytest

from harness import readers, stats


def test_rate_counts_all_units_over_the_whole_window():
    class Run:
        units, window_s = 64 * 1601, 20.25
    assert readers.per_second(Run()) == 64 * 1601 / 20.25


def test_spread_is_the_quartile_distance_over_the_median():
    v = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)
