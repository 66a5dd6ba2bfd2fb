"""The spread of runs, as the bounds are set from it."""
from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile over the median, as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2)
