"""Arithmetic shared by the metric readers in ``metrics/``."""
from __future__ import annotations

import re
from typing import Iterable, Optional


def per_second(run, units: Optional[float] = None) -> float:
    """Units completed over the whole window (host clock)."""
    return (run.units if units is None else units) / run.window_s


def idle_percent(run) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card."""
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def kernel_seconds(run, names: Iterable[str]) -> float:
    """Device seconds in the traced window of the kernels whose names hold
    one of ``names`` as a whole word."""
    pat = re.compile(r"\b(" + "|".join(re.escape(n) for n in names) + r")\b")
    return run.summary.kernel_seconds(pat)


def roofline_percent(run, bound_s: float, names: Iterable[str]) -> Optional[float]:
    """The least time the peaks allow over the kernels' device time; None
    where the trace shows none of them."""
    if run.summary is None:
        return None
    t = kernel_seconds(run, names)
    return 100.0 * bound_s / t if t > 0 else None


def mfu_percent(run, least_s: float) -> Optional[float]:
    """The least time the peaks allow for the window's model operations
    over the traced window."""
    if run.summary is None or run.summary.window_s <= 0:
        return None
    return 100.0 * least_s / run.summary.window_s
