"""Profiling / tracing hooks.

Port of ``easy_vitpose_tpu/utils/profiling.py``: a device trace of a code
block, here ``torch.profiler`` (host activity, and the card's kernels and
copies where CUDA is present) written as a Chrome trace, plus a
lightweight per-stage wall-clock aggregator for the serving pipeline.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to
    ``logdir/trace.json`` (chrome://tracing, Perfetto) when it ends, also
    when it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StageTimer:
    """Accumulates host wall-clock per named pipeline stage.  A stage that
    queues work on the card ends before the card does: time a stage that
    ends in a fetch or a synchronize."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        lines = [f"  {k:20s} {v['mean_ms']:8.2f} ms x {v['calls']}"
                 for k, v in sorted(self.summary().items())]
        return "\n".join(lines)
