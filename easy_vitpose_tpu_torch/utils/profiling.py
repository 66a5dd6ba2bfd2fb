"""Profiling / tracing hooks.

Port of ``easy_vitpose_tpu/utils/profiling.py``: a device trace of a code
block, here ``torch.profiler`` (host activity, and the card's kernels and
copies where CUDA is present) written as a Chrome trace, plus a
lightweight per-stage wall-clock aggregator for the serving pipeline.

The program's spans: :func:`span` opens a ``record_function`` range on the
profiler's clock while a profiler records on the calling thread, and is a
shared no-op context otherwise (one check a call).  Names are
``evt.<layer>.<stage>``:

  evt.pose.step, .sample, .backbone, .head, .decode   pipeline/pose_step.py,
                                                       models/vitpose.py
  evt.train.step, .render, .forward, .backward,       train/step.py
    .optimizer
  evt.frame.upload, .dispatch, .fetch, .track         pipeline/inference.py
  evt.gc.gen1, evt.gc.gen2                            a ``gc.callbacks`` hook
                                                       here, one a collection

``scripts/trace_spans.py`` reads them from a traced benchmark run: each
device operation goes to the innermost span open when its launch call was
made.
"""
from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records on this
    thread, else the shared no-op context."""
    if _profiler_enabled():
        return record_function(name)
    return _NO_SPAN


_GC_SPANS = {1: "evt.gc.gen1", 2: "evt.gc.gen2"}
_gc_open = threading.local()


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a span over each generation 1 or 2 collection
    that starts while a profiler records; a stop with no open span is
    ignored."""
    if phase == "start":
        if info["generation"] and _profiler_enabled():
            rf = record_function(_GC_SPANS[info["generation"]])
            rf.__enter__()
            _gc_open.rf = rf
        return
    rf = getattr(_gc_open, "rf", None)
    if rf is not None:
        _gc_open.rf = None
        rf.__exit__(None, None, None)


def _install_gc_span() -> None:
    """One hook however often this module is (re)imported: an earlier
    copy's is replaced."""
    gc.callbacks[:] = [cb for cb in gc.callbacks
                       if getattr(cb, "__qualname__", None) != _gc_span.__qualname__
                       or getattr(cb, "__module__", None) != __name__]
    gc.callbacks.append(_gc_span)


_install_gc_span()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the block, written to
    ``logdir/trace.json`` (chrome://tracing, Perfetto) when it ends, also
    when it raises."""
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
    ends in a fetch or a synchronize.  Each stage is also a :func:`span`
    of the same name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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
