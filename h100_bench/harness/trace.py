"""The traced run: spans from the benchmark's own code, the device's trace.

Spans are ``torch.profiler.record_function`` ranges named ``bench.*``
around the harness's calls into the port; on a run without the profiler
they cost a no-op context.  :func:`summarize` reads one profile: every
device operation's interval, the union of them (busy seconds) inside the
``bench.window`` span, the device time of each kernel name, the longest
idle gaps named by the innermost ``bench.*`` span the host was in, and each
span's durations.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"


def span(name: str):
    return torch.profiler.record_function(name)


class Profile:
    """The events of one profile, there once the profiled block has ended."""

    def __init__(self):
        self.events = []


@contextlib.contextmanager
def profiled(enabled: bool):
    """A profile of the block, or None: the card's operations and, on the
    host, only the ``bench.*`` spans (``record_function``'s user scope).
    Recording every ATen operator on the host as well stretched a ViT-L
    training step of 64 crops on an H100 from 105 to 146 ms, so that the
    idle share and the mfu measured the profiler."""
    if not enabled:
        yield None
        return
    from torch._C._profiler import ProfilerActivity, RecordScope
    from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch.autograd.profiler import profile

    activities = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        activities.add(ProfilerActivity.CUDA)
    config = profile(use_kineto=True).config()
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    prof = Profile()
    try:
        yield prof
    finally:
        prof.events = _disable_profiler().events()


def _device_event(e) -> bool:
    """A kernel, copy or set on the card; not a span's device-side copy."""
    return (str(e.device_type()).endswith("CUDA") and not e.is_user_annotation()
            and not e.name().startswith("bench."))


class Summary:
    """What a profile says about one window."""

    def __init__(self, window: Tuple[float, float], busy: List[Tuple[float, float]],
                 kernels: Dict[str, float], spans: Dict[str, List[float]],
                 gaps: List[Tuple[str, float]]):
        self.window_s = window[1] - window[0]
        self.busy_s = sum(b - a for a, b in busy)
        self.kernels = kernels          # device seconds by kernel name
        self.spans = spans              # bench.* span durations in seconds
        self.gaps = gaps                # (span, seconds), longest first

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of every kernel whose name ``pattern`` searches."""
        return sum(s for k, s in self.kernels.items() if pattern.search(k))

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps[:10]]}


def summarize(prof) -> Summary:
    events = prof.events
    spans, dev = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if _device_event(e):
            dev.append((start, start + dur, e.name()))
        elif e.name().startswith("bench.") and str(e.device_type()).endswith("CPU"):
            spans.append((start, start + dur, e.name()))
    win = [s for s in spans if s[2] == WINDOW]
    if not win:
        raise RuntimeError("the profile holds no bench.window span")
    w0, w1 = win[0][0], win[0][1]
    kernels: Dict[str, float] = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
        clipped.append((a, b))
    clipped.sort()
    busy: List[Tuple[float, float]] = []
    for a, b in clipped:
        if busy and a <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], b))
        else:
            busy.append((a, b))
    inner = sorted((s for s in spans if s[2] != WINDOW), key=lambda s: s[0])
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [(_host_at(inner, (a + b) / 2), (b - a) * 1e-9) for a, b in gaps[:10]]
    durations: Dict[str, List[float]] = {}
    for a, b, name in inner:
        if w0 <= a and b <= w1:
            durations.setdefault(name, []).append((b - a) * 1e-9)
    return Summary((w0 * 1e-9, w1 * 1e-9), [(a * 1e-9, b * 1e-9) for a, b in busy],
                   kernels, durations, named)


def _host_at(spans, t: float) -> str:
    """The innermost span (latest start) covering host time ``t``."""
    best = "host"
    for a, b, name in spans:
        if a > t:
            break
        if b >= t:
            best = name
    return best
