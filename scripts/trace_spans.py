"""The program's spans in one traced benchmark run: where each stage's
device time and host time go.

Runs one cell of the H100 benchmark (``h100_bench/``) with ``--trace 1``,
as ``h100_bench/run.py`` does, and keeps the profile's events, which the
benchmark's own summary reads only for its ``bench.*`` spans.  From them
it reads the port's ``evt.*`` spans (``easy_vitpose_tpu_torch/utils/
profiling.py::span``):

* each device operation inside the window is given to the innermost
  ``evt.*`` span open when the host made its launch call, the runtime or
  driver call with the operation's correlation id: device ms per step of
  each span and its operations that take the most, and the share of the
  window's device time that no span launched (the harness's own copies);
* each span's host ms (median of its durations inside the window) and the
  host ms of the CUDA runtime and driver calls that start inside it on any
  thread (median per span): against the span's own time it says whether
  the host waits on a full launch queue or is itself slow;
* the share of the window in the collector's ``evt.gc.gen1`` and
  ``evt.gc.gen2`` spans;
* the longest idle gaps of the card, each named by the innermost
  ``bench.*`` or ``evt.*`` span the host was in at its middle.

Beside them it prints the cell's own result line (its per-layer metrics,
device, breakdown).  Usage (repository root, one CUDA card):

    python3 scripts/trace_spans.py --workload pose-b-int8-64 --seed 7 \\
        [--seconds 10] [--out FILE]

Prints one JSON object and appends it to ``--out``.
"""
from __future__ import annotations

import argparse
import bisect
import json
import re
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

PROCESS_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
WINDOW = "bench.window"
PROGRAM = "evt."
LAUNCH = re.compile(r"^cu(da)?[A-Z]")   # a CUDA runtime or driver call

Interval = Tuple[int, int, object]      # (start ns, end ns, name or correlation id)


def sort_events(events) -> dict:
    """The profile's events as intervals: host spans (``bench.*``,
    ``evt.*``), host CUDA calls with their correlation ids and names, and the card's
    operations (kernels, copies, sets; not a span's device-side copy)."""
    spans, calls, dev = [], [], []
    for e in events:
        a = e.start_ns()
        b, name = a + e.duration_ns(), e.name()
        if not str(e.device_type()).endswith("CPU"):
            if not e.is_user_annotation() and not name.startswith(("bench.", PROGRAM)):
                dev.append((a, b, name, e.correlation_id()))
        elif name.startswith(("bench.", PROGRAM)):
            spans.append((a, b, name))
        elif LAUNCH.match(name):
            calls.append((a, b, e.correlation_id(), name))
    return {"spans": spans, "calls": sorted(calls), "dev": dev}


def innermost(spans: Sequence[Interval], times: Sequence[int]) -> List[Optional[str]]:
    """The innermost span (latest start) covering each of the sorted
    ``times``, or None.  The spans nest, as one thread's do; a collector's
    span on another thread falls inside the span the waiting thread holds."""
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            while stack and stack[-1][1] < order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def device_by_span(program, dev, calls, window) -> Tuple[Dict[str, Dict[str, float]],
                                                         Dict[str, float]]:
    """(device seconds inside the window by operation name of the operations
    each program span launched, device seconds by operation name of those
    that no span launched or whose launch call the profile lacks)."""
    w0, w1 = window
    at = {c[2]: c[0] for c in calls}
    owned, loose = [], {}
    for a, b, op, c in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if c in at:
            owned.append((at[c], a, b, op))
        else:
            loose[op] = loose.get(op, 0.0) + (b - a) * 1e-9
    owned.sort()
    out: Dict[str, Dict[str, float]] = {}
    for name, (_, a, b, op) in zip(innermost(program, [o[0] for o in owned]), owned):
        by_op = loose if name is None else out.setdefault(name, {})
        by_op[op] = by_op.get(op, 0.0) + (b - a) * 1e-9
    return out, loose


def calls_by_span(spans, calls, window) -> Dict[str, List[float]]:
    """For each span inside the window, in order of start, the host seconds
    of the CUDA calls (sorted by start) that start inside it."""
    starts = [c[0] for c in calls]
    total = [0]
    for a, b, *_ in calls:
        total.append(total[-1] + (b - a))
    out: Dict[str, List[float]] = {}
    for a, b, name in sorted(spans):
        if window[0] <= a and b <= window[1]:
            i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
            out.setdefault(name, []).append((total[j] - total[i]) * 1e-9)
    return out


def slow_calls(calls, at_least_ns: int = 50_000) -> List[list]:
    """CUDA calls of at least ``at_least_ns`` by name: [name, count, total
    ms], most time first; a launch that waits for room in the queue is one."""
    out: Dict[str, list] = {}
    for a, b, _, name in calls:
        if b - a >= at_least_ns:
            row = out.setdefault(name, [name, 0, 0.0])
            row[1] += 1
            row[2] += 1e-6 * (b - a)
    return sorted(out.values(), key=lambda r: -r[2])


def idle_gaps(dev, window, n: int = 10) -> List[Tuple[int, int]]:
    """The ``n`` longest stretches of the window with no device operation."""
    w0, w1 = window
    busy: List[List[int]] = []
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b, _, _ in dev):
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return sorted(gaps, key=lambda g: g[0] - g[1])[:n]


def top(ops: Dict[str, float], steps: int, n: int = 8) -> List[list]:
    """The ``n`` operations with the most device time: [name, ms a step]."""
    rows = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    return [[k, 1e3 * v / max(steps, 1)] for k, v in rows]


def split(events, steps: int) -> dict:
    """The spans' reading of one traced window of ``steps`` units of work."""
    ev = sort_events(events)
    win = [s for s in ev["spans"] if s[2] == WINDOW]
    if not win:
        raise RuntimeError("the profile holds no bench.window span")
    window = win[0][:2]
    inner = [s for s in ev["spans"] if s[2] != WINDOW]
    program = [s for s in inner if s[2].startswith(PROGRAM)]
    dev_ops, loose = device_by_span(program, ev["dev"], ev["calls"], window)
    dev_s = {n: sum(ops.values()) for n, ops in dev_ops.items()}
    calls = [c for c in ev["calls"] if window[0] <= c[0] <= window[1]]
    host = calls_by_span(program, calls, window)
    window_s = (window[1] - window[0]) * 1e-9
    durations: Dict[str, List[float]] = {}
    for a, b, name in inner:
        if window[0] <= a and b <= window[1]:
            durations.setdefault(name, []).append((b - a) * 1e-9)
    names = sorted(set(dev_s) | {s[2] for s in program})
    gaps = idle_gaps(ev["dev"], window)                 # longest first
    by_start = sorted(range(len(gaps)), key=lambda i: gaps[i][0])
    at = innermost(inner, [(gaps[i][0] + gaps[i][1]) // 2 for i in by_start])
    gap_names = dict(zip(by_start, at))
    gc_s = sum(sum(v) for k, v in durations.items() if k.startswith(PROGRAM + "gc."))
    spanned, unspanned = sum(dev_s.values()), sum(loose.values())
    total = spanned + unspanned
    return {
        "steps": steps, "window_s": window_s, "cuda_calls": len(calls),
        "slow_calls": slow_calls(calls),
        "spans": {n: {"device_ms_per_step": 1e3 * dev_s.get(n, 0.0) / max(steps, 1),
                      "count": len(durations.get(n, [])),
                      "host_ms_median": 1e3 * statistics.median(durations[n])
                      if durations.get(n) else None,
                      "call_ms_median": 1e3 * statistics.median(host[n])
                      if host.get(n) else None,
                      "top_ops_ms_per_step": top(dev_ops.get(n, {}), steps)}
                  for n in names},
        "device_ms_per_step_no_span": 1e3 * unspanned / max(steps, 1),
        "no_span_ops_ms_per_step": top(loose, steps),
        "span_share_of_device_pct": 100.0 * spanned / total if total else None,
        "gc_share_pct": 100.0 * gc_s / window_s if window_s else None,
        "idle_gaps": [[gap_names[i] or "host", 1e-6 * (b - a)] for i, (a, b) in enumerate(gaps)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = ROOT / "h100_bench"
    sys.path[:0] = [str(bench), str(ROOT)]
    import torch
    from harness import core, trace

    import run as bench_run

    if not torch.cuda.is_available():
        print("trace_spans.py: needs a CUDA card", file=sys.stderr)
        return 2
    kept = {}
    summarize = trace.summarize

    def keep(prof):
        kept["events"] = prof.events
        return summarize(prof)

    trace.summarize = keep
    from easy_vitpose_tpu_torch import kernels
    kernels.build()
    cell = core.Cell(core.load_manifest(ROOT), args.workload)
    line = bench_run.run_cell(cell, args.seed, args.seconds, True, "cuda",
                              process_start=PROCESS_START)
    steps = line["attempted"]
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), "correct": line["correct"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()},
           "device": line["device"], "breakdown": line.get("breakdown"),
           **split(kept["events"], steps)}
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
