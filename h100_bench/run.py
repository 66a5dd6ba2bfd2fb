"""Run one cell of the port's H100 benchmark and print its result line.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, ``h100_bench/`` and
the port (``easy_vitpose_tpu_torch``), on a machine with the cards the cell
asks for.  The cell's configuration, traffic mix and metrics are found by
name (``harness/core.py``); the traffic's ``kind`` names the driver that
sets up the port, warms every shape it will use, measures for ``--seconds``
and then holds what the timed path produced to the plain reference.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profile of the same window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``compared``: each number that decides ``correct``
beside its limit, also printed as the last lines of standard error.  The
run exits non-zero and prints no result without enough CUDA cards, or when
JAX, Flax or the JAX package was loaded.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness import core  # noqa: E402


class Context:
    """What a driver is handed: the cell, the seed and window, the device,
    and the hooks that time, trace and report a run."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device,
                 process_start: float = PROCESS_START):
        import torch

        self.torch = torch
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.process_start = process_start
        self.setup_s = None
        self.marks = {}
        self.summary = None
        self.memory_peak = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def profiled(self):
        from harness.trace import profiled
        return profiled(self.trace)

    def mark(self, stage: str) -> None:
        """Seconds from the process's start to the end of a set-up stage,
        printed with the result, so that a slow set-up shows its stage."""
        self.sync()
        self.marks[stage] = time.perf_counter() - self.process_start

    def start_window(self) -> None:
        """Set-up ends here: the process's start to the first timed unit."""
        self.sync()
        self.setup_s = time.perf_counter() - self.process_start

    def end_window(self, prof) -> None:
        """After the window: the peak memory, then the profile's summary."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = self.torch.cuda.max_memory_allocated(self.device)
        if prof is not None:
            from harness.trace import summarize
            self.summary = summarize(prof)

    def free(self) -> None:
        """Drop the program's freed memory before the reference runs."""
        import gc
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def result(self, **kw):
        from types import SimpleNamespace
        return SimpleNamespace(summary=self.summary, memory_peak=self.memory_peak,
                               config=self.config, traffic=self.traffic, **kw)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, process_start=PROCESS_START,
             marks=None):
    """Drive the cell once; -> (result line as a dict, compared numbers)."""
    from reference import compare

    ctx = Context(cell, seed, seconds, trace, device, process_start)
    ctx.marks.update(marks or {})
    run = core.load_driver(cell.traffic["kind"], cell.bench).run(ctx)
    compared = compare.held(run.numbers, cell.limits)
    metrics = {}
    for m in cell.metrics(trace):
        value = core.load_metric(m["name"], cell.bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": compare.passes(compared) and run.failed == 0,
            "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device_record(ctx, run)}
    if trace and run.summary is not None:
        line["breakdown"] = run.summary.breakdown()
    line["diagnostics"] = dict(run.diag, setup_marks=ctx.marks)
    line["compared"] = compared
    return line


def device_record(ctx, run) -> dict:
    torch = ctx.torch
    if ctx.device.type != "cuda":
        rec = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
               "count": ctx.cell.chips, "memory_peak_bytes": run.memory_peak}
    if run.summary is not None:
        rec["busy_s"] = run.summary.busy_s
        rec["window_s"] = run.summary.window_s
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # a kernel cache at a fixed place inside the checkout (the port builds
    # its own into easy_vitpose_tpu_torch/_build)
    os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / ".cache" / "triton"))

    cell = core.Cell(core.load_manifest(ROOT), args.workload)
    import torch
    marks = {"import_torch": time.perf_counter() - PROCESS_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    marks["cuda_init"] = time.perf_counter() - PROCESS_START
    from easy_vitpose_tpu_torch import kernels
    kernels.build()
    marks["kernels"] = time.perf_counter() - PROCESS_START
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", marks=marks)
    found = core.forbidden_modules()
    if found:
        print(f"run.py: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
