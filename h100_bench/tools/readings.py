"""Readings that set a cell's limits and bounds, many seeds in one process.

    python3 h100_bench/tools/readings.py --workload W --seeds 11 12 ... \
        [--seconds 2] [--control] [--trace 0|1] [--out readings.jsonl]

Without ``--control``: a run of the cell per seed (a short window, the
comparison as the benchmark makes it), each printed as one JSON line with
its compared numbers, diagnostics and metrics: the lower readings.  With
``--control``: per seed, the reference at the next precision down in the
program's place, against the reference (the driver's ``control``): the
upper readings.  With ``--fault``: runs with a fault of ``tools/faults.py``
planted in the port.  Run on the card from the checkout's root.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import run as bench_run  # noqa: E402
from harness import core  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", help="a fault of tools/faults.py planted in the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = core.Cell(core.load_manifest(BENCH.parent), args.workload)
    if args.device == "cuda":
        from easy_vitpose_tpu_torch import kernels
        kernels.build()
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.control:
            ctx = bench_run.Context(cell, seed, args.seconds, False, args.device)
            row = {"control": core.load_driver(cell.traffic["kind"], cell.bench).control(ctx)}
        else:
            from tools.faults import FAULTS
            plant = FAULTS[args.fault] if args.fault else contextlib.nullcontext
            with plant():
                line = bench_run.run_cell(cell, seed, args.seconds, bool(args.trace),
                                          args.device, time.perf_counter())
            row = {k: line[k] for k in ("correct", "metrics", "diagnostics", "compared")}
            row["device"] = line["device"]
            if "breakdown" in line:
                row["breakdown"] = line["breakdown"]
        row.update(workload=args.workload, fault=args.fault, seed=seed,
                   seconds=time.perf_counter() - t0)
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        bench_run.Context(cell, seed, 0, False, args.device).free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
