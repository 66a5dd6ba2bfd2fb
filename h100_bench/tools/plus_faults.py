"""Faults planted in the port's mixed-task ViTPose+ step, to show that the
cell's ``correct`` catches them, and their readings at the cell's size.

    python3 h100_bench/tools/plus_faults.py --fault plus_expert --seeds 11 12 ... \
        [--workload plus-h-int8-mixed-64] [--seconds 2] [--out readings.jsonl]

Each fault is a context manager that patches one entry of the port and
restores it (``tools/faults.py``'s ``patched``):

* ``plus_expert``: coco's and ap10k's experts trade places in every block of
  the serving copy, so those tasks' crops meet another task's expert rows;
* ``plus_head``: coco's and ap10k's heads trade places (both have K 17);
* ``plus_shift``: every live keypoint moved 4 frame pixels right.

Runs as ``tools/readings.py`` does, one JSON line a seed, on the card from
the checkout's root.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from tools.faults import patched  # noqa: E402

A, B = 0, 3          # coco and ap10k: the same K, so their heads trade too


def _copy_fault(edit):
    @contextlib.contextmanager
    def fault():
        from easy_vitpose_tpu_torch.models import moe

        def wrap(real):
            def make(*args, **kw):
                return edit(real(*args, **kw))
            return make

        with patched(moe, "PlusQ8", wrap):
            yield
    return fault


def _swap_experts(model):
    for blk in model.backbone.blocks:
        for n in ("ex_wq", "ex_s", "ex_b"):
            t = getattr(blk, n)
            t[[A, B]] = t[[B, A]].clone()
    return model


def _swap_heads(model):
    model.heads[A], model.heads[B] = model.heads[B], model.heads[A]
    return model


@contextlib.contextmanager
def _shift():
    import easy_vitpose_tpu_torch.pipeline.pose_step as ps

    def wrap(real):
        def step(model, frame, boxes, mask, **kw):
            kp = real(model, frame, boxes, mask, **kw).clone()
            ks = torch.tensor(model.num_keypoints, device=kp.device)[
                torch.as_tensor(kw["tasks"], device=kp.device)]
            live = (torch.arange(kp.shape[1], device=kp.device)[None] < ks[:, None]) & mask[:, None]
            kp[..., 1] += 4.0 * live.to(kp.dtype)
            return kp
        return step

    with patched(ps, "pose_step", wrap):
        yield


FAULTS = {"plus_expert": _copy_fault(_swap_experts), "plus_head": _copy_fault(_swap_heads),
          "plus_shift": _shift}


def main() -> int:
    import run as bench_run
    from harness import core

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="plus-h-int8-mixed-64")
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
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
        with FAULTS[args.fault]():
            line = bench_run.run_cell(cell, seed, args.seconds, False, args.device,
                                      time.perf_counter())
        row = {k: line[k] for k in ("correct", "compared", "diagnostics")}
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
