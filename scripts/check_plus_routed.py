"""ViTPose+-H served on boxes of mixed tasks, held to the task-spliced int8
models on the card, at the benchmark cell's own size.

    python3 scripts/check_plus_routed.py [--seed N] [--workload plus-h-int8-mixed-64]

From a checkout's root on a machine with a CUDA card.  Makes the cell's
weights, frames, boxes and tasks from the seed (its driver's ``made``), then
for each of the traffic's pool frames, and for a mix of the first frame's
boxes with one task absent: the routed backbone's features of each task's
crops against the spliced int8 model's features of those crops alone, bit
for bit; one step queued under ``torch.cuda.set_sync_debug_mode("error")``;
the launch counters of one step (the grouped GEMM once a block, the rows
routed to each expert, the heads, the decode); and ms a step.  Prints one
JSON line; exits 1 if a check fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "h100_bench"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2 ** 31 + 23)
    ap.add_argument("--workload", default="plus-h-int8-mixed-64")
    args = ap.parse_args()

    import run as bench_run
    from harness import core, plus_weights
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.models import moe, quant
    from easy_vitpose_tpu_torch.models.vit import vit_forward
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.ops.sampler import crop_normalize
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    kernels.build()
    dev = torch.device("cuda")
    cell = core.Cell(core.load_manifest(ROOT), args.workload)
    ctx = bench_run.Context(cell, args.seed, 0, False, dev)
    driver = core.load_driver(cell.traffic["kind"])
    s = driver.made(ctx)
    c = ctx.config
    cfg = plus_weights.plus_port_config(c)
    model = moe.PlusQ8(s["weights"], cfg)
    frames, boxes, mask, tasks = s["frames"], s["boxes"], s["mask"], s["tasks"]
    names, depth = c["tasks"], c["depth"]
    absent = tasks[0].copy()
    absent[absent == names.index("aic")] = names.index("coco")
    cases = [(j, tasks[j]) for j in range(len(frames))] + [(0, absent)]
    out = {"card": torch.cuda.get_device_name(dev), "seed": args.seed, "failures": []}

    def fail(msg):
        out["failures"].append(msg)

    # one step's launches and routed rows, then one step under the sync check
    pose_step(model, frames[0], boxes[0], mask, tasks=tasks[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    moe.reset_routing_counts()
    g0 = quant.grouped_gemm_launches()
    q0 = sum(quant.gemm_q8_launches().values())
    pose_step(model, frames[0], boxes[0], mask, tasks=tasks[0])
    torch.cuda.synchronize()
    counts = np.bincount(tasks[0], minlength=len(names))
    out["launches"] = {**kernels.launch_counts(), "grouped_gemm": quant.grouped_gemm_launches() - g0,
                       "dense_gemm_q8": sum(quant.gemm_q8_launches().values()) - q0,
                       "heads": moe.head_launches()}
    out["routed_rows"] = moe.routed_rows()
    want_rows = {"padded": 0, **{names[e]: depth * int(n) * 192 for e, n in enumerate(counts) if n}}
    if out["routed_rows"] != want_rows:
        fail(f"routed rows {out['routed_rows']} != {want_rows}")
    if out["launches"]["grouped_gemm"] != depth or out["launches"]["dense_gemm_q8"] != 4 * depth:
        fail(f"GEMM launches {out['launches']}")
    if out["launches"].get("decode") != int((counts > 0).sum()):
        fail(f"decode launches {out['launches']}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pose_step(model, frames[1], boxes[1], mask, tasks=tasks[1])
        out["sync_free"] = True
    except RuntimeError as e:
        out["sync_free"] = False
        fail(f"host sync: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    # ms a step, the host clock over 20 steps queued back to back
    t0 = time.perf_counter()
    for i in range(20):
        pose_step(model, frames[i % len(frames)], boxes[i % len(frames)], mask,
                  tasks=tasks[i % len(frames)])
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - t0) / 20 * 1e3

    # features: routed against each task's spliced int8 model on its own crops
    routed = []
    with torch.no_grad():
        for j, t in cases:
            r = moe.Routing(t, len(names), 192).to(dev)
            x, _ = crop_normalize(frames[j], boxes[j].index_select(0, r.order_t), IMAGE_SIZE,
                                  torch.bfloat16)
            routed.append((j, t, r, moe.routed_backbone(model, x, r)))
        del model
        equal = {}
        for e, name in enumerate(names):
            spliced = serving_copy(moe.task_model(s["weights"], cfg, name), "int8")
            for k, (j, t, r, feats) in enumerate(routed):
                sl = [x for x in r.slices if x[0] == e]
                if not sl:
                    continue
                (_, first, end), = sl
                own = torch.from_numpy(np.flatnonzero(t == e)).to(dev)
                x, _ = crop_normalize(frames[j], boxes[j].index_select(0, own), IMAGE_SIZE,
                                      torch.bfloat16)
                same = torch.equal(feats[first:end], vit_forward(spliced.backbone, x))
                equal.setdefault(name, []).append(same)
                if not same:
                    fail(f"features of {name} on case {k} differ from the spliced model's")
            del spliced
            torch.cuda.empty_cache()
    out["features_equal"] = {k: f"{sum(v)}/{len(v)}" for k, v in equal.items()}
    out["ok"] = not out["failures"]
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
