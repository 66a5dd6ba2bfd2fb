"""Traffic kind ``pose_plus_step``: the mixed-task serving entry, dispatched ahead.

A ViTPose+ int8 serving copy (``models/moe.py::PlusQ8``) and a
pool of ``frames`` distinct uint8 frames sit on the card, each with
``slots`` boxes (``pose_step``'s boxes: the awkward ones first, the last
``masked`` slots masked) and, on the host, a task per box: the live boxes'
tasks drawn from the seed, independently, by ``task_shares`` and left in box
order; the masked ones ``masked_task``.  Each frame's mix gives its heads
batches of their own sizes, so the warm-up runs every pool entry
(``warmup_steps`` at least ``frames``).  The window calls ``pose_step(...,
tasks=)`` on the next pool entry each time and fetches every step's
keypoints to the host through pinned memory, with at most ``in_flight``
steps queued (a traced run first times ``enqueue_steps`` such calls on the
host, untraced).  Crops per second count every slot the steps run, over the
whole window.  After the window, ``check_steps`` steps drawn from the seed
are held to the reference (``reference/vitpose_plus_ref.py``).

The run records the counters of the routed step over the window: the
grouped GEMM's launches, the rows routed to the experts and padded, the
heads' and the decode's launches; and, from its own host data, the window's
crops by K and the experts each step meets.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from harness import inputs, plus_weights
from harness.trace import WINDOW, span
from reference import compare, vitpose_plus_ref
from reference.compare_plus import plus_numbers


def draw_tasks(ctx, F: int, M: int) -> np.ndarray:
    """(F, M) task ids: the live boxes' drawn i.i.d. by the traffic's
    shares, the masked ones the traffic's ``masked_task``."""
    tr, names = ctx.traffic, ctx.config["tasks"]
    p = np.array([tr["task_shares"][n] for n in names], np.float64)
    live = M - tr["masked"]
    t = np.full((F, M), names.index(tr["masked_task"]), np.int64)
    t[:, :live] = inputs.host_rng(ctx.seed, 3).choice(len(names), size=(F, live), p=p / p.sum())
    return t


def made(ctx) -> dict:
    """The benchmark's weights and inputs from the seed, on the device."""
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    w = plus_weights.plus_weights(c, ctx.seed, dev)
    F, (H, W), M = tr["frames"], tr["frame_hw"], tr["slots"]
    frames = inputs.noise_frames(ctx.seed, F, H, W, dev)
    rng = inputs.host_rng(ctx.seed, 1)
    boxes = torch.from_numpy(np.stack([inputs.make_boxes(rng, M, H, W) for _ in range(F)]))
    mask = torch.from_numpy(np.arange(M) < M - tr["masked"])
    return {"weights": w, "frames": frames, "boxes": boxes.to(dev), "mask": mask.to(dev),
            "tasks": draw_tasks(ctx, F, M)}


def qbits(config) -> int:
    return 8 if config["serving_dtype"] == "int8" else None


def control(ctx) -> dict:
    """The control: the reference at the next precision down (int4 for
    int8) in the program's place, on ``check_steps`` pool entries."""
    s, parts = made(ctx), []
    for j in range(ctx.traffic["check_steps"]):
        args = (s["weights"], s["frames"][j], s["boxes"][j], s["tasks"][j], ctx.config)
        heats, ref, geo = vitpose_plus_ref.pose(*args, qbits(ctx.config))
        _, low, _ = vitpose_plus_ref.pose(*args, 4)
        low = torch.where(s["mask"][:, None, None], low, torch.zeros_like(low))
        parts.append(plus_numbers(low, s["mask"], s["tasks"][j], heats, ref, geo)[0])
    return compare.worst(parts)


def counters(cuda: bool) -> dict:
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models import moe, quant

    rows = moe.routed_rows()
    return {"grouped_gemm": quant.grouped_gemm_launches() if cuda else 0,
            "padded_rows": rows.pop("padded"), "rows": sum(rows.values()),
            "heads": sum(moe.head_launches().values()),
            "decode": kernels.launch_counts().get("decode", 0)}


def run(ctx):
    # the port's mixed-task step first: a checkout without it stops here
    from easy_vitpose_tpu_torch.models.moe import PlusQ8
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    tr, dev, c = ctx.traffic, ctx.device, ctx.config
    s = made(ctx)
    ctx.mark("inputs")
    model = PlusQ8(s["weights"], plus_weights.plus_port_config(c))
    ctx.mark("program")
    frames, boxes, mask, tasks = s["frames"], s["boxes"], s["mask"], s["tasks"]
    F, M, K = tr["frames"], tr["slots"], max(c["num_keypoints"])
    cuda = dev.type == "cuda"
    ring = [torch.empty((M, K, 3), pin_memory=cuda) for _ in range(tr["in_flight"] + 1)]

    def enqueue(i):
        with span("bench.enqueue"):
            kp = pose_step(model, frames[i % F], boxes[i % F], mask, tasks=tasks[i % F])
        host = ring[i % len(ring)]
        host.copy_(kp, non_blocking=cuda)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        return i, host, ev

    def fetch(item):
        i, host, ev = item
        with span("bench.fetch"):
            if ev is not None:
                ev.synchronize()
        return i, host.numpy().copy()

    for i in range(tr["warmup_steps"]):
        fetch(enqueue(i))
    ctx.mark("warmup")
    enqueue_s = []
    if ctx.trace:        # the host's time to queue a step, before the profiler adds its own
        queue = collections.deque()
        for i in range(tr["enqueue_steps"]):
            t = time.perf_counter()
            queue.append(enqueue(i))
            enqueue_s.append(time.perf_counter() - t)
            if len(queue) >= tr["in_flight"]:
                fetch(queue.popleft())
        while queue:
            fetch(queue.popleft())
    ctx.sync()
    before = counters(cuda)
    outputs = []
    queue = collections.deque()
    with ctx.profiled() as prof:
        with span(WINDOW):
            ctx.start_window()
            t0 = time.perf_counter()
            deadline, i = t0 + ctx.seconds, 0
            while time.perf_counter() < deadline:
                queue.append(enqueue(i))
                i += 1
                if len(queue) >= tr["in_flight"]:
                    outputs.append(fetch(queue.popleft()))
            while queue:
                outputs.append(fetch(queue.popleft()))
            t1 = time.perf_counter()
    ctx.end_window(prof)
    after = counters(cuda)
    steps = len(outputs)
    failed = sum(not np.isfinite(kp).all() for _, kp in outputs)
    window = {k: after[k] - before[k] for k in after}
    crops_by_k = collections.Counter()
    experts = []
    for i, _ in outputs:
        t = tasks[i % F]
        for e, n in zip(*np.unique(t, return_counts=True)):
            crops_by_k[c["num_keypoints"][e]] += int(n)
        experts.append(len(np.unique(t)))
    del model
    ctx.free()

    rng = inputs.host_rng(ctx.seed, 2)
    picks = sorted(rng.choice(steps, size=min(tr["check_steps"], steps), replace=False))
    parts, diags, refs = [], [], {}
    for n in picks:
        i, kp = outputs[n]
        j = i % F
        if j not in refs:
            refs[j] = vitpose_plus_ref.pose(s["weights"], frames[j], boxes[j], tasks[j], c,
                                            qbits(c))
        heats, ref, geo = refs[j]
        nums, diag = plus_numbers(torch.from_numpy(kp), mask, tasks[j], heats, ref, geo)
        parts.append(nums)
        diags.append(diag)
    diag = compare.worst(diags)
    diag["per_step"] = {k: v / max(steps, 1) for k, v in window.items()}
    return ctx.result(setup_s=ctx.setup_s, window_s=t1 - t0, units=steps * M, steps=steps,
                      attempted=steps, failed=failed, numbers=compare.worst(parts), diag=diag,
                      enqueue_s=enqueue_s, counters=window, crops_by_k=dict(crops_by_k),
                      experts_per_step=experts)
