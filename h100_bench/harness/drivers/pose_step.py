"""Traffic kind ``pose_step``: the serving entry, dispatched ahead.

A pool of ``frames`` distinct uint8 frames and, for each, ``slots`` boxes
(the awkward ones first; the last ``masked`` slots masked) sit on the card
before the window.  The window calls ``pose_step`` on the next pool entry
each time and fetches every step's keypoints to the host through pinned
memory, with at most ``in_flight`` steps queued (a traced run first times
``enqueue_steps`` such calls on the host, untraced).  Crops per second count
every slot the steps run, over the whole window.  After the window,
``check_steps`` steps drawn from the seed are held to the reference.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from harness import inputs, weights
from harness.trace import WINDOW, span
from reference import compare, vitpose_ref


def made(ctx) -> dict:
    """The benchmark's weights and inputs from the seed, on the device."""
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    w = weights.vitpose_weights(weights.port_config(c), ctx.seed, dev)
    F, (H, W), M = tr["frames"], tr["frame_hw"], tr["slots"]
    frames = inputs.noise_frames(ctx.seed, F, H, W, dev)
    rng = inputs.host_rng(ctx.seed, 1)
    boxes = torch.from_numpy(np.stack([inputs.make_boxes(rng, M, H, W) for _ in range(F)]))
    mask = torch.from_numpy(np.arange(M) < M - tr["masked"])
    return {"weights": w, "frames": frames, "boxes": boxes.to(dev), "mask": mask.to(dev)}


def qbits(config) -> int:
    return 8 if config["serving_dtype"] == "int8" else None


def setup(ctx):
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy

    s = made(ctx)
    ctx.mark("inputs")
    cfg = weights.port_config(ctx.config)
    s["model"] = serving_copy(weights.vitpose_model(cfg, s["weights"], ctx.device),
                              ctx.config["serving_dtype"])
    return s


def control(ctx) -> dict:
    """The control: the reference at the next precision down (int4 for
    int8) in the program's place, on ``check_steps`` pool entries."""
    s, parts = made(ctx), []
    for j in range(ctx.traffic["check_steps"]):
        heat, ref, geo = vitpose_ref.pose(s["weights"], s["frames"][j], s["boxes"][j],
                                          ctx.config, qbits(ctx.config))
        _, low, _ = vitpose_ref.pose(s["weights"], s["frames"][j], s["boxes"][j], ctx.config, 4)
        low = torch.where(s["mask"][:, None, None], low, torch.zeros_like(low))
        parts.append(compare.pose_numbers(low, s["mask"], heat, ref, geo)[0])
    return compare.worst(parts)


def run(ctx):
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    tr, dev = ctx.traffic, ctx.device
    s = setup(ctx)
    ctx.mark("program")
    model, frames, boxes, mask = s["model"], s["frames"], s["boxes"], s["mask"]
    F, M, K = tr["frames"], tr["slots"], ctx.config["num_keypoints"]
    cuda = dev.type == "cuda"
    ring = [torch.empty((M, K, 3), pin_memory=cuda) for _ in range(tr["in_flight"] + 1)]

    def enqueue(i):
        with span("bench.enqueue"):
            kp = pose_step(model, frames[i % F], boxes[i % F], mask)
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
    steps = len(outputs)
    failed = sum(not np.isfinite(kp).all() for _, kp in outputs)
    del model, s["model"]
    ctx.free()

    rng = inputs.host_rng(ctx.seed, 2)
    picks = sorted(rng.choice(steps, size=min(tr["check_steps"], steps), replace=False))
    parts, diags, refs = [], [], {}
    for n in picks:
        i, kp = outputs[n]
        j = i % F
        if j not in refs:
            refs[j] = vitpose_ref.pose(s["weights"], frames[j], boxes[j], ctx.config,
                                       qbits(ctx.config))
        heat, ref, geo = refs[j]
        nums, diag = compare.pose_numbers(torch.from_numpy(kp), mask, heat, ref, geo)
        parts.append(nums)
        diags.append(diag)
    return ctx.result(setup_s=ctx.setup_s, window_s=t1 - t0, units=steps * M, steps=steps,
                      attempted=steps, failed=failed, numbers=compare.worst(parts),
                      diag=compare.worst(diags), enqueue_s=enqueue_s)
