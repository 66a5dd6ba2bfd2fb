"""Where the PyTorch port's pose step spends its time on the GPU.

For ViT-B, 64 slots and a 1080p frame from ``--seed`` (random weights), at
int8 and bf16:

* stages of one pose step (the crop kernel with its geometry, backbone,
  head, the fused decode), device time between CUDA events, mean over
  ``--reps`` steps, with each stage's device operations (kernels, copies,
  fills) from ``torch.profiler``; beside them, on the same heatmaps, the
  decode's plain version (``decode_keypoints_plain``), its time and
  operations, and the operations of the geometry's plain version
  (``crop_geometry`` + ``pack_geometry``).  A sleep kernel holds the
  stream while the host queues each step, so no stage holds the host's
  time to issue it;
* each launch of one transformer block at the same shapes, beside one
  PyTorch call for the same sub-step as a yardstick (cuBLAS ``matmul`` /
  ``_int_mm`` for the GEMMs, ``scaled_dot_product_attention`` for the
  attention); the port never calls these.  Timed as ``chip_smoke.time_ms``
  does: the median of five windows of at least 50 ms;
* the device's busy share over a few steps, its operations per step, the
  kernels that take the most device time (``torch.profiler``) and the
  host's time to queue a step;
* the peak device memory one step allocates beyond the weights;
* the train step as ``chip_smoke.py`` drives it (64 crops, AMP, drop-path,
  fused Adam) at ``--size`` (ViT-B by default) with Adam moments at
  ``--moments``: device time of the step's own phases (render, forward +
  loss, backward, optimizer; ``train/step.py``'s helpers) between CUDA
  events, its busy share, top kernels and the bf16 training GEMM's device
  time by layout (NT, NN, the TN pairs);
* a backward's two weight grads (the MLP's, K6a and K6c, and the
  attention's, K7) as one pair launch, as the port runs them, beside two
  launches of the same kernel with one product each, on the same bf16
  operands at ViT-B's and ViT-L's widths and 64 crops;
* with ``--moments int8``, K9 on each distinct leaf size of that model,
  beside K8 on the same size (each a table of one leaf): device time per
  launch from
  ``torch.profiler`` (so the host's launch gaps do not count), the rate
  over each kernel's bytes (16 per element for K9, 28 for K8), and K9's
  device time per step split between one-block leaves and the rest.  It
  tells a kernel body that cannot keep up with memory (a low rate on the
  largest leaves, where K8 is fast) from launches too small to fill the
  card (a low rate only on the small leaves).

With ``--flavors`` it runs only the A/B of the training block's opt-in
flavors against the default, each pair in one process on one state, in
turns (default, flavor, flavor, default; ``--reps`` steps a turn after a
warm-up step of each): ViT-B (f32 moments) with ``EVT_TRAIN_ATTN=saved``
and with ``EVT_TRAIN_MLP=saved``, ViT-L (int8 moments) with
``EVT_TRAIN_WIDE=recompute`` and with ``EVT_TRAIN_MLP=saved``; ms/step on
the host clock around synchronized steps and the peak memory of each.

Usage (repository root, one CUDA card):
    python3 scripts/bench_torch_breakdown.py [--seed 0] [--reps 20] [--out FILE] \
        [--size l --moments int8] [--flavors]
Prints one JSON object per part, and writes them all to ``--out`` as JSON.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402  (repo root; the smoke's timing helpers)

STAGE_SLEEP_CYCLES = 20_000_000   # about 10 ms at 2 GHz: longer than the host queues a step


def device_ops(torch, fn, calls=3):
    """Device operations (kernels, copies, fills) one call of ``fn``
    launches, counted by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n / calls


def stage_times(torch, model, frame, boxes, mask, reps):
    """Device ms of each stage of the pose step's route (crop kernel,
    backbone, head, fused decode) between CUDA events, mean over ``reps``;
    the device operations of each stage; and, on the same heatmaps, the
    decode's plain version (``decode_keypoints_plain``) and the device
    operations of the geometry's.  A sleep kernel holds the stream while
    the host queues each step, so the events time the device, not the
    host's issuing."""
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.models.head import head_forward
    from easy_vitpose_tpu_torch.models.vit import vit_forward
    from easy_vitpose_tpu_torch.models.vitpose import compute_dtype
    from easy_vitpose_tpu_torch.ops.decode import decode_keypoints, decode_keypoints_plain
    from easy_vitpose_tpu_torch.ops.preprocess import crop_geometry, pack_geometry
    from easy_vitpose_tpu_torch.ops.sampler import crop_normalize

    dt = compute_dtype(model)
    stages = {
        "sampler": lambda: crop_normalize(frame, boxes, IMAGE_SIZE, dt),
        "backbone": lambda x: vit_forward(model.backbone, x),
        "head": lambda f: head_forward(model.keypoint_head, f.permute(0, 3, 1, 2)).contiguous(),
    }
    total = dict.fromkeys(("sampler", "backbone", "head", "decode", "decode_plain"), 0.0)
    for rep in range(reps + 1):                      # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda._sleep(STAGE_SLEEP_CYCLES)
        ev[0].record()
        x, geo = stages["sampler"]()
        ev[1].record()
        # the warm-up step makes the per-device constants, which waits for the sleep
        cs.check(not rep or not ev[0].query(),
                 "the sleep kernel ended before the crop stage was queued")
        feats = stages["backbone"](x)
        ev[2].record()
        heat = stages["head"](feats)
        ev[3].record()
        decode_keypoints(heat, geo, mask)
        ev[4].record()
        decode_keypoints_plain(heat, geo, mask)
        ev[5].record()
        torch.cuda.synchronize()
        if rep:
            for i, n in enumerate(total):
                total[n] += ev[i].elapsed_time(ev[i + 1])
    out = {f"{n}_ms": v / reps for n, v in total.items()}
    out["device_ops"] = {
        "sampler": device_ops(torch, stages["sampler"]),
        "backbone": device_ops(torch, lambda: stages["backbone"](x)),
        "head": device_ops(torch, lambda: stages["head"](feats)),
        "decode": device_ops(torch, lambda: decode_keypoints(heat, geo, mask)),
        "decode_plain": device_ops(torch, lambda: decode_keypoints_plain(heat, geo, mask)),
        "geometry_plain": device_ops(torch, lambda: pack_geometry(
            crop_geometry(boxes, tuple(frame.shape[:2]))))}
    return out


def block_parts(torch, copies, dev):
    """Each launch of block 0 at (64*192, 768), with a library yardstick."""
    import torch.nn.functional as F
    from easy_vitpose_tpu_torch.models import fused_block as fb
    from easy_vitpose_tpu_torch.models import quant

    out = {}
    blk = copies["bf16"].backbone.blocks[0]
    a, m = blk.attn, blk.mlp
    B, N, D, heads = cs.SLOTS, 192, a.proj.weight.shape[0], a.num_heads
    x = torch.randn(B * N, D, device=dev).bfloat16()
    h = fb.layernorm_cuda(x, blk.norm1.weight, blk.norm1.bias, blk.eps, torch.bfloat16)
    qkv = fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias)
    hid = fb.gemm_cuda(h, m.fc1.weight, m.fc1.bias, fb.EPI_GELU)
    q, k, v = qkv.reshape(B, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    parts = {
        "layernorm": (lambda: fb.layernorm_cuda(x, blk.norm1.weight, blk.norm1.bias, blk.eps,
                                                torch.bfloat16), None),
        "gemm_qkv": (lambda: fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias),
                     lambda: torch.matmul(h, a.qkv.weight.t())),
        "attention": (lambda: fb.attention_cuda(qkv, B, N, heads),
                      lambda: F.scaled_dot_product_attention(q, k, v)),
        "gemm_proj_residual": (lambda: fb.gemm_cuda(h, a.proj.weight, a.proj.bias,
                                                    fb.EPI_RESIDUAL, x),
                               lambda: torch.matmul(h, a.proj.weight.t())),
        "gemm_fc1_gelu": (lambda: fb.gemm_cuda(h, m.fc1.weight, m.fc1.bias, fb.EPI_GELU),
                          lambda: torch.matmul(h, m.fc1.weight.t())),
        "gemm_fc2_residual": (lambda: fb.gemm_cuda(hid, m.fc2.weight, m.fc2.bias,
                                                   fb.EPI_RESIDUAL, x),
                              lambda: torch.matmul(hid, m.fc2.weight.t())),
    }
    out["bf16"] = {name: {"ms": cs.time_ms(torch, k_),
                          "library_ms": cs.time_ms(torch, lib) if lib else None}
                   for name, (k_, lib) in parts.items()}

    qb = copies["int8"].backbone.blocks[0]
    hf = h.float()
    hid_f = hid.float()
    qh, _ = quant.rowquant_cuda(hf)
    qm, _ = quant.rowquant_cuda(hid_f)
    wq = {n: qb.linear(n)[0] for n in ("qkv", "proj", "fc1", "fc2")}
    parts_q8 = {
        "rowquant_768": (lambda: quant.rowquant_cuda(hf), None),
        "rowquant_3072": (lambda: quant.rowquant_cuda(hid_f), None),
        "gemm_q8_qkv": (lambda: quant.gemm_q8_cuda(hf, *qb.linear("qkv"), torch.bfloat16),
                        lambda: torch._int_mm(qh, wq["qkv"].t())),
        "gemm_q8_fc1": (lambda: quant.gemm_q8_cuda(hf, *qb.linear("fc1"), torch.float32,
                                                   fb.EPI_GELU),
                        lambda: torch._int_mm(qh, wq["fc1"].t())),
        "gemm_q8_fc2": (lambda: quant.gemm_q8_cuda(hid_f, *qb.linear("fc2"), torch.bfloat16,
                                                   fb.EPI_RESIDUAL, x),
                        lambda: torch._int_mm(qm, wq["fc2"].t())),
    }
    out["int8"] = {name: {"ms": cs.time_ms(torch, k_),
                          "library_ms": cs.time_ms(torch, lib) if lib else None}
                   for name, (k_, lib) in parts_q8.items()}
    out["note"] = ("gemm_q8_* include their row quantisation; library_ms of a GEMM is the "
                   "bare product without bias or epilogue")
    return out


def kernel_rows(prof, steps):
    """(name, device ms per step, launches per step) of each device-side
    event, longest first.  The profiler also credits kernel time to the CPU
    ops and autograd ranges that launched the kernels; those rows are left
    out, so the sum is the device's busy time."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def gemm_layouts(rows):
    """Device ms and launches per step of the bf16 training GEMM by layout,
    from ``kernel_rows``: NT (``gemm_bf16_kernel<true, mode>``, B K-major),
    NN (``<false, mode>``) and the TN pairs (``gemm_tn2_bf16_kernel``)."""
    out = {}
    for name, ms, n in rows:
        layout = ("tn_pairs" if "gemm_tn2_bf16_kernel" in name else
                  "nt" if "gemm_bf16_kernel<true" in name else
                  "nn" if "gemm_bf16_kernel<false" in name else None)
        if layout:
            acc = out.setdefault(layout, {"ms_per_step": 0.0, "launches_per_step": 0})
            acc["ms_per_step"] += ms
            acc["launches_per_step"] += n
    return out


def profile_step(torch, model, frame, boxes, mask, steps=5):
    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    pose_step(model, frame, boxes, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        pose_step(model, frame, boxes, mask)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            pose_step(model, frame, boxes, mask)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, steps)
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms_per_step": wall_ms, "host_queue_ms_per_step": (t1 - t0) * 1e3 / steps,
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
            "device_ops_per_step": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                            for k, ms, n in rows[:10]]}


def train_parts(torch, model, seed, dev, moments="f32", steps=3):
    """The train step's phases (device time between CUDA events, mean over
    ``steps``), wall time, busy share and top kernels of the whole step."""
    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    cfg = model.cfg
    batch = cs.train_batch(torch, np.random.default_rng(seed), cs.SLOTS, dev)
    tx = fused_opt.make_fused_adam(cs.TRAIN_LR, max_grad_norm=cs.TRAIN_CLIP, moment_dtype=moments)
    state = tstep.init_train_state(model, tx, device=dev)
    step = tstep.make_train_step(cfg, tx)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(2):                                        # warm-up
        state, _ = step(state, batch, gen)
    names = ("render", "forward_loss", "backward", "optimizer")
    total = dict.fromkeys(names, 0.0)
    for _ in range(steps):          # the step's own helpers, with events between them
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        rendered = tstep.render_batch_on_device(batch, dev)
        ev[1].record()
        loss, _, leaves = tstep.forward_loss(cfg, state["params"], state["bn_state"], rendered,
                                             generator=gen)
        ev[2].record()
        grads = tstep.backward(loss, leaves)
        ev[3].record()
        tstep.apply_optimizer(tx, grads, state["opt_state"], state["params"])
        ev[4].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1]) / steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    rows = kernel_rows(prof, steps)
    device_ms = sum(r[1] for r in rows)
    return {"config": f"ViT-{cfg.name.upper()}, {cs.SLOTS} crops, AMP, {moments} moments",
            "phases_ms": total, "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms, "training_gemms": gemm_layouts(rows),
            "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                            for k, ms, n in rows[:14]]}


def weight_grad_pairs(torch, dev):
    """ms of a backward's two weight grads as one pair launch (``gemm_tn2``)
    and as two launches of the same kernel with one product each, bf16,
    R = 64 * 192 rows: the MLP's (dm1c^T h2, dm2c^T g; K6a, K6c) and the
    attention's (dqkvc^T h1, dac^T o; K7)."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt

    out = {}
    R = cs.SLOTS * 192
    gen = torch.Generator(device=dev).manual_seed(0)
    none = torch.empty((R, 0), dtype=torch.bfloat16, device=dev)
    for name, D in (("vit_b", 768), ("vit_l", 1024)):
        for part, (m0, n0, m1, n1) in (("mlp", (4 * D, D, D, 4 * D)), ("attn", (3 * D, D, D, D))):
            a0, b0, a1, b1 = (torch.randn(R, c, device=dev, generator=gen).bfloat16()
                              for c in (m0, n0, m1, n1))
            pair = cs.time_ms(torch, lambda: fbt.gemm_tn2(a0, b0, a1, b1))
            two = cs.time_ms(torch, lambda: (fbt.gemm_tn2(a0, b0, none, none),
                                             fbt.gemm_tn2(a1, b1, none, none)))
            out[f"{name}_{part}"] = {"pair_launch_ms": pair, "two_launches_ms": two,
                                     "gflop": 2 * R * (m0 * n0 + m1 * n1) / 1e9}
    return out


def adam_leaf_sizes(torch, params, dev, reps=10):
    """K9 and K8 per distinct leaf size of ``params`` (see the module doc)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch.train import fused_opt

    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda n, sc: torch.randn(n, device=dev, generator=gen) * sc  # noqa: E731
    scal = torch.tensor([0.7, 3.75e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device=dev)
    rows = []
    for n, leaves in sorted(Counter(v.numel() for v in params.values()).items()):
        g, p = rnd(n, 1e-3), rnd(n, 1.0)
        mq, ms = fused_opt.q8_encode(rnd(n, 1e-3), 127)
        nq, ns = fused_opt.q8_encode(rnd(n, 1e-3).abs(), 255)
        mu, nu = rnd(n, 1e-3), rnd(n, 1e-3).square()
        calls = {"adam_q8": lambda: fused_opt.adam_leaf_q8(g, mq, ms, nq, ns, p, scal),
                 "adam": lambda: fused_opt.adam_leaf(g, mu, nu, p, scal)}
        row = {"n": n, "leaves": leaves}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            us = sum(ms_ for key, ms_, _ in kernel_rows(prof, reps)
                     if f"{name}_table_kernel(" in key) * 1e3
            row[f"{name}_us"] = us
            # None where the profiler caught no launch of the kernel
            row[f"{name}_tb_s"] = ((16 if name == "adam_q8" else 28) * n / (us * 1e-6) / 1e12
                                   if us > 0 else None)
        rows.append(row)
    k9 = sum(r["adam_q8_us"] * r["leaves"] for r in rows) / 1e3
    one = sum(r["adam_q8_us"] * r["leaves"] for r in rows if r["n"] <= 2048) / 1e3
    return {"k9_ms_per_step": k9, "k9_ms_one_block_leaves": one,
            "k8_ms_per_step": sum(r["adam_us"] * r["leaves"] for r in rows) / 1e3,
            "sizes": rows}


FLAVOR_AB = (("vit_b_attn_saved", "b", "f32", {"EVT_TRAIN_ATTN": "saved"}),
             ("vit_b_mlp_saved", "b", "f32", {"EVT_TRAIN_MLP": "saved"}),
             ("vit_l_wide_recompute", "l", "int8", {"EVT_TRAIN_WIDE": "recompute"}),
             ("vit_l_mlp_saved", "l", "int8", {"EVT_TRAIN_MLP": "saved"}))


def flavor_ab(torch, seed, dev, reps):
    """Each opt-in flavor against the default (see the module doc)."""
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    out, models = {}, {}
    for name, size, moments, flavor in FLAVOR_AB:
        if size not in models:
            models.clear()
            torch.cuda.empty_cache()
            models[size] = init_params(get_model_config("coco", size), seed).to(dev)
        model = models[size]
        batch = cs.train_batch(torch, np.random.default_rng(seed), cs.SLOTS, dev)
        tx = fused_opt.make_fused_adam(cs.TRAIN_LR, max_grad_norm=cs.TRAIN_CLIP, moment_dtype=moments)
        state = tstep.init_train_state(model, tx, device=dev)
        step = tstep.make_train_step(model.cfg, tx)
        gen = torch.Generator(device=dev).manual_seed(seed)
        times = {"default": [], "flavor": []}
        peak = dict.fromkeys(times, 0.0)
        for turn in ("default", "flavor", "flavor", "default"):
            with cs.flavor_env(flavor if turn == "flavor" else {}):
                if not times[turn]:
                    state, _ = step(state, batch, gen)           # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(reps):
                    state, _ = step(state, batch, gen)
                torch.cuda.synchronize()
                times[turn].append((time.perf_counter() - t0) * 1e3 / reps)
                peak[turn] = max(peak[turn], torch.cuda.max_memory_allocated() / 2 ** 30)
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        out[name] = {"flavor": flavor, "moments": moments, "ms_per_step": ms, "turns_ms": times,
                     "flavor_over_default": ms["flavor"] / ms["default"], "peak_gib": peak}
        print(name + ":", json.dumps(out[name]))
        del state
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write the whole result here as JSON")
    ap.add_argument("--size", default="b", choices=("s", "b", "l", "h"),
                    help="ViT size of the train step (the pose step stays ViT-B)")
    ap.add_argument("--moments", default="f32", choices=("f32", "bf16", "int8"),
                    help="Adam moment dtype of the train step")
    ap.add_argument("--flavors", action="store_true",
                    help="run only the A/B of the training block's flavors")
    args = ap.parse_args()

    import torch
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    kernels.build()
    dev = torch.device("cuda")
    if args.flavors:
        result = {"card": card, "flavor_ab": flavor_ab(torch, args.seed, dev, args.reps)}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return
    rng = np.random.default_rng(args.seed)
    model = init_params(get_model_config("coco", "b"), args.seed).to(dev)
    H, W = cs.FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(cs.make_boxes(rng, cs.SLOTS, H, W)).to(dev)
    mask = torch.arange(cs.SLOTS, device=dev) < cs.SLOTS - 4
    copies = {d: serving_copy(model, d) for d in ("int8", "bf16")}

    result = {"card": card, "config": "ViT-B coco, 64 slots, 1080p, random weights"}
    with torch.no_grad():
        for d, sm in copies.items():
            result[f"stages_{d}"] = stage_times(torch, sm, frame, boxes, mask, args.reps)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pose_step(sm, frame, boxes, mask)
            torch.cuda.synchronize()
            result[f"step_peak_mib_{d}"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            result[f"profile_{d}"] = profile_step(torch, sm, frame, boxes, mask)
        result["block_parts"] = block_parts(torch, copies, dev)
        result["weight_grad_pairs"] = weight_grad_pairs(torch, dev)
    if args.size != "b":
        del model, copies
        model = init_params(get_model_config("coco", args.size), args.seed).to(dev)
    result["train_step"] = train_parts(torch, model, args.seed, dev, args.moments)
    if args.moments == "int8":
        from easy_vitpose_tpu_torch.train.step import split_bn_state
        result["adam_leaf_sizes"] = adam_leaf_sizes(
            torch, split_bn_state(model.state_dict())[0], dev)
    for k, v in result.items():
        print(k + ":", json.dumps(v))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
