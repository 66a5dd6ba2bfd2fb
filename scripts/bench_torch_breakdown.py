"""Where the PyTorch port's pose step spends its time on the GPU.

For ViT-B, 64 slots and a 1080p frame from ``--seed`` (random weights), at
int8 and bf16:

* stages of one pose step (crop geometry + sampler, backbone, head, decode),
  device time between CUDA events, mean over ``--reps`` steps;
* each launch of one transformer block at the same shapes, beside one
  PyTorch call for the same sub-step as a yardstick (cuBLAS ``matmul`` /
  ``_int_mm`` for the GEMMs, ``scaled_dot_product_attention`` for the
  attention); the port never calls these.  Timed as ``chip_smoke.time_ms``
  does: the median of five windows of at least 50 ms;
* the device's busy share over a few steps and the kernels that take the
  most device time, from ``torch.profiler``;
* the peak device memory one step allocates beyond the weights.

Usage (repository root, one CUDA card):
    python3 scripts/bench_torch_breakdown.py [--seed 0] [--reps 20] [--out FILE]
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


def stage_times(torch, model, frame, boxes, reps):
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.models.head import head_forward
    from easy_vitpose_tpu_torch.models.vit import vit_forward
    from easy_vitpose_tpu_torch.models.vitpose import compute_dtype
    from easy_vitpose_tpu_torch.ops.decode import keypoints_from_heatmaps_udp
    from easy_vitpose_tpu_torch.ops.preprocess import crop_geometry
    from easy_vitpose_tpu_torch.ops.sampler import sample_normalize

    names = ("geometry_sampler", "backbone", "head", "decode")
    total = dict.fromkeys(names, 0.0)
    for rep in range(reps + 1):                      # the first is a warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        geo = crop_geometry(boxes, tuple(frame.shape[:2]))
        x = sample_normalize(frame, geo, IMAGE_SIZE, compute_dtype(model))
        ev[1].record()
        feats = vit_forward(model.backbone, x)
        ev[2].record()
        heat = head_forward(model.keypoint_head, feats.permute(0, 3, 1, 2)).float()
        ev[3].record()
        center = torch.stack([geo["wp"] // 2, geo["hp"] // 2], -1).float()
        scale = torch.stack([geo["wp"], geo["hp"]], -1).float()
        keypoints_from_heatmaps_udp(heat.contiguous(), center, scale)
        ev[4].record()
        torch.cuda.synchronize()
        if rep:
            for i, n in enumerate(names):
                total[n] += ev[i].elapsed_time(ev[i + 1])
    return {n: v / reps for n, v in total.items()}


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


def profile_step(torch, model, frame, boxes, mask, steps=5):
    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    pose_step(model, frame, boxes, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        pose_step(model, frame, boxes, mask)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            pose_step(model, frame, boxes, mask)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / steps, e.count // steps)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": n}
                            for k, ms, n in rows[:10]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", help="write the whole result here as JSON")
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
    rng = np.random.default_rng(args.seed)
    model = init_params(get_model_config("coco", "b"), args.seed).to(dev)
    H, W = cs.FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(cs.make_boxes(rng, cs.SLOTS, H, W)).to(dev)
    mask = torch.ones(cs.SLOTS, dtype=torch.bool, device=dev)
    copies = {d: serving_copy(model, d) for d in ("int8", "bf16")}

    result = {"card": card, "config": "ViT-B coco, 64 slots, 1080p, random weights"}
    with torch.no_grad():
        for d, sm in copies.items():
            result[f"stages_{d}"] = stage_times(torch, sm, frame, boxes, args.reps)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            pose_step(sm, frame, boxes, mask)
            torch.cuda.synchronize()
            result[f"step_peak_mib_{d}"] = (torch.cuda.max_memory_allocated() - base) / 2**20
            result[f"profile_{d}"] = profile_step(torch, sm, frame, boxes, mask)
        result["block_parts"] = block_parts(torch, copies, dev)
    for k, v in result.items():
        print(k + ":", json.dumps(v))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
