"""Time the serving path of one checkout of the PyTorch port.

The serving counterpart of ``scripts/bench_torch_train_ab.py``.  For the
checkout at ``--root`` (default: this repository) it imports that checkout's
``chip_smoke.py`` and package, and on one CUDA card, with ViT-B weights and
inputs from ``--seed``:

* times the pose step (64 slots, one 1080p frame of noise, 4 masked slots,
  as ``chip_smoke.py``) at int8 and bf16: host clock around synchronized
  steps, median of five windows of ``--reps`` steps after a warm-up;
* times, per launch at block 0's shapes and 64 crops (CUDA events, the
  median of five windows of at least 50 ms, as ``chip_smoke.time_ms``):
  K1 bf16 (``fused_block``), K2 (``fused_block_q8``), the bf16 forward
  attention, the four bf16 GEMMs (qkv, proj with the residual, fc1 with
  GELU, fc2 with the residual) and the four int8 GEMMs (the row
  quantisation included, as ``gemm_q8_cuda`` runs it);
* counts the device operations (kernels, copies, fills) of one pose step
  with ``torch.profiler``, and the host's time to queue a step;
* runs the four int8 GEMMs of K2 once more on fixed inputs made with numpy
  from ``--seed`` (ViT-B block 0's shapes, 64 crops: M = 12288), the crop
  sampler (K3, with its geometry) on the pose step's frame and boxes at
  bf16 and float32, and the pose step's decode (the fused kernel where the
  checkout has it, else the eager route with the full-map K4) on fixed
  heatmaps, geometry and mask, and records a SHA-256 of each output's
  bytes.  With ``--against FILE`` (another run's ``--out``) it reports
  whether each output is the same bits.

It prints one JSON line and writes it to ``--out``.  To compare two
checkouts on one card, run it on each in turns in one call, A, B, B, A:

    python3 scripts/bench_torch_serve_ab.py --root PARENT_DIR --out a1.json
    python3 scripts/bench_torch_serve_ab.py --root . --out b1.json --against a1.json
    ...
"""
import argparse
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np


def sha(torch, t) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def step_ops(torch, fn, steps=3):
    """(device operations per call of ``fn`` from ``torch.profiler``, host
    ms to queue one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return n / steps, host_ms


def serving_digests(torch, frame, boxes, g, dev) -> dict:
    """SHA-256 of the crop sampler's crops and geometry (bf16, float32) on
    the pose step's frame and boxes, and of the pose step's decode on fixed
    heatmaps, through whichever route this checkout has."""
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.ops import decode, preprocess, sampler

    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        if hasattr(sampler, "crop_normalize"):
            crops, geo = sampler.crop_normalize(frame, boxes, IMAGE_SIZE, dt)
        else:
            geo_d = preprocess.crop_geometry(boxes, tuple(frame.shape[:2]))
            crops = sampler.sample_normalize(frame, geo_d, IMAGE_SIZE, dt)
            geo = preprocess.pack_geometry(geo_d)
        out[f"sampler_{name}"] = sha(torch, crops)
        out[f"geometry_{name}"] = sha(torch, geo)
    M = boxes.shape[0]
    heat = torch.from_numpy((g.standard_normal((M, 17, 64, 48)) * 0.3 + 0.3)
                            .astype(np.float32)).to(dev)
    geo = preprocess.pack_geometry(preprocess.crop_geometry(boxes, tuple(frame.shape[:2])))
    mask = torch.arange(M, device=dev) < M - 4
    if hasattr(decode, "decode_keypoints"):
        kp = decode.decode_keypoints(heat, geo, mask)
    else:                       # the eager route of pipeline/pose_step.py before the fused decode
        gd = {k: geo[:, i] for i, k in enumerate(preprocess.GEO_KEYS)}
        center = torch.stack([gd["wp"] // 2, gd["hp"] // 2], -1).float()
        scale = torch.stack([gd["wp"], gd["hp"]], -1).float()
        preds, maxvals = decode.keypoints_from_heatmaps_udp(heat, center, scale)
        off_x = (gd["x1"] - gd["left"]).float()[:, None]
        off_y = (gd["y1"] - gd["top"]).float()[:, None]
        kp = torch.stack([preds[..., 1] + off_y, preds[..., 0] + off_x, maxvals[..., 0]], -1)
        kp = torch.where(mask[:, None, None], kp, torch.zeros_like(kp))
    out["decode_keypoints"] = sha(torch, kp)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20, help="pose steps in each timed window")
    ap.add_argument("--out", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block as fb, quant, vit
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.check(os.path.dirname(kernels.__file__).startswith(root), "imported another checkout")
    kernels.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    model = init_params(get_model_config("coco", "b"), args.seed).to(dev)
    cfg = model.cfg.backbone
    B, N, D = cs.SLOTS, cfg.num_tokens, cfg.embed_dim
    out = {"root": root, "card": torch.cuda.get_device_name(0)}

    # pose steps
    H, W = cs.FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(cs.make_boxes(rng, B, H, W)).to(dev)
    mask = torch.arange(B, device=dev) < B - 4
    copies = {dt: serving_copy(model, dt) for dt in ("int8", "bf16")}
    with torch.no_grad():
        for dt, sm in copies.items():
            pose_step(sm, frame, boxes, mask)

            def window():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    pose_step(sm, frame, boxes, mask)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / args.reps

            out[f"pose_step_{dt}_ms"] = statistics.median(window() for _ in range(5))
            out[f"pose_step_{dt}_device_ops"], out[f"pose_step_{dt}_host_queue_ms"] = \
                step_ops(torch, lambda: pose_step(sm, frame, boxes, mask))

        # per launch at block 0
        x = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).to(dev)
        blk, qb = copies["bf16"].backbone.blocks[0], copies["int8"].backbone.blocks[0]
        xb = x.bfloat16()
        out["K1_bf16_ms"] = cs.time_ms(torch, lambda: fb.fused_block(xb, blk))
        out["K2_ms"] = cs.time_ms(torch, lambda: quant.fused_block_q8(xb, qb))
        a, mlp = blk.attn, blk.mlp
        x2 = xb.reshape(B * N, D)
        h = fb.layernorm_cuda(x2, blk.norm1.weight, blk.norm1.bias, blk.eps, torch.bfloat16)
        qkv = fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias)
        o = fb.attention_cuda(qkv, B, N, a.num_heads)
        hid = fb.gemm_cuda(h, mlp.fc1.weight, mlp.fc1.bias, fb.EPI_GELU)
        out["attention_ms"] = cs.time_ms(torch, lambda: fb.attention_cuda(qkv, B, N, a.num_heads))
        bf16_gemms = {
            "qkv": lambda: fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias),
            "proj": lambda: fb.gemm_cuda(o, a.proj.weight, a.proj.bias, fb.EPI_RESIDUAL, x2),
            "fc1": lambda: fb.gemm_cuda(h, mlp.fc1.weight, mlp.fc1.bias, fb.EPI_GELU),
            "fc2": lambda: fb.gemm_cuda(hid, mlp.fc2.weight, mlp.fc2.bias, fb.EPI_RESIDUAL, x2)}
        for name, fn in bf16_gemms.items():
            out[f"gemm_bf16_{name}_ms"] = cs.time_ms(torch, fn)
        out["gemm_bf16_sum_ms"] = sum(out[f"gemm_bf16_{n}_ms"] for n in bf16_gemms)

        # int8 GEMMs: times at block 0, and output bits on fixed numpy inputs
        g = np.random.default_rng(args.seed + 1)
        hidden = int(D * cfg.mlp_ratio)
        digests = {}
        for name, (n_out, k_in, out_dt, epi) in {
                "qkv": (3 * D, D, torch.bfloat16, fb.EPI_NONE),
                "proj": (D, D, torch.bfloat16, fb.EPI_RESIDUAL),
                "fc1": (hidden, D, torch.float32, fb.EPI_GELU),
                "fc2": (D, hidden, torch.bfloat16, fb.EPI_RESIDUAL)}.items():
            hin = torch.from_numpy(g.standard_normal((B * N, k_in)).astype(np.float32)).to(dev)
            w = torch.from_numpy((g.standard_normal((n_out, k_in)) * 0.03).astype(np.float32))
            wq, sw = (t.to(dev) for t in quant.quantize_linear(w))
            bias = torch.from_numpy((g.standard_normal(n_out) * 0.1).astype(np.float32)).to(dev)
            res = (torch.from_numpy(g.standard_normal((B * N, n_out)).astype(np.float32))
                   .to(dev, out_dt) if epi == fb.EPI_RESIDUAL else None)
            run = lambda: quant.gemm_q8_cuda(hin, wq, sw, bias, out_dt, epi, res)  # noqa: E731
            y = run()
            torch.cuda.synchronize()
            digests[name] = hashlib.sha256(y.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            out[f"gemm_int8_{name}_ms"] = cs.time_ms(torch, run)
        out["gemm_int8_sum_ms"] = sum(out[f"gemm_int8_{n}_ms"] for n in digests)
        out["int8_digests"] = digests
        out["serving_digests"] = serving_digests(torch, frame, boxes, g, dev)
    if args.against:
        with open(args.against) as f:
            other = json.load(f)
        out["int8_bit_equal_to_against"] = {n: other["int8_digests"].get(n) == d
                                            for n, d in digests.items()}
        out["serving_bit_equal_to_against"] = {
            n: other.get("serving_digests", {}).get(n) == d
            for n, d in out["serving_digests"].items()}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
