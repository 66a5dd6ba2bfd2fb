"""Time the serving path of one checkout of the PyTorch port.

The serving counterpart of ``scripts/bench_torch_train_ab.py``.  For the
checkout at ``--root`` (default: this repository) it imports that checkout's
``chip_smoke.py`` and package, and on one CUDA card, with ViT-B weights and
inputs from ``--seed``:

* first, with PyTorch's global TF32 flags as a user finds them
  (``torch.backends.cudnn.allow_tf32`` True), runs the default
  ``VitInference`` frame, ``VitInference(vitpose-b.npz, yolo=yolov8n.npz,
  model_name="b")`` with no ``dtype`` (fp32), on ``chip_smoke.py``'s
  1080p noise frame: its detections, the pose step's heatmaps and the
  keypoints go to ``--out`` with ``.frame.npz`` in place of ``.json``, and
  its ms per frame into the line; with ``--against`` the gaps to the other
  run's frame are reported (``fp32_frame_gap``);
* then, with both flags False, times the pose step (64 slots, one 1080p
  frame of noise, 4 masked slots, as ``chip_smoke.py``) at int8, bf16 and
  fp32: host clock around synchronized steps, median of five windows of
  ``--reps`` steps (a fifth of them at fp32) after a warm-up;
* times, per launch at block 0's shapes and 64 crops (CUDA events, the
  median of five windows of at least 50 ms, as ``chip_smoke.time_ms``):
  K1 bf16 (``fused_block``), K1 fp32, K2 (``fused_block_q8``), the bf16
  forward attention, the four bf16 GEMMs (qkv, proj with the residual, fc1
  with GELU, fc2 with the residual), the four int8 GEMMs (the row
  quantisation included, as ``gemm_q8_cuda`` runs it), K1 fp32's seven
  launches one by one (LN1, qkv, attention, proj, LN2, fc1, fc2) and
  ``nn.TransformerEncoderLayer`` at float32 on the same block;
* counts the device operations (kernels, copies, fills) of one pose step
  with ``torch.profiler``, and the host's time to queue a step;
* records a SHA-256 of the int8 pose step's outputs on the timed step's
  frame and boxes (the backbone's features, the heatmaps, the keypoints'
  coordinates and scores);
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


def int8_pose_digests(torch, model, frame, boxes, mask) -> dict:
    """SHA-256 of the int8 pose step's outputs on the timed step's frame and
    boxes: the backbone's features, the heatmaps, and the keypoints'
    coordinates and scores."""
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE
    from easy_vitpose_tpu_torch.models.vit import vit_forward
    from easy_vitpose_tpu_torch.models.vitpose import compute_dtype
    from easy_vitpose_tpu_torch.ops import sampler
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

    crops, _ = sampler.crop_normalize(frame, boxes, IMAGE_SIZE, compute_dtype(model))
    heat, _ = pose_heatmaps(model, frame, boxes)
    kp = pose_step(model, frame, boxes, mask)
    return {"backbone": sha(torch, vit_forward(model.backbone, crops)),
            "heatmaps": sha(torch, heat), "keypoints": sha(torch, kp[..., :2]),
            "scores": sha(torch, kp[..., 2])}


def fp32_default_frame(torch, cs, model, seed: int, frame_out: str) -> dict:
    """The default fp32 ``VitInference`` image frame with the global TF32
    flags untouched: writes its detections, heatmaps and keypoints to
    ``frame_out`` and returns its ms per frame (graphed, steady state)."""
    import tempfile
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    flags = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    frame = np.random.default_rng(seed + 3).integers(0, 256, (*cs.FRAME_HW, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        pose, det = os.path.join(d, "vitpose-b-coco.npz"), os.path.join(d, "yolov8n.npz")
        cs.save_pose_npz(pose, model)
        spec = yolo.YoloSpec("n")
        yolo.save_yolo_npz(det, yolo.init_yolo_params(seed, spec, frame, 320), "n")
        vi = VitInference(pose, yolo=det, model_name="b")
        for _ in range(2):                       # the slot high-water mark rises
            vi.inference(frame)
        seen = []
        with cs.decode_spy(ps, seen), cs.eager_graphs(vi._detector):
            out = vi.inference(frame)
        heat = seen[-1][0].float().cpu().numpy()
        kp = np.stack([out[k] for k in sorted(out)]) if out else np.zeros((0, 17, 3))
        np.savez(frame_out, detections=np.asarray(vi._yolo_res, np.float32), heatmaps=heat,
                 keypoints=kp.astype(np.float32))

        def frames(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                vi.inference(frame)
            return (time.perf_counter() - t0) * 1e3 / n

        ms = statistics.median(frames(5) for _ in range(3))
    return {"ms_per_frame": ms, "people": len(out), "flags": flags}


def frame_gap(a: str, b: str) -> dict:
    """Gaps between two runs' default fp32 frames (``.frame.npz``)."""
    fa, fb_ = np.load(a), np.load(b)
    gap = {"same_detection_count": fa["detections"].shape == fb_["detections"].shape}
    if gap["same_detection_count"]:
        gap["detections_max_abs"] = float(np.abs(fa["detections"] - fb_["detections"]).max(initial=0))
    if fa["heatmaps"].shape == fb_["heatmaps"].shape:
        h, g = fa["heatmaps"], fb_["heatmaps"]
        gap["heatmaps_max_abs"] = float(np.abs(h - g).max())
        gap["heatmaps_rel_to_range"] = gap["heatmaps_max_abs"] / float(h.max() - h.min())
    if fa["keypoints"].shape == fb_["keypoints"].shape:
        d = np.abs(fa["keypoints"] - fb_["keypoints"])
        gap["keypoints_xy_max_px"] = float(d[..., :2].max(initial=0))
        gap["keypoints_score_max_abs"] = float(d[..., 2].max(initial=0))
    return gap


def k1_fp32_split(torch, cs, fb, blk, x) -> dict:
    """K1 fp32 at block 0, whole and launch by launch (each fed the kernel
    path's own intermediates; the GEMMs from the TF32 halves the block
    holds, where the tree has them), and ``nn.TransformerEncoderLayer`` at
    float32 on the same weights and tokens."""
    B, N, D = x.shape
    a, mlp = blk.attn, blk.mlp
    x2 = x.reshape(B * N, D)
    ln = lambda n, t: fb.layernorm_cuda(t, n.weight, n.bias, blk.eps, torch.float32)  # noqa: E731
    halves = getattr(blk, "tf32_halves", None)
    sq, sp, s1, s2 = ({"split": s} for s in halves) if halves else ({},) * 4
    h = ln(blk.norm1, x2)
    qkv = fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias, **sq)
    o = fb.attention_cuda(qkv, B, N, a.num_heads)
    x1 = fb.gemm_cuda(o, a.proj.weight, a.proj.bias, fb.EPI_RESIDUAL, x2, **sp)
    h2 = ln(blk.norm2, x1)
    hid = fb.gemm_cuda(h2, mlp.fc1.weight, mlp.fc1.bias, fb.EPI_GELU, **s1)
    launches = {
        "ln1": lambda: ln(blk.norm1, x2),
        "qkv": lambda: fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias, **sq),
        "attention": lambda: fb.attention_cuda(qkv, B, N, a.num_heads),
        "proj": lambda: fb.gemm_cuda(o, a.proj.weight, a.proj.bias, fb.EPI_RESIDUAL, x2, **sp),
        "ln2": lambda: ln(blk.norm2, x1),
        "fc1": lambda: fb.gemm_cuda(h2, mlp.fc1.weight, mlp.fc1.bias, fb.EPI_GELU, **s1),
        "fc2": lambda: fb.gemm_cuda(hid, mlp.fc2.weight, mlp.fc2.bias, fb.EPI_RESIDUAL, x1,
                                    **s2)}
    out = {f"{k}_ms": cs.time_ms(torch, fn) for k, fn in launches.items()}
    out["sum_ms"] = sum(out[f"{k}_ms"] for k in launches)
    out["block_ms"] = cs.time_ms(torch, lambda: fb.fused_block(x, blk))
    layer = cs.encoder_layer(torch, blk)
    out["encoder_layer_ms"] = cs.time_ms(torch, lambda: layer(x))
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

    cs.check(os.path.dirname(kernels.__file__).startswith(root), "imported another checkout")
    kernels.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    model = init_params(get_model_config("coco", "b"), args.seed).to(dev)
    cfg = model.cfg.backbone
    B, N, D = cs.SLOTS, cfg.num_tokens, cfg.embed_dim
    out = {"root": root, "card": torch.cuda.get_device_name(0)}
    frame_out = (args.out[:-5] if args.out and args.out.endswith(".json") else
                 (args.out or "serve_ab")) + ".frame.npz"
    with torch.no_grad():        # PyTorch's default flags, as a user's process has them
        out["fp32_frame_default_flags"] = fp32_default_frame(torch, cs, model, args.seed,
                                                             frame_out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # pose steps
    H, W = cs.FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(cs.make_boxes(rng, B, H, W)).to(dev)
    mask = torch.arange(B, device=dev) < B - 4
    copies = {dt: serving_copy(model, dt) for dt in ("int8", "bf16", "fp32")}
    with torch.no_grad():
        for dt, sm in copies.items():
            pose_step(sm, frame, boxes, mask)
            reps = args.reps if dt != "fp32" else max(2, args.reps // 5)

            def window():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    pose_step(sm, frame, boxes, mask)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3 / reps

            out[f"pose_step_{dt}_ms"] = statistics.median(window() for _ in range(5))
            out[f"pose_step_{dt}_device_ops"], out[f"pose_step_{dt}_host_queue_ms"] = \
                step_ops(torch, lambda: pose_step(sm, frame, boxes, mask))

        # per launch at block 0
        x = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).to(dev)
        blk, qb = copies["bf16"].backbone.blocks[0], copies["int8"].backbone.blocks[0]
        xb = x.bfloat16()
        out["K1_bf16_ms"] = cs.time_ms(torch, lambda: fb.fused_block(xb, blk))
        out["K2_ms"] = cs.time_ms(torch, lambda: quant.fused_block_q8(xb, qb))
        out["K1_fp32"] = k1_fp32_split(torch, cs, fb, copies["fp32"].backbone.blocks[0], x)
        out["K1_fp32_ms"] = out["K1_fp32"]["block_ms"]
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
        out["int8_pose_digests"] = int8_pose_digests(torch, copies["int8"], frame, boxes, mask)
    if args.against:
        with open(args.against) as f:
            other = json.load(f)
        out["int8_bit_equal_to_against"] = {n: other["int8_digests"].get(n) == d
                                            for n, d in digests.items()}
        out["fp32_frame_gap"] = frame_gap(frame_out, (args.against[:-5] if args.against.endswith(
            ".json") else args.against) + ".frame.npz")
        out["serving_bit_equal_to_against"] = {
            n: other.get("serving_digests", {}).get(n) == d
            for n, d in out["serving_digests"].items()}
        out["int8_pose_bit_equal_to_against"] = {
            n: other.get("int8_pose_digests", {}).get(n) == d
            for n, d in out["int8_pose_digests"].items()}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
