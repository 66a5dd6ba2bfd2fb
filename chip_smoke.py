#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check its kernels.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py [--seed 0]

1. prints the host record: the card's name and power limit, CUDA, nvcc
   and triton versions;
2. builds every kernel from ``easy_vitpose_tpu_torch/csrc`` (one nvcc per
   source, all at once);
3. holds each kernel (K1 bf16 and fp32, K2, K3, K4) against its plain
   PyTorch version on the card, at the main path's shapes and at a ragged
   one, and each launch of the block at the main path's shapes; times
   kernel, plain version and, for K1, ``nn.TransformerEncoderLayer`` holding
   the same weights;
4. runs the full-width ViT-B pose step (12 layers, D=768, 64 slots, a 1080p
   frame from ``--seed``, random weights from ``--seed``) at int8, bf16 and
   fp32 through the kernels: it checks the launch counts (K1/K2 12 per
   step, K3 and K4 once), that every output is finite and masked slots are
   zero, and the heatmaps against the plain pose step on the card, and
   times it (host clock, median of five windows of ``--reps`` steps);
5. prints one JSON line per kernel set (``kernels``), the card line, and
   last ``{"ok": true, "device": {...}}``.

Any failure raises: the script then exits non-zero and prints no result.
It exits non-zero at once when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet, dense: the bound of each kernel is the larger of its
# bytes over the memory rate and its operations over the peak of their type
PEAK = {"hbm": 3.35e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12}
TOL = {  # max |kernel - plain| allowed, relative to max |plain|
    "fp32": 1e-4,    # float32 sums in another order
    "bf16": 2e-2,    # a few bf16 ulps: roundings at the kernel's points may flip
    "int8": 2e-2,    # a flipped rint(h / s) moves one int8 step
}
# one block's update (out - x), relative to max |update|, beyond two ulps of
# the output's dtype (a rounding flip of the output or of the inner residual)
UPDATE_TOL = {"fp32": 1e-5, "bf16": 1.5e-2, "int8": 2e-2}
# each launch of the block against its plain version, relative to max |plain|
LAUNCH_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-2}
# pose-step heatmaps against the plain pose step, relative to their range
HEATMAP_TOL = {"fp32": 1e-5, "bf16": 2e-2, "int8": 2e-2}
SLOTS, FRAME_HW = 64, (1080, 1920)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def host_record(torch) -> str:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    from easy_vitpose_tpu_torch import kernels
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "absent"
    print("host:", json.dumps({"card": card, "torch": torch.__version__,
                               "cuda": torch.version.cuda, "nvcc": nvcc,
                               "triton": triton_version, "python": sys.version.split()[0]}))
    return card


def time_ms(torch, fn, window_ms: float = 50.0, windows: int = 5) -> float:
    """Device time of one call of ``fn``, from CUDA events: the median over
    ``windows`` of the mean of back-to-back calls filling ``window_ms``,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def window(reps):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    reps = max(1, math.ceil(window_ms / max(window(1), 1e-3)))
    return statistics.median(window(reps) for _ in range(windows))


def max_rel_err(torch, got, ref) -> tuple:
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = float((got - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def make_boxes(rng: np.random.Generator, M: int, H: int, W: int) -> np.ndarray:
    """M boxes: random ones, and the awkward cases first: one past the
    top-left edge, one at the bottom-right edge, a 1-px box on .5 corners
    (banker's rounding), one wholly outside the frame, a wide one."""
    special = np.array([[-30.0, -40.0, 300.0, 500.0],
                        [W - 250.0, H - 120.0, W + 20.0, H + 5.0],
                        [100.5, 200.5, 101.5, 201.5],
                        [W + 50.0, H + 50.0, W + 90.0, H + 80.0],
                        [10.0, 500.0, 1900.0, 620.0]], np.float32)
    x1 = rng.uniform(0, W - 40, M)
    y1 = rng.uniform(0, H - 40, M)
    w = rng.uniform(20, 700, M)
    h = rng.uniform(20, 900, M)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    n = min(M, len(special))
    boxes[:n] = special[:n]
    return boxes


def update_err(torch, got, ref, x) -> float:
    """Max |got - ref| of a block's output beyond two ulps of its dtype,
    relative to the largest update ``ref - x`` (the residual ``x`` dominates
    ``out``, so an error relative to ``out`` would hide a wrong update)."""
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                      torch.frexp(ref.float())[1] - (8 if ref.dtype == torch.bfloat16 else 24))
    excess = ((got.float() - ref.float()).abs() - 2 * ulp).clamp(min=0)
    return float(excess.max()) / float((ref.float() - x.float()).abs().max())


def check_block_launches(torch, blk, x, dtype: str) -> dict:
    """Each launch of one block (LN, the four GEMMs with their epilogues,
    attention, the row quantisation) against its plain version, fed the
    plain version's own intermediates, at the shapes of ``x``."""
    from easy_vitpose_tpu_torch.models import fused_block as fb, quant, vit

    B, N, D = x.shape
    dt = x.dtype
    x2 = x.reshape(B * N, D)
    errs = {}

    def hold(name, got, ref):
        _, rel = max_rel_err(torch, got, ref)
        errs[name] = rel
        check(rel <= LAUNCH_TOL[str(ref.dtype)], f"{dtype} {name} at B={B} disagrees with its plain version: {rel}")

    if dtype == "int8":
        f32, lin = torch.float32, blk.linear
        h = vit.layer_norm(x2, blk.ln1_s, blk.ln1_b, blk.eps, f32)
        hold("layernorm", fb.layernorm_cuda(x2, blk.ln1_s, blk.ln1_b, blk.eps, f32), h)
        q, s = quant.rowquant_cuda(h)
        rq, rs = quant.quant_rows(h)
        check(torch.equal(q, rq) and torch.equal(s, rs[:, 0]), "int8 rowquant is not bit-equal")
        qkv = quant.linear_q8(h, *lin("qkv")).to(dt)
        hold("gemm qkv", quant.gemm_q8_cuda(h, *lin("qkv"), dt), qkv)
        o = vit.attention_core(qkv.reshape(B, N, -1), blk.num_heads).reshape(B * N, D)
        hold("attention", fb.attention_cuda(qkv, B, N, blk.num_heads), o)
        hold("gemm proj", quant.gemm_q8_cuda(o, *lin("proj"), f32), quant.linear_q8(o, *lin("proj")))
        m = vit.gelu(quant.linear_q8(h, *lin("fc1")))
        hold("gemm fc1 gelu", quant.gemm_q8_cuda(h, *lin("fc1"), f32, fb.EPI_GELU), m)
        hold("gemm fc2", quant.gemm_q8_cuda(m, *lin("fc2"), f32), quant.linear_q8(m, *lin("fc2")))
        return errs
    a, mlp, ln = blk.attn, blk.mlp, blk.norm1
    wb = lambda lin: (lin.weight, lin.bias)
    h = vit.layer_norm(x2, ln.weight, ln.bias, blk.eps)
    hold("layernorm", fb.layernorm_cuda(x2, ln.weight, ln.bias, blk.eps, dt), h)
    qkv = vit.linear_f32(h, *wb(a.qkv)).to(dt)
    hold("gemm qkv", fb.gemm_cuda(h, *wb(a.qkv)), qkv)
    o = vit.attention_core(qkv.reshape(B, N, -1), a.num_heads).reshape(B * N, D)
    hold("attention", fb.attention_cuda(qkv, B, N, a.num_heads), o)
    hold("gemm proj", fb.gemm_cuda(o, *wb(a.proj)), vit.linear_f32(o, *wb(a.proj)).to(dt))
    m = vit.gelu(vit.linear_f32(h, *wb(mlp.fc1))).to(dt)
    hold("gemm fc1 gelu", fb.gemm_cuda(h, *wb(mlp.fc1), fb.EPI_GELU), m)
    hold("gemm fc2", fb.gemm_cuda(m, *wb(mlp.fc2)), vit.linear_f32(m, *wb(mlp.fc2)).to(dt))
    return errs


def encoder_layer(torch, blk):
    """``nn.TransformerEncoderLayer`` holding a float block's weights: the
    same pre-LN block (with torch's exact-erf GELU), in one PyTorch call."""
    a, mlp = blk.attn, blk.mlp
    D = a.proj.weight.shape[0]
    layer = torch.nn.TransformerEncoderLayer(
        D, a.num_heads, mlp.fc1.weight.shape[0], dropout=0.0, activation="gelu",
        layer_norm_eps=blk.eps, batch_first=True, norm_first=True)
    layer.load_state_dict({
        "self_attn.in_proj_weight": a.qkv.weight, "self_attn.in_proj_bias": a.qkv.bias,
        "self_attn.out_proj.weight": a.proj.weight, "self_attn.out_proj.bias": a.proj.bias,
        "linear1.weight": mlp.fc1.weight, "linear1.bias": mlp.fc1.bias,
        "linear2.weight": mlp.fc2.weight, "linear2.bias": mlp.fc2.bias,
        "norm1.weight": blk.norm1.weight, "norm1.bias": blk.norm1.bias,
        "norm2.weight": blk.norm2.weight, "norm2.bias": blk.norm2.bias})
    return layer.to(a.qkv.weight.device, a.qkv.weight.dtype).eval()


def footprint_bytes(geo, H: int, W: int) -> int:
    """Bytes of the frame that the crops read: the union of the boxes."""
    cover = np.zeros((H, W), bool)
    g = {k: v.cpu().numpy() for k, v in geo.items()}
    for i in range(len(g["x1"])):
        x0, y0 = min(g["x1"][i], W - 1), min(g["y1"][i], H - 1)
        cover[y0:y0 + g["hc"][i], x0:x0 + g["wc"][i]] = True
    return int(cover.sum()) * 3


def bound(bytes_: float, ops: dict) -> tuple:
    """(ms, "bytes" | "operations"): ops maps a peak's name to a count."""
    t_bytes = bytes_ / PEAK["hbm"]
    t_ops = sum(n / PEAK[k] for k, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def block_work(B, N, D, hidden, w_bytes, x_bytes):
    linear = 2.0 * B * N * (3 * D * D + D * D + 2 * D * hidden)
    attn = 4.0 * B * N * N * D
    weights = (4 * D * D + 2 * D * hidden) * w_bytes
    return linear, attn, 2.0 * B * N * D * x_bytes + weights


def check_kernels(torch, model, rng, dev):
    """Each kernel against its plain version at the main path's shapes and
    a ragged one; returns a dict of measurements per kernel."""
    from easy_vitpose_tpu_torch.models import fused_block as fb, quant, vit
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.ops import modulate, preprocess, sampler

    cfg = model.cfg.backbone
    D, N, hidden = cfg.embed_dim, cfg.num_tokens, int(cfg.embed_dim * cfg.mlp_ratio)
    out = {}

    # K1 (bf16, fp32) and K2: one block on (B, 192, 768) tokens
    copies = {"bf16": serving_copy(model, "bf16"), "fp32": serving_copy(model, "fp32"),
              "int8": serving_copy(model, "int8")}
    for dtype, (wrapper, plain) in (("bf16", (fb.fused_block, vit.block)),
                                    ("fp32", (fb.fused_block, vit.block)),
                                    ("int8", (quant.fused_block_q8, quant.block_q8))):
        blk = copies[dtype].backbone.blocks[0]
        tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
        for B in (SLOTS, 5):
            x = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).to(dev, tdt)
            got, ref = wrapper(x, blk), plain(x, blk)
            err, rel = max_rel_err(torch, got, ref)
            upd = update_err(torch, got, ref, x)
            print(f"check {dtype} block B={B}: max_abs_err {err:.3e} rel {rel:.3e} "
                  f"update {upd:.3e}")
            check(rel <= TOL[dtype], f"{dtype} block disagrees with its plain version: {rel}")
            check(upd <= UPDATE_TOL[dtype], f"{dtype} block update disagrees: {upd}")
            if B != SLOTS:
                continue
            launches = check_block_launches(torch, blk, x, dtype)
            print(f"check {dtype} block launches B={B}:",
                  " ".join(f"{k} {v:.3e}" for k, v in launches.items()))
            lin, attn, nbytes = block_work(B, N, D, hidden, 1 if dtype == "int8" else
                                           (4 if dtype == "fp32" else 2),
                                           4 if dtype == "fp32" else 2)
            ops = ({"int8": lin, "bf16": attn} if dtype == "int8" else
                   {"bf16": lin + attn} if dtype == "bf16" else {"f32": lin + attn})
            library_ms = None        # no PyTorch call runs int8 (W8A8) linears
            if dtype != "int8":
                layer = encoder_layer(torch, blk)
                _, lib_rel = max_rel_err(torch, layer(x), ref)
                print(f"check {dtype} TransformerEncoderLayer vs plain: rel {lib_rel:.3e}")
                check(lib_rel <= TOL[dtype], f"{dtype} TransformerEncoderLayer disagrees: {lib_rel}")
                library_ms = time_ms(torch, lambda: layer(x))
            out[dtype] = {"max_abs_err": err, "ms": time_ms(torch, lambda: wrapper(x, blk)),
                          "plain_ms": time_ms(torch, lambda: plain(x, blk)),
                          "bound": bound(nbytes, ops), "library_ms": library_ms}

    # K3: crops of SLOTS boxes (and 5) from a 1080p frame, bf16 and f32
    H, W = FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    for M in (SLOTS, 5):
        boxes = torch.from_numpy(make_boxes(rng, M, H, W)).to(dev)
        geo = preprocess.crop_geometry(boxes, (H, W))
        for tdt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            got = sampler.sample_normalize(frame, geo, dtype=tdt)
            ref = sampler.sample_normalize_plain(frame, geo, dtype=tdt)
            err, rel = max_rel_err(torch, got, ref)
            print(f"check sampler M={M} {tdt}: max_abs_err {err:.3e} rel {rel:.3e}")
            check(rel <= tol, f"sampler disagrees with its plain version: {rel}")
            if M == SLOTS and tdt == torch.bfloat16:
                nbytes = footprint_bytes(geo, H, W) + got.numel() * 2 + M * 32
                out["sampler"] = {
                    "max_abs_err": err,
                    "ms": time_ms(torch, lambda: sampler.sample_normalize(frame, geo, dtype=tdt)),
                    "plain_ms": time_ms(torch, lambda: sampler.sample_normalize_plain(
                        frame, geo, dtype=tdt)),
                    "bound": bound(nbytes, {"f32": 40.0 * got.numel()}), "library_ms": None}

    # K4: UDP modulate of SLOTS * 17 maps (and 5 * 17)
    for M in (SLOTS, 5):
        hm = torch.from_numpy((rng.standard_normal((M, 17, 64, 48)) * 0.3 + 0.2)
                              .astype(np.float32)).to(dev)
        got, ref = modulate.udp_modulate(hm), modulate.udp_modulate_plain(hm)
        err, rel = max_rel_err(torch, got, ref)
        print(f"check modulate M={M}: max_abs_err {err:.3e} rel {rel:.3e}")
        check(err <= 1e-5, f"modulate disagrees with its plain version: {err}")
        if M == SLOTS:
            out["modulate"] = {
                "max_abs_err": err, "ms": time_ms(torch, lambda: modulate.udp_modulate(hm)),
                "plain_ms": time_ms(torch, lambda: modulate.udp_modulate_plain(hm)),
                "bound": bound(2.0 * hm.numel() * 4, {"f32": 46.0 * hm.numel()}),
                "library_ms": None}
    return out


def run_pose_steps(torch, model, rng, reps, dev):
    """The main path at each serving dtype; returns launches and times."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_heatmaps, pose_step

    H, W = FRAME_HW
    depth = model.cfg.backbone.depth
    frame_np = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    boxes_np = make_boxes(rng, SLOTS, H, W)
    mask_np = np.arange(SLOTS) < SLOTS - 4
    # the timed steps reuse one device copy, as a server holding its frame
    frame, boxes, mask = (torch.from_numpy(a).to(dev) for a in (frame_np, boxes_np, mask_np))
    block_kernel = {"int8": "block_q8", "bf16": "block", "fp32": "block"}
    results = {}
    for dtype in ("int8", "bf16", "fp32"):
        sm = serving_copy(model, dtype)
        pose_step(sm, frame, boxes, mask)                 # warm-up
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        kp = pose_step(sm, frame_np, boxes_np, mask_np)   # as a caller would: numpy in
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        print(f"pose step {dtype}: launches {counts}")
        want = {block_kernel[dtype]: depth, "sampler": 1, "modulate": 1}
        check(counts == want, f"{dtype} pose step launched {counts}, expected {want}")
        check(kp.is_cuda and tuple(kp.shape) == (SLOTS, 17, 3),
              f"keypoints {kp.device} {tuple(kp.shape)}")
        check(bool(torch.isfinite(kp).all()), f"{dtype} keypoints are not finite")
        check(bool((kp[~mask] == 0).all()), f"{dtype} masked slots are not zero")

        with torch.no_grad():
            hk, _ = pose_heatmaps(sm, frame, boxes)
            hp, _ = pose_heatmaps(sm, frame, boxes, plain=True)
        err = float((hk - hp).abs().max())
        rng_ = float(hp.max() - hp.min())
        print(f"pose step {dtype}: heatmaps vs plain max_abs_err {err:.3e} (range {rng_:.3f})")
        check(bool(torch.isfinite(hk).all()), f"{dtype} heatmaps are not finite")
        check(err <= HEATMAP_TOL[dtype] * rng_,
              f"{dtype} heatmaps disagree with the plain pose step: {err}")

        r = reps if dtype != "fp32" else max(2, reps // 5)

        def window():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(r):
                pose_step(sm, frame, boxes, mask)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / r

        ms = statistics.median(window() for _ in range(5))
        results[dtype] = {"launches": counts, "ms_per_step": ms,
                          "crops_per_s": SLOTS / ms * 1e3, "heatmap_max_abs_err": err,
                          "heatmap_range": rng_}
        print(f"pose step {dtype}: {ms:.3f} ms/step, {SLOTS / ms * 1e3:.1f} crops/s")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20,
                    help="pose steps in each of the five timed windows per dtype")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params

    card = host_record(torch)
    t0 = time.perf_counter()
    secs = kernels.build()
    print("build:", json.dumps({k: round(v, 1) for k, v in secs.items()}),
          f"wall {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(args.seed)
    cfg = get_model_config("coco", "b")
    dev = torch.device("cuda")
    model = init_params(cfg, args.seed).to(dev)
    with torch.no_grad():
        meas = check_kernels(torch, model, rng, dev)
        steps = run_pose_steps(torch, model, rng, args.reps, dev)

    rows = []
    spec = (("K1 fused_block bf16", "bf16", "block.cu", "models/fused_block.py:51", "bf16", "block"),
            ("K1 fused_block fp32", "fp32", "block.cu", "models/fused_block.py:51", "fp32", "block"),
            ("K2 fused_block_q8 int8", "int8", "block_q8.cu", "models/quant.py:171", "int8", "block_q8"),
            ("K3 sample_normalize", "sampler", "sampler.cu", "ops/pallas_sampler.py:46", "int8", "sampler"),
            ("K4 udp_modulate", "modulate", "modulate.cu", "ops/pallas_kernels.py:23", "int8", "modulate"))
    for name, key, src, replaces, run, counter in spec:
        m = meas[key]
        rows.append({"name": name, "route": "cuda",
                     "source": f"easy_vitpose_tpu_torch/csrc/{src}",
                     "replaces": f"easy_vitpose_tpu/{replaces}",
                     "launches": steps[run]["launches"].get(counter, 0),
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                     "library_ms": m["library_ms"]})
    print("pose_steps:", json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                     for k, v in steps.items()}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
