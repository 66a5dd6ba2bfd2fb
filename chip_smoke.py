#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check its kernels.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py [--seed 0]

1. prints the host record: the card's name and power limit, CUDA, nvcc
   and triton versions;
2. builds every kernel from ``easy_vitpose_tpu_torch/csrc`` (one nvcc per
   source, all at once);
3. holds each kernel (K1 bf16 and fp32, K2, K3, the full-map K4 and the
   fused decode) against its plain PyTorch version on the card, at the
   main path's shapes and at a ragged one, and each launch of the block at
   the main path's shapes; K3's geometry equal to ``crop_geometry``'s and
   its crops to the plain version's bits; the decode on 64x17 maps with no
   peak (the wrap-around into the last map), border peaks, ties and masked
   slots: scores bit for bit, coordinates within ``DECODE_TOL`` heatmap px,
   its seven modulated points per map bit for bit the full-map K4's, bf16
   heatmaps as their widening; times kernel, plain version and, for K1,
   ``nn.TransformerEncoderLayer`` holding the same weights (K3, K4 and the
   decode, shorter than their wrappers' host time, by ``device_ms``: calls
   queued behind a sleep kernel, so the device time alone);
4. runs the full-width ViT-B pose step (12 layers, D=768, 64 slots, a 1080p
   frame from ``--seed``, random weights from ``--seed``) at int8, bf16 and
   fp32 through the kernels: it checks the launch counts (K1/K2 12 per
   step, K3 and the decode once), that every output is finite and masked
   slots are zero, the keypoints against the plain decode of the step's own
   heatmaps, that a step on inputs already on the card runs under
   PyTorch's synchronisation check set to raise, and the heatmaps against
   the plain pose step on the card, and times it (host clock, median of
   five windows of ``--reps`` steps, and the host's time to queue them);
4a. holds the library's UDP decode with JAX's ``use_pallas``
   (``ops/decode.py::keypoints_from_heatmaps(use_udp=True,
   use_pallas=True)``) on the int8 pose step's heatmaps: one full-map K4
   launch, scores bit for bit and coordinates within ``DECODE_TOL`` of the
   same call without ``use_pallas`` on the card; prints the gap to the
   CPU's run (``k4_front_door:``);
4b. holds the detector's kernels against their plain versions on the 1080p
   frame at YOLOv8n/320 and YOLOv8x/640 (random weights from ``--seed``,
   scaled on that frame), float32 and bf16, square and rect letterbox: D1
   (``csrc/letterbox.cu``) and D2 (``csrc/nms.cu``) bit for bit, and the
   whole ``detect_frame_core`` against the same function with the plain D1
   and D2 (the same packed rows); times D1, D2 (``device_ms``), their
   plain versions and the detector's ms per frame;
4c. drives ``VitInference`` (ViT-B from a ``.npz`` the script writes, with
   YOLOv8n/320, int8 and bf16) in image mode at steady state: launches per
   frame ({D1, D2, K3, K2/K1 x 12, the decode} once each), one host sync per
   frame, the frame's launches queued under the synchronisation check set
   to raise, the host's ms to queue them, ms per frame and the device's busy
   share (``torch.profiler``); and the int8 model in video mode (SORT over
   30 frames of the frame moving right); every frame held to the plain path
   on the card (detections bit for bit, IDs equal, heatmaps within
   ``HEATMAP_TOL``, keypoints the plain decode of their own heatmaps);
   the detection frame is a CUDA graph replay (``pipeline/graphs.py``): the
   replay equals the eager ``detect_pose`` bit for bit and counts the
   captured launches, and the host's ms to queue a frame is the replay's;
   the pipelined video (``inference_pipelined``) equals the sync path's
   results one frame late; a batched window of 16 frames
   (``inference_batched``) has the per-frame path's IDs and heatmaps within
   ``HEATMAP_TOL`` on the same detections; the fused tick's keypoint
   divergence (single dispatch against two-program, video mode) in px;
4d. holds K3 over a stack of 8 frames (64 boxes in per-frame blocks, a
   frame index per box; the 1080p stack and a 1079x1917 one, bf16 and fp32)
   and D1 and D2 over 8 frames (YOLOv8n/320 square bf16 and fp32, YOLOv8x/640
   rect bf16) bit for bit against their plain versions and against
   single-frame launches, ``detect_batch_core`` against its plain twin, and
   times the stacked launches;
4e. drives ``MultiStreamPose`` at BASELINE config 5 (ViT-H int8 + YOLOv8x/640
   rect bf16, 8 streams of 1080p, 8 people a stream): every two-program tick
   against ``plain=True`` (detections bit for bit, IDs, heatmaps within
   ``DEEP_HEATMAP_TOL``, keypoints the plain decode of their heatmaps), the
   fused tick's graph against its eager program and that against the plain
   one, single-dispatch IDs equal to the two-program path's, pipelined ticks
   equal to sync ones a tick late (both kinds); ms per tick, stream-frames/s,
   host ms, busy share, launches and syncs per tick, peak memory, the fused
   keypoint divergence;
4f. drives ``cli/serve_http.py``'s ``PoseService`` (ViT-B int8 + YOLOv8n/320)
   with and without its micro-batcher: 24 requests with boxes and with the
   detector, on 1080p and on a 433x577 frame that ``_bucket_pad`` pads, each
   single answer equal to a direct ``VitInference`` call, each micro-batched
   crop's heatmaps within ``HEATMAP_TOL`` of the single path's; ms per
   request;
4f'. ``api:`` the package's top level: ``from easy_vitpose_tpu_torch import
   VitInference, __version__`` on 4c's files, a frame's keypoints and
   launches bit for bit 4c's int8 image frame, ``API_FRAMES`` frames in a
   ``utils/profiling.py::StageTimer`` (report printed), one frame under
   ``device_trace`` (CUDA kernels in its trace.json), ``get_logger`` at
   INFO on rank 0, and each ``vitpose-torch-*`` console entry of
   pyproject.toml a callable whose ``python -m <module> --help`` exits 0;
4g. ``convert:`` drives ``cli/convert.py`` at ViT-B: a reference .pth
   through ``vitpose`` and back through ``to-torch`` key for key and bit for
   bit; ``average``; a synthetic ViTPose+ ViT-B through ``plus`` and
   ``split``, each of its six tasks (K = 17, 14, 16, 17, 17, 133) through
   ``VitInference(plus.npz, task=t, dtype="int8")`` bit for bit against the
   split checkpoint's, within ``HEATMAP_TOL`` of the plain path and with
   {K2: 12, K3: 1, decode: 1} launches a frame; a stand-in ultralytics
   YOLOv8n .pt against its converted .npz, detections bit for bit;
4h. ``export:`` drives ``cli/export.py``: ``.pt2`` files at fp32, bf16 and
   int8 for 64 crops, each loaded with ``torch.export.load`` and run on the
   card against the kernel forward within ``HEATMAP_TOL`` (both timed; the
   artifact holds plain ops), and ONNX through the numpy interpreter on 2
   crops against the card's fp32 forward within ``ONNX_TOL``;
4i. ``eval_coco:`` drives ``cli/eval_coco.py``'s ``main`` at ViT-B int8 on a
   synthetic val set (32 images, 128 people) in four lanes
   (``--gt-crops-batched 64``, ``--use-gt-bbox``, YOLOv8n/320, and the
   gt-crops lane with ``--flip-test --oks-nms soft --per-keypoint``), each
   against the same call with ``--plain``; launches per batch and per image,
   crops/s and images/s, the scorer's AP of 1.0 on the ground truth; cv2's
   image read and warp are stood in for (the card's host has no cv2);
5. holds the training kernels (K5 forward, K6a MLP backward, K7 attention
   backward at bf16 and fp32) against their plain versions at the main
   shapes and a ragged batch, and times each beside its plain version and
   a PyTorch yardstick; holds K8's one launch over a table of leaves
   against its per-leaf plain version bit for bit on ViT-B's 157 leaves,
   on ragged and misaligned leaf sets, the norm kernel against
   ``global_norm`` (bit for bit on exact-norm leaves, rel 1e-5 on random
   ones), checks that ``fused_apply`` writes none of its inputs and
   launches each once, and times the whole ``fused_apply``, the table
   launch, the norm, the plain step, ``clip_grad_norm_`` + fused
   ``torch.optim.Adam`` and the host time of one call; probes whether
   mma.sync gives a product with its operands swapped as the same bits
   (K7's P in its two kernels); holds the bf16 training GEMM in each layout
   (NT, NN, the TN pair) at ViT-B's MLP shapes against float32 matmul,
   checks two runs bit-equal and times it beside ``torch.matmul``;
6. drives the training step at full width (ViT-B, depth 12, 64 crops,
   AMP bf16, drop-path 0.3 from a seeded generator, fused f32 Adam at the
   finetune lr 3.75e-4 and clip 1.0) on a device-input batch from
   ``--seed``: it checks the launch counts (K5, K6a, K7 12 per step, the
   norm kernel and K8 once), that the loss falls over 20 steps on the batch, one
   step's loss and gradients against the plain step on the card, and times
   it (median of five windows, images/s, peak memory);
7. holds the wide MLP backward (K6b, K6c; against their plain versions and
   K6a) on ViT-L's block 0 at bf16 and fp32, 64 crops and 3, and times
   each; the int8-moment Adam (K9) and the norm kernel as K8 in 5, on
   ViT-L's 301 leaves; the bf16 training GEMM's layouts as in 5 at
   ViT-L's shapes;
8. drives the ViT-L finetune step (depth 24, D=1024, 64 crops, AMP bf16,
   drop-path 0.5, int8 Adam moments, lr 3.75e-4, clip 1.0) as in 6: K5,
   K6b, K6c and K7 24 times per step, the norm kernel and K9 once, no K6a
   or K8;
   ms/step, images/s, peak memory and the moments' bytes against float32;
9. holds the opt-in flavors of the training block against their plain
   versions at bf16 and fp32, 64 crops and 3: on ViT-B's block 0 K5's saved
   qkv and m, K6a ``_ms`` and K7 ``_saved`` (K7 ``_saved`` on K5's own qkv
   equal to K7 bit for bit; at fp32 K6a ``_ms`` within 1e-6 of K6a); on
   ViT-L's block 0 K6b ``_ms``, K6d and K6e (K6d then K6e equal to K6b then
   K6c bit for bit; at fp32 K6b ``_ms`` within 1e-6 of K6b); and times each;
10. drives three flavored AMP train steps as in 6, with the ``EVT_TRAIN_*``
   switches set around each step's use and restored after: ViT-B with
   ``ATTN=saved`` and ``MLP=saved`` (K5, K6a ``_ms`` and K7 ``_saved`` 12
   times, no K6a or K7), ViT-L int8 with ``WIDE=recompute`` (K5, K6d, K6e,
   K7 24 times, no K6b or K6c) and ViT-L int8 with ``MLP=saved`` (K6b
   ``_ms`` and K6c 24 times, no K6b); each with its falling loss over 20
   steps, grads against the plain step under the same switches, ms/step and
   peak memory;
11. drives one ViT-B step with ``grad_accum=2`` and ``ema_decay=0.999``
   through the kernels (K5, K6a, K7 24 times, the norm kernel and K8 once) against
   the plain step with the same settings and drop-path masks;
12. drives the training loop (``train/loop.py::train_model``, the
   ``train_loop:`` line) on a dataset of its own made from ``--seed`` (the
   card's host has no cv2): ViT-B at full width and depth with the finetune
   preset through the kernels (K5, K6a, K7, the norm kernel and K8 each
   step; K1 in validation), AMP, device input, 3 epochs of 4 steps and one
   val batch with PCK and the in-loop AP, a save and a full-state save each
   epoch: launches per step and per val batch, host syncs per step, the
   loop's losses against the same steps driven by hand (within
   ``STEP_LOSS_TOL``; bit-equality reported), ``last.npz`` through
   ``VitInference`` against the state's serving model (``HEATMAP_TOL``), a
   run resumed after epoch 2 against the uninterrupted one (weights within
   half an lr; bit-equality reported; that run under ``torch.profiler`` for
   the busy share), ms per loop step against the bare step of 6, the
   loader's share and each checkpoint write's seconds; ViT-L at full width
   with int8 moments (K5, K6b, K6c, K7, the norm kernel and K9), 2 epochs
   of 2 steps and a resume; the from-scratch preset at ViT-B (AdamW with
   layer decay in plain torch) for 2 epochs of 2 steps, its history's
   rates equal to ``make_step_lr_schedule``'s;
12b. drives the live ViTPose+-B (``models/moe.py``, ``train/moe_step.py``;
   D 768, 12 blocks, fc2 576 shared + 6 x 192 expert rows, heads K = 17,
   14, 16, 17, 17, 133, random weights from ``--seed``): each task's
   serving forward of 64 crops at bf16 through K1 (12 launches) against
   ``plain=True`` (JAX's XLA MoE block; ``HEATMAP_TOL``), a mixed batch's
   features against each expert's homogeneous forward; three rounds of
   AMP steps over the six tasks (32 crops each, f32 moments): launches
   per step (K5, K6a, K7 12 each, the norm kernel and K8 once), the other
   tasks' weights and moments bit for bit, each task's loss falling, one
   step per task against the plain step (``STEP_LOSS_TOL``,
   ``STEP_GRAD_TOL``), ms per step and peak memory; one round with int8
   moments (K9) (``moe:``);
12c. drives ViT-B with the hybrid CNN stem (``stem_channels`` (64, 128,
   256, 512)): the serving forward of 64 crops at bf16 (K1) and int8 (K2)
   against ``plain=True``, ``train_model`` for 2 epochs of 2 steps (K5,
   K6a, K7, the norm kernel, K8 a step) against the same steps by hand;
   and the simple head at ViT-B: one serving forward against
   ``plain=True`` and one train step against the plain step (``stem:``);
12d. ``parallel:``: (a) the sharded ViT-B f32 and ViT-L
   int8-moment steps (``make_train_step_sharded``) on a one-rank NCCL group
   against ``make_train_step``: the same launches, loss and params bit for
   bit, ms of each and of the flat gradient all-reduce; (b) two spawned
   ranks on the one card over gloo with CUDA tensors: the DP step of 64
   crops (32 a rank) through the kernels against the one-process step,
   2-way TP (6 heads, 1536 units a rank) at float32 against the plain
   path within ``TP_GRAD_TOL``, with cuDNN's default and deterministic
   algorithms, and the head alone on the TP forward's features against the
   one-process head on the same features (ROADMAP C17); PP over the two
   ranks (``pipeline_vit_forward``, ViT-B's 12 layers, 6 a stage, 16
   crops in 4 micro-batches, float32, the hand-off staged through pinned
   host memory) against the one-process backbone within ``PP_TOL``, and
   its ms; rank 1's logger at ERROR and ``master_only`` None there; (c) in
   the ``multistream:`` and ``eval_coco:`` phases,
   the stream-parallel tick over two mesh entries naming the card, bit for
   bit its blocks' own 4-stream ticks and, with the boxes given, the
   8-stream tick (each pose kernel twice), YOLO's raw-output gaps at
   batches 1, 4 and 8 against 8 within ``DETECTOR_BATCH_GAP`` (ROADMAP
   C18), and the eval gt-crops lane so split, bit for bit the one-device
   lane;
12e. ``plus:`` ViTPose+-H int8 on boxes of mixed tasks (``models/moe.py``;
   D 1280, 32 blocks, fc2 960 shared + 6 x 320 expert rows, random weights
   from ``--seed``; 64 boxes on a 1080p frame, 4 masked, tasks drawn at the
   benchmark's plus-cell shares): G1 (``grouped_gemm_kernel``) on 64 crops
   of those tasks against ``moe.routed_fc2_plain``'s arithmetic within
   ``G1_TOL``, a rolled expert table and rolled rows failing it by ten
   times over, timed beside its plain version; one ``pose_step(PlusQ8,
   tasks=)`` queued under the synchronisation check set to raise, with the
   launch counts set to 0 just before it (K3 once, K2 and G1 32 times, the
   dense int8 GEMM 128, one head and one decode a task with boxes, every
   box's 32 x 192 rows routed to its task's expert, none padded), its
   keypoints zero past each box's K and in masked slots, each task's
   features the spliced int8 model's bits and heatmaps within
   ``DEEP_HEATMAP_TOL`` of the plain step's; ms a step and the host's ms to
   queue one (alone: ``run_plus_phase``);
13. prints the optimizer's times (``optimizer``), the norm kernel's row
   (``grad_norm``: it replaces no Pallas kernel), one JSON line per kernel
   set (``kernels``, 23 rows: D1, D2 and G1 after K4's; K3's, D1's and D2's
   launches count the image frame's and a multi-stream tick's), the
   detector's, ``VitInference``'s, the stacked kernels', the multi-stream,
   the HTTP and the tools' measurements (``detector``, ``detector_stacked``,
   ``sampler_stacked``, ``vitinference``, ``multistream``, ``serve_http``,
   ``api``, ``convert``, ``export``, ``eval_coco``: these four with the card; the
   kernel rows count their launches too), the ``k4_front_door``, ``moe``,
   ``stem``, ``plus`` and ``parallel`` lines (their launches counted in the rows
   too), the card line, and last ``{"ok": true, "device": {...}}``.

The A/B of each flavor against the default, interleaved in one process,
is ``scripts/bench_torch_breakdown.py --flavors``.

Any failure raises: the script then exits non-zero and prints no result.
It exits non-zero at once when no CUDA device is available.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet, dense: the bound of each kernel is the larger of its
# bytes over the memory rate and its operations over the peak of their type
PEAK = {"hbm": 3.35e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
TF32_PASSES = 3    # K1 fp32's products: lo.hi + hi.lo + hi.hi on the TF32 tensor cores
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
# ViT-H's 32 blocks against ViT-B's 12: a rounding flip's error compounds
# through the blocks as a random walk, so the multi-stream phase's bound is
# HEATMAP_TOL times sqrt(32 / 12)
DEEP_HEATMAP_TOL = HEATMAP_TOL["int8"] * math.sqrt(32 / 12)
# the fused decode's coordinates against its plain version, in heatmap px:
# the same operations in the same order, so 0 is expected; the kernel's logf
# and the eager log may differ by an ulp, which the Newton step magnifies
DECODE_TOL = 1e-3
SLOTS, FRAME_HW = 64, (1080, 1920)
# K5-K7 outputs and gradients against their plain versions, relative to the
# largest |plain| of each tensor: float32 sums in another order (the weight
# grads sum 12288 rows); at bf16 a rounding of the kernel may flip
TRAIN_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}
# one AMP step through the kernels against the plain step: the loss, and each
# gradient leaf relative to its largest |plain|; bf16 flips compound through
# 12 blocks and the head, and cuDNN's head backward is not deterministic
# (measured up to 9.7e-5 and 9.6e-3 on an H100)
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-3, 0.05
TRAIN_LR, TRAIN_CLIP, TRAIN_STEPS = 3.75e-4, 1.0, 20
TRAIN_REPS = 3     # train steps in each of the five timed windows


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


def device_ms(torch, fn, reps: int = 200, windows: int = 5) -> float:
    """Device time of one call of ``fn`` without the host's cost of issuing
    it: a sleep kernel holds the stream while the host queues ``reps`` calls,
    which then run back to back between two CUDA events; the median of
    ``windows``.  For kernels shorter than their wrapper's host time, which
    ``time_ms`` would measure instead.  A window whose sleep ended before
    the host had queued it is run again with a sleep four times as long."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = int(4e9 * queue_s) + 1000000   # > 2x the queueing at 2 GHz

    def window():
        nonlocal cycles
        for _ in range(4):
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            held = not start.query()        # the sleep still holds the stream
            end.synchronize()
            if held:
                return start.elapsed_time(end) / reps
            cycles *= 4
        raise RuntimeError("device_ms: the sleep kernel never outlasted the host's queueing")

    return statistics.median(window() for _ in range(windows))


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
        tops = {}

        def hold_q8(name, inp, wname, out_dt, epi, ref):
            """The int8 GEMM against its plain version, the same bits on a
            second run, and its TOP/s (the GEMM alone, its rows quantised)."""
            got = quant.gemm_q8_cuda(inp, *lin(wname), out_dt, epi)
            hold(name, got, ref)
            check(torch.equal(got, quant.gemm_q8_cuda(inp, *lin(wname), out_dt, epi)),
                  f"int8 {name}: two runs are not bit-equal")
            qi, si = quant.rowquant_cuda(inp)
            ms = device_ms(torch, lambda: quant.gemm_q8_rows_cuda(qi, si, *lin(wname), out_dt, epi))
            tops[name] = 2.0 * qi.shape[0] * qi.shape[1] * lin(wname)[0].shape[0] / ms / 1e9

        qkv = quant.linear_q8(h, *lin("qkv")).to(dt)
        hold_q8("gemm qkv", h, "qkv", dt, fb.EPI_NONE, qkv)
        o = vit.attention_core(qkv.reshape(B, N, -1), blk.num_heads).reshape(B * N, D)
        hold("attention", fb.attention_cuda(qkv, B, N, blk.num_heads), o)
        hold_q8("gemm proj", o, "proj", f32, fb.EPI_NONE, quant.linear_q8(o, *lin("proj")))
        m = vit.gelu(quant.linear_q8(h, *lin("fc1")))
        hold_q8("gemm fc1 gelu", h, "fc1", f32, fb.EPI_GELU, m)
        hold_q8("gemm fc2", m, "fc2", f32, fb.EPI_NONE, quant.linear_q8(m, *lin("fc2")))
        print(f"int8 GEMM TOP/s at B={B} (wgmma; peak 1979):",
              " ".join(f"{k.split()[1]} {v:.1f}" for k, v in tops.items()),
              "| launches by tile", quant.gemm_q8_launches())
        return errs
    a, mlp, ln = blk.attn, blk.mlp, blk.norm1
    wb = lambda lin: (lin.weight, lin.bias)
    # float32: the TF32 halves the fp32 copy's block holds
    sq, sp, s1, s2 = getattr(blk, "tf32_halves", None) or (None,) * 4
    h = vit.layer_norm(x2, ln.weight, ln.bias, blk.eps)
    hold("layernorm", fb.layernorm_cuda(x2, ln.weight, ln.bias, blk.eps, dt), h)
    qkv = vit.linear_f32(h, *wb(a.qkv)).to(dt)
    hold("gemm qkv", fb.gemm_cuda(h, *wb(a.qkv), split=sq), qkv)
    o = vit.attention_core(qkv.reshape(B, N, -1), a.num_heads).reshape(B * N, D)
    hold("attention", fb.attention_cuda(qkv, B, N, a.num_heads), o)
    hold("gemm proj", fb.gemm_cuda(o, *wb(a.proj), split=sp),
         vit.linear_f32(o, *wb(a.proj)).to(dt))
    m = vit.gelu(vit.linear_f32(h, *wb(mlp.fc1))).to(dt)
    hold("gemm fc1 gelu", fb.gemm_cuda(h, *wb(mlp.fc1), fb.EPI_GELU, split=s1), m)
    hold("gemm fc2", fb.gemm_cuda(m, *wb(mlp.fc2), split=s2),
         vit.linear_f32(m, *wb(mlp.fc2)).to(dt))
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


def check_tf32_parts(torch, blk, x) -> dict:
    """K1 fp32's own kernels at block 0's shapes.  The four 3xTF32 GEMMs,
    each fed the kernel path's own A: launched one by one and timed in sum
    against their plain float32 products and against one ``torch.addmm``
    each (the product and bias alone), each within LAUNCH_TOL of the plain
    product, from the TF32 halves the fp32 copy's block holds.  The split
    kernel on the block's four weights, bit for bit the halves the block
    holds and the plain split there and on crafted patterns, timed in sum
    against the plain split."""
    from easy_vitpose_tpu_torch.models import fused_block as fb, vit
    from easy_vitpose_tpu_torch.utils.precision import tf32_check_floats

    B, N, D = x.shape
    M = B * N
    a, mlp = blk.attn, blk.mlp
    x2 = x.reshape(M, D)
    h = fb.layernorm_cuda(x2, blk.norm1.weight, blk.norm1.bias, blk.eps, torch.float32)
    sq, sp, s1, s2 = blk.tf32_halves
    qkv = fb.gemm_cuda(h, a.qkv.weight, a.qkv.bias, split=sq)
    o = fb.attention_cuda(qkv, B, N, a.num_heads)
    hid = fb.gemm_cuda(h, mlp.fc1.weight, mlp.fc1.bias, fb.EPI_GELU, split=s1)
    cases = {"qkv": (h, a.qkv, fb.EPI_NONE, sq), "proj": (o, a.proj, fb.EPI_RESIDUAL, sp),
             "fc1": (h, mlp.fc1, fb.EPI_GELU, s1), "fc2": (hid, mlp.fc2, fb.EPI_RESIDUAL, s2)}
    err, ms, plain_ms, lib_ms, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    for name, (a_in, lin, epi, w) in cases.items():
        res = x2 if epi == fb.EPI_RESIDUAL else None
        run = lambda: fb.gemm_tf32_cuda(a_in, w, lin.bias, epi, res)  # noqa: E731

        def plain():
            y = vit.linear_f32(a_in, lin.weight, lin.bias)
            return vit.gelu(y) if epi == fb.EPI_GELU else (y + res if res is not None else y)

        e, rel = max_rel_err(torch, run(), plain())
        check(rel <= LAUNCH_TOL["torch.float32"], f"fp32 gemm_tf32 {name} disagrees: {rel}")
        err = max(err, e)
        ms += time_ms(torch, run)
        plain_ms += time_ms(torch, plain)
        lib_ms += time_ms(torch, lambda: torch.addmm(lin.bias, a_in, lin.weight.t()))
        Nw, K = lin.weight.shape
        nbytes += 4 * (M * K + 2 * Nw * K + Nw + M * Nw + (M * Nw if res is not None else 0))
        ops += 2.0 * M * Nw * K
    ws = [t.weight for t in (a.qkv, a.proj, mlp.fc1, mlp.fc2)]
    held = [torch.stack(s) for s in blk.tf32_halves]
    pat = torch.from_numpy(tf32_check_floats())
    for t, h_ in zip(ws + [pat], held + [None]):
        got = fb.tf32_split_stacked(t.to(x.device))
        want = torch.stack(fb.tf32_split_plain(t.to(x.device)))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32))
              and (h_ is None or torch.equal(h_.view(torch.int32), got.view(torch.int32))),
              "the TF32 split kernel differs from the plain split or the block's halves")
    n = sum(t.numel() for t in ws)
    out = {"gemm_tf32": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound": bound(nbytes, {"tf32": TF32_PASSES * ops}),
                         "library_ms": lib_ms},
           "tf32_split": {"max_abs_err": 0.0,
                          "ms": time_ms(torch, lambda: [fb.tf32_split_stacked(t) for t in ws]),
                          "plain_ms": time_ms(torch, lambda: [fb.tf32_split_plain(t) for t in ws]),
                          "bound": bound(12.0 * n, {}), "library_ms": None}}
    print("check fp32 gemm_tf32 and tf32_split:", json.dumps(out))
    return out


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
            # fp32: three TF32 passes of every product on the tensor cores
            ops = ({"int8": lin, "bf16": attn} if dtype == "int8" else
                   {"bf16": lin + attn} if dtype == "bf16" else
                   {"tf32": TF32_PASSES * (lin + attn)})
            if dtype == "fp32":
                simt = bound(nbytes, {"f32": lin + attn})
                print(f"fp32 block bound: {bound(nbytes, ops)[0]:.3f} ms on the TF32 tensor cores "
                      f"(3 passes), {simt[0]:.3f} ms on the float32 FMA units")
                out.update(check_tf32_parts(torch, blk, x))
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

    # K3: geometry and crops of SLOTS boxes (and 5) from a 1080p frame, bf16
    # and f32: the geometry equals crop_geometry's, the crops the plain
    # version's bits (which the earlier gather kernel also gave)
    H, W = FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    for M in (SLOTS, 5):
        boxes = torch.from_numpy(make_boxes(rng, M, H, W)).to(dev)
        want_geo = preprocess.pack_geometry(preprocess.crop_geometry(boxes, (H, W)))
        for tdt in (torch.float32, torch.bfloat16):
            got, geo = sampler.crop_normalize(frame, boxes, dtype=tdt)
            ref, _ = sampler.crop_normalize_plain(frame, boxes, dtype=tdt)
            err, rel = max_rel_err(torch, got, ref)
            print(f"check sampler M={M} {tdt}: max_abs_err {err:.3e} rel {rel:.3e}, "
                  f"geometry equal {torch.equal(geo, want_geo)}")
            check(torch.equal(geo, want_geo), "sampler geometry differs from crop_geometry")
            check(torch.equal(got, ref), f"sampler crops are not the plain version's bits: {err}")
            if M == SLOTS and tdt == torch.bfloat16:
                nbytes = (footprint_bytes(preprocess.geometry_views(geo), H, W)
                          + got.numel() * 2 + M * (16 + 32))
                run = lambda: sampler.crop_normalize(frame, boxes, dtype=tdt)  # noqa: E731
                out["sampler"] = {
                    "max_abs_err": err, "ms": device_ms(torch, run), "issued_ms": time_ms(torch, run),
                    "plain_ms": time_ms(torch, lambda: sampler.crop_normalize_plain(
                        frame, boxes, dtype=tdt)),
                    "bound": bound(nbytes, {"f32": 40.0 * got.numel()}), "library_ms": None}

    # K4, full map: UDP modulate of SLOTS * 17 maps (and 5 * 17)
    for M in (SLOTS, 5):
        hm = torch.from_numpy((rng.standard_normal((M, 17, 64, 48)) * 0.3 + 0.2)
                              .astype(np.float32)).to(dev)
        got, ref = modulate.udp_modulate(hm), modulate.udp_modulate_plain(hm)
        err, rel = max_rel_err(torch, got, ref)
        print(f"check modulate M={M}: max_abs_err {err:.3e} rel {rel:.3e}")
        check(err <= 1e-5, f"modulate disagrees with its plain version: {err}")
        if M == SLOTS:
            run = lambda: modulate.udp_modulate(hm)  # noqa: E731
            out["modulate"] = {
                "max_abs_err": err, "ms": device_ms(torch, run), "issued_ms": time_ms(torch, run),
                "plain_ms": time_ms(torch, lambda: modulate.udp_modulate_plain(hm)),
                "bound": bound(2.0 * hm.numel() * 4, {"f32": 46.0 * hm.numel()}),
                "library_ms": None}
    return out


def check_stacked_sampler(torch, rng, dev) -> dict:
    """K3 over a stack of STACK frames, SLOTS boxes in per-frame blocks
    (the multi-stream tick's layout), at bf16 and fp32, on the 1080p stack
    and on a 1079x1917 one (H * W * 3 not a multiple of 4, so frames after
    the first start off a word): crops and packed geometry bit for bit
    against the plain version and against per-frame launches; the 1080p
    bf16 launch timed by device_ms."""
    from easy_vitpose_tpu_torch.ops import preprocess, sampler

    out = {}
    per = SLOTS // STACK
    fidx = torch.arange(SLOTS, dtype=torch.int32, device=dev) // per
    for H, W in (FRAME_HW, (1079, 1917)):
        frames = torch.from_numpy(rng.integers(0, 256, (STACK, H, W, 3), dtype=np.uint8)).to(dev)
        boxes = torch.from_numpy(np.concatenate([make_boxes(rng, per, H, W)
                                                 for _ in range(STACK)])).to(dev)
        for tdt in (torch.float32, torch.bfloat16):
            got, geo = sampler.crop_normalize(frames, boxes, dtype=tdt, frame_idx=fidx)
            ref, rgeo = sampler.crop_normalize_plain(frames, boxes, dtype=tdt, frame_idx=fidx)
            check(torch.equal(geo, rgeo), f"stacked sampler {H}x{W}: geometry differs")
            check(torch.equal(got, ref), f"stacked sampler {H}x{W} {tdt}: crops are not the "
                                         "plain version's bits")
            for f in range(STACK):
                one, g1 = sampler.crop_normalize(frames[f], boxes[f * per:(f + 1) * per], dtype=tdt)
                check(torch.equal(got[f * per:(f + 1) * per], one) and
                      torch.equal(geo[f * per:(f + 1) * per], g1),
                      f"stacked sampler {H}x{W} {tdt}: frame {f} differs from its own launch")
            print(f"check sampler stacked S={STACK} M={SLOTS} {H}x{W} {tdt}: bit-equal to the "
                  "plain version and to per-frame launches")
            if (H, W) == FRAME_HW and tdt == torch.bfloat16:
                nbytes = sum(footprint_bytes(preprocess.geometry_views(geo[f * per:(f + 1) * per]),
                                             H, W) for f in range(STACK))
                nbytes += got.numel() * 2 + SLOTS * (16 + 32 + 4)
                run = lambda: sampler.crop_normalize(frames, boxes, dtype=tdt,  # noqa: E731
                                                     frame_idx=fidx)
                out = {"max_abs_err": 0.0, "ms": device_ms(torch, run),
                       "issued_ms": time_ms(torch, run),
                       "plain_ms": time_ms(torch, lambda: sampler.crop_normalize_plain(
                           frames, boxes, dtype=tdt, frame_idx=fidx)),
                       "bound": bound(nbytes, {"f32": 40.0 * got.numel()}), "library_ms": None,
                       "frames": STACK, "boxes": SLOTS}
    print("sampler_stacked:", json.dumps(out))
    return out


def decode_maps(rng, M: int, K: int = 17, H: int = 64, W: int = 48) -> np.ndarray:
    """Heatmaps with one Gaussian peak each (sigma 2, random height and
    place, some just off the map) and a little noise, with the decode's edge
    cases written in: no peak in slot 0 (maximum < 0 in map 0, whose Newton
    step reads the last map, and 0 in maps 1-2); in the last slot, peaks on
    each border and corner and two tied maxima in its last map."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    cy, cx = rng.uniform(-1, H, (M, K, 1, 1)), rng.uniform(-1, W, (M, K, 1, 1))
    hm = rng.uniform(0.2, 1.0, (M, K, 1, 1)) * np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 8.0)
    hm = (hm + 0.01 * rng.standard_normal(hm.shape)).astype(np.float32)
    hm[0, 0] = -np.abs(hm[0, 0]) - 0.05
    hm[0, 1:3] = 0.0
    peaks = [(0, W // 2), (H - 1, W // 3), (H // 2, 0), (H // 3, W - 1),
             (0, 0), (H - 1, W - 1), (0, W - 1), (H - 1, 0)]
    for k, (py, px) in enumerate(peaks[:K]):           # in the last slot
        hm[-1, k, py, px] = hm[-1, k].max() + 0.5
    tie = hm[-1, -1]
    tie[H // 4, W // 4] = tie[3 * H // 4, 3 * W // 4] = tie.max() + 0.25
    return hm


def decode_gap(torch, got, ref, geo, H: int, W: int) -> float:
    """Largest coordinate gap between two (M, K, 3) keypoint sets, in
    heatmap pixels (frame pixels over the UDP scale of each slot)."""
    scale = torch.stack([geo[:, 5] / (H - 1), geo[:, 4] / (W - 1)], -1)[:, None, :]
    return float(((got[..., :2] - ref[..., :2]).abs() / scale).max())


def check_decode(torch, rng, dev) -> dict:
    """The fused decode on SLOTS * 17 maps (and 5 * 17) against its plain
    version: scores bit for bit, coordinates within DECODE_TOL heatmap px;
    its seven modulated points per map bit for bit the full-map K4's at the
    same positions; bf16 heatmaps (the int8 and bf16 steps' head output)
    decode as their float32 widening."""
    from easy_vitpose_tpu_torch.ops import decode, modulate, sampler

    H, W = FRAME_HW
    frame = torch.zeros((H, W, 3), dtype=torch.uint8, device=dev)
    res = {}
    for M, kernel in ((SLOTS, 11), (SLOTS, 17), (5, 11)):
        hm = torch.from_numpy(decode_maps(rng, M)).to(dev)
        _, geo = sampler.crop_normalize(frame, torch.from_numpy(make_boxes(rng, M, H, W)).to(dev))
        mask = torch.arange(M, device=dev) != M - 2    # map 0 reads the last slot's maps
        got, pts = decode.decode_keypoints(hm, geo, mask, kernel, with_points=True)
        ref = decode.decode_keypoints_plain(hm, geo, mask, kernel)
        gap = decode_gap(torch, got, ref, geo, *hm.shape[-2:])
        coords, _ = decode.get_max_preds(hm)
        full = modulate.udp_modulate(hm, kernel).reshape(-1)
        want = full[decode.newton_point_index(coords, *hm.shape[-2:])]
        pts_equal = torch.equal(pts[mask], want[mask])
        hb = hm.bfloat16()
        bf16_equal = torch.equal(decode.decode_keypoints(hb, geo, mask, kernel),
                                 decode.decode_keypoints(hb.float(), geo, mask, kernel))
        print(f"check decode M={M} kernel {kernel}: scores equal "
              f"{torch.equal(got[..., 2], ref[..., 2])}, coordinate gap {gap:.3e} heatmap px, "
              f"points equal K4 {pts_equal}, bf16 equal {bf16_equal}")
        check(bool(torch.isfinite(got).all()) and bool((got[~mask] == 0).all()),
              "decode keypoints not finite or masked slots not zero")
        check(torch.equal(got[..., 2], ref[..., 2]), "decode scores are not the plain bits")
        check(gap <= DECODE_TOL, f"decode coordinates disagree: {gap} heatmap px")
        check(pts_equal, "decode's modulated points are not the full-map K4's bits")
        check(bf16_equal, "bf16 heatmaps do not decode as their widening")
        if M == SLOTS and kernel == 11:
            res = {"max_abs_err": float((got - ref).abs().max()), "coordinate_gap_px": gap}
            for name, x in (("f32", hm), ("bf16", hb)):
                n_read = int(mask.sum()) * 17 * 64 * 48 * x.element_size()
                run = lambda: decode.decode_keypoints(x, geo, mask)  # noqa: E731
                res[f"ms_{name}"] = device_ms(torch, run)
                res[f"issued_ms_{name}"] = time_ms(torch, run)
                res[f"plain_ms_{name}"] = time_ms(
                    torch, lambda: decode.decode_keypoints_plain(x, geo, mask))
                res[f"bound_{name}"] = bound(n_read + M * (32 + 1) + got.numel() * 4,
                                             {"f32": 1700.0 * int(mask.sum()) * 17})
            # the int8 and bf16 steps hand it bf16 heatmaps: that is the row
            res.update(ms=res["ms_bf16"], issued_ms=res["issued_ms_bf16"],
                       plain_ms=res["plain_ms_bf16"], bound=res["bound_bf16"], library_ms=None)
            print("decode:", json.dumps(res))
    return res


def train_block_work(B, N, D, hidden):
    """Operations of K5, K6a and K7 on one block (bf16 tensor-core work)."""
    R = B * N
    attn = 2.0 * R * N * D                 # one (N x N x head_dim) product, all heads
    fwd = 2.0 * R * (4 * D * D + 2 * D * hidden) + 2 * attn
    mlp = 5 * 2.0 * R * D * hidden        # fc1 recompute, dg, dh2, dW2, dW1
    attn_bwd = 2.0 * R * (3 * 3 * D * D + 2 * D * D) + 6 * attn
    return fwd, mlp, attn_bwd


def sublayer_backward(torch, layer, x, dout, which: str, weights=True):
    """A closure running the backward of one residual half of
    ``nn.TransformerEncoderLayer`` (``x + mlp(norm2(x))`` or ``x +
    attn(norm1(x))``) for ``dout``: the yardstick of K6a or K7; without
    ``weights``, the grads of the input and the vector parameters only (K6b,
    K6d); with ``weights="only"``, the grads of the two linears' weights and
    the first one's bias only (K6e)."""
    import torch.nn.functional as F
    xg = x.detach().requires_grad_(True)
    if which == "mlp":
        mods = (layer.norm2, layer.linear1, layer.linear2)
        out = xg + layer.linear2(F.gelu(layer.linear1(layer.norm2(xg))))
    else:
        mods = (layer.norm1, layer.self_attn)
        h = layer.norm1(xg)
        out = xg + layer.self_attn(h, h, h, need_weights=False)[0]
    if weights == "only":
        wrt = [layer.linear1.weight, layer.linear1.bias, layer.linear2.weight]
    else:
        wrt = [xg, *(p for m in mods for p in m.parameters() if weights or p.dim() == 1)]
    return lambda: torch.autograd.grad(out, wrt, dout, retain_graph=True)


def block_inputs(torch, model, rng, dev, tdt, B, keep_prob):
    """Block 0's weights in ``tdt``, tokens, an output grad and a keep mask
    with one kept and one dropped crop."""
    import copy

    from easy_vitpose_tpu_torch.models.vit import block_weights

    D, N = model.cfg.backbone.embed_dim, model.cfg.backbone.num_tokens
    blk = copy.deepcopy(model.backbone.blocks[0]).to(tdt)
    w = block_weights({k: v.detach() for k, v in blk.named_parameters()}, "")
    x = torch.from_numpy(rng.standard_normal((B, N, D)).astype(np.float32)).to(dev, tdt)
    dout = torch.from_numpy((rng.standard_normal((B, N, D)) * 0.02).astype(np.float32)).to(dev, tdt)
    keep = torch.from_numpy((np.floor(keep_prob + rng.uniform(size=B)) / keep_prob)
                            .astype(np.float32)).to(dev)
    keep[0], keep[1] = 1 / keep_prob, 0.0
    return blk, w, x, dout, keep


def holder(torch, errs, tdt, B):
    """``hold(name, got, ref)``: ``got`` against its plain version ``ref``
    within ``TRAIN_TOL``, the worst (relative, absolute) error per name
    kept in ``errs``."""
    def hold(name, got, ref):
        check(got.dtype == ref.dtype and got.shape == ref.shape, f"{name}: {got.dtype} {ref.dtype}")
        err, rel = max_rel_err(torch, got, ref)
        errs[name] = max(errs.get(name, (0.0, 0.0)), (rel, err))
        check(rel <= TRAIN_TOL[str(tdt)], f"{name} {tdt} B={B} disagrees with its plain version: {rel}")
    return hold


def mma_swap_bit_equal(torch, dev, N: int, hd: int) -> bool:
    """Whether mma.sync forms X Y^T and Y X^T as the same bits transposed,
    for bf16 (N, hd) operands summed in the same k order: K7's kernel B
    recomputes the logits and dP of kernel A with the operands swapped, so
    its P is A's bit for bit exactly when this holds.  Probed with
    ``mma_probe``: m16n8k16 steps in k order from zero, float32 out."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    rng = np.random.default_rng(N * hd)      # apart from the smoke's own draws
    x, y = (torch.from_numpy(rng.standard_normal((N, hd)).astype(np.float32)).to(dev, torch.bfloat16)
            for _ in range(2))
    return bool(torch.equal(fbt.mma_probe(x, y), fbt.mma_probe(y, x).t()))


def check_train_gemms(torch, model, rng, dev) -> dict:
    """The bf16 training GEMM in its three layouts at the model's MLP shapes
    and 64 crops (R = 12288 rows): NT (the fc1 recompute, h2 W1^T), NN (the
    grad through fc2, dm2c W2) and the TN pair (dW1 = dm1c^T h2, dW2 =
    h2^T dm1c); each against float32 ``torch.matmul`` of the same operands
    within ``LAUNCH_TOL`` bf16 (1e-2) of its largest value, bit-equal over
    two runs, and timed per launch beside ``torch.matmul`` on the same bf16
    operands; returns {layout: {ms, tflops, matmul_ms, ...}}."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    cfg = model.cfg.backbone
    R, D = SLOTS * cfg.num_tokens, cfg.embed_dim
    H = int(D * cfg.mlp_ratio)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(
            dev, torch.bfloat16)

    x, y, w1, w2 = rand(R, D), rand(R, H, scale=0.1), rand(H, D, scale=0.05), rand(D, H, scale=0.05)
    cases = {
        "nt": (lambda: fbt.gemm_nt(x, w1, fbt.TE_NONE)[:1], lambda: [x.float() @ w1.float().t()],
               lambda: torch.matmul(x, w1.t()), (R, D, H)),
        "nn": (lambda: fbt.gemm_nn(x, w2, fbt.TE_NONE)[:1], lambda: [x.float() @ w2.float()],
               lambda: torch.matmul(x, w2), (R, D, H)),
        "tn_pair": (lambda: fbt.gemm_tn2(y, x, x, y),
                    lambda: [y.float().t() @ x.float(), x.float().t() @ y.float()],
                    lambda: (torch.matmul(y.t(), x), torch.matmul(x.t(), y)), (2 * R, D, H)),
    }
    out = {}
    for name, (run, ref, lib, (r, d, h)) in cases.items():
        got = run()
        rel = max(max_rel_err(torch, g, f.to(g.dtype))[1] for g, f in zip(got, ref()))
        check(rel <= LAUNCH_TOL["torch.bfloat16"], f"bf16 GEMM {name} disagrees with matmul: {rel}")
        check(all(torch.equal(g, g2) for g, g2 in zip(got, run())), f"bf16 GEMM {name} is not "
              "the same bits in two runs")
        ms, lib_ms = time_ms(torch, run), time_ms(torch, lib)
        out[name] = {"R": R, "D": D, "H": H, "rel": rel, "ms": ms, "tflops": 2e-9 * r * d * h / ms,
                     "matmul_ms": lib_ms}
        print(f"check bf16 GEMM {name} ({r} x {d} x {h}): rel {rel:.3e}, bit-equal twice, "
              f"{ms:.4f} ms = {out[name]['tflops']:.1f} TFLOP/s (torch.matmul {lib_ms:.4f} ms)")
    return out


def check_train_kernels(torch, model, rng, dev):
    """K5, K6a and K7 against their plain versions on block 0 at bf16 and
    fp32, at the main path's 64 crops and at 3, and K8 and the norm kernel
    (:func:`check_optimizer`); returns measurements per kernel."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt

    cfg = model.cfg.backbone
    D, N, heads, eps = cfg.embed_dim, cfg.num_tokens, cfg.num_heads, cfg.layer_norm_eps
    hidden = int(D * cfg.mlp_ratio)
    out = {}
    for tdt in (torch.bfloat16, torch.float32):
        for B in (SLOTS, 3):
            blk, w, x, dout, keep = block_inputs(torch, model, rng, dev, tdt, B, 0.7)
            errs = {}
            hold = holder(torch, errs, tdt, B)

            o, x1, _, _ = fbt.train_forward(x, keep, w, heads, eps)
            ro, rx1, _, _ = fbt.train_forward_plain(x, keep, w, heads, eps)
            hold("K5", o, ro)
            hold("K5", x1, rx1)
            dx1, gm = fbt.mlp_backward(rx1, dout, keep, w, eps)
            rdx1, rgm = fbt.mlp_backward_plain(rx1, dout, keep, w, eps)
            for got, ref in zip((dx1, *gm), (rdx1, *rgm)):
                hold("K6a", got, ref)
            dx, ga = fbt.attn_backward(x, rdx1, keep, w, heads, eps)
            rdx, rga = fbt.attn_backward_plain(x, rdx1, keep, w, heads, eps)
            for got, ref in zip((dx, *ga), (rdx, *rga)):
                hold("K7", got, ref)
            print(f"check train {tdt} B={B}:", " ".join(f"{k} rel {v[0]:.3e} abs {v[1]:.3e}"
                                                       for k, v in errs.items()))
            if B != SLOTS or tdt != torch.bfloat16:
                continue
            swap = mma_swap_bit_equal(torch, dev, N, D // heads)
            print(f"check mma.sync m16n8k16 operand swap (mma_probe, {N} x {D // heads}; K7's P "
                  f"in kernels A and B): {'bit-equal' if swap else 'differs'}")
            fwd_ops, mlp_ops, attn_ops = train_block_work(B, N, D, hidden)
            act, wts = B * N * D * 2, (4 * D * D + 2 * D * hidden) * 2
            layer = encoder_layer(torch, blk)
            with torch.no_grad():
                lib_fwd = time_ms(torch, lambda: layer(x))
            whole = layer(x.detach().requires_grad_(True))
            lib_layer_bwd = time_ms(torch, lambda: torch.autograd.grad(
                whole, list(layer.parameters()), dout, retain_graph=True))
            print(f"yardstick TransformerEncoderLayer bf16 B={B}: forward {lib_fwd:.3f} ms, "
                  f"whole backward {lib_layer_bwd:.3f} ms")
            out["K5"] = {"max_abs_err": errs["K5"][1],
                         "ms": time_ms(torch, lambda: fbt.train_forward(x, keep, w, heads, eps)),
                         "plain_ms": time_ms(torch, lambda: fbt.train_forward_plain(x, keep, w, heads, eps)),
                         "bound": bound(act + 2 * act + wts, {"bf16": fwd_ops}), "library_ms": lib_fwd}
            out["K6a"] = {"max_abs_err": errs["K6a"][1],
                          "ms": time_ms(torch, lambda: fbt.mlp_backward(rx1, dout, keep, w, eps)),
                          "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_plain(rx1, dout, keep, w, eps)),
                          "bound": bound(3 * act + 2 * wts, {"bf16": mlp_ops}),
                          "library_ms": time_ms(torch, sublayer_backward(torch, layer, rx1, dout, "mlp"))}
            out["K7"] = {"max_abs_err": errs["K7"][1],
                         "ms": time_ms(torch, lambda: fbt.attn_backward(x, rdx1, keep, w, heads, eps)),
                         "plain_ms": time_ms(torch, lambda: fbt.attn_backward_plain(x, rdx1, keep, w, heads, eps)),
                         "bound": bound(3 * act + 2 * wts, {"bf16": attn_ops}),
                         "library_ms": time_ms(torch, sublayer_backward(torch, layer, x, rdx1, "attn"))}

    out.update(check_optimizer(torch, model, rng, dev, "f32"))
    return out


def check_wide_kernels(torch, model, rng, dev):
    """K6b and K6c against their plain versions on ViT-L's block 0 at bf16
    and fp32, at 64 crops and at 3, and against K6a on the same inputs; K9
    and the norm kernel (:func:`check_optimizer`); returns measurements per
    kernel."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt

    cfg = model.cfg.backbone
    D, N, eps = cfg.embed_dim, cfg.num_tokens, cfg.layer_norm_eps
    hidden = int(D * cfg.mlp_ratio)
    out = {}
    for tdt in (torch.bfloat16, torch.float32):
        for B in (SLOTS, 3):
            blk, w, x1, dout, keep = block_inputs(torch, model, rng, dev, tdt, B, 0.5)
            errs = {}
            hold = holder(torch, errs, tdt, B)

            got = fbt.mlp_backward_dx_save(x1, dout, keep, w, eps)
            ref = fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps)
            for g_, r_ in zip(got, ref):
                hold("K6b", g_, r_)
            dW = fbt.mlp_backward_dw_saved(*ref[1:5])
            for g_, r_ in zip(dW, fbt.mlp_backward_dw_saved_plain(*ref[1:5])):
                hold("K6c", g_, r_)
            # K6b then K6c is K6a's function, launch for launch
            k6a = fbt.mlp_backward(x1, dout, keep, w, eps)
            wide = fbt.wide_mlp_backward(x1, dout, keep, w, eps)
            check(all(torch.equal(a, b) for a, b in zip((k6a[0], *k6a[1]), (wide[0], *wide[1]))),
                  f"K6b + K6c is not K6a's result at {tdt} B={B}")
            print(f"check wide mlp {tdt} B={B}:", " ".join(f"{k} rel {v[0]:.3e} abs {v[1]:.3e}"
                                                          for k, v in errs.items()),
                  "K6b+K6c == K6a")
            if B != SLOTS or tdt != torch.bfloat16:
                continue
            R = B * N
            gemm = 2.0 * R * D * hidden
            act, hid = R * D * 2, R * hidden * 2
            layer = encoder_layer(torch, blk)
            saved = ref[1:5]
            out["K6b"] = {"max_abs_err": errs["K6b"][1],
                          "ms": time_ms(torch, lambda: fbt.mlp_backward_dx_save(x1, dout, keep, w, eps)),
                          "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps)),
                          "bound": bound(5 * act + 2 * hid + 2 * D * hidden * 2, {"bf16": 3 * gemm}),
                          "library_ms": time_ms(torch, sublayer_backward(torch, layer, x1, dout, "mlp",
                                                                         weights=False))}
            out["K6c"] = {"max_abs_err": errs["K6c"][1],
                          "ms": time_ms(torch, lambda: fbt.mlp_backward_dw_saved(*saved)),
                          "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_dw_saved_plain(*saved)),
                          "bound": bound(2 * act + 2 * hid + 2 * D * hidden * 2, {"bf16": 2 * gemm}),
                          "library_ms": time_ms(torch, lambda: (torch.matmul(saved[2].t(), saved[0]),
                                                                torch.matmul(saved[1].t(), saved[3])))}

    out.update(check_optimizer(torch, model, rng, dev, "int8"))
    return out


# leaf sets of the optimizer's table launches beside a model's leaves: lengths
# around the 2048-element unit, and 300 leaves of 0-2100 elements
TABLE_SETS = {"ragged": [1, 3, 1001, 2047, 2048, 2049],
              "many": [int(n) for n in np.random.default_rng(5).integers(0, 2100, 300)]}


def optimizer_inputs(torch, fo, leaves, gen, moments, misalign=False):
    """Random gradients and moments (codes, for int8) for ``leaves``, drawn
    on the card; with ``misalign`` every other gradient and moment is a
    view one element into its buffer (the kernels' scalar path)."""
    def draw(p, odd):
        t = torch.randn(p.numel() + 1, generator=gen, device=p.device) * 1e-3
        return (t[1:] if odd else t[:-1]).view_as(p)

    rows = []
    for i, p in enumerate(leaves):
        g, m, v = (draw(p, misalign and i % 2) for _ in range(3))
        if moments == "int8":
            rows.append((g, *fo.q8_encode(m, 127), *fo.q8_encode(v.abs(), 255)))
        else:
            rows.append((g, m, v.square()))
    return [list(c) for c in zip(*rows)]


def check_optimizer(torch, model, rng, dev, moments):
    """K8 (``moments="f32"``) or K9 (``"int8"``) and the norm kernel: the
    table launch over every leaf of the model, of ragged sets and of a
    misaligned set against the per-leaf plain versions, bit for bit; the
    norm kernel against ``global_norm`` (bit for bit on exact-norm leaves,
    rel 1e-5 on random ones); ``fused_apply`` on the model's leaves
    writes none of its inputs and launches each kernel once; times the
    whole ``fused_apply`` (norm included), the table launch alone, the norm
    alone, the plain step, the library's and the host time of one call."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.train import fused_opt as fo

    q8 = moments == "int8"
    key, table_fn, leaf_plain = (("K9", fo.adam_table_q8, fo.adam_leaf_q8_plain) if q8 else
                                 ("K8", fo.adam_table, fo.adam_leaf_plain))
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 31)))
    main = [p.detach().float().contiguous() for p in model.parameters()]
    scal = torch.tensor([0.37, TRAIN_LR, 1 - 0.9 ** 7, 1 - 0.999 ** 7], device=dev)
    sets = {"model": (main, False),
            **{k: ([torch.randn(n, generator=gen, device=dev) for n in v], False)
               for k, v in TABLE_SETS.items()},
            "misaligned": ([torch.randn(n, generator=gen, device=dev)
                            for n in TABLE_SETS["ragged"] * 2], True)}
    for name, (leaves, mis) in sets.items():
        cols = optimizer_inputs(torch, fo, leaves, gen, moments, mis)
        got = table_fn(*cols, leaves, scal)
        for i, p in enumerate(leaves):
            if p.numel() == 0:
                continue
            ref = leaf_plain(*(c[i] for c in cols), p, scal)
            check(all(o[i].dtype == r.dtype and torch.equal(o[i], r) for o, r in zip(got, ref)),
                  f"{key}'s table launch is not bit-equal to its plain version on leaf {i} "
                  f"({p.numel()}) of the {name} set")
    print(f"check {key} table: one launch each, bit-equal on the {len(main)} model leaves "
          f"({sum(p.numel() for p in main)} parameters) and the sets "
          f"{ {k: len(v[0]) for k, v in sets.items() if k != 'model'} }")

    # the norm kernel: exact sums (+-c, +-2c) bit for bit, random within 1e-5
    for name, lengths in TABLE_SETS.items():
        signs = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=dev) * 2.0 ** -6
        gs = [signs[torch.randint(0, 4, (n,), generator=gen, device=dev)] for n in lengths]
        sg, ref = fo.clip_scale(gs, TRAIN_CLIP), fo.global_norm(gs)
        check(torch.equal(sg[1], ref), f"the norm kernel on exact {name} leaves: "
                                        f"{float(sg[1])} vs {float(ref)}")
    gs = optimizer_inputs(torch, fo, main, gen, moments)[0]
    sg, ref = fo.clip_scale(gs, TRAIN_CLIP), fo.global_norm(gs)
    norm_abs_err = abs(float(sg[1]) - float(ref))
    norm_err = norm_abs_err / float(ref)
    check(norm_err <= 1e-5, f"the norm kernel on the model's leaves: rel {norm_err}")
    print(f"check grad_norm: bit-equal on exact-norm leaves, rel {norm_err:.3e} on "
          f"{len(gs)} random model leaves")

    # fused_apply on the model's leaves, from non-zero moments
    names = [str(i) for i in range(len(main))]
    params, grads = dict(zip(names, main)), dict(zip(names, gs))
    tx = fo.make_fused_adam(TRAIN_LR, max_grad_norm=TRAIN_CLIP, moment_dtype=moments)
    params, state, _ = tx.fused_apply(grads, tx.init(params), params)

    def inputs():
        mom = [state.mu, state.nu]
        return [*grads.values(), *params.values(),
                *(t for m in mom for t in ((*m["q_tree"].values(), *m["s_tree"].values())
                                           if q8 else m.values()))]

    before = [t.clone() for t in inputs()]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    tx.fused_apply(grads, state, params)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    want = {fo.KERNEL_NORM: 1, (fo.KERNEL_Q8 if q8 else fo.KERNEL): 1}
    check(counts == want, f"fused_apply launched {counts}, expected {want}")
    check(all(torch.equal(a, b) for a, b in zip(before, inputs())),
          "fused_apply wrote one of its inputs")
    del before
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.fused_apply(grads, state, params)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host_ms = statistics.median(host)

    pl = list(params.values())
    if q8:
        cols = [list(grads.values()), *[list(m[t].values()) for m in (state.mu, state.nu)
                                        for t in ("q_tree", "s_tree")]]
        tab, _, _ = fo._prepare(pl, (cols[0], pl, *cols[1:]), fo.Q8_IN, fo.Q8_OUT)
    else:
        cols = [list(grads.values()), list(state.mu.values()), list(state.nu.values())]
        tab, _, _ = fo._prepare(pl, (*cols, pl), fo.F32_IN, fo.F32_OUT)
    sg = fo._launch_norm(tab, TRAIN_CLIP)
    step_scal = torch.stack([sg[0], scal[1], scal[2], scal[3]])

    def plain_step():
        s = fo.clip_scale_plain(cols[0], TRAIN_CLIP)
        sc = torch.stack([s[0], scal[1], scal[2], scal[3]])
        return [leaf_plain(*(c[i] for c in cols), p, sc) for i, p in enumerate(pl)]

    n = sum(p.numel() for p in main)
    n_blocks = sum(fo.q8_blocks(p.numel()) for p in main)
    res = {"max_abs_err": 0.0, "ms": time_ms(torch, lambda: tx.fused_apply(grads, state, params)),
           "table_ms": time_ms(torch, lambda: fo._launch_adam(tab, step_scal)),
           "norm_ms": time_ms(torch, lambda: fo._launch_norm(tab, TRAIN_CLIP)),
           "plain_ms": time_ms(torch, plain_step), "host_ms": host_ms,
           "norm_abs_err": norm_abs_err,
           "norm_plain_ms": time_ms(torch, lambda: fo.global_norm(cols[0])),
           # the row includes the norm: 4 more bytes of g per element
           "bound": (bound(20.0 * n + 16.0 * n_blocks, {"f32": 52.0 * n}) if q8 else
                     bound(32.0 * n, {"f32": 14.0 * n})),
           "table_bound": (bound(16.0 * n + 16.0 * n_blocks, {"f32": 50.0 * n}) if q8 else
                           bound(28.0 * n, {"f32": 12.0 * n})),
           "norm_bound": bound(4.0 * n, {"f32": 2.0 * n})}
    total_norm = getattr(torch.nn.utils, "get_total_norm", None)
    res["norm_library_ms"] = (time_ms(torch, lambda: total_norm(cols[0]))
                              if total_norm is not None else None)
    res["library_ms"] = None
    if not q8:
        ps = [torch.nn.Parameter(p.clone()) for p in params.values()]
        for p, g in zip(ps, cols[0]):
            p.grad = g.clone()
        opt = torch.optim.Adam(ps, lr=TRAIN_LR, fused=True)

        def library_step():
            torch.nn.utils.clip_grad_norm_(ps, TRAIN_CLIP)
            opt.step()

        res["library_ms"] = time_ms(torch, library_step)
        del ps, opt
    print(f"{key} fused_apply on {len(main)} leaves: {res['ms']:.3f} ms (bound "
          f"{res['bound'][0]:.3f}), table launch {res['table_ms']:.3f} (bound "
          f"{res['table_bound'][0]:.3f}), norm {res['norm_ms']:.3f} (bound "
          f"{res['norm_bound'][0]:.3f}), plain {res['plain_ms']:.3f}, library "
          f"{res['library_ms']}, host {host_ms:.3f} ms a call")
    return {key: res}


def equal_to(torch, got, ref, what):
    check(all(torch.equal(a, b) for a, b in zip(got, ref)), f"{what} is not bit for bit")


def f32_close(torch, got, ref, what):
    """Each tensor within 1e-6 of the largest |ref| of its kind."""
    worst = max(max_rel_err(torch, a, b)[1] for a, b in zip(got, ref))
    check(worst <= 1e-6, f"{what} at float32: {worst}")
    return worst


def flat(res):
    """(dx, (grads...)) -> (dx, grads...)"""
    return (res[0], *res[1])


def check_flavor_kernels(torch, model, rng, dev):
    """The saved flavors on ViT-B's block 0 at bf16 and fp32, 64 crops and
    3: K5's saved qkv and m, K6a ``_ms`` and K7 ``_saved`` against their
    plain versions (on the plain forward's x1, m and qkv); K7 ``_saved`` on
    K5's own qkv equal to K7 bit for bit; at fp32 K6a ``_ms`` on K5's own x1
    and m within 1e-6 of K6a.  Returns measurements per kernel."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt

    cfg = model.cfg.backbone
    D, N, heads, eps = cfg.embed_dim, cfg.num_tokens, cfg.num_heads, cfg.layer_norm_eps
    hidden = int(D * cfg.mlp_ratio)
    out = {}
    for tdt in (torch.bfloat16, torch.float32):
        for B in (SLOTS, 3):
            blk, w, x, dout, keep = block_inputs(torch, model, rng, dev, tdt, B, 0.7)
            errs = {}
            hold = holder(torch, errs, tdt, B)

            got = fbt.train_forward(x, keep, w, heads, eps, save_qkv=True, save_m=True)
            ref = fbt.train_forward_plain(x, keep, w, heads, eps, save_qkv=True, save_m=True)
            for g_, r_ in zip(got, ref):
                hold("K5 saves", g_, r_)
            _, rx1, rqkv, rm = ref
            dx1 = dout * 5                                  # the grad into x1, rounded
            equal_to(torch, flat(fbt.attn_backward(x, dx1, keep, w, heads, eps, qkv=got[2])),
                     flat(fbt.attn_backward(x, dx1, keep, w, heads, eps)), "K7_saved = K7")
            for g_, r_ in zip(flat(fbt.attn_backward(x, dx1, keep, w, heads, eps, qkv=rqkv)),
                              flat(fbt.attn_backward_plain(x, dx1, keep, w, heads, eps, rqkv))):
                hold("K7_saved", g_, r_)
            ms_got = flat(fbt.mlp_backward(rx1, dout, keep, w, eps, m=rm))
            for g_, r_ in zip(ms_got, flat(fbt.mlp_backward_plain(rx1, dout, keep, w, eps, rm))):
                hold("K6a_ms", g_, r_)
            note = ""
            if tdt == torch.float32:      # on K5's own x1 and m: the m K6a recomputes
                worst = f32_close(torch, flat(fbt.mlp_backward(got[1], dout, keep, w, eps, m=got[3])),
                                  flat(fbt.mlp_backward(got[1], dout, keep, w, eps)), "K6a_ms vs K6a")
                note = f" K6a_ms vs K6a {worst:.2e}"
            print(f"check flavors {tdt} B={B}:", " ".join(f"{k} rel {v[0]:.3e} abs {v[1]:.3e}"
                                                         for k, v in errs.items()),
                  f"K7_saved == K7{note}")
            if B != SLOTS or tdt != torch.bfloat16:
                continue
            fwd_ops, mlp_ops, attn_ops = train_block_work(B, N, D, hidden)
            R = B * N
            act, mlp_w, attn_w = R * D * 2, 2 * D * hidden * 2, 4 * D * D * 2
            layer = encoder_layer(torch, blk)
            out["K6a_ms"] = {
                "max_abs_err": errs["K6a_ms"][1],
                "ms": time_ms(torch, lambda: fbt.mlp_backward(rx1, dout, keep, w, eps, m=rm)),
                "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_plain(rx1, dout, keep, w, eps, rm)),
                "bound": bound(3 * act + R * hidden * 2 + 2 * mlp_w, {"bf16": mlp_ops * 4 / 5}),
                "library_ms": time_ms(torch, sublayer_backward(torch, layer, rx1, dout, "mlp"))}
            out["K7_saved"] = {
                "max_abs_err": errs["K7_saved"][1],
                "ms": time_ms(torch, lambda: fbt.attn_backward(x, dx1, keep, w, heads, eps, qkv=rqkv)),
                "plain_ms": time_ms(torch, lambda: fbt.attn_backward_plain(x, dx1, keep, w, heads, eps, rqkv)),
                "bound": bound(6 * act + 2 * attn_w, {"bf16": attn_ops - 2.0 * R * D * 3 * D}),
                "library_ms": time_ms(torch, sublayer_backward(torch, layer, x, dx1, "attn"))}
    return out


def saved_m_cuda(x1, w, eps):
    """The pre-GELU m that K5's launches save for ``x1`` (its LN2 and fc1
    GEMM), (B, N, hidden) in x1's dtype."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt

    B, N, D = x1.shape
    h2 = fbt.layernorm_cuda(x1.reshape(B * N, D), w.ln2_w, w.ln2_b, eps, x1.dtype)
    return fbt.gemm_nt(h2, w.fc1_w, fbt.TE_GELU_SAVE_T, bias=w.fc1_b)[1].reshape(B, N, -1)


def check_wide_flavor_kernels(torch, model, rng, dev):
    """The wide flavors on ViT-L's block 0 at bf16 and fp32, 64 crops and
    3: K6b ``_ms`` (on a saved m from the plain forward's chain), K6d and
    K6e against their plain versions; K6d then K6e equal to K6b then K6c
    bit for bit; at fp32 K6b ``_ms`` on the m K5 saves for that x1 within
    1e-6 of K6b.  Returns measurements per kernel."""
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vit import layer_norm, linear_f32

    cfg = model.cfg.backbone
    D, N, eps = cfg.embed_dim, cfg.num_tokens, cfg.layer_norm_eps
    hidden = int(D * cfg.mlp_ratio)
    out = {}
    for tdt in (torch.bfloat16, torch.float32):
        for B in (SLOTS, 3):
            blk, w, x1, dout, keep = block_inputs(torch, model, rng, dev, tdt, B, 0.5)
            m = linear_f32(layer_norm(x1, w.ln2_w, w.ln2_b, eps), w.fc1_w, w.fc1_b).to(tdt)
            errs = {}
            hold = holder(torch, errs, tdt, B)

            got = fbt.mlp_backward_dx_save(x1, dout, keep, w, eps, m=m)
            for g_, r_ in zip(got, fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps, m)):
                hold("K6b_ms", g_, r_)
            for g_, r_ in zip(fbt.mlp_backward_dx(x1, dout, keep, w, eps),
                              fbt.mlp_backward_dx_plain(x1, dout, keep, w, eps)):
                hold("K6d", g_, r_)
            for g_, r_ in zip(fbt.mlp_backward_dw(x1, dout, keep, w, eps),
                              fbt.mlp_backward_dw_plain(x1, dout, keep, w, eps)):
                hold("K6e", g_, r_)
            equal_to(torch, flat(fbt.wide_mlp_backward_recompute(x1, dout, keep, w, eps)),
                     flat(fbt.wide_mlp_backward(x1, dout, keep, w, eps)), "K6d + K6e = K6b + K6c")
            note = ""
            if tdt == torch.float32:      # on the m that K5 would save for this x1
                worst = f32_close(torch, fbt.mlp_backward_dx_save(x1, dout, keep, w, eps,
                                                                  m=saved_m_cuda(x1, w, eps)),
                                  fbt.mlp_backward_dx_save(x1, dout, keep, w, eps), "K6b_ms vs K6b")
                note = f" K6b_ms vs K6b {worst:.2e}"
            print(f"check wide flavors {tdt} B={B}:", " ".join(
                f"{k} rel {v[0]:.3e} abs {v[1]:.3e}" for k, v in errs.items()),
                f"K6d+K6e == K6b+K6c{note}")
            if B != SLOTS or tdt != torch.bfloat16:
                continue
            R = B * N
            gemm = 2.0 * R * D * hidden
            act, hid, wts = R * D * 2, R * hidden * 2, 2 * D * hidden * 2
            layer = encoder_layer(torch, blk)
            inputs = sublayer_backward(torch, layer, x1, dout, "mlp", weights=False)
            out["K6b_ms"] = {
                "max_abs_err": errs["K6b_ms"][1],
                "ms": time_ms(torch, lambda: fbt.mlp_backward_dx_save(x1, dout, keep, w, eps, m=m)),
                "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_dx_save_plain(x1, dout, keep, w, eps, m)),
                "bound": bound(5 * act + 3 * hid + wts, {"bf16": 2 * gemm}),
                "library_ms": time_ms(torch, inputs)}
            out["K6d"] = {
                "max_abs_err": errs["K6d"][1],
                "ms": time_ms(torch, lambda: fbt.mlp_backward_dx(x1, dout, keep, w, eps)),
                "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_dx_plain(x1, dout, keep, w, eps)),
                "bound": bound(3 * act + wts, {"bf16": 3 * gemm}),
                "library_ms": time_ms(torch, inputs)}
            out["K6e"] = {
                "max_abs_err": errs["K6e"][1],
                "ms": time_ms(torch, lambda: fbt.mlp_backward_dw(x1, dout, keep, w, eps)),
                "plain_ms": time_ms(torch, lambda: fbt.mlp_backward_dw_plain(x1, dout, keep, w, eps)),
                "bound": bound(2 * act + 2 * wts, {"bf16": 4 * gemm}),
                "library_ms": time_ms(torch, sublayer_backward(torch, layer, x1, dout, "mlp",
                                                               weights="only"))}
    return out


def train_batch(torch, rng, B: int, dev, K: int = 17) -> dict:
    """A device-input batch: B uint8 crops of noise and K joints each
    inside the crop, 85% visible."""
    W, H = 192, 256
    joints = np.stack([rng.uniform(0, W, (B, K)), rng.uniform(0, H, (B, K))], -1)
    return {"images_u8": torch.from_numpy(rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(dev),
            "joints": torch.from_numpy(joints.astype(np.float32)).to(dev),
            "joints_vis": torch.from_numpy((rng.uniform(size=(B, K, 2)) > 0.15)
                                           .astype(np.float32)).to(dev)}


FLAVOR_VARS = ("EVT_TRAIN_ATTN", "EVT_TRAIN_MLP", "EVT_TRAIN_WIDE")


@contextlib.contextmanager
def flavor_env(flavor: dict):
    """The ``EVT_TRAIN_*`` switches set to ``flavor`` (the others unset)
    inside the block, and restored after it."""
    saved = {k: os.environ.get(k) for k in FLAVOR_VARS}
    try:
        for k in FLAVOR_VARS:
            os.environ.pop(k, None)
        os.environ.update(flavor)
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def run_train_step(torch, model, rng, seed, dev, block_kernels, moments: str = "f32",
                   flavor: dict = None):
    """The training step at full width with Adam moments at ``moments``
    under the ``EVT_TRAIN_*`` switches ``flavor``; each counter of
    ``block_kernels`` must count one launch per block and no other block
    kernel may launch.  Returns launches, losses, the kernel-vs-plain
    errors and times."""
    with flavor_env(flavor or {}):
        return _run_train_step(torch, model, rng, seed, dev, block_kernels, moments, flavor)


def _run_train_step(torch, model, rng, seed, dev, block_kernels, moments, flavor):
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    cfg = model.cfg
    depth, name = cfg.backbone.depth, f"train step ViT-{cfg.name.upper()} {moments}"
    if flavor:
        name += " " + " ".join(f"{k[10:]}={v}" for k, v in flavor.items())
    B = SLOTS
    batch = train_batch(torch, rng, B, dev)
    tx = fused_opt.make_fused_adam(TRAIN_LR, max_grad_norm=TRAIN_CLIP, moment_dtype=moments)
    state = tstep.init_train_state(model, tx, device=dev)
    step = tstep.make_train_step(cfg, tx, use_amp=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    state, m = step(state, batch, gen)                      # warm-up, the first step
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {**dict.fromkeys(block_kernels, depth), fused_opt.KERNEL_NORM: 1,
            (fused_opt.KERNEL_Q8 if moments == "int8" else fused_opt.KERNEL): 1}
    print(f"{name}: launches {counts}")
    check(counts == want, f"{name} launched {counts}, expected {want}")
    losses = [float(m["loss"])]
    for _ in range(TRAIN_STEPS - 2):
        state, m = step(state, batch, gen)
        losses.append(float(m["loss"]))
    check(all(math.isfinite(v) for v in losses) and math.isfinite(float(m["grad_norm"])),
          f"{name}: loss or grad norm not finite: {losses}")
    print(f"{name}: losses", " ".join(f"{v:.5f}" for v in losses))
    check(losses[-1] < 0.9 * losses[0], f"{name}: the loss did not fall: {losses}")

    rendered = tstep.render_batch_on_device(batch, dev)
    masks = draw_drop_path_masks(cfg.backbone, B, gen, dev)
    lk, _, gk = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks)
    lp, _, gp = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks, plain=True)
    loss_err = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_err = {k: max_rel_err(torch, gk[k], gp[k])[1] for k in gp}
    worst = sorted(grad_err.items(), key=lambda kv: kv[1])[-3:]
    print(f"{name} vs plain: loss {float(lk):.6f} vs {float(lp):.6f} (rel {loss_err:.3e}); "
          f"worst grads {worst}")
    check(loss_err <= STEP_LOSS_TOL, f"{name} loss disagrees with the plain step: {loss_err}")
    check(max(grad_err.values()) <= STEP_GRAD_TOL, f"{name} grads disagree: {worst}")
    del gk, gp

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def window():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_REPS):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / TRAIN_REPS

    ms = statistics.median(window() for _ in range(5))
    n_params = sum(p.numel() for p in state["params"].values())
    res = {"launches": counts, "ms_per_step": ms, "images_per_s": B / ms * 1e3,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss_first": losses[0], "loss_last": losses[-1], "loss_rel_err_vs_plain": loss_err,
           "max_grad_rel_err_vs_plain": max(grad_err.values()), "parameters": n_params,
           "moment_bytes": fused_opt.moment_bytes(state["opt_state"]),
           "moment_bytes_f32": 8 * n_params}
    print(f"{name}: {ms:.3f} ms/step, {res['images_per_s']:.1f} images/s, "
          f"peak {res['max_memory_allocated_gib']:.2f} GiB, moments {res['moment_bytes']} B "
          f"({moments}) against {res['moment_bytes_f32']} B at f32")
    return res


def run_accum_step(torch, model, rng, seed, dev, accum: int = 2, ema: float = 0.999):
    """One ViT-B AMP step of 64 crops in ``accum`` micro-batches with an EMA
    of decay ``ema``, through the kernels and as the plain step, from one
    state and the same drop-path masks: launches (the blocks' kernels once
    per block and micro-batch, the norm kernel and K8 once), the loss, the grads (from
    the first Adam moment, mu = 0.1 s g with each side's clip scale s), the
    BN running statistics chained through the micro-batches, and each EMA
    against ``ema * e + (1 - ema) * p'`` of its own step."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    cfg, B = model.cfg, SLOTS
    name = f"train step ViT-{cfg.name.upper()} grad_accum={accum} ema_decay={ema}"
    batch = train_batch(torch, rng, B, dev)
    masks = draw_drop_path_masks(cfg.backbone, B, torch.Generator(device=dev).manual_seed(seed), dev)
    res = {}
    for plain in (False, True):
        tx = fused_opt.make_fused_adam(TRAIN_LR, max_grad_norm=TRAIN_CLIP)
        state = tstep.init_train_state(model, tx, ema_decay=ema, device=dev)
        step = tstep.make_train_step(cfg, tx, use_amp=True, ema_decay=ema, grad_accum=accum,
                                     plain=plain)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        new, m = step(state, batch, drop_path_masks=masks)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        depth = cfg.backbone.depth
        want = {fused_opt.KERNEL: 1, fused_opt.KERNEL_NORM: 1}
        if not plain:
            want.update({fbt.FWD: accum * depth, fbt.BWD_MLP: accum * depth,
                         fbt.BWD_ATTN: accum * depth})
        print(f"{name}{' plain' if plain else ''}: launches {counts}, {ms:.1f} ms (first call)")
        check(counts == want, f"{name} launched {counts}, expected {want}")
        for k, e in new["ema_params"].items():
            ref = state["ema_params"][k] * ema + new["params"][k] * (1.0 - ema)
            check(torch.allclose(e, ref, rtol=2 ** -22, atol=1e-12),
                  f"{name}: the EMA of {k} is not e' = d e + (1 - d) p'")
        scale = 0.1 * min(1.0, TRAIN_CLIP / float(m["grad_norm"]))
        res[plain] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "grads": {k: v / scale for k, v in new["opt_state"].mu.items()},
                      "bn": new["bn_state"], "launches": counts}
        del state, new
    k, p = res[False], res[True]
    loss_err = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    grad_err = {n: max_rel_err(torch, k["grads"][n], p["grads"][n])[1] for n in p["grads"]}
    bn_err = max(max_rel_err(torch, k["bn"][n], p["bn"][n])[1] for n in p["bn"])
    worst = sorted(grad_err.items(), key=lambda kv: kv[1])[-3:]
    print(f"{name} vs plain: loss {k['loss']:.6f} vs {p['loss']:.6f} (rel {loss_err:.3e}); "
          f"grad norm {k['grad_norm']:.5f} vs {p['grad_norm']:.5f}; worst grads {worst}; "
          f"BN statistics {bn_err:.3e}")
    check(loss_err <= STEP_LOSS_TOL, f"{name} loss disagrees with the plain step: {loss_err}")
    check(max(grad_err.values()) <= STEP_GRAD_TOL, f"{name} grads disagree: {worst}")
    check(bn_err <= TRAIN_TOL["torch.bfloat16"], f"{name} BN statistics disagree: {bn_err}")
    return {"launches": k["launches"], "loss_rel_err_vs_plain": loss_err,
            "max_grad_rel_err_vs_plain": max(grad_err.values()), "bn_rel_err_vs_plain": bn_err}


# ----------------------------------------------------------------- parallel
PAR_RANKS = 2          # spawned ranks of the two-rank checks, both on the one card
PAR_CROPS = 16         # crops of the two-rank TP check (float32, plain blocks)
PAR_TIMEOUT = 240.0    # seconds the spawned ranks may take
PAR_MICRO = 4          # micro-batches of the two-rank PP check (4 crops each)
PAR_PP_REPS = 3        # timed PP forward + backward passes after a warm-up
PP_TOL = 1e-5          # PP against one process: a leaf's gap over its largest value
# 2-way TP's grads against the plain one-process step at float32: twice the
# largest gap measured on the card, 1.693e-3 of the deconv weights' largest
# grad (ROADMAP C17: the TP features' float32 gap, 7.8e-7, flips ReLU
# decisions in the head; on the same features the head is bit for bit);
# the CPU tests hold 1e-5; the loss is held at 1e-4 as DP's
TP_GRAD_TOL = 2 * 1.693e-3


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_one_rank(torch, dev):
    """A one-rank NCCL process group on ``dev`` for the block, destroyed
    after it."""
    import torch.distributed as dist
    from easy_vitpose_tpu_torch.kernels import resolve_device
    torch.cuda.set_device(resolve_device(dev))
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def states_equal(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def run_sharded_one_rank(torch, model, rng, seed, dev, block_kernels, moments: str) -> dict:
    """(a) The sharded step (``make_train_step_sharded``) over a one-rank
    NCCL group against ``make_train_step`` from one state, batch and set of
    drop-path masks: the same launches, loss and params bit for bit; ms per
    step of each (alternating windows) and of the flat all-reduce alone."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.parallel import comm
    from easy_vitpose_tpu_torch.parallel.mesh import make_mesh
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    cfg, B = model.cfg, SLOTS
    depth, name = cfg.backbone.depth, f"parallel one-rank NCCL ViT-{cfg.name.upper()} {moments}"
    batch = train_batch(torch, rng, B, dev)
    masks = draw_drop_path_masks(cfg.backbone, B, torch.Generator(device=dev).manual_seed(seed),
                                 dev)
    tx = fused_opt.make_fused_adam(TRAIN_LR, max_grad_norm=TRAIN_CLIP, moment_dtype=moments)
    want = {**dict.fromkeys(block_kernels, depth), fused_opt.KERNEL_NORM: 1,
            (fused_opt.KERNEL_Q8 if moments == "int8" else fused_opt.KERNEL): 1}
    with nccl_one_rank(torch, dev):
        mesh = make_mesh(device=dev)
        check(mesh.size == 1 and mesh.group is not None, f"{name}: mesh {mesh}")
        steps = {"bare": tstep.make_train_step(cfg, tx, use_amp=True),
                 "sharded": tstep.make_train_step_sharded(cfg, tx, mesh, use_amp=True)}
        out, counts = {}, {}
        for k, step in steps.items():
            state = tstep.init_train_state(model, tx, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out[k] = step(state, batch, drop_path_masks=masks)
            torch.cuda.synchronize()
            counts[k] = kernels.launch_counts()
            del state
        print(f"{name}: launches {counts['sharded']}")
        check(counts["sharded"] == counts["bare"] == want,
              f"{name} launched {counts}, expected {want}")
        (sb, mb), (ss, msh) = out["bare"], out["sharded"]
        check(torch.equal(mb["loss"], msh["loss"]), f"{name}: loss {msh['loss']} vs {mb['loss']}")
        check(states_equal(torch, sb["params"], ss["params"]), f"{name}: params differ")
        check(states_equal(torch, sb["bn_state"], ss["bn_state"]), f"{name}: BN statistics differ")
        del sb

        def window(step):
            nonlocal ss
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_REPS):
                ss, _ = step(ss, batch, drop_path_masks=masks)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / TRAIN_REPS

        ms = {"bare": [], "sharded": []}
        for _ in range(4):
            for k in ("bare", "sharded"):
                ms[k].append(window(steps[k]))
        grads = [torch.randn_like(v) for v in ss["params"].values()]
        n = sum(g.numel() for g in grads)
        ar_ms = device_ms(torch, lambda: comm.all_reduce_mean_flat(grads, mesh.group), reps=20)
        del ss, grads
    res = {"launches": counts["sharded"], "bit_equal": True,
           "ms_per_step": statistics.median(ms["sharded"]),
           "bare_ms_per_step": statistics.median(ms["bare"]),
           "flat_all_reduce_ms": ar_ms, "flat_all_reduce_floats": n}
    print(f"{name}: bit-equal to make_train_step; {json.dumps(res)}")
    return res


def _parallel_rank(rank: int, world: int, store: str, seed: int, out_dir: str) -> None:
    """(b) One spawned rank of the two-rank checks over gloo with CUDA
    tensors, both ranks on cuda:0: DP, TP and PP.  Rank 0 holds DP and TP
    against the one-process path on the card, each rank its PP stage; the
    parent checks the saved numbers; an exception is saved for the parent,
    which fails."""
    import traceback
    import torch
    try:
        _parallel_rank_checks(torch, rank, world, store, seed, out_dir)
    except BaseException:  # noqa: BLE001 — the parent reads it and fails
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def _parallel_rank_checks(torch, rank, world, store, seed, out_dir):
    import torch.distributed as dist
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, shard_batch
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, cfg, slots, crops = torch.device("cuda", 0), get_model_config("coco", "b"), SLOTS, PAR_CROPS
    initialize_distributed("file://" + store, world, rank, device=dev, backend="gloo")
    model = init_params(cfg, seed).to(dev)
    res = {}
    # DP: the global batch of `slots` crops, slots / world a rank, through the kernels
    mesh = make_mesh(device=dev)
    batch = train_batch(torch, np.random.default_rng(seed + 30), slots, dev)
    tx = fused_opt.make_fused_adam(TRAIN_LR, max_grad_norm=TRAIN_CLIP)
    step = tstep.make_train_step_sharded(cfg, tx, mesh, use_amp=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    new, m = step(tstep.init_train_state(model, tx, device=dev), shard_batch(mesh, batch), gen)
    if rank == 0:
        masks = draw_drop_path_masks(cfg.backbone, slots,
                                     torch.Generator(device=dev).manual_seed(seed), dev)
        one, m1 = tstep.make_train_step(cfg, tx, use_amp=True)(
            tstep.init_train_state(model, tx, device=dev), batch, drop_path_masks=masks)
        grads = {}
        for (k, mu), mu1 in zip(new["opt_state"].mu.items(), one["opt_state"].mu.values()):
            s = 0.1 * min(1.0, TRAIN_CLIP / float(m["grad_norm"]))
            s1 = 0.1 * min(1.0, TRAIN_CLIP / float(m1["grad_norm"]))
            grads[k] = max_rel_err(torch, mu / s, mu1 / s1)[1]
        res["dp"] = {"loss": float(m["loss"]), "one_process_loss": float(m1["loss"]),
                     "loss_rel_err": abs(float(m["loss"]) - float(m1["loss"])) / float(m1["loss"]),
                     "max_grad_rel_err": max(grads.values()),
                     "worst": sorted(grads.items(), key=lambda kv: kv[1])[-2:]}
        del one
    del new
    # TP: 2-way model parallel (6 heads, 1536 hidden units a rank), float32 plain blocks
    sd = {k: v.float() for k, v in model.state_dict().items() if not k.endswith("tracked")}
    params, bn = tstep.split_bn_state(sd)
    rendered = tstep.render_batch_on_device(
        {k: v[:crops] for k, v in batch.items()}, dev)
    res["tp"] = _tp_checks(torch, rank, world, dev, cfg, params, bn, rendered)
    # PP: 2 stages of 6 layers, PAR_MICRO micro-batches, the hand-off staged
    # through host memory (gloo sends host memory only)
    res["pp"] = _pp_checks(torch, rank, world, dev, cfg, params, rendered["images"], seed)
    # logging on each rank: rank 0 logs at INFO, the others only errors
    from easy_vitpose_tpu_torch.utils.logging import get_logger, master_only
    lg = get_logger("easy_vitpose_tpu_torch.chip_smoke")
    res["logging"] = {"level": logging.getLevelName(lg.level),
                      "master_only": master_only(lambda: rank)()}
    torch.save(res, os.path.join(out_dir, f"{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _head_grads(torch, heads, bn, feats, cfg, rendered, group) -> dict:
    """The head's float32 grads of the joints loss on fixed ``feats``."""
    from easy_vitpose_tpu_torch.models.head import head_forward_train
    from easy_vitpose_tpu_torch.train.losses import joints_mse_loss
    leaves = {k: v.detach().requires_grad_(True) for k, v in heads.items()}
    heat, _ = head_forward_train({**leaves, **bn}, feats, cfg.head, group=group)
    loss = joints_mse_loss(heat, rendered["targets"], rendered["target_weights"])
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _relu_flips(torch, heads, bn, fa, fb, cfg) -> list:
    """Per deconv stage of the head, the activations whose ReLU decision
    differs between features ``fa`` and ``fb`` (train-mode BatchNorm)."""
    import torch.nn.functional as F
    from easy_vitpose_tpu_torch.models.head import batch_norm_train
    flips, xa, xb = [], fa, fb
    for i, k in enumerate(cfg.head.deconv_kernels):
        dc, b = f"keypoint_head.deconv_layers.{3 * i}", f"keypoint_head.deconv_layers.{3 * i + 1}"
        ys = []
        for x in (xa, xb):
            x = F.conv_transpose2d(x, heads[f"{dc}.weight"], stride=2, padding=k // 2 - 1)
            ys.append(batch_norm_train(x, heads[f"{b}.weight"], heads[f"{b}.bias"],
                                       bn[f"{b}.running_mean"], bn[f"{b}.running_var"])[0])
        flips.append(int(((ys[0] > 0) != (ys[1] > 0)).sum()))
        xa, xb = torch.relu(ys[0]), torch.relu(ys[1])
    return flips


def _tp_checks(torch, rank, world, dev, cfg, params, bn, rendered) -> dict:
    """2-way TP at float32 against the one-process plain path, with cuDNN's
    default algorithms and with its deterministic ones; then C17's split:
    the head alone on the TP forward's features against the one-process
    head on the same features and on its own."""
    import dataclasses
    from easy_vitpose_tpu_torch.models.vit import vit_forward_train
    from easy_vitpose_tpu_torch.parallel import tp
    from easy_vitpose_tpu_torch.train import step as tstep

    mesh2 = tp.make_mesh_2d(1, world, device=dev)
    shards = tp.shard_params(params, mesh2)
    cfg0 = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, drop_path_rate=0.0))
    out = {"heads_per_rank": cfg.backbone.num_heads // world,
           "hidden_per_rank": shards["backbone.blocks.0.mlp.fc1.weight"].shape[0]}
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    try:
        for mode, deterministic in (("default", False), ("deterministic", True)):
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = False
            local = {k: v.detach().requires_grad_(True) for k, v in shards.items()}
            heat, _ = tp.tp_vitpose_forward_train({**local, **bn}, rendered["images"], cfg, mesh2)
            loss = tstep.joints_mse_loss(heat, rendered["targets"], rendered["target_weights"])
            g = tp.gather_params(dict(zip(local, torch.autograd.grad(loss, list(local.values())))),
                                 mesh2)
            if rank == 0:        # the TP step has no drop-path
                l1, _, g1 = tstep.loss_and_grads(cfg0, params, bn, rendered, use_amp=False,
                                                 block_impl="xla")
                errs = {k: max_rel_err(torch, g[k], g1[k])[1] for k in g1}
                out[mode] = {"loss_rel_err": abs(float(loss.detach()) - float(l1)) / float(l1),
                             "max_grad_rel_err": max(errs.values()),
                             "worst": sorted(errs.items(), key=lambda kv: kv[1])[-2:]}
            del g, local
        # C17's split, cuDNN deterministic: the head alone on fixed features
        with torch.no_grad():
            feats = tp.tp_backbone_forward_train({**shards, **bn}, rendered["images"], cfg, mesh2)
        if rank == 0:
            with torch.no_grad():
                feats1 = vit_forward_train(params, rendered["images"], cfg0.backbone,
                                           block_impl="xla").permute(0, 3, 1, 2)
            heads = {k: v for k, v in params.items() if k.startswith("keypoint_head.")}
            g_tp = _head_grads(torch, heads, bn, feats, cfg, rendered, mesh2.data.group)
            g_same = _head_grads(torch, heads, bn, feats, cfg, rendered, None)
            g_own = _head_grads(torch, heads, bn, feats1, cfg, rendered, None)
            with torch.no_grad():
                flips = _relu_flips(torch, heads, bn, feats, feats1, cfg)
            out["head_alone"] = {
                "same_features_max_grad_rel_err": max(max_rel_err(torch, g_tp[k], g_same[k])[1]
                                                      for k in heads),
                "own_features_max_grad_rel_err": max(max_rel_err(torch, g_tp[k], g_own[k])[1]
                                                     for k in heads),
                "features_rel_err": max_rel_err(torch, feats, feats1)[1],
                "relu_flips_per_stage": flips}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before
    return out


def _pp_checks(torch, rank, world, dev, cfg, params, images, seed) -> dict:
    """The pipelined backbone (``pipeline_vit_forward``, ``world`` stages,
    PAR_MICRO micro-batches) at float32: this stage's output and the grads
    of every leaf it holds, of ``sum(out * cot)`` with ``cot`` drawn from
    ``seed``, against the one-process plain backbone (``vit_forward_train``,
    the XLA block) on the same weights and crops; ms of a PP forward plus
    backward (median of PAR_PP_REPS after one warm-up, both stages at once
    on the card) and of the one-process forward plus backward."""
    import dataclasses
    import torch.distributed as dist
    from easy_vitpose_tpu_torch.models.vit import vit_forward_train
    from easy_vitpose_tpu_torch.parallel import pp

    bcfg = dataclasses.replace(cfg.backbone, drop_path_rate=0.0)
    full = {k: v for k, v in params.items() if k.startswith("backbone.")}
    mesh = pp.make_pipe_mesh(world, device=dev)
    Hp, Wp = bcfg.patch_shape
    cot = torch.from_numpy(np.random.default_rng(seed + 40).standard_normal(
        (images.shape[0], Hp, Wp, bcfg.embed_dim)).astype(np.float32)).to(dev)

    def pipelined():
        local = {k: v.detach().requires_grad_(True)
                 for k, v in pp.stage_params(full, bcfg.depth, mesh).items()}
        out = pp.pipeline_vit_forward(local, images, bcfg, mesh, n_micro=PAR_MICRO)
        (out * cot).sum().backward()
        return out.detach(), {k: v.grad for k, v in local.items()}

    def one_process():
        leaves = {k: v.detach().requires_grad_(True) for k, v in full.items()}
        out = vit_forward_train(leaves, images, bcfg, block_impl="xla")
        (out * cot).sum().backward()
        return out.detach(), {k: v.grad for k, v in leaves.items()}

    def ms(fn):
        times = []
        for _ in range(PAR_PP_REPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    out, grads = pipelined()
    ref, ref_grads = one_process()
    errs = {k: max_rel_err(torch, g, ref_grads[k])[1] for k, g in grads.items()}
    res = {"stage": mesh.rank, "layers": list(pp.stage_layers(bcfg.depth, mesh)),
           "leaves": len(grads), "out_rel_err": max_rel_err(torch, out, ref)[1],
           "max_grad_rel_err": max(errs.values()),
           "worst": sorted(errs.items(), key=lambda kv: kv[1])[-2:]}
    del out, grads, ref, ref_grads
    res["ms_fwd_bwd"] = ms(pipelined)
    dist.barrier()               # the one-process pass timed alone on the card
    if rank == 0:
        res["one_process_ms_fwd_bwd"] = ms(one_process)
    dist.barrier()
    return res


def run_parallel_ranks(torch, seed: int) -> dict:
    """(b) PAR_RANKS spawned ranks on the one card over gloo with CUDA
    tensors (NCCL takes one rank per device): the DP step of SLOTS crops
    through the kernels against the one-process step (loss within 1e-4
    relative, grads within STEP_GRAD_TOL); 2-way TP against the plain
    one-process path at float32 (loss within 1e-4, grads within
    TP_GRAD_TOL, with cuDNN's default and deterministic algorithms; the
    head alone on the TP features within PP_TOL of one process's head on
    the same features); PP over 2 stages at ViT-B's full depth, each
    stage's output and grads within PP_TOL of the one-process backbone;
    rank-gated logging (rank 0 at INFO, ``master_only`` None elsewhere)."""
    import multiprocessing as mp
    import tempfile

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_parallel_rank,
                             args=(r, PAR_RANKS, os.path.join(d, "store"), seed, d))
                 for r in range(PAR_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + PAR_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = [open(os.path.join(d, f"{r}.err")).read() for r in range(PAR_RANKS)
                  if os.path.exists(os.path.join(d, f"{r}.err"))]
        check(not errors and all(p.exitcode == 0 for p in procs),
              f"parallel ranks failed: exit codes {[p.exitcode for p in procs]}\n"
              + "\n".join(errors))
        results = [torch.load(os.path.join(d, f"{r}.pt"), weights_only=False)
                   for r in range(PAR_RANKS)]
    res = results[0]
    res["seconds"] = time.perf_counter() - t0
    dp, tpr = res["dp"], res["tp"]
    check(dp["loss_rel_err"] <= 1e-4 and dp["max_grad_rel_err"] <= STEP_GRAD_TOL,
          f"parallel DP on {PAR_RANKS} ranks disagrees with one process: {dp}")
    for mode in ("default", "deterministic"):
        check(tpr[mode]["loss_rel_err"] <= 1e-4 and tpr[mode]["max_grad_rel_err"] <= TP_GRAD_TOL,
              f"parallel TP ({mode} cuDNN) disagrees with the plain path: {tpr}")
    check(tpr["head_alone"]["same_features_max_grad_rel_err"] <= PP_TOL,
          f"the TP head's grads differ from one process's on the same features: {tpr}")
    res["pp"] = {"stages": [r["pp"] for r in results]}
    for st in res["pp"]["stages"]:
        check(st["out_rel_err"] <= PP_TOL and st["max_grad_rel_err"] <= PP_TOL,
              f"parallel PP stage {st['stage']} disagrees with the one-process backbone: {st}")
    check(sorted(sum((st["layers"] for st in res["pp"]["stages"]), [])) == list(range(12)),
          f"PP stages hold layers {[st['layers'] for st in res['pp']['stages']]}")
    res["logging"] = [r["logging"] for r in results]
    check(res["logging"][0] == {"level": "INFO", "master_only": 0}
          and all(lg == {"level": "ERROR", "master_only": None} for lg in res["logging"][1:]),
          f"rank-gated logging: {res['logging']}")
    print(f"parallel ranks: {json.dumps(res)}")
    return res


def run_pose_steps(torch, model, rng, reps, dev):
    """The main path at each serving dtype; returns launches and times."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models import quant
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.ops import decode
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps

    H, W = FRAME_HW
    depth = model.cfg.backbone.depth
    frame_np = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    boxes_np = make_boxes(rng, SLOTS, H, W)
    mask_np = np.arange(SLOTS) < SLOTS - 4
    # the timed steps reuse one device copy, as a server holding its frame
    frame, boxes, mask = (torch.from_numpy(a).to(dev) for a in (frame_np, boxes_np, mask_np))
    block_kernel = {"int8": "block_q8", "bf16": "block", "fp32": "block"}
    results = {}
    real_decode = ps.decode_keypoints
    for dtype in ("int8", "bf16", "fp32"):
        kernels.reset_launch_counts()
        sm = serving_copy(model, dtype)
        torch.cuda.synchronize()
        made = kernels.launch_counts()
        if dtype == "fp32":       # the fp32 copy splits each block weight, once
            print(f"serving copy fp32: launches {made}")
            check(made.get("tf32_split") == 4 * depth,
                  f"the fp32 copy split {made.get('tf32_split')} weights, expected {4 * depth}")
        ps.pose_step(sm, frame, boxes, mask)              # warm-up
        seen = {}

        def spy(heat, geo, mask_, *a, **k):               # the step's own decode inputs
            seen.update(heat=heat, geo=geo, mask=mask_)
            return real_decode(heat, geo, mask_, *a, **k)

        ps.decode_keypoints = spy
        try:
            kernels.reset_launch_counts()
            tiles = quant.gemm_q8_launches() if dtype == "int8" else None
            kp = ps.pose_step(sm, frame_np, boxes_np, mask_np)   # as a caller would: numpy in
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        finally:
            ps.decode_keypoints = real_decode
        print(f"pose step {dtype}: launches {counts}")
        want = {block_kernel[dtype]: depth, "sampler": 1, "decode": 1}
        if dtype == "fp32":       # the four 3xTF32 GEMMs of each block
            want["gemm_tf32"] = 4 * depth
        check(counts == want, f"{dtype} pose step launched {counts}, expected {want}")
        if dtype == "int8":       # the four int8 GEMMs of each block, all on wgmma
            tiles = {t: n - tiles[t] for t, n in quant.gemm_q8_launches().items()}
            print(f"pose step int8: int8 GEMM (wgmma) launches by tile {tiles}")
            check(sum(tiles.values()) == 4 * depth,
                  f"int8 pose step: {tiles} int8 GEMM launches, expected {4 * depth}")
        check(kp.is_cuda and tuple(kp.shape) == (SLOTS, 17, 3),
              f"keypoints {kp.device} {tuple(kp.shape)}")
        check(bool(torch.isfinite(kp).all()), f"{dtype} keypoints are not finite")
        check(bool((kp[~mask] == 0).all()), f"{dtype} masked slots are not zero")
        ref = decode.decode_keypoints_plain(seen["heat"], seen["geo"], seen["mask"])
        gap = decode_gap(torch, kp, ref, seen["geo"], *seen["heat"].shape[-2:])
        print(f"pose step {dtype}: heatmaps {seen['heat'].dtype}, keypoints vs the plain "
              f"decode of its heatmaps: scores equal {torch.equal(kp[..., 2], ref[..., 2])}, "
              f"coordinate gap {gap:.3e} heatmap px")
        check(torch.equal(kp[..., 2], ref[..., 2]) and gap <= DECODE_TOL,
              f"{dtype} keypoints disagree with the plain decode of the step's heatmaps")

        # with its inputs on the card the step makes the host wait for nothing
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ps.pose_step(sm, frame, boxes, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print(f"pose step {dtype}: no host synchronisation")

        with torch.no_grad():
            hk, _ = ps.pose_heatmaps(sm, frame, boxes)
            hp, _ = ps.pose_heatmaps(sm, frame, boxes, plain=True)
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
                ps.pose_step(sm, frame, boxes, mask)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (t2 - t0) * 1e3 / r, (t1 - t0) * 1e3 / r

        wins = [window() for _ in range(5)]
        ms = statistics.median(w[0] for w in wins)
        host_ms = statistics.median(w[1] for w in wins)
        results[dtype] = {"launches": counts, "copy_launches": made,
                          "ms_per_step": ms, "host_ms_per_step": host_ms,
                          "crops_per_s": SLOTS / ms * 1e3, "heatmap_max_abs_err": err,
                          "heatmap_range": rng_, "decode_gap_px": gap}
        print(f"pose step {dtype}: {ms:.3f} ms/step, {SLOTS / ms * 1e3:.1f} crops/s, "
              f"host {host_ms:.3f} ms/step to queue")
    return results


# ---------------------------------------------------- detector and VitInference

DET_CONFIGS = (("n", 320), ("x", 640))   # README's YOLOv8n/320, and the largest at 640
VI_FRAMES, VIDEO_FRAMES = 10, 30
# pose steps of an image frame at steady state on this random-weight scene:
# at fp32 the detector's rows past the slot count that the cap keeps take a
# second, fetched step (64 people, as seen on an H100)
VI_POSE_STEPS = {"int8": 1, "bf16": 1, "fp32": 2}
STACK = 8                 # frames of a stacked launch: the multi-stream tick's streams
BATCH_WINDOW = 16         # frames of an inference_batched window


def sampled_bytes(geom, H: int, W: int) -> int:
    """Bytes of the frame that D1's taps read: the distinct rows times the
    distinct columns of the resized image's bilinear taps, 3 bytes each."""
    r, new_w, new_h, left, top, cw, ch = geom

    def taps(n, new_n):
        s = np.float32(n / new_n)
        src = (np.arange(new_n, dtype=np.float32) + np.float32(0.5)) * s - np.float32(0.5)
        i0 = np.floor(np.clip(src, 0, n - 1)).astype(int)
        return len(np.union1d(i0, np.minimum(i0 + 1, n - 1)))

    return taps(W, new_w) * taps(H, new_h) * 3


def detector_candidates(torch, yolo, model, frame, geom, spec, dtype):
    """The detector up to D2's input: the score-sorted candidates of the
    pipeline's "human" gate, as detect_frame_core makes them."""
    x = yolo.letterbox_input(frame, geom, dtype)
    boxes, scores = yolo.decode_detections(yolo.yolo_forward(model, x.permute(0, 2, 3, 1)),
                                           spec.nc)
    scores = torch.where(yolo._class_mask((0,), spec.nc, scores.device), scores[0], 0.0)
    conf, cls = torch.max(scores, -1)
    return yolo.nms_candidates(boxes[0], conf, cls.to(torch.int32), 0.25, 300)


def check_detector(torch, frame_np, seed, dev) -> dict:
    """D1 and D2 against their plain versions on the card, bit for bit, at
    YOLOv8n/320 and YOLOv8x/640, float32 and bf16, square and rect, on the
    1080p frame; the whole detect_frame_core against the same function with
    the plain D1 and D2; each kernel's device time, its plain version's and
    its bound; the detector's ms per frame."""
    from easy_vitpose_tpu_torch.detect import yolo

    H, W = frame_np.shape[:2]
    frame = torch.from_numpy(frame_np).to(dev)
    res, params = {}, {}
    for scale, imgsz in DET_CONFIGS:
        spec = yolo.YoloSpec(scale)
        params[scale] = yolo.init_yolo_params(seed, spec, frame_np, imgsz)
        for dtype in (torch.float32, torch.bfloat16):
            model = yolo.yolo_params_from_jax(params[scale], spec, dtype, dev)
            dt = "bf16" if dtype == torch.bfloat16 else "fp32"
            for rect in (False, True):
                key = f"{scale}{imgsz}_{dt}_{'rect' if rect else 'square'}"
                geom = yolo.letterbox_geometry(H, W, imgsz, rect=rect)
                x = yolo.letterbox_input(frame, geom, dtype)
                x_plain = yolo.letterbox_input_plain(frame, geom, dtype)
                check(torch.equal(x, x_plain), f"{key}: D1 is not its plain version's bits")
                cand = detector_candidates(torch, yolo, model, frame, geom, spec, dtype)
                r, _, _, left, top = geom[:5]
                got = yolo.nms_packed(*cand, 300, 0.7, left, top, r)
                got_plain = yolo.nms_packed_plain(*cand, 300, 0.7, left, top, r)
                check(torch.equal(got, got_plain), f"{key}: D2 is not its plain version's bits")
                core = lambda plain=False: yolo.detect_frame_core(  # noqa: E731
                    model, frame, geom, spec, imgsz, (0,), 0.25, 0.7, 300, dtype, plain=plain)
                packed = core()
                check(torch.equal(packed, core(True)),
                      f"{key}: detect_frame_core differs from its plain-D1/D2 twin")
                n_valid, n_kept = int((cand[1] > 0).sum()), int(packed[:, 6].sum())
                row = {"candidates": int(cand[0].shape[0]), "valid": n_valid, "kept": n_kept,
                       "ms_per_frame": time_ms(torch, core),
                       "d1_err": float((x.float() - x_plain.float()).abs().max()),
                       "d2_err": float((got - got_plain).abs().max())}
                if scale == "n" or not rect:
                    k = cand[0].shape[0]
                    row.update(
                        d1_ms=device_ms(torch, lambda: yolo.letterbox_input(frame, geom, dtype)),
                        d1_plain_ms=time_ms(torch, lambda: yolo.letterbox_input_plain(
                            frame, geom, dtype)),
                        d1_bound=bound(sampled_bytes(geom, H, W) + x.numel() * x.element_size(),
                                       {"f32": 30.0 * geom[5] * geom[6]}),
                        d2_ms=device_ms(torch, lambda: yolo.nms_packed(*cand, 300, 0.7, left,
                                                                       top, r)),
                        d2_plain_ms=time_ms(torch, lambda: yolo.nms_packed_plain(
                            *cand, 300, 0.7, left, top, r)),
                        d2_bound=bound(k * 24 + 300 * 28, {"f32": 14.0 * n_valid * (n_valid - 1) / 2}))
                res[key] = row
                print(f"detector {key}: {json.dumps(row)}")
    stacked = check_stacked_detector(torch, frame_np, params, dev)
    print("detector: D1 and D2 equal their plain versions bit for bit in every configuration; "
          "library_ms none: no torchvision on the card's host, and no single PyTorch call "
          "letterboxes or runs greedy NMS")
    return {"configs": res, "stacked": stacked, "params_n": params["n"], "params_x": params["x"]}


def stack_frames(frame_np, S: int, step: int = 240) -> np.ndarray:
    """S frames of one stack: the frame rolled right by ``step`` px each."""
    return np.stack([np.roll(frame_np, step * s, axis=1) for s in range(S)])


def stack_candidates(torch, yolo, model, frames, geom, spec, dtype):
    """detector_candidates for a stack: (S, k) score-sorted candidates."""
    x = yolo.letterbox_input(frames, geom, dtype)
    boxes, scores = yolo.decode_detections(yolo.yolo_forward(model, x.permute(0, 2, 3, 1)),
                                           spec.nc)
    scores = torch.where(yolo._class_mask((0,), spec.nc, scores.device), scores, 0.0)
    conf, cls = torch.max(scores, -1)
    return yolo.nms_candidates(boxes, conf, cls.to(torch.int32), 0.25, 300)


def check_stacked_detector(torch, frame_np, params, dev) -> dict:
    """D1 and D2 over an S-frame stack (one launch each) at YOLOv8n/320
    (square, bf16 and fp32) and YOLOv8x/640 (rect, bf16): bit for bit
    against their plain versions and against S single-frame launches, and
    detect_batch_core against its plain-D1/D2 twin; the stacked launches'
    device ms, plain ms and bounds."""
    from easy_vitpose_tpu_torch.detect import yolo

    H, W = frame_np.shape[:2]
    frames = torch.from_numpy(stack_frames(frame_np, STACK)).to(dev)
    res = {}
    for scale, imgsz, rect, dtype in (("n", 320, False, torch.bfloat16),
                                      ("n", 320, False, torch.float32),
                                      ("x", 640, True, torch.bfloat16)):
        spec = yolo.YoloSpec(scale)
        model = yolo.yolo_params_from_jax(params[scale], spec, dtype, dev)
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        key = f"{scale}{imgsz}_{dt}_{'rect' if rect else 'square'}_S{STACK}"
        geom = yolo.letterbox_geometry(H, W, imgsz, rect=rect)
        x = yolo.letterbox_input(frames, geom, dtype)
        check(torch.equal(x, yolo.letterbox_input_plain(frames, geom, dtype)),
              f"{key}: stacked D1 is not its plain version's bits")
        check(all(torch.equal(x[s:s + 1], yolo.letterbox_input(frames[s], geom, dtype))
                  for s in range(STACK)), f"{key}: stacked D1 differs from single-frame launches")
        cand = stack_candidates(torch, yolo, model, frames, geom, spec, dtype)
        r, _, _, left, top = geom[:5]
        got = yolo.nms_packed(*cand, 300, 0.7, left, top, r)
        check(torch.equal(got, yolo.nms_packed_plain(*cand, 300, 0.7, left, top, r)),
              f"{key}: stacked D2 is not its plain version's bits")
        check(all(torch.equal(got[s], yolo.nms_packed(cand[0][s], cand[1][s], cand[2][s], 300,
                                                      0.7, left, top, r))
                  for s in range(STACK)), f"{key}: stacked D2 differs from single-frame launches")
        core = lambda plain=False: yolo.detect_batch_core(  # noqa: E731
            model, frames, geom, spec, (0,), 0.25, 0.7, 300, dtype, plain=plain)
        packed = core()
        check(torch.equal(packed, core(True)),
              f"{key}: detect_batch_core differs from its plain-D1/D2 twin")
        valid = (cand[1] > 0).sum(1).tolist()
        row = {"valid_per_frame": valid, "kept_per_frame": packed[:, :, 6].sum(1).tolist()}
        if dtype == torch.bfloat16:
            k = cand[0].shape[1]
            row.update(
                d1_ms=device_ms(torch, lambda: yolo.letterbox_input(frames, geom, dtype)),
                d1_plain_ms=time_ms(torch, lambda: yolo.letterbox_input_plain(frames, geom, dtype)),
                d1_bound=bound(STACK * sampled_bytes(geom, H, W) + x.numel() * x.element_size(),
                               {"f32": 30.0 * geom[5] * geom[6] * STACK}),
                d1_err=float((x.float() - yolo.letterbox_input_plain(frames, geom, dtype)
                              .float()).abs().max()),
                d2_ms=device_ms(torch, lambda: yolo.nms_packed(*cand, 300, 0.7, left, top, r)),
                d2_plain_ms=time_ms(torch, lambda: yolo.nms_packed_plain(*cand, 300, 0.7, left,
                                                                         top, r)),
                d2_bound=bound(STACK * (k * 24 + 300 * 28),
                               {"f32": 14.0 * sum(n * (n - 1) / 2 for n in valid)}),
                d2_err=0.0, ms_per_stack=time_ms(torch, core))
        res[key] = row
        print(f"detector stacked {key}: {json.dumps(row)}")
    return res


def save_pose_npz(path: str, model) -> None:
    """A float32 ViTPose written as the JAX package's .npz (uncompressed:
    the format's reader takes both, and ViT-B's 344 MB compress slowly)."""
    from easy_vitpose_tpu_torch.convert.vitpose_torch import convert_vitpose_state_dict
    from easy_vitpose_tpu_torch.utils.checkpoint import flatten_params
    np.savez(path, **flatten_params(convert_vitpose_state_dict(model.state_dict(), model.cfg)))


@contextlib.contextmanager
def decode_spy(ps, seen: list):
    """Record the (heatmaps, geometry, mask) each pose step decodes, on the
    kernel path and the plain one."""
    real = ps.decode_keypoints, ps.decode_keypoints_plain

    def wrap(fn):
        def spy(heat, geo, mask, *a, **k):
            seen.append((heat, geo, mask))
            return fn(heat, geo, mask, *a, **k)
        return spy

    ps.decode_keypoints, ps.decode_keypoints_plain = wrap(real[0]), wrap(real[1])
    try:
        yield
    finally:
        ps.decode_keypoints, ps.decode_keypoints_plain = real


def syncs_in(torch, fn) -> int:
    """The host synchronisations ``fn`` makes: PyTorch's synchronisation
    check set to warn, its warnings counted."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing" in str(w.message) for w in caught)


@contextlib.contextmanager
def eager_graphs(det):
    """Run ``det``'s graphed programs eagerly (its cache's ``run`` calls the
    program), so a spy sees their pose steps; a replay's bits equal the
    eager program's, which run_vitinference and the CUDA tests check."""
    det.graphs.run = lambda key, fn, *inputs: fn(*inputs)
    try:
        yield
    finally:
        del det.graphs.run


def hold_step(torch, step, step_plain, dtype: str, what: str) -> tuple:
    """One pose step's decode inputs (heatmaps, geometry, mask) through the
    kernels against the plain path's: the same crop geometry and mask, the
    heatmaps within HEATMAP_TOL[dtype] of their range, and the keypoints
    the plain decode of their own heatmaps (scores bit for bit, coordinates
    within DECODE_TOL heatmap px).  Returns (heatmap error over the range,
    decode gap in px)."""
    from easy_vitpose_tpu_torch.ops import decode

    (hk, gk, mk), (hp, gp, mp) = step, step_plain
    check(torch.equal(gk, gp) and torch.equal(mk, mp), f"{what}: crop geometry differs")
    span = float(hp.float().max() - hp.float().min())
    err = float((hk.float() - hp.float()).abs().max())
    check(err <= HEATMAP_TOL[dtype] * span, f"{what}: heatmaps differ: {err} of {span}")
    kk = decode.decode_keypoints(hk, gk, mk)
    kp = decode.decode_keypoints_plain(hk, gk, mk)
    gap = decode_gap(torch, kk, kp, gk, *hk.shape[-2:])
    check(torch.equal(kk[..., 2], kp[..., 2]) and gap <= DECODE_TOL,
          f"{what}: keypoints are not the plain decode of their heatmaps")
    return err / span, gap


def hold_to_plain(torch, vi, vi_plain, frames, dtype: str) -> dict:
    """The same frames through the kernel path and the plain path on the
    card: detections bit for bit, the same IDs, the pose step's heatmaps
    within HEATMAP_TOL of their range, the same crop geometry, and the
    keypoints the plain decode of their own heatmaps (scores bit for bit,
    coordinates within DECODE_TOL heatmap px).  The kernel path's programs
    run eagerly here, so the spy sees its pose steps."""
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps

    worst = {"heatmap_rel_err": 0.0, "decode_gap_px": 0.0, "people": 0}
    for f in frames:
        got, ref = [], []
        with decode_spy(ps, got), eager_graphs(vi._detector):
            out = vi.inference(f)
        with decode_spy(ps, ref):
            out_p = vi_plain.inference(f)
        check(list(out) == list(out_p), f"{dtype}: IDs differ from the plain path")
        check(np.array_equal(vi._yolo_res, vi_plain._yolo_res),
              f"{dtype}: detections differ from the plain path")
        check(len(got) == len(ref), f"{dtype}: pose steps differ from the plain path")
        for step, step_plain in zip(got, ref):
            err, gap = hold_step(torch, step, step_plain, dtype, dtype)
            worst["heatmap_rel_err"] = max(worst["heatmap_rel_err"], err)
            worst["decode_gap_px"] = max(worst["decode_gap_px"], gap)
        for k in out:
            check(np.isfinite(out[k]).all() and out[k].shape == (17, 3), f"{dtype}: keypoints")
        worst["people"] += len(out)
    return worst


def run_vitinference(torch, model, frame_np, det, dev) -> dict:
    """The user's entry point at full width: VitInference(ViT-B npz,
    yolo=YOLOv8n npz, dtype int8, then bf16, then the default fp32, no
    dtype given) on the 1080p frame, image mode
    at steady state (after the slot high-water mark has risen) and video
    mode (SORT over VIDEO_FRAMES frames of the frame moving right 8 px a
    frame), each held to the plain path on the card; ms per frame, the
    host's ms to queue one, the device's busy share, launches and host
    synchronisations per frame.  Then the HTTP service and the package's
    top level (:func:`run_api`) on the same files."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.detect.yolo import letterbox_geometry
    from easy_vitpose_tpu_torch.pipeline.fused_detect import detect_pose
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    res, images = {}, {}
    video = [np.roll(frame_np, 8 * t, axis=1) for t in range(VIDEO_FRAMES)]
    with tempfile.TemporaryDirectory() as d:
        pose, det_path = os.path.join(d, "vitpose-b-coco.npz"), os.path.join(d, "yolov8n.npz")
        save_pose_npz(pose, model)
        yolo.save_yolo_npz(det_path, det["params_n"], "n")
        for dtype in ("int8", "bf16", "fp32"):
            # fp32 is the constructor's default: the frame a user gets without a dtype
            kw = {} if dtype == "fp32" else {"dtype": dtype}
            t0 = time.perf_counter()
            vi = VitInference(pose, yolo=det_path, model_name="b", **kw)
            load_s = time.perf_counter() - t0
            vi_plain = VitInference(pose, yolo=det_path, model_name="b", plain=True, **kw)
            check(vi.device.type == "cuda" and vi.single_dispatch, "VitInference not on the card")
            for _ in range(2):                      # the slot high-water mark rises
                vi.inference(frame_np)
                vi_plain.inference(frame_np)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = images[dtype] = vi.inference(frame_np)
            counts = kernels.launch_counts()
            block = "block_q8" if dtype == "int8" else "block"
            step = {"sampler": 1, block: 12, "decode": 1}
            if dtype == "fp32":
                step["gemm_tf32"] = 48        # the four 3xTF32 GEMMs of each block
            want = {"letterbox": 1, "nms": 1, **step}
            steps = VI_POSE_STEPS[dtype]
            want_frame = {k: n * (steps if k in step else 1) for k, n in want.items()}
            print(f"vitinference {dtype} image: launches per frame {counts}, people {len(out)}, "
                  f"pose steps {steps}")
            check(counts == want_frame,
                  f"{dtype} image frame launched {counts}, expected {want_frame}")
            syncs = syncs_in(torch, lambda: vi.inference(frame_np))
            check(syncs == steps, f"{dtype} image frame made {syncs} host syncs, expected {steps}")
            # the frame's queue of launches under the check set to raise:
            # eagerly, and as the graph replay that inference() makes
            d_ = vi._detector
            geom = letterbox_geometry(*frame_np.shape[:2], d_.imgsz, rect=d_.rect)
            slots = vi._slots_highwater
            frame_dev = vi._upload(frame_np)
            key = ("detect_pose", tuple(frame_dev.shape), slots, vi._gate())
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                t0 = time.perf_counter()
                packed, kpts = detect_pose(d_.model, vi._model, frame_dev, geom, d_.spec,
                                           d_.imgsz, d_.classes, d_.conf, d_.iou, d_.max_det,
                                           d_.dtype, slots, vi._gate())
                eager_queue_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay = d_.graphs.run(key, None, frame_dev)
            queue_ms = (time.perf_counter() - t0) * 1e3
            check(torch.equal(replay[0], packed) and torch.equal(replay[1], kpts),
                  f"{dtype} image frame: the graph replay differs from the eager detect_pose")
            check(d_.graphs.launches(key) == want,
                  f"{dtype} image frame graph launches {d_.graphs.launches(key)}, expected {want}")
            print(f"vitinference {dtype} image: graph replay equals eager detect_pose bit for bit; "
                  f"{len(d_.graphs)} graphs captured")
            held = hold_to_plain(torch, vi, vi_plain, [frame_np], dtype)

            def frames(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    vi.inference(frame_np)
                return (time.perf_counter() - t0) * 1e3 / n

            ms = statistics.median(frames(VI_FRAMES) for _ in range(3))
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                wall = frames(5)
            from torch.autograd import DeviceType
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3 / 5
            row = {"ms_per_frame": ms, "host_queue_ms": queue_ms,
                   "eager_host_queue_ms": eager_queue_ms, "device_ms_per_frame": busy,
                   "profiled_ms_per_frame": wall, "device_busy_share": busy / ms,
                   "slots": slots, "people": len(out), "pose_steps_per_frame": steps,
                   "launches_per_frame": counts,
                   "host_syncs_per_frame": syncs, "load_s": load_s, **held}
            print(f"vitinference {dtype} image: {json.dumps(row)}")
            res[f"{dtype}_image"] = row
            if dtype != "int8":
                continue
            # video mode: SORT, detect -> fetch -> track -> pose on the tracker's boxes
            vv = VitInference(pose, yolo=det_path, model_name="b", dtype=dtype, is_video=True)
            vv_plain = VitInference(pose, yolo=det_path, model_name="b", dtype=dtype,
                                    is_video=True, plain=True)
            held = hold_to_plain(torch, vv, vv_plain, video, dtype)
            vv.reset()
            ids = set()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            for f in video:
                ids |= set(vv.inference(f))
            ms = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
            counts = {k: v / VIDEO_FRAMES for k, v in kernels.launch_counts().items()}
            syncs = syncs_in(torch, lambda: vv.inference(video[0]))
            vv.reset()
            busy_ms, busy = busy_share(torch, lambda: [vv.inference(f) for f in video],
                                       len(video))
            row = {"ms_per_frame": ms, "frames": VIDEO_FRAMES, "track_ids": len(ids),
                   "launches_per_frame": counts, "host_syncs_per_frame": syncs,
                   "host_queue_ms": detect_queue_ms(torch, vv, video[0]),
                   "device_ms_per_frame": busy_ms, "device_busy_share": busy, **held}
            print(f"vitinference {dtype} video: {json.dumps(row)}")
            check(len(ids) > 0, "video mode tracked nobody")
            res[f"{dtype}_video"] = row
            mk = lambda **kw: VitInference(pose, yolo=det_path, model_name="b",  # noqa: E731
                                           dtype=dtype, is_video=True, **kw)
            res[f"{dtype}_pipelined"] = run_pipelined(torch, vv, mk(), video)
            res[f"{dtype}_batched"] = run_batched(torch, mk(), mk(), video[:BATCH_WINDOW], dtype)
            res["fused_divergence"] = fused_divergence(torch, mk(), mk(single_dispatch=True),
                                                        video)
        http = run_serve_http(torch, pose, det_path, frame_np)
        api = run_api(torch, pose, det_path, frame_np, images["int8"],
                      res["int8_image"]["launches_per_frame"])
    return res, http, api


API_FRAMES = 5               # timed int8 image frames of the api phase
CONSOLE_PREFIX = "vitpose-torch-"


def console_entries() -> dict:
    """The port's console scripts in pyproject.toml: name -> (module, attr)."""
    import tomllib
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pyproject.toml"),
              "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {k: tuple(v.split(":")) for k, v in scripts.items() if k.startswith(CONSOLE_PREFIX)}


def check_console_entries() -> dict:
    """Each ``vitpose-torch-*`` entry resolves to a callable, and ``python -m
    <module> --help`` exits 0 for each (all at once, each bounded)."""
    import importlib
    entries = console_entries()
    check(len(entries) == 8, f"pyproject.toml names {sorted(entries)}")
    for name, (mod, attr) in entries.items():
        check(callable(getattr(importlib.import_module(mod), attr, None)),
              f"{name}: {mod}:{attr} is not a callable")
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen([sys.executable, "-m", mod, "--help"], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (mod, _) in entries.items()}
    rcs, failed = {}, {}
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=120)
            rcs[name] = p.returncode
            if p.returncode != 0:
                failed[name] = out[-2000:]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
    check(not failed, f"console entries' --help failed: {failed}")
    return {name: f"{mod}:{attr}" for name, (mod, attr) in entries.items()} | {"help_rcs": rcs}


def run_api(torch, pose, det_path, frame_np, want, want_counts) -> dict:
    """The package's top level as a user meets it: ``from
    easy_vitpose_tpu_torch import VitInference, __version__`` (the class of
    ``pipeline/inference.py``) on the vitinference phase's ViT-B int8 +
    YOLOv8n/320 files and 1080p frame: after the same two warm-up frames,
    a frame's keypoints bit for bit that phase's and its launches the same;
    API_FRAMES frames (each ``inference`` call, its fetch included) in a
    ``StageTimer``, whose report is printed; one frame under
    ``device_trace`` (a trace.json with CUDA kernels in it); the logger of
    ``get_logger`` at rank 0; the console entries
    (:func:`check_console_entries`)."""
    import tempfile
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch import VitInference, __version__
    from easy_vitpose_tpu_torch.pipeline import inference
    from easy_vitpose_tpu_torch.utils.logging import get_logger, print_log
    from easy_vitpose_tpu_torch.utils.profiling import StageTimer, device_trace

    check(VitInference is inference.VitInference, "the top-level VitInference is another class")
    timer = StageTimer()
    with timer.stage("load"):
        vi = VitInference(pose, yolo=det_path, model_name="b", dtype="int8")
    for _ in range(2):                      # the slot high-water mark rises, as there
        vi.inference(frame_np)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with timer.stage("inference"):
        out = vi.inference(frame_np)
    counts = kernels.launch_counts()
    check(counts == want_counts, f"api frame launched {counts}, the vitinference phase "
                                 f"{want_counts}")
    check(list(out) == list(want) and all(np.array_equal(out[k], want[k]) for k in want),
          "the top-level VitInference's keypoints differ from the vitinference phase's")
    for _ in range(API_FRAMES - 1):
        with timer.stage("inference"):
            vi.inference(frame_np)
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d):
            vi.inference(frame_np)
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f).get("traceEvents", [])
    traced = sum(e.get("cat") == "kernel" for e in events)
    check(traced > 0, "device_trace recorded no CUDA kernel")
    logger = get_logger()
    print("api: StageTimer\n" + timer.report())
    print_log(f"api: VitInference {__version__} on {vi.device}, people {len(out)}", logger)
    res = {"version": __version__, "class": f"{VitInference.__module__}.{VitInference.__name__}",
           "people": len(out), "keypoints_bit_equal": True, "launches_per_frame": counts,
           "stage_timer": timer.summary(), "trace_kernel_events": traced,
           "logger": {"name": logger.name, "level": logging.getLevelName(logger.level)},
           "console_entries": check_console_entries()}
    check(res["logger"]["level"] == "INFO", f"rank 0's logger: {res['logger']}")
    print(f"api: {json.dumps(res)}")
    return res


def busy_share(torch, run, n: int) -> tuple:
    """(device ms per unit, the device's busy share) of ``run()`` over its n
    units, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy / n, busy / wall


def detect_queue_ms(torch, vi, frame) -> float:
    """The host's ms to queue a video frame's first program: the upload and
    the detector's graph replay, without the fetch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vi._detector.detect_async(vi._upload(frame))
    ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return ms


def same_results(a, b) -> bool:
    """Two per-frame results: the same IDs and bit-equal keypoints."""
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def run_pipelined(torch, vv, vp, video) -> dict:
    """inference_pipelined over the video against the sync path one frame
    late (the same programs, so the same bits), and its ms per frame."""
    vv.reset()
    seq = [vv.inference(f) for f in video]
    got = [vp.inference_pipelined(f) for f in video]
    check(got[0] is None, "the first pipelined frame returned results")
    got = got[1:] + [vp.flush()]
    check(all(same_results(a, b) for a, b in zip(seq, got)),
          "pipelined results differ from the sync path's one frame late")
    vp.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in video:
        vp.inference_pipelined(f)
    vp.flush()
    ms = (time.perf_counter() - t0) * 1e3 / len(video)
    vv.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in video:
        vv.inference(f)
    sync_ms = (time.perf_counter() - t0) * 1e3 / len(video)
    vp.reset()
    busy_ms, busy = busy_share(torch, lambda: [vp.inference_pipelined(f) for f in video]
                               + [vp.flush()], len(video))
    row = {"ms_per_frame": ms, "sync_ms_per_frame": sync_ms, "frames": len(video),
           "host_queue_ms": detect_queue_ms(torch, vp, video[0]),
           "device_ms_per_frame": busy_ms, "device_busy_share": busy,
           "equal_to_sync_one_frame_late": True}
    print(f"vitinference pipelined: {json.dumps(row)}")
    return row


def run_batched(torch, vb, vs, window, dtype: str) -> dict:
    """inference_batched over a window against per-frame inference on the
    same detections (the window's batched detector rows, fed to the
    per-frame path as boxes): the same IDs on every frame, each box's
    heatmaps within HEATMAP_TOL of the per-frame step's; how many frames'
    batched detections are the single-frame detector's bits (cuDNN's bf16
    convolutions at batch 16 and at batch 1 may round apart); ms per frame
    of the window."""
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    hb, hs, packed = [], [], []
    with decode_spy(ps, hb), unpack_spy(vb._detector, packed):
        outs = vb.inference_batched(window)
    H, W = window[0].shape[:2]
    dets = vb._detector.unpack_batch(packed[0], (H, W))
    with decode_spy(ps, hs):
        seq = [vs.inference(f, bboxes=vs._filter_dets(r)) for f, r in zip(window, dets)]
    check(all(list(a) == list(b) for a, b in zip(outs, seq)),
          "batched window IDs differ from per-frame inference on the same detections")
    n = sum(len(o) for o in outs)
    check(len(hb) == 1 and n > 0, "the batched window did not pose in one step")
    heat_b, geo_b, _ = hb[0]
    posed = [o for o in seq if o]
    heat_s = torch.cat([h[:len(o)] for (h, _, _), o in zip(hs, posed)])
    geo_s = torch.cat([g[:len(o)] for (_, g, _), o in zip(hs, posed)])
    check(torch.equal(geo_b[:n], geo_s), "batched window crop geometry differs")
    span = float(heat_s.float().max() - heat_s.float().min())
    err = float((heat_b[:n].float() - heat_s.float()).abs().max())
    check(err <= HEATMAP_TOL[dtype] * span,
          f"batched window heatmaps differ from per-frame ones: {err} of {span}")
    single = [vs._detector(f) for f in window]
    same_dets = sum(np.array_equal(a, b) for a, b in zip(dets, single))
    gaps = [float(np.abs(a[:, 4] - b[:, 4]).max()) for a, b in zip(dets, single)
            if a.shape == b.shape and len(a)]
    score_gap = max(gaps) if gaps else None
    vb.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vb.inference_batched(window)
    ms = (time.perf_counter() - t0) * 1e3 / len(window)
    vb.reset()
    busy_ms, busy = busy_share(torch, lambda: vb.inference_batched(window), len(window))
    # the host's ms to queue the window's first program (upload, batched detector)
    stack = np.stack(window)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vb._detector.detect_batch_async(vb._upload(stack))
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    row = {"ms_per_frame": ms, "frames": len(window), "people": n,
           "host_queue_ms_per_window": queue_ms, "device_ms_per_frame": busy_ms,
           "device_busy_share": busy,
           "heatmap_rel_err": err / span, "ids_equal": True,
           "frames_with_single_frame_detections": same_dets, "detector_score_gap": score_gap}
    print(f"vitinference batched: {json.dumps(row)}")
    return row


def divergence(pairs) -> dict:
    """Keypoint distances in px between pairs of (K, 3) results."""
    d = np.concatenate([np.abs(a[:, :2] - b[:, :2]).max(-1) for a, b in pairs]) \
        if pairs else np.zeros(0)
    return {"people": len(pairs),
            "median_px": float(np.median(d)) if len(d) else 0.0,
            "p95_px": float(np.percentile(d, 95)) if len(d) else 0.0,
            "max_px": float(d.max()) if len(d) else 0.0,
            "within_2px_share": float((d <= 2).mean()) if len(d) else 0.0}


def fused_divergence(torch, vt, vf, video) -> dict:
    """The fused tick's keypoint divergence in video mode: single dispatch
    (pose on the raw detection boxes) against the two-program path (pose on
    the tracker's Kalman boxes), the same IDs on every frame."""
    pairs = []
    for f in video:
        a, b = vt.inference(f), vf.inference(f)
        check(set(a) == set(b), "single dispatch IDs differ from the two-program path's")
        pairs += [(a[k], b[k]) for k in a]
    row = divergence(pairs)
    print(f"vitinference fused_divergence: {json.dumps(row)}")
    return row


MS_TICKS = 6                  # ticks of each multi-stream mode after its warm-up
# ROADMAP C18: the largest absolute gap of YOLOv8x/640 rect bf16's raw outputs
# (largest value 16.9-18.6) at batch 1, 4 or 8 against one batch of 8: twice
# the largest measured on the card, 1.09375 at batch 4 (PERF.md)
DETECTOR_BATCH_GAP = 2 * 1.09375


@contextlib.contextmanager
def unpack_spy(det, seen: list):
    """Record the packed rows each fetch of ``det``'s batched detections
    unpacks (the two-program and the fused ticks both fetch through it)."""
    real = det.unpack_batch

    def spy(packed, frame_hw):
        seen.append(np.array(packed))
        return real(packed, frame_hw)

    det.unpack_batch = spy
    try:
        yield
    finally:
        del det.unpack_batch


def ms_ticks(frame_np, n: int, t0: int = 0) -> list:
    """n ticks of STACK streams: stream s shows the frame rolled by 240 s px,
    moving 8 px a tick."""
    return [[np.roll(frame_np, 240 * s + 8 * t, axis=1) for s in range(STACK)]
            for t in range(t0, t0 + n)]


def hold_tick_to_plain(torch, ms, ms_plain, frames, what: str) -> dict:
    """One two-program tick through the kernels and through the plain path:
    detections bit for bit, the same IDs, the pose step's heatmaps within
    HEATMAP_TOL of their range, keypoints the plain decode of their own
    heatmaps."""
    from easy_vitpose_tpu_torch.ops import decode
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    got, ref, pk, pp = [], [], [], []
    with decode_spy(ps, got), unpack_spy(ms.detector, pk):
        out = ms.step(frames)
    with decode_spy(ps, ref), unpack_spy(ms_plain.detector, pp):
        out_p = ms_plain.step(frames)
    check(len(pk) == len(pp) and all(np.array_equal(a, b) for a, b in zip(pk, pp)),
          f"{what}: detections differ from the plain path")
    check([list(r) for r in out] == [list(r) for r in out_p], f"{what}: IDs differ from plain")
    worst = {"heatmap_rel_err": 0.0, "decode_gap_px": 0.0}
    for (hk, gk, mk), (hp, gp, mp) in zip(got, ref):
        check(torch.equal(gk, gp) and torch.equal(mk, mp), f"{what}: crop geometry differs")
        span = float(hp.float().max() - hp.float().min())
        err = float((hk.float() - hp.float()).abs().max())
        check(err <= DEEP_HEATMAP_TOL * span, f"{what}: heatmaps differ: {err} of {span}")
        kk, kp = decode.decode_keypoints(hk, gk, mk), decode.decode_keypoints_plain(hk, gk, mk)
        gap = decode_gap(torch, kk, kp, gk, *hk.shape[-2:])
        check(torch.equal(kk[..., 2], kp[..., 2]) and gap <= DECODE_TOL,
              f"{what}: keypoints are not the plain decode of their heatmaps")
        worst["heatmap_rel_err"] = max(worst["heatmap_rel_err"], err / span)
        worst["decode_gap_px"] = max(worst["decode_gap_px"], gap)
    return worst


def hold_fused_to_plain(torch, msf, det_plain, model, frames, slots: int) -> dict:
    """The fused tick's program: its graph replay equal to the eager program
    bit for bit, the eager program against the plain one (detections bit
    for bit, heatmaps within HEATMAP_TOL, keypoints the plain decode of
    their own heatmaps)."""
    from easy_vitpose_tpu_torch.ops import decode
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.fused_detect import detect_pose_multi
    det = msf.detector
    (dev_frames,) = msf._upload(frames)           # one block: the unsharded tick
    geom = det.geometry(tuple(dev_frames.shape[1:3]))
    key = ("detect_pose_multi", tuple(dev_frames.shape), slots, float(msf._det_gate))
    replay = det.graphs.run(key, None, dev_frames)
    got, ref = [], []
    with decode_spy(ps, got):
        eager = detect_pose_multi(det.model, model, dev_frames, geom, det.spec, det.classes,
                                  det.conf, det.iou, det.max_det, det.dtype, slots, 0.35)
    with decode_spy(ps, ref):
        plain = detect_pose_multi(det_plain.model, model, dev_frames, geom, det.spec,
                                  det.classes, det.conf, det.iou, det.max_det, det.dtype, slots,
                                  0.35, plain=True)
    check(torch.equal(replay[0], eager[0]) and torch.equal(replay[1], eager[1]),
          "the fused multi-stream graph replay differs from the eager program")
    check(torch.equal(eager[0], plain[0]), "fused tick detections differ from the plain path")
    (hk, gk, mk), (hp, gp, mp) = got[0], ref[0]
    check(torch.equal(gk, gp) and torch.equal(mk, mp), "fused tick crop geometry differs")
    span = float(hp.float().max() - hp.float().min())
    err = float((hk.float() - hp.float()).abs().max())
    check(err <= DEEP_HEATMAP_TOL * span, f"fused tick heatmaps differ: {err} of {span}")
    kp = decode.decode_keypoints_plain(hk, gk, mk)
    gap = decode_gap(torch, eager[1], kp, gk, *hk.shape[-2:])
    check(torch.equal(eager[1][..., 2], kp[..., 2]) and gap <= DECODE_TOL,
          "fused tick keypoints are not the plain decode of their heatmaps")
    return {"heatmap_rel_err": err / span, "decode_gap_px": gap,
            "launches_per_replay": det.graphs.launches(key)}


def time_ticks(torch, ms, ticks, pipelined: bool) -> dict:
    """ms per tick, the host's ms to queue a tick, launches and host syncs
    per tick, the device's busy share (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from easy_vitpose_tpu_torch import kernels

    def run(seq):
        out = [ms.step_pipelined(f) if pipelined else ms.step(f) for f in seq]
        if pipelined:
            out.append(ms.flush())
        return out

    run(ticks[:2])                                   # warm-up: kernels, graphs
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run(ticks)
    wall = (time.perf_counter() - t0) * 1e3 / len(ticks)
    launches = {k: v / len(ticks) for k, v in kernels.launch_counts().items()}
    syncs = syncs_in(torch, lambda: run(ticks[:2])) / 2
    # the host's time to queue one tick's device work: the upload and the
    # programs of a detection tick, without its fetches
    torch.cuda.synchronize()
    frames = ms._upload(ticks[0])
    t0 = time.perf_counter()
    if ms.single_dispatch:
        ms._dispatch_fused(frames)
    else:
        ms._dispatch_detect(frames)
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(ticks[:3])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / 3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / 3
    return {"ms_per_tick": wall, "stream_frames_per_s": STACK * 1e3 / wall,
            "host_dispatch_ms": queue_ms, "device_ms_per_tick": busy,
            "device_busy_share": busy / prof_ms, "launches_per_tick": launches,
            "host_syncs_per_tick": syncs}


def run_multistream(torch, frame_np, params_x, seed, dev) -> dict:
    """BASELINE.json config 5 at full width: ViT-H int8 + YOLOv8x/640 rect
    at bf16 over STACK 1080p streams, max_people_per_stream 8 (64 pose
    slots); two-program and single-dispatch ticks, each sync and pipelined;
    every tick held to plain=True; single-dispatch IDs equal to the
    two-program path's; pipelined results equal to sync ones a tick late;
    ms per tick, stream-frames/s, host ms, busy share, launches and syncs
    per tick, peak memory, the fused tick's keypoint divergence."""
    import tempfile
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.stream import MultiStreamPose

    t0 = time.perf_counter()
    model = serving_copy(init_params(get_model_config("coco", "h"), seed).to(dev), "int8")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "yolov8x.npz")
        yolo.save_yolo_npz(path, params_x, "x")
        kw = dict(imgsz=640, classes=(0,), conf=0.25, dtype=torch.bfloat16, rect=True)
        det = yolo.YoloDetector(path, **kw)
        det_plain = yolo.YoloDetector(path, plain=True, **kw)
        det_f = yolo.YoloDetector(path, **kw)
    load_s = time.perf_counter() - t0
    slots = 8

    def mk(detector, **k):
        return MultiStreamPose(model, detector=detector, n_streams=STACK,
                               max_people_per_stream=slots, **k)

    ticks = ms_ticks(frame_np, MS_TICKS)
    res = {"load_s": load_s}
    # two-program ticks against the plain path; single dispatch's IDs
    ms, ms_plain = mk(det), mk(det_plain, plain=True)
    msf = mk(det_f, single_dispatch=True)
    held = {"heatmap_rel_err": 0.0, "decode_gap_px": 0.0}
    pairs, people = [], 0
    for t, frames in enumerate(ticks):
        w = hold_tick_to_plain(torch, ms, ms_plain, frames, f"multistream tick {t}")
        held = {k: max(held[k], w[k]) for k in held}
    res["held_to_plain"] = held
    # the same ticks through a fresh two-program and a single-dispatch instance
    ref, fus = mk(det), msf
    for frames in ticks:
        a, b = ref.step(frames), fus.step(frames)
        check([set(r) for r in a] == [set(r) for r in b],
              "single-dispatch IDs differ from the two-program path's")
        for ra, rb in zip(a, b):
            pairs += [(ra[k], rb[k]) for k in ra]
            people += len(ra)
    check(people > 0, "multi-stream ticks found nobody")
    res["fused_divergence"] = divergence(pairs)
    res["fused_held_to_plain"] = hold_fused_to_plain(torch, msf, det_plain, model, ticks[0], slots)
    # pipelined ticks equal sync ticks one tick late, both kinds
    for name, k in (("two_program", {}), ("single_dispatch", {"single_dispatch": True})):
        sync, pipe = mk(det, **k), mk(det_f if k else det, **k)
        want = [sync.step(f) for f in ticks]
        got = [pipe.step_pipelined(f) for f in ticks]
        check(got[0] is None, f"{name}: the first pipelined tick returned results")
        got = got[1:] + [pipe.flush()]
        for a, b in zip(want, got):
            check(all(same_results(x, y) for x, y in zip(a, b)),
                  f"{name}: pipelined results differ from sync ones a tick late")
    res["sharded"] = check_sharded_ticks(torch, model, det, det_f, ticks, slots, dev)
    # timing of each mode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = ms_ticks(frame_np, MS_TICKS, MS_TICKS)
    for name, k in (("two_program", {}), ("single_dispatch", {"single_dispatch": True})):
        for pipelined in (False, True):
            row = time_ticks(torch, mk(det_f if k else det, **k), timed, pipelined)
            res[f"{name}_{'pipelined' if pipelined else 'sync'}"] = row
            print(f"multistream {name} {'pipelined' if pipelined else 'sync'}: {json.dumps(row)}")
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["people_per_tick"] = people / len(ticks)
    res["graphs"] = len(det.graphs) + len(det_f.graphs)
    print(f"multistream: fused divergence {json.dumps(res['fused_divergence'])}, held "
          f"{json.dumps(held)}, peak {res['peak_memory_gib']:.2f} GiB")
    return res


def check_sharded_ticks(torch, model, det, det_f, ticks, slots: int, dev) -> dict:
    """(c) Stream-parallel ticks (``MultiStreamPose(mesh=)``) over a
    ``batch`` mesh whose two entries name the one card, a block of STACK / 2
    streams each.  Every sharded tick, two-program and single-dispatch, is
    bit for bit the ticks of two unsharded STACK / 2-stream instances, one
    per block (the same programs at the blocks' shapes), and launches what
    the two launch (a fused tick's coast rows ride one fallback pose step
    for all blocks, where each block alone runs its own).  With the boxes
    given (the unsharded STACK-stream
    detector's), the sharded pose tick is bit for bit the unsharded
    STACK-stream tick, each kernel launched twice: the pose step is
    batch-invariant.  The detector is not: cuDNN's bf16 convolutions of
    YOLO round differently at batch STACK / 2 than at STACK, so a detection
    tick's sharded and unsharded detections may differ; the raw outputs'
    gaps at batches 1, STACK / 2 and STACK (:func:`detector_batch_gaps`)
    are held to DETECTOR_BATCH_GAP."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.parallel.mesh import make_mesh
    from easy_vitpose_tpu_torch.pipeline.stream import MultiStreamPose

    mesh = make_mesh(axis="batch", devices=[dev, dev])
    half = STACK // 2

    def mk(detector, n=STACK, **k):
        return MultiStreamPose(model, detector=detector, n_streams=n,
                               max_people_per_stream=slots, **k)

    def tick(ms, *a):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        r = ms.step(*a)
        torch.cuda.synchronize()
        return r, kernels.launch_counts()

    out = {"mesh": [str(d) for d in mesh.devices]}
    for name, k in (("two_program", {}), ("single_dispatch", {"single_dispatch": True})):
        d = det_f if k else det
        sharded, blocks = mk(d, mesh=mesh, **k), [mk(d, half, **k) for _ in range(2)]
        for t, frames in enumerate(ticks):
            r, counts = tick(sharded, frames)
            want, want_counts = [], {}
            for i, b in enumerate(blocks):
                rb, cb = tick(b, frames[i * half:(i + 1) * half])
                want += rb
                add_counts(want_counts, cb)
            check(all(same_results(x, y) for x, y in zip(want, r)),
                  f"sharded {name} tick {t}: results differ from its blocks' unsharded ticks")
            if k:   # the coast rows of every block ride one fallback pose step, as JAX's
                fallbacks = want_counts.get("sampler", 0) - 2
                expect = {**want_counts, "sampler": 2 + min(fallbacks, 1)}
                for n in ("block_q8", "decode"):
                    expect[n] = want_counts[n] // want_counts["sampler"] * expect["sampler"]
            else:
                expect = want_counts
            check(counts == expect,
                  f"sharded {name} tick {t}: launched {counts}, its blocks {want_counts}")
        out[name] = {"bit_equal_to_blocks": True, "launches_per_tick": counts}
    # the pose tick with the boxes given: the unsharded STACK-stream tick's bits
    ref, sharded = mk(det), mk(det, mesh=mesh)
    for t, frames in enumerate(ticks):
        stack = torch.from_numpy(np.stack(frames)).to(dev)
        boxes = ref._boxes_from_detect(det.detect_batch_async(stack), tuple(stack.shape[1:3]))
        (a, ca), (b, cb) = tick(ref, frames, boxes), tick(sharded, frames, boxes)
        check(all(same_results(x, y) for x, y in zip(a, b)),
              f"sharded pose tick {t} with boxes given: results differ from the unsharded tick")
        check(cb == {n: 2 * c for n, c in ca.items()},
              f"sharded pose tick {t}: launched {cb}, unsharded {ca}")
    out["boxes_given"] = {"bit_equal": True, "launches_per_tick": cb}
    out["detector_batch_gaps"] = gaps = detector_batch_gaps(torch, det, stack)
    check(max(gaps["default"].values()) <= DETECTOR_BATCH_GAP,
          f"the detector's raw outputs by batch differ beyond {DETECTOR_BATCH_GAP}: {gaps}")
    print(f"multistream sharded: {json.dumps(out)}")
    return out


def detector_batch_gaps(torch, det, stack) -> dict:
    """ROADMAP C18: the largest absolute gap of YOLO's raw outputs on the
    frames of ``stack`` run in batches of 1, STACK / 2 and STACK against one
    batch of STACK (the last a second run of the same batch), with cuDNN's
    default algorithms and, as a record, with its deterministic ones (for
    this measurement only; the serving path keeps the default)."""
    from easy_vitpose_tpu_torch.detect import yolo

    x = yolo.letterbox_input(stack, det.geometry(tuple(stack.shape[1:3])), det.dtype)
    x = x.permute(0, 2, 3, 1)

    def in_batches(b):
        outs = [yolo.yolo_forward(det.model, x[i:i + b]) for i in range(0, len(x), b)]
        return [torch.cat(p) for p in zip(*outs)]

    res, before = {}, torch.backends.cudnn.deterministic
    try:
        for mode, deterministic in (("default", False), ("deterministic", True)):
            torch.backends.cudnn.deterministic = deterministic
            with torch.no_grad():
                whole = in_batches(len(x))
                res[mode] = {f"batch_{b}": max(float((a.float() - w.float()).abs().max())
                                               for a, w in zip(in_batches(b), whole))
                             for b in (1, len(x) // 2, len(x))}
    finally:
        torch.backends.cudnn.deterministic = before
    res["output_max_abs"] = max(float(w.float().abs().max()) for w in whole)
    return res


def run_serve_http(torch, pose, det_path, frame_np) -> dict:
    """cli/serve_http.py's PoseService (what the handler calls) on ViT-B int8
    + YOLOv8n/320, without and with its micro-batcher: requests with boxes
    and with the detector's own, on the 1080p frame and on a smaller frame
    that _bucket_pad pads.  Each single answer equals a direct VitInference
    call on the same padded image; each micro-batched answer with boxes has
    its boxes' heatmaps within HEATMAP_TOL of the single path's (rows matched
    by crop geometry), and with the detector the same people as the single
    path; ms per request, single and micro-batched (concurrent pairs)."""
    import threading
    from types import SimpleNamespace
    from easy_vitpose_tpu_torch.cli import serve_http
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    args = SimpleNamespace(model=pose, yolo=det_path, model_name="b", dataset=None,
                           yolo_size=320, dtype="int8", fixed_slots=16, batch_window_ms=0,
                           batch_max_frames=8, device=None)
    small = np.ascontiguousarray(frame_np[:433, :577])
    imgs = [np.roll(frame_np, 16 * i, axis=1) for i in range(4)] + [small, np.roll(small, 9, 1)]
    base = np.array([[300, 200, 700, 1000, 0.9], [900, 150, 1300, 900, 0.8],
                     [100, 50, 300, 400, 0.7]], np.float32)
    # boxes inside each frame, unique per request (its crops are found in a
    # micro-batch by their geometry)
    boxes = [base * np.float32([1, 1, 1, 1, 1] if i < 4 else [.4, .4, .4, .4, 1])
             + np.float32([4 * i, 2 * i, 4 * i, 2 * i, 0]) for i in range(len(imgs))]
    svc = serve_http.PoseService(args)
    svc.warmup([(1080, 1920), (433, 577)])
    direct = VitInference(pose, yolo=det_path, model_name="b", dtype="int8", fixed_slots=16)
    answered, single_ms, heat_single, people_single = 0, [], {}, {}
    for i, img in enumerate(imgs):
        for with_boxes in (True, False):
            bx = boxes[i] if with_boxes else None
            seen = []
            with decode_spy(ps, seen):
                t0 = time.perf_counter()
                out = svc.pose(img, bx)
                single_ms.append(((time.perf_counter() - t0) * 1e3, img.shape[0]))
            ref = direct.inference(serve_http._bucket_pad(img), bboxes=bx)
            direct.reset()
            check(list(out["keypoints"]) == list(ref) and all(
                np.array_equal(out["keypoints"][k], ref[k]) for k in ref),
                f"serve_http request {i}: differs from a direct VitInference call")
            if with_boxes:
                heat_single[i] = (seen[0][0][:len(bx)], seen[0][1][:len(bx)])
            else:
                people_single[i] = len(out["keypoints"])
            answered += 1
    svc_b = serve_http.PoseService(SimpleNamespace(**{**vars(args), "batch_window_ms": 5.0}))
    try:
        svc_b.warmup([(1080, 1920), (433, 577)])
        worst, batched_ms, frames_seen = 0.0, [], []
        for with_boxes in (True, False):
            for i in range(0, len(imgs), 2):
                outs, seen = [None, None], []

                def go(j):
                    t = time.perf_counter()
                    outs[j] = svc_b.pose(imgs[i + j], boxes[i + j] if with_boxes else None)
                    batched_ms.append((time.perf_counter() - t) * 1e3)

                with decode_spy(ps, seen):
                    th = [threading.Thread(target=go, args=(j,)) for j in range(2)]
                    for t in th:
                        t.start()
                    for t in th:
                        t.join(timeout=300)
                        check(not t.is_alive(), "a micro-batched request did not finish")
                for j, out in enumerate(outs):
                    frames_seen.append(out["batched_frames"])
                    answered += 1
                    if not with_boxes:
                        check(len(out["keypoints"]) == people_single[i + j],
                              "a micro-batched detector request posed other people")
                        continue
                    check(list(out["keypoints"]) == list(range(len(boxes[i + j]))),
                          "a micro-batched answer has other people than its boxes")
                    ref_h, ref_g = heat_single[i + j]
                    span = float(ref_h.float().max() - ref_h.float().min())
                    for r in range(len(ref_g)):
                        rows = [(h, k) for h, g, _ in seen for k in range(g.shape[0])
                                if torch.equal(g[k], ref_g[r])]
                        check(len(rows) == 1, "a micro-batched crop is not in the batch once")
                        h, k = rows[0]
                        err = float((h[k].float() - ref_h[r].float()).abs().max())
                        worst = max(worst, err / span)
        check(worst <= HEATMAP_TOL["int8"],
              f"micro-batched heatmaps differ from the single path's: {worst}")
    finally:
        svc_b.close()
    check(answered >= 20, f"serve_http answered {answered} requests")
    row = {"requests": answered,
           "single_ms_per_request_1080p": statistics.median(
               ms for ms, h in single_ms if h == FRAME_HW[0]),
           "single_ms_per_request_433x577": statistics.median(
               ms for ms, h in single_ms if h != FRAME_HW[0]),
           "batched_ms_per_request": statistics.median(batched_ms),
           "batched_frames_seen": sorted(set(frames_seen)),
           "batched_heatmap_rel_err": worst}
    print(f"serve_http: {json.dumps(row)}")
    return row


# ------------------------------------------------ eval, export and conversion
PLUS_SHARED = 576          # ViT-B fc2 rows every ViTPose+ task shares; 192 rows are each task's
PLUS_TASKS = ("coco", "aic", "mpii", "ap10k", "apt36k", "wholebody")
PLUS_BOXES = 16            # people on the frame for each ViTPose+ task
EXPORT_BATCH = 64
# the ONNX graph run by the numpy interpreter on the host against the card's
# float32 kernel forward, relative to the largest |heatmap|: numpy's exact
# erf, float32 BLAS and einsum convolutions against K1's A&S erf and FMA
# GEMMs and cuDNN (measured 1.84e-6 at ViT-B; the JAX package holds its
# ViT-S export to 1e-5 of its forward, tests/test_onnx_export.py)
ONNX_TOL = 1e-5
EVAL_IMAGES, EVAL_PEOPLE, EVAL_HW = 32, 4, (480, 640)


def add_counts(total: dict, counts: dict) -> None:
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def plus_state_dict(model, seed: int) -> dict:
    """A reference-layout ViTPose+ state dict at ViT-B: ``model``'s backbone
    with each fc2 split into PLUS_SHARED shared rows and six expert slices
    of the rest (expert 0 the model's own rows, the others moved by seeded
    noise), ``model``'s head for coco and five associate heads of 133 rows
    drawn from ``seed`` as ``init_params`` draws a head."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().cpu().numpy()
        if ".mlp.fc2." not in k:
            sd[k] = v
            continue
        sd[k] = v[:PLUS_SHARED]
        for e in range(len(PLUS_TASKS)):
            part = v[PLUS_SHARED:]
            sd[k.replace("fc2.", f"experts.{e}.")] = (
                part if e == 0 else part + np.float32(0.02) * rng.standard_normal(
                    part.shape, dtype=np.float32))
    head = {k: v for k, v in sd.items() if k.startswith("keypoint_head.")}
    for j in range(len(PLUS_TASKS) - 1):
        for k, v in head.items():
            shape = ((133,) + v.shape[1:]) if "final_layer" in k else v.shape
            if k.endswith("num_batches_tracked"):
                x = np.zeros((), np.int64)
            elif k.endswith("running_var"):
                x = rng.uniform(0.5, 1.5, shape)
            elif "deconv_layers" in k and len(shape) == 4:
                x = rng.standard_normal(shape) / np.sqrt(shape[0] * 4)
            elif k.endswith("final_layer.weight"):
                x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif k.endswith("weight"):
                x = 1.0 + 0.1 * rng.standard_normal(shape)
            else:
                x = 0.02 * rng.standard_normal(shape)
            sd[k.replace("keypoint_head", f"associate_keypoint_heads.{j}")] = (
                x if x.dtype == np.int64 else x.astype(np.float32))
    return sd


def ultralytics_state_dict(tree) -> dict:
    """The ultralytics YOLOv8 state dict whose BN-folded conversion is
    ``tree`` (the JAX layout's params) within a rounding: each conv's
    weight as it is, BN with mean 0, bias the conv's, and scale
    gamma / sqrt(var + eps) = 1 up to float32 (gamma = sqrt(var + eps))."""
    import re
    sd = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) == {"w", "b"}:
            w, b = np.asarray(node["w"]), np.asarray(node["b"])
            if re.fullmatch(r"model\.22\.cv[23]\.\d\.2", path):
                sd[path + ".weight"], sd[path + ".bias"] = w.transpose(3, 2, 0, 1), b
                return
            var = np.full(b.shape, 1.0, np.float32)
            sd[path + ".conv.weight"] = w.transpose(3, 2, 0, 1)
            sd[path + ".bn.weight"] = np.sqrt(var.astype(np.float64) + 1e-3).astype(np.float32)
            sd[path + ".bn.bias"] = b
            sd[path + ".bn.running_mean"] = np.zeros_like(b)
            sd[path + ".bn.running_var"] = var
            sd[path + ".bn.num_batches_tracked"] = np.zeros((), np.int64)
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, f"{path}.{k}" if path else str(k))

    walk(tree, "")
    sd["model.22.dfl.conv.weight"] = np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)
    return sd


def stand_in_ultralytics(torch):
    """A module class standing in for ultralytics' pickled DetectionModel
    (the card's host has no ultralytics): ``torch.load`` of a .pt unpickles
    it from this script, and the loader reads only ``state_dict()``."""
    if "StandInUltralytics" not in globals():
        class StandInUltralytics(torch.nn.Module):
            def __init__(self, sd):
                super().__init__()
                self._sd = sd

            def state_dict(self, *a, **k):
                return self._sd

        StandInUltralytics.__module__ = __name__
        StandInUltralytics.__qualname__ = "StandInUltralytics"
        globals()["StandInUltralytics"] = StandInUltralytics
    return globals()["StandInUltralytics"]


def hold_given_boxes(torch, vi, frame, bboxes, K: int) -> dict:
    """``vi`` (no detector) on ``frame`` with ``bboxes``, through the kernels
    and then through the plain path of the same model (``vi.plain`` set for
    one call), held by ``hold_step``; the launches of the kernel call."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps

    got, ref = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with decode_spy(ps, got):
        out = vi.inference(frame, bboxes=bboxes)
    counts = kernels.launch_counts()
    vi.plain = True
    try:
        with decode_spy(ps, ref):
            out_p = vi.inference(frame, bboxes=bboxes)
    finally:
        vi.plain = False
    check(list(out) == list(out_p) and len(got) == len(ref) == 1, "plain path differs in people")
    err, gap = hold_step(torch, got[0], ref[0], "int8", f"K={K}")
    check(all(v.shape == (K, 3) and np.isfinite(v).all() for v in out.values()), "keypoints")
    return {"out": out, "launches": counts, "heatmap_rel_err": err,
            "decode_gap_px": gap, "heatmaps": tuple(got[0][0].shape)}


def run_convert(torch, model, frame_np, det, seed: int, dev) -> dict:
    """The conversion CLI at ViT-B (``python -m easy_vitpose_tpu_torch.cli.convert``,
    its ``main``): a reference .pth through ``vitpose`` and back through
    ``to-torch`` key for key and bit for bit; ``average`` of two
    checkpoints; a ViTPose+ state dict through ``plus`` and ``split``, and
    for each of its six tasks ``VitInference(plus.npz, task=t, dtype="int8")``
    against the split checkpoint's (keypoints bit for bit) and against the
    plain path (``hold_given_boxes``) on the 1080p frame with given boxes,
    its launches per frame; a stand-in ultralytics YOLOv8n .pt and its
    converted .npz giving the same detections on the card."""
    import tempfile
    from easy_vitpose_tpu_torch.cli import convert as convert_cli
    from easy_vitpose_tpu_torch.convert.vitpose_torch import (convert_vitpose_state_dict,
                                                             save_torch_checkpoint)
    from easy_vitpose_tpu_torch.detect.yolo import YoloDetector
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference
    from easy_vitpose_tpu_torch.utils.checkpoint import flatten_params, load_params

    t_phase = time.perf_counter()
    res = {"tasks": {}, "launches": {}}
    H, W = FRAME_HW
    boxes = make_boxes(np.random.default_rng(seed + 13), PLUS_BOXES, H, W)
    bboxes = np.concatenate([boxes, np.full((PLUS_BOXES, 1), 0.9, np.float32)], 1)
    with tempfile.TemporaryDirectory() as d:
        p = lambda name: os.path.join(d, name)  # noqa: E731
        cfg = model.cfg
        save_torch_checkpoint(convert_vitpose_state_dict(model.state_dict(), cfg), cfg,
                              p("vitpose-b-coco.pth"))
        t0 = time.perf_counter()
        convert_cli.main(["vitpose", "--ckpt", p("vitpose-b-coco.pth"), "--model-name", "b",
                          "--out", p("vitpose-b-coco.npz")])
        convert_cli.main(["to-torch", "--ckpt", p("vitpose-b-coco.npz"), "--model-name", "b",
                          "--out", p("back-b-coco.pth")])
        res["vitpose_and_back_s"] = time.perf_counter() - t0
        a = torch.load(p("vitpose-b-coco.pth"), weights_only=True)["state_dict"]
        b = torch.load(p("back-b-coco.pth"), weights_only=True)["state_dict"]
        check(list(a) == list(b) and all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                         for k in a),
              "convert vitpose then to-torch does not give the .pth back bit for bit")
        res["pth_keys"] = len(a)
        del a, b
        t0 = time.perf_counter()
        # average: a checkpoint and its half, leaf by leaf the float64 mean cast back
        tree = load_params(p("vitpose-b-coco.npz"))
        flat = flatten_params(tree)
        np.savez(p("half.npz"), **{k: v * np.float32(0.5) for k, v in flat.items()})
        convert_cli.main(["average", "--ckpts", p("vitpose-b-coco.npz"), p("half.npz"),
                          "--out", p("soup.npz")])
        soup = flatten_params(load_params(p("soup.npz")))
        check(soup.keys() == flat.keys() and all(
            np.array_equal(soup[k], ((flat[k].astype(np.float64)
                                      + (flat[k] * np.float32(0.5)).astype(np.float64)) / 2
                                     ).astype(flat[k].dtype)) for k in flat),
              "convert average is not the float64 mean of its checkpoints")
        del tree, flat, soup
        res["average_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # ViTPose+: plus, split, and every task served from each
        torch.save({k: torch.from_numpy(v) for k, v in plus_state_dict(model, seed + 14).items()},
                   p("vitpose+-b.pth"))
        res["plus_pth_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_cli.main(["plus", "--ckpt", p("vitpose+-b.pth"), "--model-name", "b",
                          "--out", p("vitpose-b-plus.npz")])
        convert_cli.main(["split", "--source", p("vitpose+-b.pth"), "--target", p("split"),
                          "--model-name", "b"])
        res["plus_and_split_s"] = time.perf_counter() - t0
        os.remove(p("vitpose+-b.pth"))
        t_tasks = time.perf_counter()
        for task in PLUS_TASKS:
            t0 = time.perf_counter()
            vp = VitInference(p("vitpose-b-plus.npz"), model_name="b", task=task, dtype="int8")
            load_s = time.perf_counter() - t0
            vs = VitInference(os.path.join(p("split"), f"vitpose-b-{task}.npz"), model_name="b",
                              dtype="int8")
            check(vp.dataset == vs.dataset == task, f"{task}: dataset {vp.dataset}, {vs.dataset}")
            K = vp.cfg.head.num_keypoints
            held = hold_given_boxes(torch, vp, frame_np, bboxes, K)
            want = {"block_q8": 12, "sampler": 1, "decode": 1}
            check(held["launches"] == want,
                  f"{task}: launched {held['launches']} a frame, expected {want}")
            split_out = vs.inference(frame_np, bboxes=bboxes)
            check(list(split_out) == list(held["out"]) and all(
                np.array_equal(split_out[k], held["out"][k]) for k in split_out),
                f"{task}: plus and split keypoints differ")
            row = {k: v for k, v in held.items() if k != "out"}
            row.update(K=K, people=len(held["out"]), load_s=load_s)
            add_counts(res["launches"], held["launches"])
            print(f"convert {task}: {json.dumps(row)}")
            res["tasks"][task] = row
            del vp, vs
        torch.cuda.empty_cache()
        res["tasks_s"] = time.perf_counter() - t_tasks
        # a stand-in ultralytics .pt and its .npz
        cls = stand_in_ultralytics(torch)
        sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in ultralytics_state_dict(det["params_n"]).items()}
        torch.save({"model": cls(sd), "train_args": {}}, p("yolov8n.pt"))
        convert_cli.main(["yolo", "--ckpt", p("yolov8n.pt"), "--out", p("yolov8n.npz")])
        kw = dict(imgsz=320, classes=(0,), dtype=torch.bfloat16)
        det_pt, det_npz = YoloDetector(p("yolov8n.pt"), **kw), YoloDetector(p("yolov8n.npz"), **kw)
        a, b = det_pt(frame_np), det_npz(frame_np)
        check(len(a) > 0 and np.array_equal(a, b), ".pt and .npz detections differ")
        res["yolo_pt_detections"] = len(a)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def run_export(torch, model, frame_np, seed: int, dev) -> dict:
    """The export CLI at ViT-B (``cli/export.py`` ``main``): a ``.pt2`` at
    fp32, bf16 and int8 for a batch of 64, each loaded with
    ``torch.export.load`` alone and run on the card against the port's
    kernel forward on the same crops (within HEATMAP_TOL), both timed;
    the ONNX export run by the numpy interpreter on 2 crops against the
    card's fp32 kernel forward (within ONNX_TOL)."""
    import tempfile
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.cli import export as export_cli
    from easy_vitpose_tpu_torch.export.onnx_ref import run_model
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy, vitpose_forward
    from easy_vitpose_tpu_torch.ops import sampler

    t_phase = time.perf_counter()
    H, W = FRAME_HW
    frame = torch.from_numpy(frame_np).to(dev)
    boxes = torch.from_numpy(make_boxes(np.random.default_rng(seed + 15), EXPORT_BATCH, H, W))
    crops, _ = sampler.crop_normalize(frame, boxes.to(dev), dtype=torch.float32)
    res = {"launches": {}}
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "vitpose-b-coco.npz")
        save_pose_npz(npz, model)
        for dtype in ("fp32", "bf16", "int8"):
            out = os.path.join(d, f"vitpose-b-coco-{dtype}.pt2")
            t0 = time.perf_counter()
            export_cli.main(["--model", npz, "--model-name", "b", "--dtype", dtype,
                             "--batch", str(EXPORT_BATCH), "--out", out])
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            prog = torch.export.load(out).module()
            load_s = time.perf_counter() - t0
            sm = serving_copy(model, dtype)
            x = crops.to(torch.float32 if dtype == "fp32" else torch.bfloat16)
            with torch.no_grad():
                got = prog(x)
                kernels.reset_launch_counts()
                ref = vitpose_forward(sm, x)
                launches = kernels.launch_counts()
                span = float(ref.float().max() - ref.float().min())
                err = float((got.float() - ref.float()).abs().max())
                check(got.shape == ref.shape and got.dtype == ref.dtype and got.is_cuda,
                      f"{dtype} .pt2: {tuple(got.shape)} {got.dtype} on {got.device}")
                check(err <= HEATMAP_TOL[dtype] * span,
                      f"{dtype} .pt2 differs from the kernel forward: {err} of {span}")
                row = {"file_bytes": os.path.getsize(out), "export_s": export_s, "load_s": load_s,
                       "heatmap_rel_err": err / span, "kernel_launches": launches,
                       "pt2_ms": time_ms(torch, lambda: prog(x)),
                       "kernel_ms": time_ms(torch, lambda: vitpose_forward(sm, x))}
            print(f"export {dtype}: {json.dumps(row)}")
            res[dtype] = row
            res["launches"][dtype] = launches
            del prog, sm
            os.remove(out)
        onnx = os.path.join(d, "vitpose-b-coco.onnx")
        t0 = time.perf_counter()
        export_cli.main(["--model", npz, "--model-name", "b", "--format", "onnx", "--out", onnx])
        export_s = time.perf_counter() - t0
        x2 = crops[:2]
        t0 = time.perf_counter()
        (host,) = run_model(open(onnx, "rb").read(), {"input": x2.cpu().numpy().transpose(0, 3, 1, 2)})
        run_s = time.perf_counter() - t0
        with torch.no_grad():
            ref = vitpose_forward(serving_copy(model, "fp32"), x2).cpu().numpy()
        err = float(np.abs(host - ref).max()) / float(np.abs(ref).max())
        check(host.shape == ref.shape and err <= ONNX_TOL,
              f"ONNX on the host differs from the card's fp32 forward: rel {err}")
        res["onnx"] = {"file_bytes": os.path.getsize(onnx), "export_s": export_s,
                       "interpreter_s": run_s, "rel_err": err}
        print(f"export onnx: {json.dumps(res['onnx'])}")
    res["phase_s"] = time.perf_counter() - t_phase
    return res


class StandInCv2:
    """What the eval CLI's lanes read with cv2 (the card's host has none):
    ``imread`` of the smoke's in-memory images by path (BGR, as cv2 gives
    them), ``cvtColor`` BGR->RGB, and ``warpAffine`` as a bilinear numpy
    warp with a constant zero border (cv2 rounds its bilinear weights to
    1/32 and its result to uint8 the same way; the crops are the stand-in's,
    both runs of a lane read the same)."""
    IMREAD_COLOR, COLOR_BGR2RGB, INTER_LINEAR = 1, 4, 1

    def __init__(self, images: dict):
        self.images = images

    def imread(self, path, flags=None):
        img = self.images.get(path)
        return None if img is None else np.ascontiguousarray(img[..., ::-1])

    @staticmethod
    def cvtColor(img, code):
        return np.ascontiguousarray(img[..., ::-1])

    @staticmethod
    def warpAffine(img, M, dsize, flags=None):
        w, h = dsize
        inv = np.linalg.inv(np.vstack([np.asarray(M, np.float64), [0.0, 0.0, 1.0]]))[:2]
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        x0, y0 = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
        fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
        H, W = img.shape[:2]

        def at(yy, xx):
            ok = ((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W))[..., None]
            return np.where(ok, img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)], 0).astype(
                np.float64)

        out = ((at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx) * (1 - fy)
               + (at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx) * fy)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def eval_val_set(seed: int, d: str):
    """A synthetic COCO val set: EVAL_IMAGES noise images of EVAL_HW with
    EVAL_PEOPLE annotated people each, written as SmokeDataset writes its
    annotations (boxes, 17 keypoints inside them, 85% visible)."""
    rng = np.random.default_rng(seed)
    H, W = EVAL_HW
    imgdir = os.path.join(d, "val2017")
    images, anns, files = [], [], {}
    for i in range(EVAL_IMAGES):
        name = f"{i:012d}.jpg"
        files[os.path.join(imgdir, name)] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        images.append({"id": i, "file_name": name, "width": W, "height": H})
        for _ in range(EVAL_PEOPLE):
            w, h = rng.uniform(60, 200), rng.uniform(120, 300)
            x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
            kp = np.stack([rng.uniform(x, x + w, 17), rng.uniform(y, y + h, 17),
                           2.0 * (rng.uniform(size=17) > 0.15)], -1)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                         "keypoints": kp.ravel().tolist(), "num_keypoints": int((kp[:, 2] > 0).sum()),
                         "bbox": [float(x), float(y), float(w), float(h)], "area": float(w * h)})
    ann = os.path.join(d, "person_keypoints_val2017.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)
    return ann, imgdir, files, anns


@contextlib.contextmanager
def eval_spies(torch, seen: dict):
    """Record what the eval CLI computes: each batch's heatmaps of its
    gt-crops lane (``forward_heatmaps``), each image lane's VitInference
    (its detector's programs run eagerly, so the decode spy sees the pose
    steps) and every pose step's decode inputs."""
    from easy_vitpose_tpu_torch.cli import eval_coco
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps

    real_fwd, real_vi = eval_coco.forward_heatmaps, eval_coco.VitInference

    def fwd(*a, **k):
        out = real_fwd(*a, **k)
        seen["heat"].append(out)
        return out

    class Recording(real_vi):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if self._detector is not None:
                self._detector.graphs.run = lambda key, fn, *inputs: fn(*inputs)

    seen.update(heat=[], decode=[])
    eval_coco.forward_heatmaps, eval_coco.VitInference = fwd, Recording
    try:
        with decode_spy(ps, seen["decode"]):
            yield
    finally:
        eval_coco.forward_heatmaps, eval_coco.VitInference = real_fwd, real_vi


def run_eval_lane(torch, argv, spied: bool) -> dict:
    """One eval CLI run (``main(argv)``): its AP summary, results, launches
    and seconds, and with ``spied`` what ``eval_spies`` records."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.cli import eval_coco

    seen = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with (eval_spies(torch, seen) if spied else contextlib.nullcontext()):
        stats = eval_coco.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = argv[argv.index("--out") + 1]
    with open(out) as f:
        results = json.load(f)
    return {"stats": stats, "results": results, "launches": kernels.launch_counts(),
            "s": secs, "seen": seen}


def run_eval_coco(torch, model, det, seed: int, dev) -> dict:
    """The eval CLI at ViT-B int8 (``cli/eval_coco.py`` ``main``) on a
    synthetic val set, each lane against the same call with ``--plain``:
    ``--gt-crops-batched 64`` (each batch's heatmaps within
    HEATMAP_TOL["int8"], the same results' images and annotations),
    ``--use-gt-bbox`` and the YOLOv8n/320 detector lane (the same
    detections and scores bit for bit, heatmaps within HEATMAP_TOL["int8"],
    keypoints the plain decode of their own heatmaps), and the gt-crops lane
    with ``--flip-test --oks-nms soft --per-keypoint``; launches per batch
    and per image; crops/s and images/s; the scorer's AP on the ground
    truth fed back as results.  cv2's image read and warp are stood in for
    (``StandInCv2``)."""
    import tempfile
    from easy_vitpose_tpu_torch.cli import eval_coco
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.eval.cocoeval import CocoKeypointEval
    from easy_vitpose_tpu_torch.train import dataset

    t_phase = time.perf_counter()
    res = {"stood_in": "cv2.imread, cv2.cvtColor and cv2.warpAffine (StandInCv2: in-memory "
                       "images, a numpy bilinear warp)", "launches": {}}
    with tempfile.TemporaryDirectory() as d:
        ann, imgdir, files, anns = eval_val_set(seed + 16, d)
        npz, det_path = os.path.join(d, "vitpose-b-coco.npz"), os.path.join(d, "yolov8n.npz")
        save_pose_npz(npz, model)
        yolo.save_yolo_npz(det_path, det["params_n"], "n")
        gt = json.load(open(ann))
        fed_back = [{"image_id": a["image_id"], "category_id": 1, "keypoints": a["keypoints"],
                     "score": 1.0} for a in anns]
        res["gt_fed_back_AP"] = CocoKeypointEval(gt, fed_back).summarize()["AP"]
        check(abs(res["gt_fed_back_AP"] - 1.0) < 1e-9, f"the scorer gives the ground truth AP "
                                                       f"{res['gt_fed_back_AP']}")
        base = ["--ann", ann, "--imgdir", imgdir, "--model", npz, "--model-name", "b",
                "--dtype", "int8"]
        lanes = {"gt_crops": ["--gt-crops-batched", str(SLOTS)],
                 "gt_bbox": ["--use-gt-bbox"],
                 "detector": ["--yolo", det_path, "--yolo-size", "320"],
                 "gt_crops_flip_soft": ["--gt-crops-batched", str(SLOTS), "--flip-test",
                                        "--oks-nms", "soft", "--per-keypoint"]}
        stand_in = StandInCv2(files)
        real_cv2 = eval_coco.cv2, dataset.cv2
        eval_coco.cv2 = dataset.cv2 = stand_in
        try:
            for lane, extra in lanes.items():
                argv = base + extra + ["--out", os.path.join(d, f"{lane}.json")]
                k = run_eval_lane(torch, argv, spied=True)
                p = run_eval_lane(torch, argv[:-2] + ["--plain", "--out",
                                                      os.path.join(d, f"{lane}_plain.json")],
                                  spied=True)
                kr, pr = k["results"], p["results"]
                check(len(kr) == len(pr) > 0, f"{lane}: {len(kr)} results, plain {len(pr)}")
                key = lambda r: (r["image_id"], r.get("ann_id", 0), r["score"])  # noqa: E731
                if lane == "detector":     # the detector's scores are the plain path's bits
                    check(sorted(map(key, kr)) == sorted(map(key, pr)),
                          f"{lane}: detections differ from the plain path")
                else:
                    check(sorted(r["image_id"] for r in kr) == sorted(r["image_id"] for r in pr),
                          f"{lane}: results' images differ from the plain path")
                row = {"results": len(kr), "AP": k["stats"]["AP"], "plain_AP": p["stats"]["AP"],
                       "s": k["s"], "plain_s": p["s"]}
                worst, gap = 0.0, 0.0
                if lane.startswith("gt_crops"):
                    batches = len(k["seen"]["heat"])
                    check(batches == len(p["seen"]["heat"]) == -(-len(anns) // SLOTS),
                          f"{lane}: {batches} batches")
                    for hk, hp in zip(k["seen"]["heat"], p["seen"]["heat"]):
                        span = float(hp.max() - hp.min())
                        worst = max(worst, float((hk - hp).abs().max()) / span)
                    per = {n: c / batches for n, c in k["launches"].items()}
                    want = {"block_q8": 24 if "--flip-test" in extra else 12}
                    row.update(batches=batches, launches_per_batch=per,
                               crops_per_s=len(anns) / k["s"])
                else:
                    # one pose step an image; with the detector a frame
                    # with more people than the high-water mark of past
                    # frames' slots (the first frame: 1) poses the rest in a
                    # second step
                    steps = len(k["seen"]["decode"])
                    check(steps == len(p["seen"]["decode"]) and EVAL_IMAGES <= steps
                          <= EVAL_IMAGES * (1 + (lane == "detector")),
                          f"{lane}: {steps} pose steps for {EVAL_IMAGES} images")
                    for step, step_plain in zip(k["seen"]["decode"], p["seen"]["decode"]):
                        err, g = hold_step(torch, step, step_plain, "int8", lane)
                        worst, gap = max(worst, err), max(gap, g)
                    per = {n: c / EVAL_IMAGES for n, c in k["launches"].items()}
                    want = {"block_q8": 12 * steps / EVAL_IMAGES, "sampler": steps / EVAL_IMAGES,
                            "decode": steps / EVAL_IMAGES}
                    if lane == "detector":
                        want.update(letterbox=1, nms=1)
                    row.update(launches_per_image=per, images_per_s=EVAL_IMAGES / k["s"],
                               pose_steps=steps)
                check(per == want, f"{lane}: launched {per}, expected {want}")
                check(worst <= HEATMAP_TOL["int8"] and gap <= DECODE_TOL,
                      f"{lane}: heatmaps {worst} of their range, decode gap {gap}")
                row.update(heatmap_rel_err=worst, decode_gap_px=gap, launches=k["launches"])
                add_counts(res["launches"], k["launches"])
                if lane == "detector":     # the CLI's own path: the detection frames as graphs
                    g = run_eval_lane(torch, argv, spied=False)
                    check(sorted(map(key, g["results"])) == sorted(map(key, kr)),
                          "detector lane: graphed results differ from the eager ones")
                    check({n: c / EVAL_IMAGES for n, c in g["launches"].items()} == want,
                          f"detector lane (graphs): launched {g['launches']}")
                    row.update(graphed_s=g["s"], graphed_images_per_s=EVAL_IMAGES / g["s"])
                    add_counts(res["launches"], g["launches"])
                print(f"eval_coco {lane}: {json.dumps(row)}")
                res[lane] = row
            # (c) the gt-crops lane split over two mesh entries on the one card
            argv = base + lanes["gt_crops"] + ["--devices", str(dev), str(dev), "--out",
                                               os.path.join(d, "gt_crops_sharded.json")]
            sh = run_eval_lane(torch, argv, spied=False)
            one = res["gt_crops"]
            check(sh["results"] == json.load(open(os.path.join(d, "gt_crops.json"))),
                  "sharded gt-crops lane: results differ from one device")
            per = {n: c / one["batches"] for n, c in sh["launches"].items()}
            check(per == {"block_q8": 24}, f"sharded gt-crops lane: launched {per}")
            res["gt_crops_sharded"] = {"bit_equal": True, "launches_per_batch": per,
                                       "s": sh["s"], "crops_per_s": len(anns) / sh["s"]}
            add_counts(res["launches"], sh["launches"])
            print(f"eval_coco gt_crops_sharded: {json.dumps(res['gt_crops_sharded'])}")
        finally:
            eval_coco.cv2, dataset.cv2 = real_cv2
    res["phase_s"] = time.perf_counter() - t_phase
    return res



def run_tool_phases(torch, seed: int = 0) -> dict:
    """The convert, export and eval_coco phases alone, on the main path's
    ViT-B, frame and YOLOv8n/320 weights (``python3 -c "import torch,
    chip_smoke as c; c.run_tool_phases(torch)"`` on a machine with a card)."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.models.vitpose import init_params

    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    card = host_record(torch)
    kernels.build()
    dev = torch.device("cuda")
    model = init_params(get_model_config("coco", "b"), seed).to(dev)
    frame_np = np.random.default_rng(seed + 3).integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8)
    det = {"params_n": yolo.init_yolo_params(seed, yolo.YoloSpec("n"), frame_np, 320)}
    with torch.no_grad():
        out = {"convert": run_convert(torch, model, frame_np, det, seed, dev),
               "export": run_export(torch, model, frame_np, seed, dev),
               "eval_coco": run_eval_coco(torch, model, det, seed, dev)}
    for k, v in out.items():
        print(f"{k}:", json.dumps(v), "|", card)
    return out


# ----------------------------------------------------------- the training loop
LOOP_TRAIN, LOOP_VAL, LOOP_BATCH = 256, 64, 64   # ViT-B: 4 steps and 1 val batch an epoch
LOOP_L_TRAIN = 128                               # ViT-L: 2 steps an epoch, no validation


class SmokeDataset:
    """A dataset of ``CocoPoseDataset``'s items, made in bulk from a seed
    (the card's host has no cv2 to read and warp images): train items are
    device-input (uint8 256x192 crops, joints inside them, 85% visible);
    val items are host-rendered (normalized crops, the numpy targets) with
    metas whose center and scale map each crop back onto a 640x480 image of
    ``ann_file``'s annotations (written by the caller, one person an
    image), for the in-loop AP."""

    def __init__(self, n: int, seed: int, val: bool = False):
        from easy_vitpose_tpu_torch.ops.affine import affine_transform_batch, get_affine_transform
        from easy_vitpose_tpu_torch.ops.heatmap import generate_gaussian_targets_np
        from easy_vitpose_tpu_torch.train.dataset import PIXEL_STD
        rng = np.random.default_rng(seed)
        self.image_size, self.heatmap_size, self.heatmap_sigma = (192, 256), (48, 64), 3.0
        self.joints_weight = np.ones((17, 1), np.float32)
        self.use_different_joints_weight = False
        self.device_input = not val
        self.crops = rng.integers(0, 256, (n, 256, 192, 3), dtype=np.uint8)
        self.metas, self.annotations = [], []
        for i in range(n):
            x, y = rng.uniform(20, 300), rng.uniform(20, 200)
            w, h = rng.uniform(90, 300), rng.uniform(150, 260)
            c = np.array([x + w / 2, y + h / 2], np.float32)
            w, h = max(w, 0.75 * h), max(h, w / 0.75)
            s = np.array([w / PIXEL_STD, h / PIXEL_STD], np.float32) * 1.25
            trans = get_affine_transform(c, s, PIXEL_STD, 0.0, self.image_size)
            joints_img = np.stack([rng.uniform(x, x + w * 0.8, 17), rng.uniform(y, y + h * 0.8, 17)],
                                  -1).astype(np.float32)
            vis = np.repeat((rng.uniform(size=(17, 1)) > 0.15).astype(np.float32), 2, 1)
            joints = affine_transform_batch(joints_img, trans).astype(np.float32)
            self.metas.append({"imgId": i, "annId": i, "center": c, "scale": s, "rotation": 0.0,
                               "joints": joints, "joints_visibility": vis})
            kp = np.concatenate([joints_img, 2 * vis[:, :1]], -1)
            self.annotations.append({"id": i, "image_id": i, "category_id": 1, "iscrowd": 0,
                                     "keypoints": kp.ravel().tolist(),
                                     "num_keypoints": int(vis[:, 0].sum()),
                                     "bbox": [float(x), float(y), float(w), float(h)],
                                     "area": float(w * h)})
        if val:
            mean, std = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224, 0.225])
            self.images = (self.crops.astype(np.float32) / 255.0 - mean) / std
            self.targets = [generate_gaussian_targets_np(m["joints"], m["joints_visibility"])
                            for m in self.metas]

    def write_ann_file(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"images": [{"id": i, "file_name": f"{i}.jpg", "width": 640, "height": 480}
                                  for i in range(len(self))],
                       "annotations": self.annotations}, f)
        self.ann_file = path

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, i):
        if self.device_input:
            return self.crops[i], None, None, self.metas[i]
        return self.images[i], self.targets[i][0], self.targets[i][1], self.metas[i]


class LoopSpy:
    """Instruments one ``train_model`` call from outside it: each train
    step's launches, host syncs (PyTorch's sync check set to warn around
    the step), batch and loss; each val batch's launches; the loader's
    wait in the train iterator; each epoch's train phase (from its
    iterator to the read of its losses); each checkpoint write's and host
    snapshot's seconds.  The patches come off on exit."""

    def __init__(self, torch):
        self.torch = torch
        self.steps, self.val, self.batches, self.losses = [], [], [], []
        self.syncs, self.epochs, self.writes = [], [], []
        self.loader_s = 0.0

    def __enter__(self):
        import warnings
        from easy_vitpose_tpu_torch import kernels
        from easy_vitpose_tpu_torch.train import loop, state_ckpt, step as tstep
        torch, spy = self.torch, self
        self._saved = [(tstep, "make_train_step", tstep.make_train_step),
                       (tstep, "make_eval_step", tstep.make_eval_step),
                       (loop, "batch_iterator", loop.batch_iterator),
                       (loop, "fetch_mean", loop.fetch_mean),
                       (loop, "save_params", loop.save_params),
                       (state_ckpt, "save_train_state", state_ckpt.save_train_state),
                       (state_ckpt, "host_state", state_ckpt.host_state)]
        real = {name: fn for _, name, fn in self._saved}

        def launches(fn):
            before = kernels.launch_counts()
            out = fn()
            after = kernels.launch_counts()
            return out, {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}

        def make_train_step(*a, **k):
            step = real["make_train_step"](*a, **k)

            def spied(state, batch, generator=None, **kw):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        out, n = launches(lambda: step(state, batch, generator, **kw))
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                spy.syncs.append(sum("called a synchronizing" in str(w.message) for w in caught))
                spy.steps.append(n)
                spy.batches.append(batch)
                spy.losses.append(out[1]["loss"])
                return out
            return spied

        def make_eval_step(*a, **k):
            step = real["make_eval_step"](*a, **k)

            def spied(state, batch):
                out, n = launches(lambda: step(state, batch))
                spy.val.append(n)
                return out
            return spied

        def batch_iterator(ds, batch_size, **kw):
            train = kw.get("shuffle", True)
            if train:
                spy.epochs.append({"t0": time.perf_counter()})
            it = real["batch_iterator"](ds, batch_size, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                if train:
                    spy.loader_s += time.perf_counter() - t0
                yield item

        def fetch_mean(values):
            out = real["fetch_mean"](values)
            ep = spy.epochs[-1]
            ep.setdefault("train_s", time.perf_counter() - ep["t0"])
            return out

        def timed(name):
            def fn(*a, **k):
                t0 = time.perf_counter()
                out = real[name](*a, **k)
                spy.writes.append((name, os.path.basename(str(a[0])) if a and isinstance(a[0], str)
                                   else "", time.perf_counter() - t0))
                return out
            return fn

        for mod, name, _ in self._saved:
            setattr(mod, name, {"make_train_step": make_train_step, "make_eval_step": make_eval_step,
                                "batch_iterator": batch_iterator,
                                "fetch_mean": fetch_mean}.get(name) or timed(name))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def loop_settings(presets, work, seed, **kw):
    """The finetune preset through the kernels: K5-K7 blocks, the fused
    Adam, AMP, device input, a save and a full-state save every epoch."""
    return presets.finetune("b", **{**dict(
        block_impl="pallas_train", optimizer="fused_adam", use_amp=True, device_input=True,
        batch_size=LOOP_BATCH, save_interval=1, save_full_state=True, ckpt_topk_epoch=0,
        tensorboard=False, seed=seed, work_dir=work), **kw})


def flat_state(torch, path: str) -> dict:
    """A saved full train state's tensors by '/'-joined path, on the CPU."""
    from easy_vitpose_tpu_torch.train.state_ckpt import restore_train_state
    st = restore_train_state(path)
    out = {}

    def visit(tree, pre):
        if hasattr(tree, "_asdict"):
            tree = tree._asdict()
        if isinstance(tree, dict):
            for k, v in tree.items():
                visit(v, f"{pre}/{k}")
        else:
            out[pre] = tree
    visit(st, "")
    return out


def state_gap(torch, a: dict, b: dict) -> tuple:
    """(every tensor bit for bit, the largest |a - b| of a weight, int8
    moment codes that differ)."""
    check(set(a) == set(b), "the two train states hold other tensors")
    equal = all(torch.equal(a[k], b[k]) for k in a)
    gap = max(float((a[k] - b[k]).abs().max()) for k in a if k.startswith("/params/"))
    codes = sum(int((a[k] != b[k]).sum()) for k in a if not a[k].is_floating_point())
    return equal, gap, codes


def copy_state_after(spy_dir: str, n: int):
    """A ``save_train_state`` wrapper that also keeps the n-th saved state
    in ``spy_dir`` (the state after epoch n), for a resume."""
    import shutil
    from easy_vitpose_tpu_torch.train import state_ckpt
    real, calls = state_ckpt.save_train_state, [0]

    def save(path, state):
        real(path, state)
        calls[0] += 1
        if calls[0] == n:
            shutil.copytree(path, spy_dir)
    return save


def run_loop_b(torch, seed, dev, tmp, bare_ms: float) -> dict:
    """The finetune preset at ViT-B on the card, 3 epochs; the same steps by
    hand; a resume after epoch 2; last.npz through ``VitInference``."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vitpose import init_params, vitpose_forward
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference
    from easy_vitpose_tpu_torch.train import loop, presets, state_ckpt, step as tstep
    from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam

    cfg = get_model_config("coco", "b")
    params = init_params(cfg, seed).state_dict()
    train_ds, val_ds = SmokeDataset(LOOP_TRAIN, seed + 10), SmokeDataset(LOOP_VAL, seed + 11, True)
    val_ds.write_ann_file(os.path.join(tmp, "val.json"))
    work = os.path.join(tmp, "b")
    settings = loop_settings(presets, work, seed, total_epochs=3, eval_ap_interval=1)
    logs = []
    real_save = state_ckpt.save_train_state
    with LoopSpy(torch) as spy:
        state_ckpt.save_train_state = copy_state_after(os.path.join(tmp, "b_ep2"), 2)
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = loop.train_model(params, cfg, train_ds, val_ds, settings, log=logs.append,
                                   device=dev)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        finally:
            state_ckpt.save_train_state = real_save
    depth, steps = cfg.backbone.depth, len(spy.steps)
    want_step = {fbt.FWD: depth, fbt.BWD_MLP: depth, fbt.BWD_ATTN: depth, "grad_norm": 1, "adam": 1}
    print(f"train_loop ViT-B: {steps} steps, launches a step {spy.steps[0]}, a val batch "
          f"{spy.val[0]}, syncs a step {spy.syncs}")
    check(steps == 3 * LOOP_TRAIN // LOOP_BATCH, f"train_loop ViT-B ran {steps} steps")
    # the first step of a process copies its constants to the card once
    # (the ImageNet mean and std, the heatmap stride, the keep probabilities)
    check(max(spy.syncs[1:]) == 0, f"loop steps made the host wait: {spy.syncs}")
    check(all(n == want_step for n in spy.steps), f"a loop step launched {spy.steps}, "
          f"expected {want_step}")
    check(len(spy.val) == 3 and all(n == {"block": depth} for n in spy.val),
          f"a val batch launched {spy.val}, expected {{'block': {depth}}}")
    hist = out["history"]
    check(len(hist) == 3 and all(math.isfinite(h["train_loss"]) and math.isfinite(h["val_loss"])
                                 and h["val_acc"] is not None and h["val_ap"] is not None
                                 for h in hist), f"train_loop ViT-B history {hist}")
    check(hist[-1]["train_loss"] < hist[0]["train_loss"],
          f"train_loop ViT-B: the loss did not fall: {hist}")
    for f in ("epoch000.npz", "epoch001.npz", "epoch002.npz", "last.npz", "loop_state.json"):
        check(os.path.exists(os.path.join(work, f)), f"train_loop ViT-B wrote no {f}")

    # the same steps by hand, on the recorded batches and the epochs' generator seeds
    tx = make_fused_adam(settings.lr)
    state = tstep.init_train_state(params, tx, device=dev)
    step = tstep.make_train_step(cfg, tx, use_amp=True, block_impl="pallas_train",
                                 render_kwargs=dict(heatmap_size=(48, 64), image_size=(192, 256),
                                                    sigma=3.0, joints_weight=train_ds.joints_weight,
                                                    use_different_joints_weight=False))
    gen, per = torch.Generator(device=dev), LOOP_TRAIN // LOOP_BATCH
    hand = []
    for i, batch in enumerate(spy.batches):
        if i % per == 0:
            gen.manual_seed(loop.epoch_generator_seed(seed, i // per))
        state, m = step(state, batch, gen)
        hand.append(m["loss"])
    lk, lh = torch.stack(spy.losses).cpu(), torch.stack(hand).cpu()
    hand_equal = bool(torch.equal(lk, lh))
    hand_err = float(((lk - lh).abs() / lh.abs()).max())
    print(f"train_loop ViT-B: loop losses {lk.tolist()}; by hand bit for bit {hand_equal}, "
          f"rel {hand_err:.3e}")
    check(hand_err <= STEP_LOSS_TOL, f"train_loop losses differ from the hand-driven steps: "
          f"{hand_err}")
    del state, hand

    # last.npz through VitInference against the state's serving model
    final = state_ckpt.restore_train_state(os.path.join(work, "train_state"))
    vi = VitInference(os.path.join(work, "last.npz"), model_name="b", dataset="coco",
                      dtype="bf16", device=dev)
    x = torch.from_numpy(val_ds.images[:16]).to(dev, torch.bfloat16)
    with torch.no_grad():
        got = vitpose_forward(vi._model, x).float()
        ref = vitpose_forward(tstep.serving_model(
            cfg, {k: v.to(dev) for k, v in final["params"].items()},
            {k: v.to(dev) for k, v in final["bn_state"].items()}, torch.bfloat16), x).float()
    span = float(ref.max() - ref.min())
    vi_err = float((got - ref).abs().max()) / span
    print(f"train_loop ViT-B: last.npz through VitInference, heatmaps {vi_err:.3e} of their range")
    check(vi_err <= HEATMAP_TOL["bf16"], f"last.npz serves other heatmaps: {vi_err}")
    del vi, final

    # resume from the state after epoch 2 into a fresh work dir, profiled
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    resumed = loop_settings(presets, os.path.join(tmp, "b_resume"), seed, total_epochs=3,
                            eval_ap_interval=1,
                            resume_state_dir=os.path.join(tmp, "b_ep2"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out_r = loop.train_model(params, cfg, train_ds, val_ds, resumed, log=logs.append,
                                 device=dev)
        torch.cuda.synchronize()
        resume_wall_s = time.perf_counter() - t0
    busy_s = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e6
    check([h["epoch"] for h in out_r["history"]] == [2], f"the resume ran {out_r['history']}")
    equal, gap, codes = state_gap(torch, flat_state(torch, os.path.join(work, "train_state")),
                                  flat_state(torch, os.path.join(tmp, "b_resume", "train_state")))
    print(f"train_loop ViT-B: resumed after epoch 2, epoch-3 state bit for bit {equal}, "
          f"largest gap {gap:.3e}")
    check(gap <= 0.5 * settings.lr, f"the resumed run ends {gap} from the uninterrupted one")
    check(abs(out_r["history"][0]["train_loss"] - hist[2]["train_loss"])
          <= STEP_LOSS_TOL * hist[2]["train_loss"], "the resumed epoch's loss differs")

    train_s = [e["train_s"] for e in spy.epochs]
    ms_step = [s * 1e3 / per for s in train_s]
    writes = {}
    for name, f, s in spy.writes:
        writes.setdefault(f"{name} {f}".strip(), []).append(round(s, 3))
    return {"launches": counts, "launches_per_step": spy.steps[0],
            "launches_per_val_batch": spy.val[0], "steps": steps,
            "syncs_first_step": spy.syncs[0], "syncs_per_step_after": max(spy.syncs[1:]),
            "ms_per_loop_step": ms_step, "bare_ms_per_step": bare_ms,
            "epoch_seconds": [h["seconds"] for h in hist], "wall_s": wall_s,
            "loader_share": spy.loader_s / sum(train_s), "checkpoint_seconds": writes,
            "losses_by_hand_bit_equal": hand_equal, "losses_by_hand_rel_err": hand_err,
            "vitinference_heatmap_err": vi_err, "resume_bit_equal": equal, "resume_gap": gap,
            "resume_wall_s": resume_wall_s, "resume_busy_share": busy_s / resume_wall_s,
            "history": hist}


def run_loop_l(torch, seed, dev, tmp, depth: int) -> dict:
    """ViT-L at full width (D=1024, 16 heads, ``depth`` blocks) with int8
    moments: 2 epochs of 2 steps with full-state saves, and a resume of
    epoch 2 from the state after epoch 1."""
    import dataclasses
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import loop, presets, state_ckpt

    cfg = get_model_config("coco", "l")
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, depth=depth))
    params = init_params(cfg, seed).state_dict()
    train_ds = SmokeDataset(LOOP_L_TRAIN, seed + 12)
    work = os.path.join(tmp, "l")
    settings = loop_settings(presets, work, seed, total_epochs=2, opt_moments="int8",
                             ckpt_topk_epoch=10)
    real_save = state_ckpt.save_train_state
    with LoopSpy(torch) as spy:
        state_ckpt.save_train_state = copy_state_after(os.path.join(tmp, "l_ep1"), 1)
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out = loop.train_model(params, cfg, train_ds, None, settings, log=lambda m: None,
                                   device=dev)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            counts = kernels.launch_counts()
        finally:
            state_ckpt.save_train_state = real_save
    want_step = {fbt.FWD: depth, fbt.BWD_MLP_DX_SAVE: depth, fbt.BWD_MLP_DW_SAVED: depth,
                 fbt.BWD_ATTN: depth, "adam_q8": 1, "grad_norm": 1}
    print(f"train_loop ViT-L depth {depth}: launches a step {spy.steps[0]}, syncs {spy.syncs}")
    check(len(spy.steps) == 4 and all(n == want_step for n in spy.steps),
          f"a ViT-L loop step launched {spy.steps}, expected {want_step}")
    check(all(math.isfinite(h["train_loss"]) for h in out["history"]), "ViT-L loss not finite")
    for f in ("epoch000.npz", "epoch001.npz", "last.npz"):     # 1.2 GB each: free the disk
        check(os.path.exists(os.path.join(work, f)), f"train_loop ViT-L wrote no {f}")
        os.remove(os.path.join(work, f))
    resumed = dataclasses.replace(settings, work_dir=os.path.join(tmp, "l_resume"),
                                  resume_state_dir=os.path.join(tmp, "l_ep1"))
    t0 = time.perf_counter()
    out_r = loop.train_model(params, cfg, train_ds, None, resumed, log=lambda m: None, device=dev)
    resume_wall_s = time.perf_counter() - t0
    check([h["epoch"] for h in out_r["history"]] == [1], f"the ViT-L resume ran {out_r['history']}")
    equal, gap, codes = state_gap(torch, flat_state(torch, os.path.join(work, "train_state")),
                                  flat_state(torch, os.path.join(tmp, "l_resume", "train_state")))
    print(f"train_loop ViT-L: resumed after epoch 1, epoch-2 state bit for bit {equal}, "
          f"largest gap {gap:.3e}, int8 codes differing {codes}")
    check(gap <= 0.5 * settings.lr, f"the resumed ViT-L run ends {gap} from the uninterrupted one")
    writes = {}
    for name, f, s in spy.writes:
        writes.setdefault(f"{name} {f}".strip(), []).append(round(s, 3))
    return {"depth": depth, "launches": counts, "launches_per_step": spy.steps[0],
            "syncs_per_step": statistics.mean(spy.syncs),
            "ms_per_loop_step": [e["train_s"] * 1e3 / 2 for e in spy.epochs],
            "epoch_seconds": [h["seconds"] for h in out["history"]], "wall_s": wall_s,
            "resume_wall_s": resume_wall_s, "checkpoint_seconds": writes,
            "resume_bit_equal": equal, "resume_gap": gap, "resume_codes_differing": codes}


def run_loop_from_scratch(torch, seed, dev, tmp) -> dict:
    """The from-scratch preset at ViT-B (AdamW with layer decay under the
    warmup schedule, plain torch ops) for 2 epochs of 2 steps: the
    history's rates are the schedule's at the count before each epoch's
    last update."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import loop, presets, step as tstep

    cfg = get_model_config("coco", "b")
    settings = presets.from_scratch("b", total_epochs=2, batch_size=LOOP_BATCH,
                                    block_impl="pallas_train", device_input=True,
                                    tensorboard=False, seed=seed,
                                    work_dir=os.path.join(tmp, "scratch"))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = loop.train_model(init_params(cfg, seed).state_dict(), cfg,
                           SmokeDataset(2 * LOOP_BATCH, seed + 13), None, settings,
                           log=lambda m: None, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    sched = tstep.make_step_lr_schedule(settings.lr, 2, milestones=settings.lr_milestones,
                                        gamma=settings.lr_gamma, warmup_iters=settings.warmup_iters,
                                        warmup_ratio=settings.warmup_ratio)
    want = [float(sched(torch.tensor(c, dtype=torch.int32, device=dev))) for c in (1, 3)]
    got = [h["lr"] for h in out["history"]]
    print(f"train_loop from-scratch: lr {got} against the schedule's {want}, launches {counts}")
    check(got == want, f"the from-scratch history's lr {got} is not the schedule's {want}")
    check("adam" not in counts and counts.get("train_fwd") == 4 * cfg.backbone.depth,
          f"the from-scratch run launched {counts}")
    return {"lr": got, "schedule_lr": want, "launches": counts, "wall_s": wall_s,
            "train_loss": [h["train_loss"] for h in out["history"]]}


def run_train_loop(torch, seed, dev, bare_ms: float) -> dict:
    """The training loop phase: ViT-B, ViT-L int8 and the from-scratch
    preset, in a temporary work dir removed after; cuDNN deterministic
    while it runs (the head's convolutions), restored after."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="evt_train_loop_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        res = {"vit_b": run_loop_b(torch, seed, dev, tmp, bare_ms),
               "tmp_free_gb": shutil.disk_usage(tmp).free / 1e9}
        for d in os.listdir(tmp):
            shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
        t1 = time.perf_counter()
        res["vit_l_int8"] = run_loop_l(torch, seed, dev, tmp, LOOP_L_DEPTH)
        t2 = time.perf_counter()
        res["from_scratch"] = run_loop_from_scratch(torch, seed, dev, tmp)
        res["phase_seconds"] = {"vit_b": t1 - t0, "vit_l_int8": t2 - t1,
                                "from_scratch": time.perf_counter() - t2}
        return res
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)


# -------------------------- the live ViTPose+ model, the hybrid stem, K4's front door

MOE_CROPS, MOE_TRAIN_CROPS, MOE_ROUNDS = 64, 32, 3
STEM_CHANNELS = (64, 128, 256, 512)      # the /16 grid of PatchEmbed at 256x192
STEM_TRAIN = 2 * LOOP_BATCH              # 2 steps an epoch


def span_err(torch, got, ref) -> float:
    """max |got - ref| relative to ref's range."""
    got, ref = got.float(), ref.float()
    check(bool(torch.isfinite(got).all()), "output is not finite")
    return float((got - ref).abs().max()) / max(float(ref.max() - ref.min()), 1e-30)


def moe_leaves(state, task: str, active: bool) -> dict:
    """The state's weights and moment tensors of the leaves a step of
    ``task`` trains (or leaves alone), by (part, name)."""
    from easy_vitpose_tpu_torch.train import moe_step
    names = [k for k in state["params"] if moe_step.is_active(k, task) == active]
    out = {("params", k): state["params"][k] for k in names}
    opt = state["opt_state"]
    for part in ("mu", "nu"):
        tree = getattr(opt, part)
        if "q_tree" in tree:
            out.update({(part, s, k): tree[s][k] for s in ("q_tree", "s_tree") for k in names})
        else:
            out.update({(part, k): tree[k] for k in names})
    return out


def run_moe(torch, seed, dev) -> dict:
    """The live ViTPose+-B (``models/moe.py``, ``train/moe_step.py``) at full
    width: D 768, 12 blocks, fc2 of 576 shared rows and 6 experts of 192,
    heads of K = 17, 14, 16, 17, 17, 133, random weights from ``seed``."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.convert.model_split import SPLIT_DATASETS, SPLIT_NUM_KPTS
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models import moe
    from easy_vitpose_tpu_torch.train import fused_opt, moe_step
    from easy_vitpose_tpu_torch.train.step import render_batch_on_device

    t_phase = time.perf_counter()
    cfg = get_model_config("coco", "b")
    depth = cfg.backbone.depth
    params = moe.init_vitpose_plus_params(cfg, seed, SPLIT_DATASETS)
    check(params["backbone.blocks.0.mlp.fc2.weight"].shape[0] == PLUS_SHARED
          and params["backbone.blocks.0.mlp.experts.5.weight"].shape[0]
          == cfg.backbone.embed_dim - PLUS_SHARED
          and params["associate_keypoint_heads.4.final_layer.weight"].shape[0] == 133,
          "the ViTPose+-B layout is not 576 + 6 x 192 with a 133-row wholebody head")
    rng = np.random.default_rng(seed + 20)
    res, total = {"serve_err": {}, "serve_launches": {}}, {}

    # serving: each task through K1 against moe_block, and the mixed batch
    sd = moe.plus_params(params, device=dev, dtype=torch.bfloat16)
    x = torch.from_numpy(rng.normal(size=(MOE_CROPS, 256, 192, 3)).astype(np.float32)).to(
        dev, torch.bfloat16)
    with torch.no_grad():
        for task in SPLIT_DATASETS:
            kernels.reset_launch_counts()
            hk = moe.vitpose_plus_forward(sd, x, cfg, task)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            add_counts(total, counts)
            check(counts == {"block": depth}, f"moe {task} forward launched {counts}")
            check(tuple(hk.shape) == (MOE_CROPS, SPLIT_NUM_KPTS[task], 64, 48),
                  f"moe {task} heatmaps {tuple(hk.shape)}")
            err = span_err(torch, hk, moe.vitpose_plus_forward(sd, x, cfg, task, plain=True))
            check(err <= HEATMAP_TOL["bf16"], f"moe {task} heatmaps disagree with plain: {err}")
            res["serve_err"][task], res["serve_launches"][task] = err, counts
        res["serve_ms"] = time_ms(torch, lambda: moe.vitpose_plus_forward(sd, x, cfg, "coco"))
        res["serve_plain_ms"] = time_ms(
            torch, lambda: moe.vitpose_plus_forward(sd, x, cfg, "coco", plain=True))
        onehot = torch.nn.functional.one_hot(torch.arange(MOE_CROPS, device=dev) % 6, 6).float()
        mixed = moe.vit_plus_forward(sd, x, cfg, expert_onehot=onehot)
        res["mixed_err"] = max(span_err(torch, mixed[e::6], moe.vit_plus_forward(
            sd, x[e::6], cfg, expert_idx=e, plain=True)) for e in range(6))
    print(f"moe: serving bf16, 64 crops: heatmaps vs plain {res['serve_err']}; "
          f"{res['serve_ms']:.3f} ms (plain {res['serve_plain_ms']:.3f}); mixed batch vs "
          f"homogeneous features {res['mixed_err']:.3e}")
    check(res["mixed_err"] <= HEATMAP_TOL["bf16"], f"moe mixed batch: {res['mixed_err']}")
    del sd, x, mixed

    # training: AMP, 32 crops a task, f32 moments (K8), three rounds over the tasks
    want = {fbt.FWD: depth, fbt.BWD_MLP: depth, fbt.BWD_ATTN: depth, "grad_norm": 1, "adam": 1}
    batches = {t: train_batch(torch, rng, MOE_TRAIN_CROPS, dev, SPLIT_NUM_KPTS[t])
               for t in SPLIT_DATASETS}

    def rounds(tx, n_rounds, want, vs_plain):
        state = moe_step.init_moe_train_state(params, tx, device=dev)
        steps = {t: moe_step.make_moe_train_step(cfg, tx, t) for t in SPLIT_DATASETS}
        losses, errs = {t: [] for t in SPLIT_DATASETS}, {}
        for r in range(n_rounds):
            for t in SPLIT_DATASETS:
                if vs_plain and r == 0:        # one step's loss and grads against the plain step
                    b = render_batch_on_device(batches[t], dev)
                    lk, _, gk = moe_step.loss_and_grads(cfg, state, b, t)
                    lp, _, gp = moe_step.loss_and_grads(cfg, state, b, t, plain=True)
                    errs[t] = (abs(float(lk) - float(lp)) / abs(float(lp)),
                               max(max_rel_err(torch, gk[k], gp[k])[1] for k in gp))
                    check(errs[t][0] <= STEP_LOSS_TOL and errs[t][1] <= STEP_GRAD_TOL,
                          f"moe {t} step against the plain step: {errs[t]}")
                    del gk, gp
                frozen, moving = moe_leaves(state, t, False), moe_leaves(state, t, True)
                kernels.reset_launch_counts()
                state, m = steps[t](state, batches[t])
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                add_counts(total, counts)
                check(counts == want, f"moe {t} step launched {counts}, expected {want}")
                after = moe_leaves(state, t, False)
                check(all(torch.equal(after[k], v) for k, v in frozen.items()),
                      f"moe {t} step moved another task's weights or moments")
                moved = moe_leaves(state, t, True)
                check(all(not torch.equal(moved[("params", k[1])], moving[("params", k[1])])
                          for k in moving if k[0] == "params" and "experts" in k[1]),
                      f"moe {t} step left its expert slices")
                losses[t].append(float(m["loss"]))
        return state, losses, errs, steps

    state, losses, errs, steps = rounds(fused_opt.make_fused_adam(TRAIN_LR, TRAIN_CLIP),
                                        MOE_ROUNDS, want, True)
    print(f"moe: AMP f32-moment steps vs plain (loss, grads) {errs}; losses by task {losses}")
    check(all(all(math.isfinite(v) for v in ls) and ls[-1] < ls[0] for ls in losses.values()),
          f"moe: a task's loss did not fall: {losses}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def window():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in SPLIT_DATASETS:
            state, _ = steps[t](state, batches[t])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / len(SPLIT_DATASETS)

    res["ms_per_step"] = statistics.median(window() for _ in range(3))
    res["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, steps
    want8 = {**{k: v for k, v in want.items() if k != "adam"}, "adam_q8": 1}
    _, losses8, _, _ = rounds(fused_opt.make_fused_adam(TRAIN_LR, TRAIN_CLIP, "int8"), 1,
                              want8, False)
    check(all(math.isfinite(ls[0]) for ls in losses8.values()), f"moe int8 losses {losses8}")
    res.update({"launches_per_step": want, "launches_per_step_int8": want8,
                "step_vs_plain": errs, "losses": losses, "losses_int8": losses8,
                "launches": total, "phase_s": time.perf_counter() - t_phase})
    print(f"moe: {res['ms_per_step']:.3f} ms a step (32 crops, 6 tasks in turn), peak "
          f"{res['max_memory_allocated_gib']:.2f} GiB; int8 round {losses8}; "
          f"phase {res['phase_s']:.1f} s")
    return res


def run_stem(torch, seed, dev) -> dict:
    """ViT-B with the hybrid CNN stem (``models/stem.py``): the serving
    forward at bf16 and int8, ``train_model`` for 2 epochs of 2 steps
    against the same steps by hand; then the simple head at ViT-B, one
    serving forward and one train step."""
    import shutil
    import tempfile
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy, vitpose_forward
    from easy_vitpose_tpu_torch.train import fused_opt, loop, presets, step as tstep

    t_phase = time.perf_counter()
    cfg = get_model_config("coco", "b", stem_channels=STEM_CHANNELS)
    depth = cfg.backbone.depth
    model = init_params(cfg, seed)
    params = model.state_dict()
    model = model.to(dev)
    rng = np.random.default_rng(seed + 21)
    x = torch.from_numpy(rng.normal(size=(SLOTS, 256, 192, 3)).astype(np.float32)).to(dev)
    res, total = {"serve_err": {}}, {}
    with torch.no_grad():
        for dtype, kernel in (("bf16", "block"), ("int8", "block_q8")):
            sm = serving_copy(model, dtype)
            xs = x.to(torch.bfloat16)
            kernels.reset_launch_counts()
            hk = vitpose_forward(sm, xs)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            add_counts(total, counts)
            check(counts == {kernel: depth}, f"stem {dtype} forward launched {counts}")
            err = span_err(torch, hk, vitpose_forward(sm, xs, plain=True))
            check(err <= HEATMAP_TOL[dtype], f"stem {dtype} heatmaps disagree with plain: {err}")
            res["serve_err"][dtype] = err
            res[f"serve_{dtype}_ms"] = time_ms(torch, lambda: vitpose_forward(sm, xs))
            del sm
    del model
    print(f"stem: serving 64 crops vs plain {res['serve_err']}, "
          f"{res['serve_bf16_ms']:.3f} ms bf16, {res['serve_int8_ms']:.3f} ms int8")

    # train_model, then the same steps by hand
    tmp = tempfile.mkdtemp(prefix="evt_stem_")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train_ds = SmokeDataset(STEM_TRAIN, seed + 14)
        settings = loop_settings(presets, os.path.join(tmp, "stem"), seed, total_epochs=2,
                                 save_full_state=False, save_interval=2)
        with LoopSpy(torch) as spy:
            kernels.reset_launch_counts()
            out = loop.train_model(params, cfg, train_ds, None, settings, log=lambda m: None,
                                   device=dev)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        add_counts(total, counts)
        want = {fbt.FWD: depth, fbt.BWD_MLP: depth, fbt.BWD_ATTN: depth, "grad_norm": 1, "adam": 1}
        check(len(spy.steps) == 4 and all(n == want for n in spy.steps),
              f"a stem loop step launched {spy.steps}, expected {want}")
        check(all(math.isfinite(h["train_loss"]) for h in out["history"]),
              f"stem loop history {out['history']}")
        tx = fused_opt.make_fused_adam(settings.lr)
        state = tstep.init_train_state(params, tx, device=dev)
        step = tstep.make_train_step(cfg, tx, use_amp=True, block_impl="pallas_train",
                                     render_kwargs=dict(heatmap_size=(48, 64), image_size=(192, 256),
                                                        sigma=3.0,
                                                        joints_weight=train_ds.joints_weight,
                                                        use_different_joints_weight=False))
        gen, per, hand = torch.Generator(device=dev), STEM_TRAIN // LOOP_BATCH, []
        for i, batch in enumerate(spy.batches):
            if i % per == 0:
                gen.manual_seed(loop.epoch_generator_seed(seed, i // per))
            state, m = step(state, batch, gen)
            hand.append(m["loss"])
        lk, lh = torch.stack(spy.losses).cpu(), torch.stack(hand).cpu()
        res["loop_losses"], res["loop_by_hand_rel_err"] = lk.tolist(), float(
            ((lk - lh).abs() / lh.abs()).max())
        check(res["loop_by_hand_rel_err"] <= STEP_LOSS_TOL,
              f"stem loop losses differ from the steps by hand: {res['loop_by_hand_rel_err']}")
        del state, step
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"stem: train_model 2 epochs of 2 steps, launches a step {spy.steps[0]}, losses "
          f"{res['loop_losses']}, by hand rel {res['loop_by_hand_rel_err']:.3e}")

    # the simple head at ViT-B: one serving forward, one train step against the plain step
    cfg_s = get_model_config("coco", "b", simple_head=True)
    model_s = init_params(cfg_s, seed).to(dev)
    with torch.no_grad():
        sm = serving_copy(model_s, "bf16")
        xs = x.to(torch.bfloat16)
        kernels.reset_launch_counts()
        hk = vitpose_forward(sm, xs)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        add_counts(total, counts)
        check(counts == {"block": depth} and tuple(hk.shape) == (SLOTS, 17, 64, 48),
              f"simple head forward launched {counts}, heatmaps {tuple(hk.shape)}")
        res["simple_serve_err"] = span_err(torch, hk, vitpose_forward(sm, xs, plain=True))
        check(res["simple_serve_err"] <= HEATMAP_TOL["bf16"],
              f"simple head heatmaps disagree with plain: {res['simple_serve_err']}")
        del sm, x, xs
    tx = fused_opt.make_fused_adam(TRAIN_LR, TRAIN_CLIP)
    state = tstep.init_train_state(model_s, tx, device=dev)
    del model_s
    batch = train_batch(torch, rng, SLOTS, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    masks = draw_drop_path_masks(cfg_s.backbone, SLOTS, gen, dev)
    rendered = tstep.render_batch_on_device(batch, dev)
    lk, _, gk = tstep.loss_and_grads(cfg_s, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks)
    lp, _, gp = tstep.loss_and_grads(cfg_s, state["params"], state["bn_state"], rendered,
                                     drop_path_masks=masks, plain=True)
    res["simple_step_vs_plain"] = (abs(float(lk) - float(lp)) / abs(float(lp)),
                                   max(max_rel_err(torch, gk[k], gp[k])[1] for k in gp))
    check(res["simple_step_vs_plain"][0] <= STEP_LOSS_TOL
          and res["simple_step_vs_plain"][1] <= STEP_GRAD_TOL,
          f"simple head step against the plain step: {res['simple_step_vs_plain']}")
    del gk, gp
    step = tstep.make_train_step(cfg_s, tx, use_amp=True)
    kernels.reset_launch_counts()
    state, m = step(state, batch, drop_path_masks=masks)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    add_counts(total, counts)
    check(counts == want and math.isfinite(float(m["loss"])),
          f"simple head step launched {counts}, loss {float(m['loss'])}")
    res.update({"launches": total, "phase_s": time.perf_counter() - t_phase})
    print(f"stem: simple head serving vs plain {res['simple_serve_err']:.3e}, step vs plain "
          f"{res['simple_step_vs_plain']}; phase {res['phase_s']:.1f} s")
    return res


def check_k4_front_door(torch, model, rng, dev) -> dict:
    """``keypoints_from_heatmaps(use_udp=True, use_pallas=True)`` (the
    library's UDP decode with JAX's ``use_pallas``) on the int8 pose step's
    heatmaps: one full-map K4 launch, against the same call with
    ``use_pallas=False`` on the card (K4's plain version on the same maps):
    scores bit for bit, coordinates within ``DECODE_TOL`` heatmap px.  The
    gap to the CPU's run of the call is printed, not held: the CPU's
    float32 blur differs from the card's in the last bits, and on these
    near-flat random-weight maps the Newton step magnifies that (the
    plain route's own CPU-card gap is printed beside it)."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.ops import decode
    from easy_vitpose_tpu_torch.pipeline import pose_step as ps

    H, W = FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(make_boxes(rng, SLOTS, H, W)).to(dev)
    sm = serving_copy(model, "int8")
    heat, g = ps.pose_heatmaps(sm, frame, boxes)
    center = torch.stack([g["wp"] // 2, g["hp"] // 2], dim=-1).float()
    scale = torch.stack([g["wp"], g["hp"]], dim=-1).float()
    per_px = (scale / torch.tensor([heat.shape[-1] - 1.0, heat.shape[-2] - 1.0], device=dev))[:, None]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pk, vk = decode.keypoints_from_heatmaps(heat, center, scale, use_udp=True, use_pallas=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts == {"modulate": 1}, f"the K4 front door launched {counts}")
    pp, vp = decode.keypoints_from_heatmaps(heat, center, scale, use_udp=True)
    pc, _ = decode.keypoints_from_heatmaps(heat.cpu(), center.cpu(), scale.cpu(), use_udp=True,
                                           use_pallas=True)

    def gap(a, b):
        return float(((a.to(dev) - b.to(dev)) / per_px).abs().max())

    res = {"launches": counts, "scores_bit_equal": bool(torch.equal(vk, vp)),
           "coordinate_gap_px": gap(pk, pp), "cpu_route_gap_px": gap(pk, pc),
           "plain_cpu_card_gap_px": gap(pp, pc), "heatmaps": list(heat.shape),
           "ms": time_ms(torch, lambda: decode.keypoints_from_heatmaps(
               heat, center, scale, use_udp=True, use_pallas=True)),
           "plain_ms": time_ms(torch, lambda: decode.keypoints_from_heatmaps(
               heat, center, scale, use_udp=True))}
    print(f"k4_front_door: launches {counts}, against the card's plain route: scores equal "
          f"{res['scores_bit_equal']}, coordinate gap {res['coordinate_gap_px']:.3e} heatmap px; "
          f"the CPU's run {res['cpu_route_gap_px']:.3e} px (plain on the CPU against the card "
          f"{res['plain_cpu_card_gap_px']:.3e}); {res['ms']:.3f} ms (plain {res['plain_ms']:.3f})")
    check(res["scores_bit_equal"] and res["coordinate_gap_px"] <= DECODE_TOL,
          f"the K4 front door disagrees with its plain route: {res['coordinate_gap_px']}")
    return res

LOOP_L_DEPTH = 24      # ViT-L's full depth


# ---------------------------------------- ViTPose+-H on boxes of mixed tasks
# the task shares of the mixed-task pose step's boxes (SPLIT_DATASETS order:
# coco, aic, mpii, ap10k, apt36k, wholebody), as the benchmark's plus cell
PLUS_H_SHARES = (0.30, 0.10, 0.10, 0.20, 0.10, 0.20)
PLUS_H_MASKED = 4          # the last slots of the mixed-task step are masked
# G1 against the routed product's plain version, relative to max |plain|:
# the output's bf16 cast and a flipped rint(h / s) of the row quantisation
# (TOL["int8"]); a wrong expert or another crop's rows read O(1)
G1_TOL = TOL["int8"]


def check_grouped_gemm(torch, model, tasks, rng, dev) -> dict:
    """G1 (``csrc/gemm_q8.cuh::grouped_gemm_kernel``) at ViT-H's fc2 on
    ``len(tasks)`` crops of 192 rows in task order, block 0's six experts of
    320 rows: the kernel's expert columns (after the residual) against
    ``moe.routed_fc2_plain``'s arithmetic on the same float32 rows and
    experts, a task's group at a time; the same comparison with the experts
    rolled by one and with the rows rolled by a crop, which must fail it;
    and the kernel's, issued and plain times."""
    from types import SimpleNamespace

    from easy_vitpose_tpu_torch.models import moe, quant

    blk = model.backbone.blocks[0]
    E, NE, hidden = blk.ex_wq.shape
    D, T = model.cfg.backbone.embed_dim, 192
    NS, M = D - NE, len(tasks) * T
    r = moe.Routing(tasks, len(model.tasks), T).to(dev)
    m = torch.from_numpy(rng.standard_normal((M, hidden), dtype=np.float32)).to(dev)
    q, sx = quant.rowquant_cuda(m)
    x1 = torch.from_numpy(rng.standard_normal((M, D), dtype=np.float32)).to(dev, torch.bfloat16)
    out = torch.zeros_like(x1)

    def run():
        return quant.gemm_q8_grouped_cuda(q, sx, blk.ex_wq, blk.ex_s, blk.ex_b, r.groups_t,
                                          len(r.groups), x1, out, NS)

    def experts(roll):   # the experts alone: routed_fc2_plain's shared part given 0 rows
        return SimpleNamespace(fc2_wq=blk.fc2_wq[:0], fc2_s=blk.fc2_s[:0], fc2_b=blk.fc2_b[:0],
                               ex_wq=blk.ex_wq.roll(roll, 0), ex_s=blk.ex_s.roll(roll, 0),
                               ex_b=blk.ex_b.roll(roll, 0))

    run()
    got = out[:, NS:]
    ref = x1[:, NS:].float() + moe.routed_fc2_plain(m, experts(0), r)
    err, rel = max_rel_err(torch, got, ref)
    wrong_expert = max_rel_err(torch, got, x1[:, NS:].float()
                               + moe.routed_fc2_plain(m, experts(1), r))[1]
    wrong_rows = max_rel_err(torch, got, ref.roll(T, 0))[1]
    print(f"check G1 grouped GEMM {len(tasks)} crops {r.groups[:, 1].tolist()} rows: "
          f"max_abs_err {err:.3e} rel {rel:.3e}; experts rolled {wrong_expert:.3e}, "
          f"rows rolled {wrong_rows:.3e}")
    check(rel <= G1_TOL, f"G1 disagrees with the routed product's plain version: {rel}")
    check(min(wrong_expert, wrong_rows) > 10 * G1_TOL,
          f"G1's comparison misses a wrong expert ({wrong_expert}) or rows ({wrong_rows})")
    check(bool((out[:, :NS] == 0).all()), "G1 wrote outside its expert columns")
    plain = experts(0)
    nbytes = M * hidden + E * NE * hidden + M * NE * 2.0   # int8 rows, experts, bf16 output
    return {"max_abs_err": err, "rel": rel, "wrong_expert_rel": wrong_expert,
            "wrong_rows_rel": wrong_rows, "rows": r.groups[:, 1].tolist(),
            "ms": device_ms(torch, run), "issued_ms": time_ms(torch, run),
            "plain_ms": time_ms(torch, lambda: moe.routed_fc2_plain(m, plain, r)),
            "bound": bound(nbytes, {"int8": 2.0 * M * hidden * NE}), "library_ms": None}


def run_plus(torch, seed, dev) -> dict:
    """ViTPose+-H int8 served on boxes of mixed tasks: D 1280, 32 blocks,
    fc2 of 960 shared rows and 6 experts of 320, heads of K = 17, 14, 16,
    17, 17, 133, random weights from ``seed``; a 1080p frame and 64 boxes
    from ``seed`` (the last ``PLUS_H_MASKED`` masked), their tasks drawn at
    ``PLUS_H_SHARES``.  G1 against its plain version (:func:`check_grouped_gemm`);
    one ``pose_step(PlusQ8, tasks=)`` queued under PyTorch's synchronisation
    check set to raise, with the launch counts set to 0 just before it: K3
    once, K2 32 times, G1 32 times, the dense int8 GEMM 128 times, one head
    and one decode a task with boxes, 32 x 192 rows a box routed to its
    task's expert and none padded; its keypoints finite, zero in masked
    slots and past each box's K; the routed backbone's features of each
    task's crops equal to the task-spliced int8 model's bit for bit; each
    task's heatmaps within ``DEEP_HEATMAP_TOL`` of the plain step's; ms a
    step and the host's ms to queue one."""
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import IMAGE_SIZE, get_model_config
    from easy_vitpose_tpu_torch.convert.model_split import SPLIT_DATASETS, SPLIT_NUM_KPTS
    from easy_vitpose_tpu_torch.models import moe, quant
    from easy_vitpose_tpu_torch.models.head import heads_forward
    from easy_vitpose_tpu_torch.models.vit import vit_forward
    from easy_vitpose_tpu_torch.models.vitpose import serving_copy
    from easy_vitpose_tpu_torch.ops.sampler import crop_normalize
    from easy_vitpose_tpu_torch.pipeline.pose_step import pose_step

    t_phase = time.perf_counter()
    cfg = get_model_config("coco", "h")
    depth, T = cfg.backbone.depth, cfg.backbone.num_tokens
    params = {k: v.to(dev) for k, v in
              moe.init_vitpose_plus_params(cfg, seed, SPLIT_DATASETS).items()}
    model = moe.PlusQ8(params, cfg)
    check(model.backbone.blocks[0].ex_wq.shape[:2] == (6, 320)
          and model.backbone.blocks[0].fc2_wq.shape[0] == 960,
          "the ViTPose+-H layout is not 960 + 6 x 320")
    rng = np.random.default_rng(seed + 40)
    H, W = FRAME_HW
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(make_boxes(rng, SLOTS, H, W)).to(dev)
    live = np.arange(SLOTS) < SLOTS - PLUS_H_MASKED
    mask = torch.from_numpy(live).to(dev)
    tasks = rng.choice(len(SPLIT_DATASETS), SLOTS, p=PLUS_H_SHARES)
    n = np.bincount(tasks, minlength=len(SPLIT_DATASETS))
    present = [SPLIT_DATASETS[e] for e in range(len(n)) if n[e]]
    res = {"crops": dict(zip(SPLIT_DATASETS, n.tolist()))}
    with torch.no_grad():
        res["G1"] = check_grouped_gemm(torch, model, tasks, rng, dev)

        def step():
            return pose_step(model, frame, boxes, mask, tasks=tasks)

        step()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        moe.reset_routing_counts()
        g0, d0 = quant.grouped_gemm_launches(), sum(quant.gemm_q8_launches().values())
        torch.cuda.set_sync_debug_mode("error")
        try:
            kp = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        res["launches"] = {**counts, "grouped_gemm": quant.grouped_gemm_launches() - g0,
                           "dense_gemm_q8": sum(quant.gemm_q8_launches().values()) - d0}
        res["heads"], res["routed_rows"] = moe.head_launches(), moe.routed_rows()
        print(f"plus: one step of {res['crops']} queued with no host sync: launches "
              f"{res['launches']}, heads {res['heads']}, routed rows {res['routed_rows']}")
        check(counts == {"sampler": 1, "block_q8": depth, "decode": len(present)},
              f"plus step launched {counts}")
        check(res["launches"]["grouped_gemm"] == depth
              and res["launches"]["dense_gemm_q8"] == 4 * depth,
              f"plus step's int8 GEMMs: {res['launches']}")
        check(res["heads"] == {t: 1 for t in present}, f"plus step's heads: {res['heads']}")
        check(res["routed_rows"] == {"padded": 0, **{SPLIT_DATASETS[e]: depth * int(n[e]) * T
                                                     for e in range(len(n)) if n[e]}},
              f"plus step's routed rows: {res['routed_rows']}")
        k_max = max(SPLIT_NUM_KPTS.values())
        check(tuple(kp.shape) == (SLOTS, k_max, 3) and bool(torch.isfinite(kp).all()),
              f"plus keypoints {tuple(kp.shape)}, finite {bool(torch.isfinite(kp).all())}")
        check(int(torch.count_nonzero(kp[~mask])) == 0, "plus step: a masked slot is not zero")
        past = [int(torch.count_nonzero(kp[i, SPLIT_NUM_KPTS[SPLIT_DATASETS[t]]:]))
                for i, t in enumerate(tasks)]
        check(sum(past) == 0, "plus step: rows past a box's K are not zero")

        r = moe.Routing(tasks, len(SPLIT_DATASETS), T).to(dev)
        x, _ = crop_normalize(frame, boxes.index_select(0, r.order_t), IMAGE_SIZE, torch.bfloat16)
        feats = moe.routed_backbone(model, x, r)
        heats = heads_forward(model.heads, feats.permute(0, 3, 1, 2), r.slices, model.tasks)
        plain = heads_forward(model.heads, moe.routed_backbone(model, x, r, plain=True)
                              .permute(0, 3, 1, 2), r.slices, model.tasks)
        res["heatmap_err"] = {SPLIT_DATASETS[e]: span_err(torch, a, b)
                              for (e, _, _), a, b in zip(r.slices, heats, plain)}
        print(f"plus: heatmaps vs plain {res['heatmap_err']}")
        check(max(res["heatmap_err"].values()) <= DEEP_HEATMAP_TOL,
              f"plus heatmaps disagree with the plain step: {res['heatmap_err']}")
        del heats, plain
        res["features_equal"] = {}
        for e, first, end in r.slices:
            spliced = serving_copy(moe.task_model(params, cfg, SPLIT_DATASETS[e]), "int8")
            own = torch.from_numpy(np.flatnonzero(tasks == e)).to(dev)
            xe, _ = crop_normalize(frame, boxes.index_select(0, own), IMAGE_SIZE, torch.bfloat16)
            same = torch.equal(feats[first:end], vit_forward(spliced.backbone, xe))
            res["features_equal"][SPLIT_DATASETS[e]] = same
            del spliced
            torch.cuda.empty_cache()
        print(f"plus: features equal to the spliced int8 model's {res['features_equal']}")
        check(all(res["features_equal"].values()),
              f"plus features differ from the spliced models': {res['features_equal']}")
        del feats, x
        res["ms_per_step"] = time_ms(torch, step)
        queued = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            queued.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        res["host_ms"] = statistics.median(queued)
    res["crops_per_s"] = SLOTS / res["ms_per_step"] * 1e3
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"plus: {res['ms_per_step']:.3f} ms a step ({res['crops_per_s']:.1f} crops/s), host "
          f"{res['host_ms']:.2f} ms to queue one; G1 {res['G1']['ms']:.4f} ms (bound "
          f"{res['G1']['bound'][0]:.4f}, plain {res['G1']['plain_ms']:.3f}); phase "
          f"{res['phase_s']:.1f} s")
    return res


def g1_row(plus: dict) -> dict:
    """The ``kernels`` line's row of G1, from :func:`run_plus`."""
    g = plus["G1"]
    return {"name": "G1 grouped expert GEMM", "route": "cuda",
            "source": "easy_vitpose_tpu_torch/csrc/gemm_q8.cuh",
            "replaces": "easy_vitpose_tpu/models/moe.py:59 (XLA einsums over every expert, "
                        "no Pallas)",
            "launches": plus["launches"]["grouped_gemm"], "max_abs_err": g["max_abs_err"],
            "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound"][0],
            "bound_by": g["bound"][1], "library_ms": None}


def run_plus_phase(torch, seed: int = 0) -> dict:
    """The ViTPose+-H mixed-task phase alone (``python3 -c "import torch,
    chip_smoke as c; c.run_plus_phase(torch)"`` on a machine with a card):
    prints the ``plus:`` line and G1's ``kernels`` row."""
    from easy_vitpose_tpu_torch import kernels

    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means float32 here
    torch.backends.cudnn.allow_tf32 = False
    card = host_record(torch)
    kernels.build()
    res = run_plus(torch, seed, torch.device("cuda"))
    print("plus:", json.dumps(res), "|", card)
    print(json.dumps({"kernels": [g1_row(res)]}))
    return res


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
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
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
        meas["decode"] = check_decode(torch, np.random.default_rng(args.seed + 2), dev)
        steps = run_pose_steps(torch, model, rng, args.reps, dev)
        k4_door = check_k4_front_door(torch, model, np.random.default_rng(args.seed + 5), dev)
        meas["sampler_stacked"] = check_stacked_sampler(torch, np.random.default_rng(args.seed + 4),
                                                        dev)
        frame_np = np.random.default_rng(args.seed + 3).integers(0, 256, (*FRAME_HW, 3),
                                                                 dtype=np.uint8)
        det = check_detector(torch, frame_np, args.seed, dev)
        vi, http, api = run_vitinference(torch, model, frame_np, det, dev)
        ms = run_multistream(torch, frame_np, det["params_x"], args.seed, dev)
        torch.cuda.empty_cache()
        conv = run_convert(torch, model, frame_np, det, args.seed, dev)
        exported = run_export(torch, model, frame_np, args.seed, dev)
        ev = run_eval_coco(torch, model, det, args.seed, dev)
    torch.cuda.empty_cache()
    print("vitinference:", json.dumps(vi))
    print("multistream:", json.dumps(ms))
    print("serve_http:", json.dumps(http))
    print("api:", json.dumps(api), "|", card)
    print("convert:", json.dumps(conv), "|", card)
    print("export:", json.dumps(exported), "|", card)
    print("eval_coco:", json.dumps(ev), "|", card)
    new_paths = {}             # the int8 launches of the convert, export, eval_coco and api phases
    for counts in (conv["launches"], exported["launches"]["int8"], ev["launches"],
                   api["launches_per_frame"]):
        add_counts(new_paths, counts)
    meas.update(check_train_kernels(torch, model, rng, dev))
    gemms = {"vit_b": check_train_gemms(torch, model, rng, dev)}
    train = run_train_step(torch, model, rng, args.seed, dev,
                           (fbt.FWD, fbt.BWD_MLP, fbt.BWD_ATTN))
    rng2 = np.random.default_rng(args.seed + 1)        # the flavors' phases draw apart
    meas.update(check_flavor_kernels(torch, model, rng2, dev))
    train_b_saved = run_train_step(torch, model, rng2, args.seed, dev,
                                   (fbt.FWD, fbt.BWD_MLP_MS, fbt.BWD_ATTN_SAVED),
                                   flavor={"EVT_TRAIN_ATTN": "saved", "EVT_TRAIN_MLP": "saved"})
    accum = run_accum_step(torch, model, rng2, args.seed, dev)
    par_b = run_sharded_one_rank(torch, model, rng2, args.seed, dev,
                                 (fbt.FWD, fbt.BWD_MLP, fbt.BWD_ATTN), "f32")
    del model
    model_l = init_params(get_model_config("coco", "l"), args.seed).to(dev)
    meas.update(check_wide_kernels(torch, model_l, rng, dev))
    gemms["vit_l"] = check_train_gemms(torch, model_l, rng, dev)
    train_l = run_train_step(torch, model_l, rng, args.seed, dev,
                             (fbt.FWD, fbt.BWD_MLP_DX_SAVE, fbt.BWD_MLP_DW_SAVED, fbt.BWD_ATTN),
                             moments="int8")
    meas.update(check_wide_flavor_kernels(torch, model_l, rng2, dev))
    train_l_recompute = run_train_step(
        torch, model_l, rng2, args.seed, dev,
        (fbt.FWD, fbt.BWD_MLP_DX, fbt.BWD_MLP_DW, fbt.BWD_ATTN), moments="int8",
        flavor={"EVT_TRAIN_WIDE": "recompute"})
    train_l_saved_m = run_train_step(
        torch, model_l, rng2, args.seed, dev,
        (fbt.FWD, fbt.BWD_MLP_DX_SAVE_MS, fbt.BWD_MLP_DW_SAVED, fbt.BWD_ATTN), moments="int8",
        flavor={"EVT_TRAIN_MLP": "saved"})
    par_l = run_sharded_one_rank(torch, model_l, rng2, args.seed, dev,
                                 (fbt.FWD, fbt.BWD_MLP_DX_SAVE, fbt.BWD_MLP_DW_SAVED, fbt.BWD_ATTN),
                                 "int8")
    del model_l
    torch.cuda.empty_cache()
    loop = run_train_loop(torch, args.seed, dev, train["ms_per_step"])
    loop_counts = {}           # the loop phase's launches, added to the rows it runs
    for run in ("vit_b", "vit_l_int8", "from_scratch"):
        for k, n in loop[run]["launches"].items():
            loop_counts[k] = loop_counts.get(k, 0) + n
    torch.cuda.empty_cache()
    moe_res = run_moe(torch, args.seed, dev)
    torch.cuda.empty_cache()
    stem_res = run_stem(torch, args.seed, dev)
    torch.cuda.empty_cache()
    par_ranks = run_parallel_ranks(torch, args.seed)
    torch.cuda.empty_cache()
    plus = run_plus(torch, args.seed, dev)
    torch.cuda.empty_cache()
    phase_counts = {}          # the moe, stem, K4 front-door, parallel and plus phases' launches
    for counts in (moe_res["launches"], stem_res["launches"], k4_door["launches"],
                   par_b["launches"], par_l["launches"], plus["launches"]):
        add_counts(phase_counts, counts)
    for name in ("two_program", "single_dispatch", "boxes_given"):
        add_counts(phase_counts, ms["sharded"][name]["launches_per_tick"])

    rows = []
    spec = (("K1 fused_block bf16", "bf16", "block.cu", "models/fused_block.py:51", "bf16", "block"),
            ("K1 fused_block fp32", "fp32", "block.cu", "models/fused_block.py:51", "fp32", "block"),
            ("K2 fused_block_q8 int8", "int8", "block_q8.cu", "models/quant.py:171", "int8", "block_q8"),
            ("K3 crop_normalize", "sampler", "sampler.cu", "ops/pallas_sampler.py:46", "int8", "sampler"),
            ("K4 udp_modulate full map", "modulate", "modulate.cu", "ops/pallas_kernels.py:23", "int8",
             "modulate"),
            ("K4 decode_keypoints fused UDP decode", "decode", "decode.cu",
             "ops/pallas_kernels.py:23", "int8", "decode"),
            ("K1 fp32 gemm_tf32 (the block's four 3xTF32 GEMMs)", "gemm_tf32", "gemm_tf32.cuh",
             "models/fused_block.py:51", "fp32", "gemm_tf32"),
            ("K1 fp32 tf32_split (the block's four weights' TF32 halves)", "tf32_split",
             "gemm_tf32.cuh", "models/fused_block.py:51", "fp32", "tf32_split"))
    for name, key, src, replaces, run, counter in spec:
        m = meas[key]
        rows.append({"name": name, "route": "cuda",
                     "source": f"easy_vitpose_tpu_torch/csrc/{src}",
                     "replaces": f"easy_vitpose_tpu/{replaces}",
                     # the split runs once per weight, when the fp32 copy is made
                     "launches": steps[run]["copy_launches" if counter == "tf32_split"
                                            else "launches"].get(counter, 0),
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                     "library_ms": m["library_ms"]})
    # K3, D1 and D2 also launch once per multi-stream tick, stacked
    tick = ms["two_program_sync"]["launches_per_tick"]
    rows[3]["launches"] += int(tick.get("sampler", 0))
    rows[0]["launches"] += loop_counts.get("block", 0)       # the loop's bf16 validation
    # the .pt2 comparisons' kernel forwards, the ViTPose+ tasks and the eval lanes
    rows[0]["launches"] += exported["launches"]["bf16"].get("block", 0)
    rows[1]["launches"] += exported["launches"]["fp32"].get("block", 0)
    for i, counter in ((1, "block"), (6, "gemm_tf32")):   # the default fp32 frame
        rows[i]["launches"] += vi["fp32_image"]["launches_per_frame"].get(counter, 0)
    rows[6]["launches"] += exported["launches"]["fp32"].get("gemm_tf32", 0)
    for i, counter in ((2, "block_q8"), (3, "sampler"), (5, "decode")):
        rows[i]["launches"] += new_paths.get(counter, 0)
    for i, counter in ((0, "block"), (2, "block_q8"), (3, "sampler"), (4, "modulate"),
                       (5, "decode")):   # all bf16 K1
        rows[i]["launches"] += phase_counts.get(counter, 0)
    d = det["configs"]["n320_bf16_square"]              # the detector of the main path
    for name, src, replaces, counter, pre in (
            ("D1 letterbox", "letterbox.cu", "detect/yolo.py:293 (XLA, no Pallas)", "letterbox", "d1"),
            ("D2 nms", "nms.cu", "detect/yolo.py:196 (XLA, no Pallas)", "nms", "d2")):
        rows.append({"name": name, "route": "cuda", "source": f"easy_vitpose_tpu_torch/csrc/{src}",
                     "replaces": f"easy_vitpose_tpu/{replaces}",
                     "launches": (vi["int8_image"]["launches_per_frame"].get(counter, 0)
                                  + int(tick.get(counter, 0)) + new_paths.get(counter, 0)
                                  + phase_counts.get(counter, 0)),
                     "max_abs_err": d[f"{pre}_err"], "ms": d[f"{pre}_ms"],
                     "plain_ms": d[f"{pre}_plain_ms"], "bound_ms": d[f"{pre}_bound"][0],
                     "bound_by": d[f"{pre}_bound"][1], "library_ms": None})
    rows.append(g1_row(plus))
    train_spec = (("K5 train_forward", "K5", "models/fused_block_train.py:95", "train_fwd", train),
                  ("K6a mlp_backward", "K6a", "models/fused_block_train.py:195", "train_bwd_mlp", train),
                  ("K6b mlp_backward_dx_save", "K6b", "models/fused_block_train.py:280",
                   "train_bwd_mlp_dx_save", train_l),
                  ("K6c mlp_backward_dw_saved", "K6c", "models/fused_block_train.py:340",
                   "train_bwd_mlp_dw_saved", train_l),
                  ("K7 attn_backward", "K7", "models/fused_block_train.py:404", "train_bwd_attn", train),
                  ("K8 adam_table", "K8", "train/fused_opt.py:154", "adam", train),
                  ("K9 adam_table_q8", "K9", "train/fused_opt.py:266", "adam_q8", train_l),
                  ("K6a_ms mlp_backward saved m", "K6a_ms", "models/fused_block_train.py:267",
                   fbt.BWD_MLP_MS, train_b_saved),
                  ("K6b_ms mlp_backward_dx_save saved m", "K6b_ms",
                   "models/fused_block_train.py:327", fbt.BWD_MLP_DX_SAVE_MS, train_l_saved_m),
                  ("K6d mlp_backward_dx", "K6d", "models/fused_block_train.py:237", fbt.BWD_MLP_DX,
                   train_l_recompute),
                  ("K6e mlp_backward_dw", "K6e", "models/fused_block_train.py:368", fbt.BWD_MLP_DW,
                   train_l_recompute),
                  ("K7_saved attn_backward saved qkv", "K7_saved", "models/fused_block_train.py:507",
                   fbt.BWD_ATTN_SAVED, train_b_saved))
    for name, key, replaces, counter, run in train_spec:
        m = meas[key]
        src = {"K8": "adam.cu", "K9": "adam_q8.cu"}.get(key, "train_block.cu")
        rows.append({"name": name, "route": "cuda",
                     "source": f"easy_vitpose_tpu_torch/csrc/{src}",
                     "replaces": f"easy_vitpose_tpu/{replaces}",
                     "launches": (run["launches"].get(counter, 0) + loop_counts.get(counter, 0)
                                  + phase_counts.get(counter, 0)),
                     "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"],
                     "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
                     "library_ms": m["library_ms"]})
    print("train_step:", json.dumps({k: v for k, v in train.items() if k != "launches"}))
    print("train_step_l_int8:", json.dumps({k: v for k, v in train_l.items() if k != "launches"}))
    print("crop_and_decode:", json.dumps({k: {f: meas[k][f] for f in (
        "ms", "issued_ms", "plain_ms", "bound")} for k in ("sampler", "modulate", "decode")}))
    print("optimizer:", json.dumps({k: {f: meas[k][f] for f in (
        "ms", "table_ms", "norm_ms", "plain_ms", "library_ms", "host_ms", "bound", "table_bound",
        "norm_bound", "norm_plain_ms", "norm_library_ms")} for k in ("K8", "K9")}))
    for label, run in (("train_step_b_saved_qkv_m", train_b_saved),
                       ("train_step_l_int8_wide_recompute", train_l_recompute),
                       ("train_step_l_int8_saved_m", train_l_saved_m),
                       ("train_step_b_grad_accum2_ema", accum)):
        print(label + ":", json.dumps({k: v for k, v in run.items() if k != "launches"}))
    print("train_gemms:", json.dumps(gemms))
    print("detector:", json.dumps(det["configs"]))
    print("detector_stacked:", json.dumps(det["stacked"]))
    print("sampler_stacked:", json.dumps(meas["sampler_stacked"]))
    print("pose_steps:", json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                     for k, v in steps.items()}))
    # the norm kernel on ViT-B's leaves, launched once by the main path's step
    opt = meas["K8"]
    print("grad_norm:", json.dumps({
        "name": "grad_norm global norm and clip scale", "route": "cuda",
        "source": "easy_vitpose_tpu_torch/csrc/grad_norm.cu",
        "replaces": "easy_vitpose_tpu/train/fused_opt.py:399 (XLA inside fused_apply, no Pallas)",
        "launches": (train["launches"].get("grad_norm", 0) + loop_counts.get("grad_norm", 0)
                     + phase_counts.get("grad_norm", 0)),
        "max_abs_err": opt["norm_abs_err"],
        "ms": opt["norm_ms"], "plain_ms": opt["norm_plain_ms"],
        "bound_ms": opt["norm_bound"][0], "bound_by": opt["norm_bound"][1],
        "library_ms": opt["norm_library_ms"]}))
    print("train_loop:", json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "history"}
                                          if isinstance(v, dict) else v)
                                      for k, v in loop.items()}))
    print("k4_front_door:", json.dumps(k4_door), "|", card)
    print("moe:", json.dumps({k: v for k, v in moe_res.items() if k != "launches"}), "|", card)
    print("stem:", json.dumps({k: v for k, v in stem_res.items() if k != "launches"}), "|", card)
    print("plus:", json.dumps({k: v for k, v in plus.items() if k != "launches"}), "|", card)
    print("parallel:", json.dumps({
        "one_rank_nccl": {"vit_b_f32": par_b, "vit_l_int8": par_l},
        "two_ranks_gloo_cuda": par_ranks, "sharded_serving": ms["sharded"],
        "sharded_eval": ev["gt_crops_sharded"]}), "|", card)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
