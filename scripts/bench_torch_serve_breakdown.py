#!/usr/bin/env python3
"""Where a graphed image frame and an 8-stream multi-stream tick spend
their time, on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/bench_torch_serve_breakdown.py [--seed 0] [--ticks 6]

Each stage of a serving step runs alone, the card synchronised before and
after it, and is timed on the host clock (median over the repetitions):

* the image frame (ViT-B int8 + YOLOv8n/320, 1080p, 64 slots, the
  ``detect_pose`` graph of ``VitInference``): the upload, the replay's
  device time, the one fetch, and the host's work after it (unpack, gate,
  tracker stage, the result dict);
* the two-program multi-stream tick (ViT-H int8 + YOLOv8x/640 rect bf16,
  8 streams of 1080p, 8 people a stream, ``MultiStreamPose``): stacking the
  frames, the upload, the batched detector graph, the detections' fetch and
  gate, the 8 trackers, queueing the pose step and its device time, the
  fetch and the result dicts.

Inputs are chip_smoke.py's: the seed's noise frame, random weights from the
seed, detector weights scaled on the frame.  Prints one JSON line per
breakdown and the card line.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stage_ms(torch, fn, reps: int):
    """Median host ms of ``fn`` between two synchronisations, and its last
    result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def image_frame(torch, cs, frame_np, seed, reps: int) -> dict:
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.pipeline.inference import VitInference

    model = init_params(get_model_config("coco", "b"), seed)
    with tempfile.TemporaryDirectory() as d:
        pose, det = os.path.join(d, "vitpose-b-coco.npz"), os.path.join(d, "yolov8n.npz")
        cs.save_pose_npz(pose, model)
        yolo.save_yolo_npz(det, yolo.init_yolo_params(seed, yolo.YoloSpec("n"), frame_np, 320),
                           "n")
        vi = VitInference(pose, yolo=det, model_name="b", dtype="int8")
    for _ in range(3):
        vi.inference(frame_np)
    d_ = vi._detector
    out = {}
    out["frame_ms"], _ = stage_ms(torch, lambda: vi.inference(frame_np), reps)
    out["upload_ms"], frame = stage_ms(torch, lambda: vi._upload(frame_np), reps)
    key = ("detect_pose", tuple(frame.shape), vi._slots_highwater, vi._gate())
    out["replay_ms"], (packed, kpts) = stage_ms(torch, lambda: d_.graphs.run(key, None, frame),
                                                reps)
    out["fetch_ms"], _ = stage_ms(torch, lambda: torch.cat([packed.reshape(-1),
                                                            kpts.reshape(-1)]).cpu(), reps)
    out["host_after_fetch_ms"] = out["frame_ms"] - sum(out[k] for k in ("upload_ms", "replay_ms",
                                                                      "fetch_ms"))
    return out


def multistream_tick(torch, frame_np, seed, reps: int) -> dict:
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.detect import yolo
    from easy_vitpose_tpu_torch.models.vitpose import init_params, serving_copy
    from easy_vitpose_tpu_torch.pipeline.stream import MultiStreamPose
    from easy_vitpose_tpu_torch.track.sort import track_and_cap

    dev = torch.device("cuda")
    model = serving_copy(init_params(get_model_config("coco", "h"), seed).to(dev), "int8")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "yolov8x.npz")
        yolo.save_yolo_npz(path, yolo.init_yolo_params(seed, yolo.YoloSpec("x"), frame_np, 640),
                           "x")
        det = yolo.YoloDetector(path, imgsz=640, classes=(0,), conf=0.25, dtype=torch.bfloat16,
                                rect=True)
    ms = MultiStreamPose(model, detector=det, n_streams=8, max_people_per_stream=8)
    frames = [np.roll(frame_np, 240 * s, axis=1) for s in range(8)]
    for _ in range(3):
        ms.step(frames)
    H, W = frame_np.shape[:2]
    out = {}
    out["tick_ms"], _ = stage_ms(torch, lambda: ms.step(frames), reps)
    out["stack_ms"], stack = stage_ms(torch, lambda: np.stack(frames), reps)
    out["upload_ms"], frames_dev = stage_ms(torch, lambda: ms._upload(frames), reps)
    out["detector_ms"], packed = stage_ms(torch, lambda: det.detect_batch_async(frames_dev), reps)
    out["det_fetch_gate_ms"], boxes = stage_ms(
        torch, lambda: ms._boxes_from_detect(packed, (H, W)), reps)
    out["detections_per_stream"] = [len(b) for b in boxes]
    out["tracking_ms"], _ = stage_ms(
        torch, lambda: [track_and_cap(t, b, 8) for t, b in zip(ms.trackers, boxes)], reps)
    # the pose step: the host's time to queue it, then the card's to finish it
    queue, total = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle, book = ms._track_and_pose(frames_dev, boxes)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        queue.append((t1 - t0) * 1e3)
        total.append((time.perf_counter() - t0) * 1e3)
    out["track_and_queue_pose_ms"] = statistics.median(queue)
    out["track_and_pose_ms"] = statistics.median(total)
    out["fetch_collect_ms"], _ = stage_ms(torch, lambda: ms._collect(handle, book), reps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_serve_breakdown: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cudnn.allow_tf32 = False
    card = cs.host_record(torch)
    frame_np = np.random.default_rng(args.seed + 3).integers(0, 256, (*cs.FRAME_HW, 3),
                                                             dtype=np.uint8)
    with torch.no_grad():
        print("image_frame:", json.dumps(image_frame(torch, cs, frame_np, args.seed, args.reps)))
        print("multistream_tick:", json.dumps(multistream_tick(torch, frame_np, args.seed,
                                                               args.reps)))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
