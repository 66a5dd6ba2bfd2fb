"""Multi-stream serving CLI of the port: N videos through one card, batched
and pipelined.

Port of ``easy_vitpose_tpu/cli/serve.py`` with the same parser, on
``pipeline/stream.py::MultiStreamPose``: every stream shares one batched
detector program and one pose step per tick, and the pipelined schedule
hides host tracking under the card's work.  Runs on CUDA unless
``--device cpu`` is given.  Video input needs cv2.  ``--shard-streams``
puts the streams in per-device blocks over a ``batch`` mesh of the local
CUDA devices (or of ``--devices``), a model and detector replica on each.

Usage:
  python -m easy_vitpose_tpu_torch.cli.serve --inputs a.mp4 b.mp4 c.mp4 \\
      --model vitpose-b-coco.npz --model-name b --yolo yolov8n.npz \\
      --output-path out/ --save-json
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..configs import get_model_config, infer_dataset_by_path
from ..kernels import resolve_device
from ..utils.io import NumpyEncoder, VideoReader


def build_parser():
    p = argparse.ArgumentParser(description="multi-stream pose serving on the card")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="video paths (one per stream; same resolution)")
    p.add_argument("--model", required=True)
    p.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    p.add_argument("--dataset", default=None)
    p.add_argument("--yolo", default=None)
    p.add_argument("--yolo-size", type=int, default=640)
    p.add_argument("--yolo-step", type=int, default=1)
    p.add_argument("--max-people-per-stream", type=int, default=8)
    p.add_argument("--tracker", default="sort", choices=["sort", "bytetrack"],
                   help="per-stream tracker; 'bytetrack' sustains tracks through "
                        "low-confidence (blur/occlusion) windows")
    p.add_argument("--smooth", action="store_true",
                   help="per-track One-Euro keypoint smoothing per stream "
                        "(same filter as cli/infer --smooth)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32", "int8"])
    p.add_argument("--no-pipeline", action="store_true",
                   help="synchronous ticks (pipelined is the default)")
    p.add_argument("--single-dispatch", action="store_true",
                   help="detector + pose as one program per detection tick "
                        "(pipeline/fused_detect.py): IDs identical, pose crops use the "
                        "raw detection boxes instead of the Kalman-updated ones")
    p.add_argument("--shard-streams", action="store_true",
                   help="shard the streams across the local devices (a replica on each; "
                        "the stream count must divide evenly)")
    p.add_argument("--devices", nargs="+", default=None,
                   help="the mesh's entries for --shard-streams (default: every local "
                        "CUDA device; the --device once where it is the CPU)")
    p.add_argument("--device", default=None,
                   help="torch device to run on; default CUDA ('cpu' runs the kernels' "
                        "plain versions)")
    p.add_argument("--max-ticks", type=int, default=0)
    p.add_argument("--output-path", default="")
    p.add_argument("--save-json", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..pipeline.inference import load_pose_model
    from ..pipeline.stream import MultiStreamPose

    device = resolve_device(args.device)
    dataset = args.dataset or infer_dataset_by_path(args.model)
    cfg = get_model_config(dataset, args.model_name)
    model = load_pose_model(args.model, cfg, args.dtype, device)

    detector = None
    if args.yolo:
        from ..detect.yolo import YoloDetector
        from ..track.bytetrack import LOW_THRESHOLD
        # bytetrack needs the low-confidence band past the detector's NMS gate
        det_conf = LOW_THRESHOLD if args.tracker == "bytetrack" else 0.25
        dtype = torch.float32 if args.dtype == "fp32" else torch.bfloat16
        detector = YoloDetector(args.yolo, imgsz=args.yolo_size, classes=(0,), conf=det_conf,
                                dtype=dtype, rect=True, device=device)

    mesh = None
    if args.shard_streams:
        from ..parallel.mesh import make_mesh
        devices = args.devices or ([device] if device.type == "cpu" else None)
        mesh = make_mesh(axis="batch", devices=devices)

    ms = MultiStreamPose(model, detector=detector, n_streams=len(args.inputs),
                         yolo_step=args.yolo_step,
                         max_people_per_stream=args.max_people_per_stream,
                         smooth=args.smooth, tracker=args.tracker,
                         single_dispatch=args.single_dispatch, mesh=mesh)

    readers = [iter(VideoReader(p)) for p in args.inputs]
    logs = [[] for _ in args.inputs]
    tick = 0
    t0 = time.perf_counter()

    def record(res):
        if res is None:
            return
        for si, r in enumerate(res):
            logs[si].append({str(k): v for k, v in r.items()})

    while True:
        frames = []
        for r in readers:
            f = next(r, None)
            if f is None:
                break
            frames.append(f)
        if len(frames) < len(readers):
            break
        if args.no_pipeline:
            record(ms.step(frames))
        else:
            record(ms.step_pipelined(frames))
        tick += 1
        if args.max_ticks and tick >= args.max_ticks:
            break
    if not args.no_pipeline:
        record(ms.flush())

    dt = time.perf_counter() - t0
    if tick:
        print(f">>> {tick} ticks x {len(args.inputs)} streams, {dt / tick * 1e3:.1f} ms/tick "
              f"({len(args.inputs) * tick / dt:.1f} stream-fps)")
    if args.save_json and args.output_path:
        os.makedirs(args.output_path, exist_ok=True)
        for path, log in zip(args.inputs, logs):
            base = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(args.output_path, base + "_keypoints.json")
            with open(out, "w") as f:
                json.dump({"keypoints": log}, f, cls=NumpyEncoder)
            print(f">>> wrote {out}")
    return logs


if __name__ == "__main__":
    main()
