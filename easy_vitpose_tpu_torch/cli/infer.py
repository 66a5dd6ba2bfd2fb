"""Inference CLI of the port: image / video / webcam / directory input,
FPS stats, annotated image/video output, JSON keypoint dumps.

Port of ``easy_vitpose_tpu/cli/infer.py`` with the same parser and flag
rules.  Runs on CUDA unless ``--device cpu`` is given.  Video modes:
``--pipelined`` (``VitInference.inference_pipelined``, one frame late),
``--batch N`` (offline windows of N frames, ``inference_batched``) and
``--target-fps`` (``pipeline/autotune.py`` retunes ``yolo_step``).  Media
input and output need cv2.

Usage:
  python -m easy_vitpose_tpu_torch.cli.infer --input video.mp4 --model ckpt.npz \\
      --model-name b [--yolo yolov8n.npz] [--output-path out/] [--save-json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from glob import glob

import numpy as np

from ..pipeline.inference import VitInference
from ..skeletons import joints_dict
from ..utils.io import NumpyEncoder, VideoReader, video_metadata

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ViTPose inference on the card (PyTorch + CUDA)")
    p.add_argument("--input", required=True,
                   help="image / video path, webcam index, or directory")
    p.add_argument("--output-path", default="",
                   help="output dir (annotated media + json)")
    p.add_argument("--model", required=True, help=".npz or .pth checkpoint")
    p.add_argument("--model-name", default=None, choices=["s", "b", "l", "h"])
    p.add_argument("--yolo", default=None, help="YOLOv8 .npz checkpoint")
    p.add_argument("--dataset", default=None)
    p.add_argument("--det-class", default=None)
    p.add_argument("--yolo-size", type=int, default=320)
    p.add_argument("--yolo-step", type=int, default=1)
    p.add_argument("--rotate", type=int, default=0, choices=[0, 90, 180, 270])
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32", "int8"])
    p.add_argument("--single-pose", action="store_true")
    p.add_argument("--tracker", default="sort", choices=["sort", "bytetrack"],
                   help="video tracker: 'sort' (reference behaviour) or 'bytetrack' "
                        "(low-confidence detections sustain tracks)")
    p.add_argument("--smooth", action="store_true",
                   help="One-Euro temporal keypoint smoothing per track (video only)")
    p.add_argument("--show", action="store_true")
    p.add_argument("--show-yolo", action="store_true")
    p.add_argument("--show-raw-yolo", action="store_true")
    p.add_argument("--save-img", action="store_true")
    p.add_argument("--save-json", action="store_true")
    p.add_argument("--conf-threshold", type=float, default=0.5)
    p.add_argument("--fixed-slots", type=int, default=None,
                   help="pin the pose-batch slot count (video defaults to grow-only "
                        "high-water bucketing)")
    p.add_argument("--device", default=None,
                   help="torch device to run on; default CUDA ('cpu' runs the kernels' "
                        "plain versions)")
    p.add_argument("--pipelined", action="store_true",
                   help="video: queue frame t's detection before fetching frame t-1's "
                        "pose (results one frame late)")
    p.add_argument("--batch", type=int, default=0,
                   help="offline video: windows of N frames, one batched detector program "
                        "and one multi-frame pose step each (0 = off)")
    p.add_argument("--target-fps", type=float, default=None,
                   help="video/webcam: auto-tune yolo_step to hold this frame rate")
    p.add_argument("--single-dispatch", action="store_true", default=None,
                   help="queue detector + pose as one unit with one fetch on detection "
                        "frames; default on for images / --single-pose, opt-in for video "
                        "tracker mode (pose crops come from the raw detection boxes)")
    p.add_argument("--no-single-dispatch", dest="single_dispatch", action="store_false",
                   help="force the two-step (detect, fetch, then pose) path")
    p.add_argument("--trace", default="", metavar="LOGDIR",
                   help="write a torch.profiler Chrome trace of the run to "
                        "LOGDIR/trace.json")
    return p


VIDEO_EXTS = (".mp4", ".mov", ".avi", ".mkv", ".webm")
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def run_one(args, input_path: str) -> None:
    ext = os.path.splitext(str(input_path))[1].lower()
    is_video = ext in VIDEO_EXTS or str(input_path).isdigit()
    if cv2 is None:
        raise SystemExit("media input needs cv2 (opencv), which is not installed")

    out_writer = None
    keypoints_log = []
    fps_hist = []

    if is_video:
        frames = VideoReader(input_path, rotate=args.rotate)
        meta = (video_metadata(input_path)
                if not str(input_path).isdigit() else {"fps": 30})
    else:
        img = cv2.imread(str(input_path))
        if img is None:
            raise SystemExit(f"cannot read {input_path}")
        frames = [cv2.cvtColor(img, cv2.COLOR_BGR2RGB)]
        meta = {"fps": 1}

    single_dispatch = args.single_dispatch
    if single_dispatch is None and (args.batch or args.pipelined):
        # the default-on resolution (images / --single-pose) must not leak
        # into the modes with their own dispatch schedules
        single_dispatch = False
    smooth_params = ({"fps": float(meta["fps"])}
                     if args.smooth and is_video and meta.get("fps") else None)
    model = VitInference(args.model, yolo=args.yolo, model_name=args.model_name,
                         det_class=args.det_class, dataset=args.dataset,
                         yolo_size=args.yolo_size, is_video=is_video,
                         single_pose=args.single_pose, yolo_step=args.yolo_step,
                         dtype=args.dtype, smooth=args.smooth, smooth_params=smooth_params,
                         fixed_slots=args.fixed_slots, device=args.device,
                         tracker=args.tracker, single_dispatch=single_dispatch)
    print(f">>> model loaded: {args.model} (dataset={model.dataset}, dtype={args.dtype}, "
          f"device={model.device})")

    save_media = (args.save_img or args.show) or bool(args.output_path)
    base = os.path.splitext(os.path.basename(str(input_path)))[0]

    tuner = None
    if args.target_fps and is_video:
        from ..pipeline.autotune import YoloStepAutoTuner
        tuner = YoloStepAutoTuner(args.target_fps, min_step=args.yolo_step)

    use_pipeline = args.pipelined and is_video and args.yolo
    frame_iter = iter(frames)

    def stream():
        if args.batch and is_video and not str(input_path).isdigit():
            # offline windows: one batched detector program and one
            # multi-frame pose step per window of N frames
            def emit(window):
                outs = model.inference_batched(window)
                for k, (fr, out) in enumerate(zip(window, outs)):
                    if save_media:
                        model.select_frame_state(k)  # draw() per frame
                    yield fr, out

            window = []
            for f in frame_iter:
                window.append(f)
                if len(window) == args.batch:
                    yield from emit(window)
                    window = []
            if window:
                yield from emit(window)
            return
        if not use_pipeline:
            for f in frame_iter:
                yield f, model.inference(f)
            return
        prev = None
        for f in frame_iter:
            out = model.inference_pipelined(f)
            if out is not None:
                yield prev, out
            prev = f
        out = model.flush()
        if out is not None:
            yield prev, out

    t_prev = time.perf_counter()
    for i, (frame, kpts) in enumerate(stream()):
        now = time.perf_counter()
        dt = now - t_prev
        t_prev = now
        fps_hist.append(1.0 / max(dt, 1e-9))
        if tuner is not None and i >= 3:  # the first frames build the kernels
            new_step = tuner.update(dt)
            if new_step != model.yolo_step:
                print(f">>> auto-tune: yolo_step -> {new_step} "
                      f"(ema {1.0 / max(tuner._avg_dt, 1e-9):.1f} fps, "
                      f"target {args.target_fps})")
                model.set_yolo_step(new_step)
        if args.save_json:
            keypoints_log.append({str(k): v for k, v in kpts.items()})
        if save_media:
            drawn = model.draw(show_yolo=args.show_yolo, show_raw_yolo=args.show_raw_yolo,
                               confidence_threshold=args.conf_threshold)
            bgr = np.ascontiguousarray(drawn[..., ::-1])
            if args.show:
                cv2.imshow("easy_vitpose_tpu_torch", bgr)
                cv2.waitKey(1)
            if args.output_path:
                os.makedirs(args.output_path, exist_ok=True)
                if is_video:
                    if out_writer is None:
                        h, w = bgr.shape[:2]
                        for codec in ("avc1", "mp4v", "MJPG"):
                            out_writer = cv2.VideoWriter(
                                os.path.join(args.output_path, base + "_out.mp4"),
                                cv2.VideoWriter_fourcc(*codec), meta.get("fps", 30) or 30,
                                (w, h))
                            if out_writer.isOpened():
                                break
                    out_writer.write(bgr)
                elif args.save_img:
                    cv2.imwrite(os.path.join(args.output_path, base + "_out.png"), bgr)

    if out_writer is not None:
        out_writer.release()
    if args.save_json and args.output_path:
        os.makedirs(args.output_path, exist_ok=True)
        out_json = os.path.join(args.output_path, base + "_keypoints.json")
        with open(out_json, "w") as f:
            json.dump({"keypoints": keypoints_log,
                       "skeleton": joints_dict()[model.dataset]["keypoints"]},
                      f, cls=NumpyEncoder)
        print(f">>> keypoints saved to {out_json}")
    if fps_hist:
        steady = fps_hist[3:] or fps_hist   # the first frames build the kernels
        print(f">>> frames: {len(fps_hist)}  mean FPS (steady): {np.mean(steady):.1f}")


@contextlib.contextmanager
def _trace(logdir: str):
    """A torch.profiler trace of the block, written to logdir/trace.json."""
    from torch.profiler import ProfilerActivity, profile
    import torch
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def check_flags(args) -> None:
    """JAX's mode-conflict rules, checked before the model loads."""
    if args.batch and (args.target_fps or args.pipelined):
        raise SystemExit(
            "--batch is the offline windowed mode; it is incompatible with the live-pacing "
            "flags --target-fps (the auto-tuner needs steady per-frame timing, not "
            "whole-window bursts) and --pipelined (the window already overlaps detect "
            "and pose)")
    if args.single_dispatch and (args.batch or args.pipelined):
        raise SystemExit(
            "--single-dispatch fuses detector+pose into one program on plain per-frame "
            "inference only; --pipelined and --batch route through their own dispatch "
            "schedules and would silently ignore it")


def main(argv=None):
    args = build_parser().parse_args(argv)
    check_flags(args)
    with (_trace(args.trace) if args.trace else contextlib.nullcontext()):
        if os.path.isdir(args.input):
            inputs = sorted(sum((glob(os.path.join(args.input, "*" + e))
                                 for e in VIDEO_EXTS + IMAGE_EXTS), []))
            if not inputs:
                raise SystemExit(f"no media found in {args.input}")
            for p in inputs:
                run_one(args, p)
        else:
            run_one(args, args.input)
    if args.trace:
        print(f">>> trace written to {os.path.join(args.trace, 'trace.json')}")


if __name__ == "__main__":
    main()
