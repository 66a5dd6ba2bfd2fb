"""HTTP pose-estimation endpoint: one card behind a JSON API.

Port of ``easy_vitpose_tpu/cli/serve_http.py`` on the port's
``VitInference``.  A stdlib ``ThreadingHTTPServer`` (no extra
dependencies) with the shape discipline of graph replay: ``fixed_slots``
pins one pose-slot count (one CUDA graph per frame size, no slot-count
flapping between requests), arbitrary request resolutions are zero-padded
onto a 64-px grid (a bounded number of captured graphs instead of one per
novel size; see ``_bucket_pad``), and a process-wide lock serializes the
card's work (queueing in front of it beats interleaving).  Runs on CUDA
unless ``--device cpu`` is given; decoding a request's image needs cv2.

Routes:

* ``POST /pose``  — body: JPEG/PNG bytes (``Content-Type: image/*``) or
  ``application/json`` ``{"image": <base64>, "boxes": [[x1,y1,x2,y2,score]...]?}``.
  Response: ``{"keypoints": {id: [[y,x,score] x K]}, "scores": {id: conf},
  "ms": float}``. Optional ``boxes`` skips the detector (precomputed-bbox
  mode, BASELINE config 1).
* ``GET /healthz`` — 200 once the model is warm (its kernels built and its
  graphs captured; a load balancer can gate on it), with model metadata.
* ``GET /metrics`` — request count, error count, p50/p95/max latency ms,
  total crops — enough for a scraper without pulling in a client lib.

Usage:
  python -m easy_vitpose_tpu_torch.cli.serve_http --model vitpose-b-coco.npz \
      --model-name b --yolo yolov8n.npz [--port 8080] [--dtype bf16] \
      [--fixed-slots 16] [--device cuda]
"""
from __future__ import annotations

import argparse
import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.io import NumpyEncoder


def build_parser():
    p = argparse.ArgumentParser(description="HTTP pose serving")
    p.add_argument("--model", required=True)
    p.add_argument("--model-name", default=None, choices=["s", "b", "l", "h"])
    p.add_argument("--dataset", default=None)
    p.add_argument("--yolo", default=None)
    p.add_argument("--yolo-size", type=int, default=320)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32", "int8"])
    p.add_argument("--fixed-slots", type=int, default=16,
                   help="person slots of the pose program (one graph per frame size)")
    p.add_argument("--device", default=None,
                   help="torch device to run on; default CUDA ('cpu' runs the kernels' "
                        "plain versions)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-requests", type=int, default=0,
                   help="shut down cleanly after N /pose requests (0 = "
                        "serve forever) — for benchmarks and smoke runs")
    p.add_argument("--warmup-shapes", default="",
                   help="comma-separated HxW resolutions to warm (capture "
                        "their graphs) before /healthz goes 200 (e.g. "
                        "1080x1920,512x640; each is padded onto the 64-px "
                        "grid first). The first live request of an unwarmed "
                        "bucket pays that bucket's warm-up and capture")
    p.add_argument("--max-body-mb", type=int, default=32,
                   help="reject request bodies larger than this (413) — "
                        "an uncapped read would let one request exhaust the "
                        "server's memory")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="micro-batching: coalesce concurrent requests "
                        "arriving within this window into one batched "
                        "detector pass + ONE multi-frame pose program "
                        "(0 = off). Raises throughput under concurrency: "
                        "one detector batch and one bigger pose batch instead "
                        "of N serialized programs")
    p.add_argument("--batch-max-frames", type=int, default=8,
                   help="micro-batching frame-stack cap (the frame count is "
                        "exact, one detector graph per live S up to this)")
    return p


class _Metrics:
    """Lock-guarded request counters + a latency reservoir."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.crops = 0
        self._lat_ms: list[float] = []

    def record(self, ms: float, crops: int):
        with self._lock:
            self.requests += 1
            self.crops += crops
            self._lat_ms.append(ms)
            if len(self._lat_ms) > 10_000:   # bounded memory
                self._lat_ms = self._lat_ms[-5_000:]

    def error(self):
        with self._lock:
            self.errors += 1

    def count(self) -> int:
        with self._lock:
            return self.requests

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat_ms)
            pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
                   if lat else 0.0)
            return {"requests": self.requests, "errors": self.errors,
                    "crops": self.crops, "latency_ms_p50": round(pct(.5), 2),
                    "latency_ms_p95": round(pct(.95), 2),
                    "latency_ms_max": round(lat[-1], 2) if lat else 0.0}


class _MicroBatcher:
    """Coalesce concurrent requests into ONE batched detector pass (for
    requests without precomputed boxes) + ONE multi-frame pose step
    (``pipeline.pose_step.pose_multi_frame``): frames stack on one axis,
    every request's boxes share the crop-slot batch, and each crop
    samples from its own frame via ``frame_idx``.

    Why: the card runs one request's programs at a time, so N concurrent
    requests pay N underfilled pose batches and N host round trips.  One
    batched pass amortizes the host's work and fills the GEMMs with
    S x slots crops.  Requests are packed sequentially into the slot batch;
    a request bringing more boxes than ``fixed_slots`` is truncated to it
    (same cap as the single path).  :meth:`close` stops its thread."""

    def __init__(self, service: "PoseService", window_ms: float,
                 max_frames: int):
        self.service = service
        self.window_s = window_ms / 1e3
        self.max_frames = max(1, max_frames)
        self._q = queue.Queue()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def close(self, timeout: float = 10.0):
        """Stop the dispatcher thread (requests queued before it still run)."""
        self._q.put(None)
        self._t.join(timeout)

    def pose(self, img: np.ndarray, boxes: np.ndarray,
             record: bool = True) -> dict:
        """Request-thread entry: enqueue and wait for the batch result."""
        t0 = time.perf_counter()
        done = threading.Event()
        cell: dict = {}
        self._q.put((img, boxes, done, cell))
        done.wait()
        if "err" in cell:
            raise cell["err"]
        out = cell["out"]
        # request-observed latency: queue wait + batch window + device,
        # comparable to the plain path's (which times from pose() entry)
        ms = (time.perf_counter() - t0) * 1e3
        out["ms"] = round(ms, 2)
        if record:  # warmup calls must not count toward --max-requests
            self.service.metrics.record(ms, len(out["keypoints"]))
        return out

    # -- dispatcher thread ------------------------------------------------
    def _run(self):
        stop = False
        while not stop:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.perf_counter() + self.window_s
            while len(batch) < self.max_frames:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
            # one program per frame shape: run the first shape's requests,
            # requeue the rest for the next round
            shape0 = batch[0][0].shape
            run = [r for r in batch if r[0].shape == shape0]
            for r in batch:
                if r[0].shape != shape0:
                    self._q.put(r)
            try:
                outs = self._execute(run)
                for (_, _, done, cell), out in zip(run, outs):
                    cell["out"] = out
                    done.set()
            except BaseException as e:
                for _, _, done, cell in run:
                    cell["err"] = e
                    done.set()

    def _execute(self, run) -> list:
        from ..detect.yolo import to_device
        from ..pipeline.inference import YOLO_CONF_THRESHOLD
        from ..pipeline.pose_step import pose_multi_frame
        svc = self.service
        m = svc.model
        fs = svc.info["fixed_slots"]
        run = [list(r) for r in run]
        det_idx = [i for i, r in enumerate(run) if r[1] is None]
        if det_idx:
            # detector-mode requests: ONE batched YOLO pass over their
            # frame stack (same conf filter as the single path), then
            # they join the shared pose batch below
            det_frames = np.stack([run[i][0] for i in det_idx])
            with svc._lock:
                packed = m._detector.detect_batch_async(det_frames).cpu().numpy()
            dets = m._detector.unpack_batch(packed,
                                            det_frames.shape[1:3])
            for i, rows in zip(det_idx, dets):
                rows = rows[rows[:, 4] > YOLO_CONF_THRESHOLD]
                run[i][1] = rows[:, :5]
        # the exact frame count (one detector graph per S in
        # 1..max_frames), not a power-of-two bucket: padded frames would
        # upload and compute dummy pixels.  The crop-slot batch is bucketed
        # separately on the real box total, so a half-full batch runs fewer
        # slots than the single path's per-request programs.
        from ..pipeline.pose_step import bucket_slots
        from ..track.sort import sanitize_detections
        S = len(run)
        frames = np.stack([r[0] for r in run])
        per_req = []
        for img, bx, _, _ in run:
            # same semantics as the single path: degenerate/non-finite
            # rows dropped, then cap keeping the HIGHEST-scored boxes
            bx = sanitize_detections(np.asarray(bx, np.float32)
                                     .reshape(-1, 5))
            if len(bx) > fs:
                bx = bx[np.argsort(-bx[:, 4], kind="stable")[:fs]]
            per_req.append(bx)
        n_real = sum(len(b) for b in per_req)
        if n_real == 0:
            # nothing to pose anywhere: skip the device program entirely
            # (matches the single path's `if n:` guard)
            return [{"keypoints": {}, "scores": {},
                     "batched_frames": len(run)} for _ in run]
        M = bucket_slots(n_real, max_slots=S * fs)
        boxes = np.zeros((M, 4), np.float32)
        fidx = np.zeros((M,), np.int32)
        mask = np.zeros((M,), bool)
        counts, offsets, confs = [], [], []
        k = 0
        for i, bx in enumerate(per_req):
            n = len(bx)
            h, w = run[i][0].shape[:2]
            boxes[k:k + n] = bx[:, :4]
            boxes[k:k + n, 0::2] = np.clip(boxes[k:k + n, 0::2], 0, w)
            boxes[k:k + n, 1::2] = np.clip(boxes[k:k + n, 1::2], 0, h)
            fidx[k:k + n] = i
            mask[k:k + n] = True
            counts.append(n)
            offsets.append(k)
            confs.append(bx[:, 4])
            k += n
        with svc._lock:
            dev = m.device
            kpts = pose_multi_frame(
                m._model, to_device(frames, dev), to_device(boxes, dev),
                to_device(fidx, dev), to_device(mask, dev),
                flip_pairs=m._flip_pairs, plain=m.plain).cpu().numpy()
        outs = []
        for n, off, cf in zip(counts, offsets, confs):
            outs.append({
                "keypoints": {i: kpts[off + i] for i in range(n)},
                "scores": {i: float(cf[i]) for i in range(n)},
                "batched_frames": len(run)})
        return outs


class PoseService:
    """Model + dispatch lock + metrics; handler-independent so tests can
    drive it without sockets.  :meth:`close` stops the micro-batcher."""

    def __init__(self, args):
        from ..pipeline.inference import VitInference
        self.model = VitInference(
            args.model, args.yolo, model_name=args.model_name,
            dataset=args.dataset, yolo_size=args.yolo_size,
            dtype=args.dtype, is_video=False, fixed_slots=args.fixed_slots,
            device=getattr(args, "device", None))
        self.metrics = _Metrics()
        self._lock = threading.Lock()
        self.info = {"model": args.model, "model_name": args.model_name,
                     "dataset": self.model.dataset, "dtype": args.dtype,
                     "fixed_slots": args.fixed_slots}
        self.warm = False
        self.batcher = None
        if getattr(args, "batch_window_ms", 0) > 0:
            self.batcher = _MicroBatcher(self, args.batch_window_ms,
                                         args.batch_max_frames)
            self.info["batch_window_ms"] = args.batch_window_ms

    def close(self):
        if self.batcher is not None:
            self.batcher.close()

    def warmup(self, extra_shapes=()):
        """Build the kernels and capture the graphs the live request path
        will use, on a dummy frame, so the first real request doesn't pay
        for them (healthz gates on this).  Holds the dispatch lock for the
        single path: the socket is already live, and a /pose that raced the
        warmup would interleave with its tracker state.

        ``extra_shapes``: (H, W) resolutions to warm in addition
        to the default canvas (--warmup-shapes; padded onto the 64-px
        grid like live requests)."""
        shapes = [(256, 320)] + [tuple(s) for s in extra_shapes]
        for h, w in shapes:
            img = _bucket_pad(np.zeros((h, w, 3), np.uint8))
            boxes = np.array([[10., 10., w * 0.6, h * 0.9, 1.0]],
                             np.float32)
            with self._lock:
                self.model.inference(img, bboxes=boxes)
                if self.model.has_detector:
                    self.model.inference(img)
                self.model.reset()
            if self.batcher is not None:
                # the batched path runs other programs (multi-frame pose,
                # batched detector); warm the single-request shapes —
                # deeper frame counts still capture on first live use
                full = np.tile(boxes, (self.info["fixed_slots"], 1))
                self.batcher.pose(img, full, record=False)
                if self.model.has_detector:
                    self.batcher.pose(img, None, record=False)
        self.warm = True

    def pose(self, img: np.ndarray, boxes=None) -> dict:
        if self.batcher is not None and (boxes is not None
                                         or self.model.has_detector):
            # micro-batching tier: stateless requests coalesce into one
            # batched detector pass + one multi-frame pose program
            return self.batcher.pose(_bucket_pad(img), boxes)
        t0 = time.perf_counter()
        img = _bucket_pad(img)
        with self._lock:
            kp = self.model.inference(img, bboxes=boxes)
            scores = dict(self.model._scores_bbox)
            self.model.reset()   # stateless endpoint: no cross-request tracks
        ms = (time.perf_counter() - t0) * 1e3
        self.metrics.record(ms, len(kp))
        return {"keypoints": {int(k): v for k, v in kp.items()},
                "scores": {int(k): float(v) for k, v in scores.items()},
                "ms": round(ms, 2)}


def _bucket_pad(img: np.ndarray, multiple: int = 64) -> np.ndarray:
    """Zero-pad bottom/right so (H, W) are multiples of ``multiple``.

    The card replays one captured graph per frame shape; a public endpoint
    sees arbitrary resolutions, which would capture a graph per new size.
    Padding to a 64-px grid caps the graph count at #buckets while changing
    no geometry: content stays at the origin, so request boxes and returned
    keypoints need no re-mapping, and crops never read the margin (the
    detector sees black borders, which it was trained to ignore in
    letterboxed inference)."""
    h, w = img.shape[:2]
    ph = -h % multiple
    pw = -w % multiple
    if ph == 0 and pw == 0:
        return img
    return np.pad(img, ((0, ph), (0, pw), (0, 0)))


def _decode_image(body: bytes, content_type: str):
    """(image ndarray RGB, optional boxes) from an HTTP request body."""
    boxes = None
    if content_type.startswith("application/json"):
        payload = json.loads(body)
        data = base64.b64decode(payload["image"])
        if payload.get("boxes") is not None:
            boxes = np.asarray(payload["boxes"], np.float32).reshape(-1, 5)
    else:
        data = body
    import cv2
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("body is not a decodable image")
    return img[..., ::-1], boxes   # BGR -> RGB (reference reads RGB)


def make_handler(service: PoseService, max_requests: int = 0,
                 shutdown=None, max_body_bytes: int = 32 << 20):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            data = json.dumps(obj, cls=NumpyEncoder).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                if service.warm:
                    self._send(200, {"status": "ok", **service.info})
                else:
                    self._send(503, {"status": "warming up"})
            elif self.path == "/metrics":
                self._send(200, service.metrics.snapshot())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/pose":
                self._send(404, {"error": f"no route {self.path}"})
                return
            responded = False
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body_bytes:
                    service.metrics.error()
                    responded = True
                    self._send(413, {"error": f"body {n} bytes exceeds "
                                              f"the {max_body_bytes} cap"})
                    return
                img, boxes = _decode_image(
                    self.rfile.read(n), self.headers.get("Content-Type", ""))
                if boxes is None and not service.model.has_detector:
                    raise ValueError(
                        "no detector loaded (--yolo): pass precomputed "
                        "'boxes' in a JSON body")
                result = service.pose(img, boxes)
                responded = True
                self._send(200, result)
                if max_requests and service.metrics.count() >= max_requests \
                        and shutdown is not None:
                    # shutdown() joins the serve loop — must not be
                    # called from a request thread synchronously
                    threading.Thread(target=shutdown, daemon=True).start()
            except Exception as e:
                if responded:
                    # the 200 write itself failed (client hung up):
                    # nothing sensible to send on the broken socket
                    return
                service.metrics.error()
                # malformed input is the client's fault; a device/runtime
                # failure must read as 5xx so load balancers eject us
                client_fault = isinstance(
                    e, (ValueError, KeyError, TypeError,
                        json.JSONDecodeError))
                self._send(400 if client_fault else 500, {"error": str(e)})

        def log_message(self, fmt, *a):   # quiet per-request stderr spam
            pass

    return Handler


def main(argv=None, ready_event: threading.Event = None,
         server_box: list = None):
    args = build_parser().parse_args(argv)
    service = PoseService(args)
    # bind BEFORE the warmup: a load balancer probing /healthz sees the
    # documented 503 "warming up" while the kernels build
    # instead of connection-refused
    httpd = ThreadingHTTPServer((args.host, args.port), None)
    httpd.RequestHandlerClass = make_handler(
        service, max_requests=args.max_requests, shutdown=httpd.shutdown,
        max_body_bytes=args.max_body_mb << 20)
    serve_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    serve_thread.start()
    print(f">>> warming up (fixed_slots={args.fixed_slots}, "
          f"dtype={args.dtype}) on "
          f"http://{args.host}:{httpd.server_address[1]} ...", flush=True)
    shapes = []
    for tok in filter(None, args.warmup_shapes.split(",")):
        h, w = tok.lower().split("x")
        shapes.append((int(h), int(w)))
    try:
        service.warmup(shapes)
    except BaseException:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        raise
    if server_box is not None:
        server_box.append((httpd, service))
    print(f">>> serving on http://{args.host}:{httpd.server_address[1]} "
          f"(POST /pose, GET /healthz, GET /metrics)", flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        serve_thread.join()
    except KeyboardInterrupt:
        httpd.shutdown()
    finally:
        httpd.server_close()
        service.close()
        print(json.dumps(service.metrics.snapshot()), flush=True)


if __name__ == "__main__":
    main()
