"""Multi-stream batched serving on the card (BASELINE.json config 5).

Port of ``easy_vitpose_tpu/pipeline/stream.py``.  N video streams of one
resolution run through one detector batch and one pose batch per tick: the
streams' frames are stacked, YOLO runs once over the stack (D1 and D2 one
launch each for all S frames), per-stream tracking stays on the host, and
every stream's person crops share one pose step (K3 with a frame index per
crop).  On the card the batched detector is a CUDA graph replay
(``detect/yolo.py::YoloDetector.detect_batch_async``), and a
``single_dispatch`` detection tick is one graph of detector and pose
(``pipeline/fused_detect.py::detect_pose_multi``); the bare pose step of a
two-program tick runs eagerly, as ``pose_step`` does everywhere.

Stream-parallel serving (``mesh=``, JAX's ``_build_sharded_pose`` and
``_sharded_fused``) runs over a ``batch`` mesh of local devices
(``parallel/mesh.py``): the streams go in per-device blocks, as JAX's slot
layout has them (slot ``si * max_pp + j`` of stream si lies in its
device's block, so each crop's frame is on its device), and each device
holds a replica of the pose model and the detector and runs its block's
detector (D1 and D2 over its frames), pose step (K3, the blocks, the fused
decode) or fused tick; the host gathers the blocks in order.  Without a
mesh the class runs one block on the model's device.  A sharded tick is
bit for bit the unsharded ticks of its blocks.  Given the same boxes, its
pose step is also the whole stack's unsharded tick, bit for bit (the pose
kernels are batch-invariant); its detections are the detector's over each
block, which on the card may round differently from the whole stack's
(cuDNN picks the convolutions' algorithms by batch).  The rare coast
fallback of a fused tick runs unsharded on the first device, as JAX's
does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..detect.yolo import YoloDetector, to_device
from ..models.vitpose import ViTPose, serving_replica
from ..ops.one_euro import apply_track_smoothing
from ..track.sort import Sort, track_and_cap
from .pose_step import bucket_slots, pose_multi_frame


class _Shard:
    """One block of the tick's streams: the device, its pose model and its
    detector (replicas where the device is not the model's)."""

    def __init__(self, device: torch.device, model: ViTPose, detector):
        self.device, self.model, self.detector = device, model, detector


class MultiStreamPose:
    """Batched multi-stream pose serving on one card, or over a ``batch``
    mesh of local devices (``mesh=``, stream-parallel).

    Per tick, call :meth:`step` (or :meth:`step_pipelined`) with one RGB
    frame per stream, all of one resolution.  Detection cadence follows
    ``yolo_step`` as in the single-stream pipeline.

    Args:
      model: a serving copy of ViTPose (``models.vitpose.serving_copy``) on
        the card, or on the CPU, where every kernel's plain version runs.
      detector: a ``YoloDetector`` on the same device, or any object with
        ``detect_batch_async`` and ``unpack_batch``; None to pass boxes to
        :meth:`step`.
      single_dispatch: detection ticks as one program (detector + pose) and
        one fetch; IDs are those of the two-program tick, and pose runs on
        the raw detection boxes instead of the tracker's.  Needs a
        ``YoloDetector``.
      mesh: a ``batch`` mesh (``parallel/mesh.py::make_mesh(axis="batch")``)
        whose size divides ``n_streams``: the streams in per-device blocks,
        each device with its replica.
      plain: run every kernel's plain version, eagerly (for checks).
    """

    def __init__(self, model: ViTPose, detector=None, n_streams: int = 8, yolo_step: int = 1,
                 max_people_per_stream: int = 8, mesh=None, smooth: bool = False,
                 smooth_params=None, tracker: str = "sort", single_dispatch: bool = False,
                 plain: bool = False):
        if tracker not in ("sort", "bytetrack"):
            raise ValueError(f"tracker must be 'sort' or 'bytetrack', got {tracker!r}")
        self.model = model
        self.device = model.backbone.pos_embed.device
        self.detector = detector
        self.n = n_streams
        self.yolo_step = yolo_step
        self.max_pp = max_people_per_stream
        self.plain = plain
        if tracker == "bytetrack":
            from ..track.bytetrack import ByteTrack
            self.trackers = [ByteTrack(max_age=yolo_step, min_hits=3 if yolo_step == 1 else 1,
                                       iou_threshold=0.3, high_thresh=0.35,
                                       det_stride=yolo_step)
                             for _ in range(n_streams)]
            self._det_gate = self.trackers[0].low_thresh
        else:
            self.trackers = [Sort(max_age=yolo_step, min_hits=3 if yolo_step == 1 else 1,
                                  iou_threshold=0.3)
                             for _ in range(n_streams)]
            self._det_gate = 0.35  # reference inference.py:240-241
        self.mesh = mesh
        self._shards = [_Shard(self.device, model, detector)]
        if mesh is not None:
            nd = mesh.size
            if n_streams % nd:
                raise ValueError(f"n_streams={n_streams} must be a multiple of mesh size {nd}")
            replicas = {self.device: self._shards[0]}
            for d in mesh.devices:
                if d not in replicas:
                    replicas[d] = _Shard(d, serving_replica(model, d),
                                         None if detector is None else detector.on(d))
            self._shards = [replicas[d] for d in mesh.devices]
        self.frame_counter = 0
        self.smooth = bool(smooth)
        self._smooth_kw = dict(smooth_params or {})
        self._smoothers = [dict() for _ in range(n_streams)]
        # the fused tick needs a real detector (its weights, its graphs)
        self.single_dispatch = bool(single_dispatch and isinstance(detector, YoloDetector))
        self._pending = None  # ("plain", frames, det) | ("fused", frames, outputs)
        # grow-only bucket of the fused tick's fallback pose step
        self._fb_highwater = 0

    # ------------------------------------------------------------ plumbing

    def _upload(self, frames) -> List[torch.Tensor]:
        """The tick's (S, H, W, 3) stack as each shard's block of streams on
        its device; frames of mixed resolution are refused, as ``np.stack``
        refuses them."""
        if len(frames) != self.n:
            raise ValueError(f"expected {self.n} frames, got {len(frames)}")
        if not isinstance(frames, torch.Tensor):
            frames = np.stack(frames)
        per = self.n // len(self._shards)
        return [to_device(frames[i * per:(i + 1) * per], sh.device)
                for i, sh in enumerate(self._shards)]

    @staticmethod
    def _frame_hw(frames_dev) -> tuple:
        return tuple(frames_dev[0].shape[1:3])

    @staticmethod
    def _gather(handles) -> torch.Tensor:
        """The shards' outputs as one host tensor, in the shards' order."""
        if len(handles) == 1:
            return handles[0].cpu()
        return torch.cat([h.cpu() for h in handles])

    def _det_due(self) -> bool:
        """Detection cadence for this tick (reference inference.py:235-236)."""
        return self.frame_counter % self.yolo_step == 0 or self.frame_counter < 3

    def _dispatch_detect(self, frames_dev):
        """Queue this tick's detection (cadence-gated) without fetching:
        packed rows on the device, or None (no detection this tick)."""
        run_det = self._det_due()
        self.frame_counter += 1
        if not run_det or self.detector is None:
            return None
        return [sh.detector.detect_batch_async(f) for sh, f in zip(self._shards, frames_dev)]

    def _boxes_from_detect(self, det, frame_hw):
        if det is None:
            return [np.empty((0, 5), np.float32) for _ in range(self.n)]
        if isinstance(det, torch.Tensor):
            det = [det]
        if isinstance(det, list):  # each shard's packed rows on its device: the fetch
            det = self._gather(det).numpy()
        det = self.detector.unpack_batch(det, frame_hw)
        return [(r[r[:, 4] > self._det_gate][:, :5] if len(r)
                 else np.empty((0, 5), np.float32)) for r in det]

    def step(self, frames: Sequence[np.ndarray],
             boxes_per_stream: Optional[List[np.ndarray]] = None) -> List[Dict[int, np.ndarray]]:
        """Synchronous tick: frames -> per stream {track_id: (K, 3)}."""
        frames_dev = self._upload(frames)
        H, W = self._frame_hw(frames_dev)
        if boxes_per_stream is None and self.single_dispatch and self._det_due():
            return self._collect_fused(self._dispatch_fused(frames_dev), frames_dev)
        if boxes_per_stream is None:
            boxes_per_stream = self._boxes_from_detect(self._dispatch_detect(frames_dev), (H, W))
        else:
            self.frame_counter += 1
        handle, book = self._track_and_pose(frames_dev, boxes_per_stream)
        return self._collect(handle, book)

    def step_pipelined(self, frames: Sequence[np.ndarray]
                       ) -> Optional[List[Dict[int, np.ndarray]]]:
        """Pipelined tick: returns the results of the PREVIOUS frames (None
        on the first call; :meth:`flush` drains the last tick).

        Tick t is queued first (neither kind depends on the trackers when it
        is queued): a two-program tick queues its detection, which runs while
        the host fetches tick t-1's detections, tracks and queues and fetches
        its pose; a single-dispatch tick queues detector and pose together,
        so all of tick t-1's host work overlaps the card."""
        frames_dev = self._upload(frames)
        if self.single_dispatch and self._det_due():
            tick = ("fused", frames_dev, self._dispatch_fused(frames_dev))
        else:
            tick = ("plain", frames_dev, self._dispatch_detect(frames_dev))
        results = self._process_pending() if self._pending is not None else None
        self._pending = tick
        return results

    def flush(self) -> Optional[List[Dict[int, np.ndarray]]]:
        """Drain the pipeline: process and return the last pending tick."""
        if self._pending is None:
            return None
        return self._process_pending()

    def _process_pending(self) -> List[Dict[int, np.ndarray]]:
        kind, prev_dev, payload = self._pending
        self._pending = None
        if kind == "fused":
            return self._collect_fused(payload, prev_dev)
        H, W = self._frame_hw(prev_dev)
        boxes = self._boxes_from_detect(payload, (H, W))
        handle, book = self._track_and_pose(prev_dev, boxes)
        return self._collect(handle, book)

    # ------------------------------------------------ single-dispatch tick

    def _dispatch_fused(self, frames_dev):
        """Queue the detector + pose program of this tick without fetching,
        on each shard: its (packed (s, max_det, 7), keypoints (s * max_pp,
        K, 3)) on its device, a CUDA graph replay on the card."""
        self.frame_counter += 1
        return [self._dispatch_fused_shard(sh, f) for sh, f in zip(self._shards, frames_dev)]

    def _dispatch_fused_shard(self, sh: _Shard, frames_dev: torch.Tensor):
        from .fused_detect import detect_pose_multi
        det = sh.detector
        geom = det.geometry(tuple(frames_dev.shape[1:3]))
        gate = float(self._det_gate)

        def program(frames):
            return detect_pose_multi(det.model, sh.model, frames, geom, det.spec, det.classes,
                                     det.conf, det.iou, det.max_det, det.dtype, self.max_pp,
                                     gate, plain=self.plain)

        if det.graphed and not self.plain:
            key = ("detect_pose_multi", tuple(frames_dev.shape), self.max_pp, gate)
            return det.graphs.run(key, program, frames_dev)
        return program(frames_dev)

    def _collect_fused(self, handles, frames_dev) -> List[Dict[int, np.ndarray]]:
        """Fetch the fused tick once, then key each stream's posed
        detections to its tracks (slot ``si * max_pp + j`` is detection j of
        stream si: the packed rows are a score-sorted valid prefix, so the
        host gate keeps a prefix and the indices line up).  Tracker rows
        without an in-slot detection this tick (coasting tracks, detections
        beyond max_pp) take one multi-frame pose step on their tracker
        boxes."""
        H, W = self._frame_hw(frames_dev)
        packed, kpts = [], []
        for packed_dev, kpts_dev in handles:   # one fetch per shard
            both = torch.cat([packed_dev.reshape(-1), kpts_dev.reshape(-1)]).cpu().numpy()
            packed.append(both[:packed_dev.numel()].reshape(packed_dev.shape))
            kpts.append(both[packed_dev.numel():].reshape(kpts_dev.shape))
        packed, kpts = np.concatenate(packed), np.concatenate(kpts)
        # one copy of the host gate: the slot alignment needs it to be the
        # device gate's
        gated = self._boxes_from_detect(packed, (H, W))

        results: List[Dict[int, np.ndarray]] = [dict() for _ in range(self.n)]
        fb_boxes: List[np.ndarray] = []
        fb_keys: List[tuple] = []  # (stream, track_id)
        for si in range(self.n):
            rows, det_idx = track_and_cap(self.trackers[si], gated[si], self.max_pp)
            for row, di in zip(rows, det_idx):
                tid, di = int(row[5]), int(di)
                if 0 <= di < self.max_pp:
                    results[si][tid] = kpts[si * self.max_pp + di]
                else:
                    fb_keys.append((si, tid))
                    fb_boxes.append(row[:4])

        if fb_boxes:
            nb = len(fb_boxes)
            self._fb_highwater = max(self._fb_highwater,
                                     bucket_slots(nb, max_slots=self.n * self.max_pp))
            M = self._fb_highwater
            boxes = np.zeros((M, 4), np.float32)
            fidx = np.zeros((M,), np.int32)
            mask = np.zeros((M,), bool)
            boxes[:nb] = np.stack(fb_boxes)
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
            fidx[:nb] = [si for si, _ in fb_keys]
            mask[:nb] = True
            # unsharded on the first shard, as JAX's: coast rows are rare and
            # their streams fall in any block; the frames move device to device
            first = self._shards[0]
            frames = (frames_dev[0] if len(frames_dev) == 1 else
                      torch.cat([f.to(first.device) for f in frames_dev]))
            out = self._pose(first, frames, boxes, fidx, mask).cpu().numpy()
            for j, (si, tid) in enumerate(fb_keys[:M]):
                results[si][tid] = out[j]

        if self.smooth:
            results = [apply_track_smoothing(r, self._smoothers[si], **self._smooth_kw)
                       for si, r in enumerate(results)]
        return results

    # ------------------------------------------------------ two-program tick

    def _pose(self, sh: _Shard, frames_dev, boxes, fidx, mask) -> torch.Tensor:
        dev = sh.device
        return pose_multi_frame(sh.model, frames_dev, to_device(boxes, dev),
                                to_device(fidx, dev), to_device(mask, dev), plain=self.plain)

    def _track_and_pose(self, frames_dev, boxes_per_stream):
        H, W = self._frame_hw(frames_dev)
        # a fixed slot count in per-stream blocks (slot si * max_pp + j is
        # person j of stream si): one program shape for the whole stream
        M = self.n * self.max_pp
        boxes = np.zeros((M, 4), np.float32)
        mask = np.zeros((M,), bool)
        fidx = np.arange(M, dtype=np.int32) // self.max_pp
        book = []  # (slot, stream, track_id)
        for si in range(self.n):
            tracked, _ = track_and_cap(self.trackers[si], boxes_per_stream[si], self.max_pp)
            for j, row in enumerate(tracked):
                slot = si * self.max_pp + j
                boxes[slot] = row[:4]
                mask[slot] = True
                book.append((slot, si, int(row[5])))
        if not book:
            return None, book
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, W)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, H)
        # each shard poses its block of slots from its block of frames
        per = M // len(self._shards)
        outs = [self._pose(sh, f, boxes[i * per:(i + 1) * per], fidx[:per],
                           mask[i * per:(i + 1) * per])
                for i, (sh, f) in enumerate(zip(self._shards, frames_dev))]
        return outs, book  # queued, not fetched

    def _collect(self, out_handle, book) -> List[Dict[int, np.ndarray]]:
        results: List[Dict[int, np.ndarray]] = [dict() for _ in range(self.n)]
        if out_handle is None:
            if self.smooth:  # every track gone: drop their filters too
                for d in self._smoothers:
                    d.clear()
            return results
        out = self._gather(out_handle).numpy()
        for slot, si, tid in book:
            results[si][tid] = out[slot]
        if self.smooth:
            results = [apply_track_smoothing(r, self._smoothers[si], **self._smooth_kw)
                       for si, r in enumerate(results)]
        return results
