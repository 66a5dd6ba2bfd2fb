"""BYTE two-stage association tracker (ByteTrack, Zhang et al., ECCV 2022)
on the batched-Kalman SORT substrate.

The reference pipeline discards every detection under its 0.35 confidence
gate before tracking (reference easy_ViTPose/inference.py:240-241), so a
person who blurs or occludes for a few frames drops below the gate, the
track coasts, and after ``max_age`` frames the identity is lost.  BYTE's
observation: low-confidence boxes are usually *real but degraded* — use
them to SUSTAIN existing tracks (never to create new ones):

  1. first association: high-confidence detections (score >= high_thresh)
     vs every live track — standard SORT matching;
  2. second association (the BYTE step): remaining low-confidence
     detections (low_thresh <= score < high_thresh) rescue only tracks that
     are already CONFIRMED (emitted at least once, i.e. past the min_hits
     warm-up) and were matched at the last detection opportunity
     (``time_since_update <= det_stride``), with a stricter IoU gate.
     Warming-up tracks are excluded outright, so a low box can neither
     spawn a track nor supply the hit that confirms one;
  3. new tracks spawn from unmatched HIGH-confidence detections only.

``det_stride`` makes rescue eligibility detector-cadence aware: with
``yolo_step > 1`` the pipeline calls ``update(empty)`` on skipped frames
(time_since_update grows by yolo_step between detector frames), so the
pipeline passes ``det_stride=yolo_step`` and "matched at the last detector
frame" stays the eligibility rule at any cadence.  At the default stride 1
this is exactly "matched on the previous frame".

With no low-confidence detections in the stream the behaviour is exactly
``Sort`` (tests/test_bytetrack.py pins the equivalence), so this is a
strict upgrade the reference does not have.  Select it with
``VitInference(tracker='bytetrack')`` / ``cli.infer --tracker bytetrack``;
the pipeline then lowers its detector gate (NMS confidence threshold
included — see ``LOW_THRESHOLD``) so the full low-confidence band reaches
the tracker.

The port's own numpy copy of ``easy_vitpose_tpu/track/bytetrack.py``.
"""
from __future__ import annotations

import numpy as np

from .sort import Sort, associate

# Default BYTE low gate. The pipeline/CLIs also construct the YOLO detector
# with this as its NMS confidence threshold in bytetrack mode — the
# detector's default 0.25 gate would discard the [0.1, 0.25) band on device
# before the tracker ever saw it.
LOW_THRESHOLD = 0.1


class ByteTrack(Sort):
    """Drop-in ``Sort`` replacement with the BYTE second association."""

    def __init__(self, max_age: int = 1, min_hits: int = 3,
                 iou_threshold: float = 0.3,
                 high_thresh: float = 0.35,
                 low_thresh: float = LOW_THRESHOLD,
                 second_iou: float = 0.5,
                 det_stride: int = 1):
        super().__init__(max_age=max_age, min_hits=min_hits,
                         iou_threshold=iou_threshold)
        assert low_thresh < high_thresh
        assert det_stride >= 1
        self.high_thresh = high_thresh
        self.low_thresh = low_thresh
        self.second_iou = second_iou
        self.det_stride = det_stride

    def update(self, dets: np.ndarray = None, det_indices=None):
        """Advance one frame.  dets: (N, 5) [x1,y1,x2,y2,score] including
        LOW-confidence boxes (>= low_thresh).  Same output contract as
        ``Sort.update``: plain confirmed [x1,y1,x2,y2,score,id] rows (coast
        output on empty-detection frames), or ``(rows, emitted_det_idx)``
        when ``det_indices`` is given."""
        if dets is None:
            dets = np.empty((0, 5), np.float32)
        dets = np.asarray(dets, np.float32).reshape(-1, 5)
        self.frame_count += 1
        empty_dets = len(dets) == 0
        want_indices = det_indices is not None
        if det_indices is None:
            det_indices = np.arange(len(dets))
        det_indices = np.asarray(det_indices, int)

        hi_m = dets[:, 4] >= self.high_thresh
        lo_m = (dets[:, 4] >= self.low_thresh) & ~hi_m
        high, high_idx = dets[hi_m], det_indices[hi_m]
        low, low_idx = dets[lo_m], det_indices[lo_m]

        trk_boxes = self._predict()

        # 1. high-confidence dets vs every live track
        matched, unmatched_high, unmatched_trks = associate(
            high, trk_boxes, self.iou_threshold)
        self._apply_matches(high, matched, high_idx)

        # 2. BYTE: low-confidence dets rescue CONFIRMED tracks that were
        # matched at the last detection opportunity (tsu <= det_stride
        # after _predict; skipped-detector frames increment tsu too).
        # Coasting/lost tracks don't participate — a weak box matching a
        # long-coasted prediction is more likely a different person — and
        # warming-up tracks can't be confirmed by a weak box.
        if len(low) and len(unmatched_trks):
            unmatched_trks = np.asarray(unmatched_trks, int)
            fresh = unmatched_trks[
                (self.time_since_update[unmatched_trks] <= self.det_stride)
                & self.confirmed[unmatched_trks]]
            if len(fresh):
                m2, _, _ = associate(low, trk_boxes[fresh], self.second_iou)
                if len(m2):
                    m2 = np.stack([m2[:, 0], fresh[m2[:, 1]]], axis=1)
                    self._apply_matches(low, m2, low_idx)

        # 3. new identities from unmatched high-confidence dets only
        self._spawn(high, unmatched_high, high_idx)
        rows, emitted = self._emit_and_retire(empty_dets)
        return (rows, emitted) if want_indices else rows
