"""SORT multi-object tracker with batched Kalman math.

Same observable semantics as the reference tracker (easy_ViTPose/sort.py:
203-266): per-frame ``update(dets)`` returning [x1,y1,x2,y2,score,id] rows,
IoU-gated Hungarian association with the unambiguous-greedy shortcut
(sort.py:169-174), min_hits warm-up, max_age retirement, and the coast-through
behaviour on empty-detection frames (sort.py:259-265) that lets
``yolo_step > 1`` skip the detector.

Unlike the reference (one filterpy.KalmanFilter object per track, python
loops), all per-track state lives in stacked arrays and predict/update run
batched over every track at once (track/kalman.py).  ID bookkeeping stays on
host — it is inherently sequential and costs nanoseconds.

The port's own numpy copy of ``easy_vitpose_tpu/track/sort.py``.
"""
from __future__ import annotations

import numpy as np

from . import kalman


def linear_assignment(cost: np.ndarray) -> np.ndarray:
    """Hungarian assignment -> (n, 2) [det_idx, trk_idx] pairs."""
    from scipy.optimize import linear_sum_assignment
    r, c = linear_sum_assignment(cost)
    return np.stack([r, c], axis=1)


def associate(dets: np.ndarray, trks: np.ndarray, iou_threshold: float):
    """Match detections to tracker boxes (reference sort.py:158-200).

    Returns (matches (n,2), unmatched_dets (list), unmatched_trks (list)).
    """
    if len(trks) == 0:
        return (np.empty((0, 2), int), np.arange(len(dets)),
                np.empty((0,), int))
    iou = kalman.iou_matrix(dets[:, :4], trks[:, :4])
    if min(iou.shape) > 0:
        above = (iou > iou_threshold).astype(np.int32)
        if above.sum(1).max() == 1 and above.sum(0).max() == 1:
            matched = np.stack(np.where(above), axis=1)  # unambiguous greedy
        else:
            matched = linear_assignment(-iou)
    else:
        matched = np.empty((0, 2), int)

    unmatched_dets = [d for d in range(len(dets)) if d not in matched[:, 0]]
    unmatched_trks = [t for t in range(len(trks)) if t not in matched[:, 1]]
    matches = []
    for m in matched:
        if iou[m[0], m[1]] < iou_threshold:
            unmatched_dets.append(m[0])
            unmatched_trks.append(m[1])
        else:
            matches.append(m)
    matches = (np.stack(matches) if matches else np.empty((0, 2), int))
    return matches, np.array(unmatched_dets), np.array(unmatched_trks)


def sanitize_detections(dets, return_indices: bool = False):
    """Drop non-finite / degenerate (x2<=x1 or y2<=y1) detector rows before
    tracking — the Kalman sqrt(s*r) would NaN on them and permanently poison
    the filter state.  Shared by the single- and multi-stream pipelines.

    With ``return_indices=True`` also returns the kept rows' indices into
    the input — the single-dispatch pipeline aligns pose slots with
    detector rows through this map."""
    if not len(dets):
        return (dets, np.empty((0,), int)) if return_indices else dets
    ok = (np.isfinite(dets[:, :4]).all(1)
          & (dets[:, 2] > dets[:, 0])
          & (dets[:, 3] > dets[:, 1]))
    return (dets[ok], np.where(ok)[0]) if return_indices else dets[ok]


def track_and_cap(tracker, dets, cap: int):
    """The host tracking stage every pipeline shares: sanitize ->
    tracker.update -> finite-filter -> highest-score cap.

    Returns ``(rows, det_idx)``: up to ``cap`` tracker rows
    ``[x1, y1, x2, y2, score, id]`` and each row's index into the input
    ``dets`` (-1 for coast rows the tracker emitted without a detection
    this frame — the single-dispatch pipelines key pre-computed pose
    slots with this map).  ``tracker=None`` degrades to sanitize + cap
    (rows keep the detector's 5 columns).

    This is the ONE home for the sequence: VitInference._track_boxes and
    MultiStreamPose's fused/plain ticks all call it, so the cap policy
    cannot drift between pipelines (it once did — one path truncated in
    tracker-row order while the others kept the highest-scored boxes)."""
    dets, kept = sanitize_detections(dets, return_indices=True)
    if tracker is None:
        rows, det_idx = dets, kept
    else:
        rows, det_idx = tracker.update(dets, det_indices=kept)
        keep = np.isfinite(rows[:, :4]).all(1)
        rows, det_idx = rows[keep], det_idx[keep]
    if len(rows) > cap:
        order = np.argsort(-rows[:, 4], kind="stable")[:cap]
        rows, det_idx = rows[order], det_idx[order]
    return rows, det_idx


class Sort:
    """Drop-in equivalent of the reference Sort class."""

    def __init__(self, max_age: int = 1, min_hits: int = 3,
                 iou_threshold: float = 0.3):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.frame_count = 0
        self._next_id = 1
        # stacked per-track state (all arrays share row order)
        self.x = np.zeros((0, kalman.DIM_X), np.float32)
        self.P = np.zeros((0, kalman.DIM_X, kalman.DIM_X), np.float32)
        self.ids = np.zeros((0,), np.int64)
        self.scores = np.zeros((0,), np.float32)
        self.hits = np.zeros((0,), np.int32)
        self.hit_streak = np.zeros((0,), np.int32)
        self.time_since_update = np.zeros((0,), np.int32)
        # sticky per-track flag: has this track ever been emitted (passed
        # the min_hits warm-up)?  Sort itself never reads it; ByteTrack's
        # second association is restricted to confirmed tracks so a
        # low-confidence box can never supply the confirming hit
        self.confirmed = np.zeros((0,), bool)

    def __len__(self):
        return len(self.ids)

    def _keep(self, keep: np.ndarray):
        for name in ("x", "P", "ids", "scores", "hits", "hit_streak",
                     "time_since_update", "confirmed"):
            setattr(self, name, getattr(self, name)[keep])

    # --- stages (shared with track/bytetrack.py, which recomposes them) ---

    def _predict(self) -> np.ndarray:
        """Batched Kalman predict for every live track; drops tracks whose
        predicted box went non-finite.  Returns the predicted boxes (row
        order == state row order)."""
        # per-frame bookkeeping: state row -> detection index that updated
        # (or spawned) it this frame.  Consumed by the single-dispatch
        # pipeline, which poses detections BEFORE association and needs to
        # key the keypoints by emitted track id (pipeline/fused_detect.py).
        self._frame_det_idx = {}
        if not len(self):
            return np.zeros((0, 4), np.float32)
        self.x, self.P = kalman.predict(self.x, self.P)
        self.hit_streak = np.where(self.time_since_update > 0, 0,
                                   self.hit_streak)
        self.time_since_update += 1
        trk_boxes = kalman.x_to_bbox(self.x)
        finite = np.isfinite(trk_boxes).all(axis=1)
        if not finite.all():
            self._keep(finite)
            trk_boxes = trk_boxes[finite]
        return trk_boxes

    def _apply_matches(self, dets: np.ndarray, matched: np.ndarray,
                       det_indices=None):
        """Batched Kalman update of matched tracks.  matched: (n, 2)
        [det_idx, state_row] pairs.  det_indices: optional map from local
        det rows to the caller's global detection indices (ByteTrack feeds
        high/low SUBSETS here)."""
        if not len(matched):
            return
        di, ti = matched[:, 0], matched[:, 1]
        for d, t in zip(di, ti):
            self._frame_det_idx[int(t)] = int(
                det_indices[d] if det_indices is not None else d)
        z = kalman.bbox_to_z(dets[di, :4])
        xs, Ps = kalman.update(self.x[ti], self.P[ti], z)
        self.x[ti] = xs
        self.P[ti] = Ps
        self.scores[ti] = dets[di, 4]
        self.hits[ti] += 1
        self.hit_streak[ti] += 1
        self.time_since_update[ti] = 0

    def _spawn(self, dets: np.ndarray, indices, det_indices=None) -> None:
        """Open a new track for each listed detection row."""
        for i in indices:
            self._frame_det_idx[len(self)] = int(
                det_indices[i] if det_indices is not None else i)
            z = kalman.bbox_to_z(dets[i, :4])
            x0, P0 = kalman.init_state(z[None])
            self.x = np.concatenate([self.x, x0])
            self.P = np.concatenate([self.P, P0])
            self.ids = np.concatenate([self.ids, [self._next_id]])
            self.scores = np.concatenate([self.scores, [dets[i, 4]]])
            self.hits = np.concatenate([self.hits, [0]])
            self.hit_streak = np.concatenate([self.hit_streak, [0]])
            self.time_since_update = np.concatenate(
                [self.time_since_update, [0]])
            self.confirmed = np.concatenate([self.confirmed, [False]])
            self._next_id += 1

    def _emit_and_retire(self, empty_dets: bool):
        """Emit confirmed tracks (min_hits warm-up; coast output on
        empty-detection frames, reference sort.py:259-265) and retire
        tracks older than max_age.  Returns (rows, emitted_det_idx):
        per output row, the detection index that updated it this frame
        (-1 for coast rows)."""
        boxes = kalman.x_to_bbox(self.x) if len(self) else \
            np.zeros((0, 4), np.float32)
        emit = (self.time_since_update < 1) & (
            (self.hit_streak >= self.min_hits)
            | (self.frame_count <= self.min_hits))
        self.confirmed = self.confirmed | emit
        rows = np.concatenate(
            [boxes, self.scores[:, None],
             self.ids[:, None].astype(np.float32)], axis=1)
        ret = rows[emit]
        coasted = rows if empty_dets else None
        # detection index per OUTPUT row (-1 = emitted without a matching
        # detection this frame, i.e. the coast path)
        fdi = getattr(self, "_frame_det_idx", {})
        emit_di = np.array([fdi.get(int(r), -1)
                            for r in np.where(emit)[0]], int)
        all_di = np.array([fdi.get(r, -1) for r in range(len(rows))], int)

        self._keep(self.time_since_update <= self.max_age)

        if len(ret):
            return ret, emit_di
        if empty_dets and coasted is not None and len(coasted):
            return coasted, all_di
        return np.empty((0, 6), np.float32), np.empty((0,), int)

    def update(self, dets: np.ndarray = None, det_indices=None):
        """Advance one frame.  dets: (N, 5) [x1,y1,x2,y2,score] (may be empty;
        must be called every frame).  Returns (M, 6) rows
        [x1,y1,x2,y2,score,id] for confirmed tracks — or, on empty-detection
        frames with no confirmed tracks, the coasted predictions of every
        live track (reference sort.py:259-265).

        ``det_indices``: optional per-row global detection indices.  When
        given, the call instead returns ``(rows, emitted_det_idx)`` where
        ``emitted_det_idx`` maps each returned row to the detection that
        updated it this frame (-1 for coast rows) — the single-dispatch
        pipeline keys pre-computed keypoints with it.  Without it the
        plain rows keep the reference Sort.update contract."""
        if dets is None:
            dets = np.empty((0, 5), np.float32)
        dets = np.asarray(dets, np.float32).reshape(-1, 5)
        self.frame_count += 1
        empty_dets = len(dets) == 0

        trk_boxes = self._predict()
        matched, unmatched_dets, _ = associate(dets, trk_boxes,
                                               self.iou_threshold)
        self._apply_matches(dets, matched, det_indices)
        self._spawn(dets, unmatched_dets, det_indices)
        rows, emitted = self._emit_and_retire(empty_dets)
        return rows if det_indices is None else (rows, emitted)
