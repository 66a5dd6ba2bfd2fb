"""Latency-budget auto-tuning for webcam/live serving.

Port of ``easy_vitpose_tpu/pipeline/autotune.py`` (host-side, no device
work).

The reference exposes ``yolo_step`` as a fixed CLI knob (reference
inference.py:165-168: "Run YOLO detection every N frames"); for live input
the right value depends on the machine, so this controller adjusts it from
the measured frame budget: detection is the elastic cost (the tracker coasts
between detections, reference sort.py:259-265), so under-budget frames raise
``yolo_step`` (detect less often) and head-room lowers it back toward every
frame (best accuracy).
"""
from __future__ import annotations


class YoloStepAutoTuner:
    """EMA frame-time controller with hysteresis.

    Call :meth:`update` with each frame's wall time; apply the returned step
    via ``VitInference.set_yolo_step`` (it also retunes the tracker's
    max_age/min_hits like ``reset()`` would).
    """

    def __init__(self, target_fps: float, min_step: int = 1,
                 max_step: int = 10, ema: float = 0.9,
                 adjust_every: int = 15):
        if not target_fps > 0:
            raise ValueError(f"target_fps must be positive, got {target_fps}")
        self.target = target_fps
        self.min_step = min_step
        self.max_step = max_step
        self.ema = ema
        self.adjust_every = adjust_every
        self.step = min_step
        self._avg_dt = None
        self._count = 0

    def update(self, frame_dt: float) -> int:
        """Feed one frame's seconds; returns the (possibly new) yolo_step."""
        self._avg_dt = (frame_dt if self._avg_dt is None
                        else self.ema * self._avg_dt
                        + (1 - self.ema) * frame_dt)
        self._count += 1
        if self._count % self.adjust_every:
            return self.step
        fps = 1.0 / max(self._avg_dt, 1e-9)
        if fps < 0.9 * self.target and self.step < self.max_step:
            self.step += 1
        elif fps > 1.25 * self.target and self.step > self.min_step:
            # only relax when there is clear headroom (hysteresis band
            # 0.9..1.25 prevents oscillation at the boundary)
            self.step -= 1
        return self.step
