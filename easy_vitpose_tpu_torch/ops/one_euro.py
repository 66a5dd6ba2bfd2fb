"""One-Euro temporal keypoint smoothing filter.

Capability parity with the reference's exported-but-optional filter
(reference vit_utils/post_processing/one_euro_filter.py:19-102): adaptive
low-pass whose cutoff rises with signal speed, applied element-wise to
keypoint arrays across frames.  Vectorized over all keypoints at once.

The port's own numpy copy of ``easy_vitpose_tpu/ops/one_euro.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np


def smoothing_factor(t_e: float, cutoff) -> np.ndarray:
    r = 2.0 * math.pi * np.asarray(cutoff) * t_e
    return r / (r + 1.0)


def exponential_smoothing(a, x, x_prev):
    return a * x + (1.0 - a) * x_prev


class OneEuroFilter:
    """Filter a stream of (..., )-shaped keypoint arrays.

    Args follow the standard formulation: ``min_cutoff`` (base low-pass
    cutoff, Hz), ``beta`` (speed coefficient), ``d_cutoff`` (derivative
    cutoff), ``fps`` (fixed frame rate; if None, pass ``t`` per call).
    """

    def __init__(self, x0: np.ndarray, dx0=0.0, min_cutoff: float = 1.7,
                 beta: float = 0.3, d_cutoff: float = 30.0,
                 fps: Optional[float] = 30.0):
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.d_cutoff = float(d_cutoff)
        self.fps = fps
        self.x_prev = np.asarray(x0, np.float64).copy()
        self.dx_prev = np.full_like(self.x_prev, dx0)
        self.t = 0.0

    def __call__(self, x: np.ndarray, t: Optional[float] = None) -> np.ndarray:
        if t is None:
            assert self.fps, "fps not set; pass explicit timestamps"
            t_e = 1.0 / self.fps
        else:
            t_e = max(t - self.t, 1e-6)
            self.t = t
        x = np.asarray(x, np.float64)
        a_d = smoothing_factor(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = exponential_smoothing(a_d, dx, self.dx_prev)
        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = smoothing_factor(t_e, cutoff)
        x_hat = exponential_smoothing(a, x, self.x_prev)
        self.x_prev = x_hat
        self.dx_prev = dx_hat
        return x_hat


def apply_track_smoothing(kps, smoothers: dict, **smooth_kw):
    """Per-track One-Euro smoothing of ``{track_id: (K, 3)}`` keypoints
    (y/x smoothed, scores pass through), maintaining one filter per live
    track in ``smoothers``.  A track's filter initializes on its first
    frame and is dropped the frame the track disappears, so a re-acquired
    id restarts clean.  Shared by the single-stream pipeline
    (VitInference ``smooth=True``) and the multi-stream server."""
    import numpy as np
    out = {}
    for pid, kp in kps.items():
        f = smoothers.get(pid)
        if f is None:
            smoothers[pid] = OneEuroFilter(kp[:, :2], **smooth_kw)
            out[pid] = kp
        else:
            sm = kp.copy()
            sm[:, :2] = f(kp[:, :2]).astype(kp.dtype)
            out[pid] = sm
    for pid in list(smoothers):
        if pid not in kps:
            del smoothers[pid]
    return out
