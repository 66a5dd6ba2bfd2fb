"""Batched constant-velocity Kalman filter for bbox tracking.

Re-derivation of the SORT box filter (reference: easy_ViTPose/sort.py:94-155,
which delegates the linear algebra to filterpy.KalmanFilter) as *batched*
array ops over all track slots at once: states (N, 7), covariances (N, 7, 7).
Runs on the host in numpy.

State: [cx, cy, s, r, vcx, vcy, vs] — box center, area, aspect ratio and
their velocities (r has no velocity).  Matches the reference's noise setup:
R = diag(1,1,10,10); P0 = diag(10,10,10,10,1e4,1e4,1e4);
Q = diag(1,1,1,1,0.01,0.01,1e-4).  The update uses the Joseph-form covariance
(filterpy's default), load-bearing for numeric parity.

The port's own numpy copy of ``easy_vitpose_tpu/track/kalman.py``.
"""
from __future__ import annotations

import numpy as np

DIM_X, DIM_Z = 7, 4

F = np.eye(DIM_X, dtype=np.float32)
F[0, 4] = F[1, 5] = F[2, 6] = 1.0
H = np.zeros((DIM_Z, DIM_X), dtype=np.float32)
H[0, 0] = H[1, 1] = H[2, 2] = H[3, 3] = 1.0
R = np.diag([1.0, 1.0, 10.0, 10.0]).astype(np.float32)
Q = np.diag([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4]).astype(np.float32)
P0 = np.diag([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4]).astype(np.float32)
I7 = np.eye(DIM_X, dtype=np.float32)


def bbox_to_z(bbox):
    """[x1,y1,x2,y2] -> [cx, cy, area, aspect] (reference sort.py:66-78)."""
    xp = np  # works for np arrays; jnp arrays dispatch via ufuncs anyway
    bbox = xp.asarray(bbox, dtype=np.float32)
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    cx = bbox[..., 0] + w / 2.0
    cy = bbox[..., 1] + h / 2.0
    return np.stack([cx, cy, w * h, w / h], axis=-1)


def x_to_bbox(x):
    """state -> [x1,y1,x2,y2] (reference sort.py:81-91)."""
    w = np.sqrt(x[..., 2] * x[..., 3])
    h = x[..., 2] / w
    return np.stack([x[..., 0] - w / 2.0, x[..., 1] - h / 2.0,
                     x[..., 0] + w / 2.0, x[..., 1] + h / 2.0], axis=-1)


def init_state(z):
    """New track from measurement z (..., 4). Returns (x (...,7), P (...,7,7))."""
    z = np.asarray(z, dtype=np.float32)
    x = np.concatenate([z, np.zeros(z.shape[:-1] + (3,), np.float32)], axis=-1)
    P = np.broadcast_to(P0, z.shape[:-1] + (DIM_X, DIM_X)).copy()
    return x, P


def predict(x, P):
    """Batched predict. x: (N, 7), P: (N, 7, 7).

    Includes the reference guard: if predicted area would go non-positive
    (s + vs <= 0), zero the area velocity first (sort.py:141-142).
    """
    vs_bad = (x[..., 6] + x[..., 2]) <= 0
    x = x.copy()
    x[..., 6] = np.where(vs_bad, 0.0, x[..., 6])
    x = x @ F.T
    P = np.einsum("ij,njk,lk->nil", F, P, F) + Q
    return x, P


def update(x, P, z):
    """Batched Joseph-form measurement update. z: (N, 4)."""
    y = z - x @ H.T                                     # (N, 4)
    PHt = np.einsum("nij,kj->nik", P, H)                # (N, 7, 4)
    S = np.einsum("ij,njk->nik", H, PHt) + R            # (N, 4, 4)
    K = PHt @ np.linalg.inv(S)                          # (N, 7, 4)
    x = x + np.einsum("nij,nj->ni", K, y)
    IKH = I7 - K @ H                                    # (N, 7, 7)
    P = np.einsum("nij,njk,nlk->nil", IKH, P, IKH) \
        + np.einsum("nij,jk,nlk->nil", K, R, K)
    return x, P


def iou_matrix(a, b):
    """Pairwise IoU, a: (N, 4), b: (M, 4) -> (N, M)
    (reference sort.py:47-63 semantics, including no zero-area guard)."""
    a = a[:, None]
    b = b[None, :]
    xx1 = np.maximum(a[..., 0], b[..., 0])
    yy1 = np.maximum(a[..., 1], b[..., 1])
    xx2 = np.minimum(a[..., 2], b[..., 2])
    yy2 = np.minimum(a[..., 3], b[..., 3])
    w = np.maximum(0.0, xx2 - xx1)
    h = np.maximum(0.0, yy2 - yy1)
    inter = w * h
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)
