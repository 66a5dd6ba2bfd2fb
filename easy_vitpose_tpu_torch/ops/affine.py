"""Affine transforms for training augmentation and the flip test.

The port's own copy of ``easy_vitpose_tpu/ops/affine.py``:

* the training side, host numpy, bit for bit the JAX package's functions
  (reference vit_utils/transform.py:32-96): the pixel_std-parameterized
  :func:`get_affine_transform` (a 3-point solve), :func:`affine_transform`,
  :func:`affine_transform_batch`, :func:`fliplr_joints`;
* the UDP warp (reference post_processing/post_transforms.py:312-359):
  :func:`get_warp_matrix`, :func:`warp_affine_joints`;
* :func:`fliplr_regression` (post_transforms.py:54-107) in numpy;
* :func:`flip_back_heatmaps` in PyTorch, for the flip test on the device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _rotate_vec(v, rot_rad):
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([v[0] * cs - v[1] * sn, v[0] * sn + v[1] * cs],
                    dtype=np.float32)


def _third_point(a, b):
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def _solve_affine(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Exact 3-point affine solve (what cv2.getAffineTransform computes)."""
    A = np.concatenate([src, np.ones((3, 1), np.float64)], axis=1)
    out = np.linalg.solve(A, dst.astype(np.float64))
    return out.T  # (2, 3)


def get_affine_transform(center, scale, pixel_std, rot, output_size,
                         shift=(0.0, 0.0), inv: bool = False) -> np.ndarray:
    """Crop-to-output affine (reference transform.py:46-75 semantics)."""
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale, np.float32)
    shift = np.asarray(shift, np.float32)
    scale_tmp = scale * 1.0 * pixel_std
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    rot_rad = np.pi * rot / 180.0
    src_dir = _rotate_vec([0.0, src_w * -0.5], rot_rad)
    dst_dir = np.array([0.0, dst_w * -0.5], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        return _solve_affine(dst, src)
    return _solve_affine(src, dst)


def affine_transform(pt, t) -> np.ndarray:
    """Apply 2x3 affine to one point (reference transform.py:78-81)."""
    p = np.array([pt[0], pt[1], 1.0])
    return (t @ p)[:2]


def affine_transform_batch(pts: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N, 2) points through a 2x3 affine."""
    return pts @ t[:, :2].T + t[:, 2]


def fliplr_joints(joints: np.ndarray, joints_vis: np.ndarray, width: int,
                  matched_parts: Sequence[Sequence[int]]):
    """Horizontal flip of joints + left/right swap
    (reference transform.py:32-43, incl. the final ``joints * joints_vis``)."""
    joints = joints.copy()
    joints_vis = joints_vis.copy()
    joints[:, 0] = width - joints[:, 0] - 1
    for a, b in matched_parts:
        joints[[a, b]] = joints[[b, a]]
        joints_vis[[a, b]] = joints_vis[[b, a]]
    return joints * joints_vis, joints_vis


def get_warp_matrix(theta: float, size_input, size_dst, size_target
                    ) -> np.ndarray:
    """UDP-style warp matrix (reference post_transforms.py:312-340)."""
    theta = np.deg2rad(theta)
    matrix = np.zeros((2, 3), dtype=np.float32)
    scale_x = size_dst[0] / size_target[0]
    scale_y = size_dst[1] / size_target[1]
    matrix[0, 0] = np.cos(theta) * scale_x
    matrix[0, 1] = -np.sin(theta) * scale_x
    matrix[0, 2] = scale_x * (
        -0.5 * size_input[0] * np.cos(theta)
        + 0.5 * size_input[1] * np.sin(theta) + 0.5 * size_target[0])
    matrix[1, 0] = np.sin(theta) * scale_y
    matrix[1, 1] = np.cos(theta) * scale_y
    matrix[1, 2] = scale_y * (
        -0.5 * size_input[0] * np.sin(theta)
        - 0.5 * size_input[1] * np.cos(theta) + 0.5 * size_target[1])
    return matrix


def warp_affine_joints(joints: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """(…, 2) joints through a 2x3 matrix (post_transforms.py:343-359)."""
    shape = joints.shape
    j = joints.reshape(-1, 2)
    out = np.concatenate([j, np.ones((len(j), 1))], axis=1) @ mat.T
    return out.reshape(shape)


def fliplr_regression(regression, flip_pairs: Sequence[Sequence[int]],
                      center_mode: str = "static", center_x: float = 0.5,
                      center_index: int = 0) -> np.ndarray:
    """Flip regression-decoded joints horizontally (reference
    post_processing/post_transforms.py:54-107): swap mirrored pairs, then
    reflect x around a static center or a root joint's x, over any leading
    batch axes ([..., K, C])."""
    reg = np.asarray(regression)
    if center_mode == "static":
        x_c = center_x
    elif center_mode == "root":
        x_c = reg[..., center_index:center_index + 1, 0]
    else:
        raise ValueError(f"center_mode {center_mode!r} not in "
                         "{'static', 'root'}")
    K = reg.shape[-2]
    perm = list(range(K))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    out = reg[..., perm, :].copy()
    out[..., 0] = x_c * 2 - out[..., 0]
    return out


def flip_back_heatmaps(heatmaps: torch.Tensor,
                       flip_pairs: Sequence[Sequence[int]]) -> torch.Tensor:
    """Un-flip (N, K, H, W) heatmaps of a horizontally flipped input: swap
    the left/right channels, then mirror the width."""
    perm = list(range(heatmaps.shape[1]))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return heatmaps[:, perm].flip(-1)
