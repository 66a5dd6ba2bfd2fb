"""Heatmap -> keypoint decoding, in PyTorch.

Port of ``easy_vitpose_tpu/ops/decode.py``:

* :func:`get_max_preds` — argmax decode, -1 where the max is <= 0 (ties to
  the first maximum, as ``jnp.argmax``; torch's argmax on either device);
* :func:`gaussian_blur_2d` — cv2.GaussianBlur(sigma=0) with reflect-101
  borders, as two separable passes;
* :func:`post_dark_udp` — the DARK/UDP Newton step on the log-modulated map:
  its blur + clip + log is the full-map K4 (``ops/modulate.py::udp_modulate``,
  ``csrc/modulate.cu``) with ``use_pallas=True`` on CUDA heatmaps, and the
  kernel's plain version otherwise, as JAX's ``use_pallas`` picks its Pallas
  kernel (default off);
* :func:`transform_preds` and :func:`keypoints_from_heatmaps_udp`;
* the rest of the library (reference top_down_eval.py): :func:`get_max_preds_3d`,
  :func:`keypoints_from_regression`, :func:`default_shift_decode`,
  :func:`modulate_gaussian_blur`, :func:`taylor_refine`, the front door
  :func:`keypoints_from_heatmaps` (default, megvii, unbiased/DARK, None and
  UDP) and :func:`keypoints_from_heatmaps3d`;
* :func:`decode_keypoints` — the pose step's whole decode (the above, the
  un-crop to the frame and the slot mask) as one launch of
  ``csrc/decode.cu``; :func:`decode_keypoints_plain` is its plain version;
  :func:`decode_task_groups` decodes a mixed-task step, one launch a task,
  each over its crops' own K maps.

Batched over (N, K) with no host loop, and with no host synchronisation on
the card: the constants it needs on the device are made once per device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel: int) -> np.ndarray:
    """cv2.getGaussianKernel(kernel, sigma=0) for kernel > 7: the sampled,
    normalized Gaussian with sigma = 0.3*((k-1)*0.5-1)+0.8."""
    sigma = 0.3 * ((kernel - 1) * 0.5 - 1) + 0.8
    x = np.arange(kernel, dtype=np.float64) - (kernel - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def gaussian_taps(kernel: int) -> Tuple[float, ...]:
    """:func:`gaussian_kernel_1d` as Python floats (exact float32 values),
    made once per kernel size."""
    return tuple(gaussian_kernel_1d(kernel).tolist())


def get_max_preds(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K, H, W) -> preds (N, K, 2) xy of the first maximum, maxvals
    (N, K, 1); preds are -1 where the maximum is <= 0."""
    N, K, H, W = heatmaps.shape
    flat = heatmaps.reshape(N, K, H * W)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None]
    preds = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    preds = torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0))
    return preds, maxvals


def gaussian_blur_2d(heatmaps: torch.Tensor, kernel: int) -> torch.Tensor:
    """Separable Gaussian blur of the last two dims of (N, K, H, W) with
    reflect-101 borders, summing the taps in order as the JAX version does."""
    r = kernel // 2
    g = gaussian_taps(kernel)
    H, W = heatmaps.shape[-2:]
    x = F.pad(heatmaps.float(), (r, r, r, r), mode="reflect")
    h = sum(x[..., :, i:i + W] * g[i] for i in range(kernel))
    return sum(h[..., i:i + H, :] * g[i] for i in range(kernel))


def post_dark_udp(coords: torch.Tensor, heatmaps: torch.Tensor,
                  kernel: int = 11, use_pallas: bool = False) -> torch.Tensor:
    """DARK/UDP sub-pixel refinement of (N, K, 2) integer argmax coords.

    The modulated map is edge-padded by one and flattened over the WHOLE
    batch, and the finite differences read it with wrap-around, as the
    reference does: a border or -1 coordinate reads the neighbouring map.
    Where the Hessian is singular the coordinate keeps its argmax (the
    reference's step is infinite there).
    ``use_pallas``: modulate with the full-map K4 (one launch on CUDA
    heatmaps; its plain version on the CPU).
    """
    from .modulate import udp_modulate, udp_modulate_plain

    N, K, H, W = heatmaps.shape
    hm = (udp_modulate(heatmaps.float(), kernel) if use_pallas
          else udp_modulate_plain(heatmaps, kernel))
    hm = F.pad(hm, (1, 1, 1, 1), mode="replicate")
    flat = hm.reshape(-1)
    ix = coords[..., 0].to(torch.int64) + 1
    iy = coords[..., 1].to(torch.int64) + 1
    per_map = (H + 2) * (W + 2)
    maps = torch.arange(N * K, dtype=torch.int64, device=coords.device).reshape(N, K)
    base = ix + iy * (W + 2) + per_map * maps

    def take(offset):
        return flat[(base + offset) % flat.numel()]

    i0 = take(0)
    ix1, iy1, ix1y1 = take(1), take(W + 2), take(W + 3)
    ix1_y1_, ix1_, iy1_ = take(-(W + 3)), take(-1), take(-(W + 2))

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2.0 * i0 + ix1_
    dyy = iy1 - 2.0 * i0 + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2.0 * i0 - ix1_ - iy1_ + ix1_y1_)

    eps = float(np.finfo(np.float32).eps)
    a = dxx + eps
    d = dyy + eps
    inv_det = 1.0 / (a * d - dxy * dxy)
    off_x = (d * dx - dxy * dy) * inv_det
    off_y = (a * dy - dxy * dx) * inv_det
    # A singular Hessian (det exactly 0: the modulated map clipped flat on
    # one side of the peak, so that dxx = dyy = -dxy) gives an infinite or
    # undefined step, where the reference returns -inf or raises: no step.
    ok = torch.isfinite(off_x) & torch.isfinite(off_y)
    off = torch.where(ok[..., None], torch.stack([off_x, off_y], dim=-1), 0.0)
    return coords - off


def transform_preds(coords: torch.Tensor, center: torch.Tensor, scale: torch.Tensor,
                    output_size: Tuple[int, int], use_udp: bool = True) -> torch.Tensor:
    """Heatmap-space (N, K, 2) xy -> image space, for box ``center`` (N, 2)
    and pixel size ``scale`` (N, 2); UDP divides by size - 1."""
    denom = _denominator(tuple(output_size), use_udp, coords.device)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which is not the IEEE division of the JAX version
    sxy = scale / denom
    return coords * sxy[:, None, :] + (center - scale * 0.5)[:, None, :]


@functools.lru_cache(maxsize=None)
def _denominator(output_size: Tuple[int, int], use_udp: bool,
                 device: torch.device) -> torch.Tensor:
    """(2,) float32 size, minus one with UDP, made once per device."""
    out = torch.tensor(output_size, dtype=torch.float32)
    return (out - 1.0 if use_udp else out).to(device)


def keypoints_from_heatmaps_udp(heatmaps: torch.Tensor, center: torch.Tensor,
                                scale: torch.Tensor, kernel: int = 11,
                                use_pallas: bool = False
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """UDP decode: (preds (N, K, 2) image-space xy, maxvals (N, K, 1));
    ``use_pallas`` as :func:`post_dark_udp`."""
    N, K, H, W = heatmaps.shape
    preds, maxvals = get_max_preds(heatmaps)
    preds = post_dark_udp(preds, heatmaps, kernel=kernel, use_pallas=use_pallas)
    return transform_preds(preds, center, scale, (W, H), use_udp=True), maxvals


def get_max_preds_3d(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax decode of (N, K, D, H, W) score maps -> preds (N, K, 3) as
    (x, y, z), maxvals (N, K, 1); -1 where the maximum is <= 0."""
    N, K, D, H, W = heatmaps.shape
    flat = heatmaps.reshape(N, K, D * H * W)
    idx = torch.argmax(flat, dim=2)
    maxvals = torch.amax(flat, dim=2)[..., None]
    preds = torch.stack([(idx % W).float(), ((idx // W) % H).float(),
                         (idx // (H * W)).float()], dim=-1)
    return torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0)), maxvals


def keypoints_from_regression(regression_preds: torch.Tensor, center: torch.Tensor,
                              scale: torch.Tensor, img_size: Tuple[int, int]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized (N, K, 2) regression output -> image coords: times
    ``img_size`` (W, H), then the non-UDP transform; scores are 1."""
    N, K, _ = regression_preds.shape
    size = _denominator(tuple(img_size), False, regression_preds.device)
    preds = transform_preds(regression_preds * size, center, scale, img_size, use_udp=False)
    return preds, torch.ones((N, K, 1), dtype=torch.float32, device=regression_preds.device)


def _at(flat: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """``flat`` (N, K, H*W) at the clamped (yy, xx) of each map."""
    idx = torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)
    return torch.gather(flat, 2, idx[..., None])[..., 0]


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: NaN stays NaN (``torch.sign`` gives 0), as on megvii's
    rescale of an all-zero map."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


def default_shift_decode(heatmaps: torch.Tensor, return_gate: bool = False):
    """The non-UDP 'default' post-process: the argmax moved 0.25 toward the
    higher neighbour on each axis, for interior peaks only.
    ``return_gate`` also returns that interior-peak gate (N, K) float32."""
    N, K, H, W = heatmaps.shape
    preds, maxvals = get_max_preds(heatmaps)
    px, py = preds[..., 0].to(torch.int64), preds[..., 1].to(torch.int64)
    flat = heatmaps.reshape(N, K, H * W)
    diff_x = _at(flat, py, px + 1, H, W) - _at(flat, py, px - 1, H, W)
    diff_y = _at(flat, py + 1, px, H, W) - _at(flat, py - 1, px, H, W)
    ok = ((px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)).float()
    shift = torch.stack([_sign(diff_x), _sign(diff_y)], dim=-1) * 0.25
    out = preds + shift * ok[..., None]
    return (out, maxvals, ok) if return_gate else (out, maxvals)


def modulate_gaussian_blur(heatmaps: torch.Tensor, kernel: int) -> torch.Tensor:
    """The reference's modulation blur (top_down_eval.py:418-457): each map
    zero-padded by the kernel radius, blurred (the taps summed in order)
    and rescaled so its maximum is the original maximum."""
    r = kernel // 2
    g = gaussian_taps(kernel)
    x = heatmaps.float()
    H, W = x.shape[-2:]
    orig_max = torch.amax(x, dim=(-2, -1), keepdim=True)
    xp = F.pad(x, (r, r, r, r))
    h1 = sum(xp[..., :, i:i + W] * g[i] for i in range(kernel))
    out = sum(h1[..., i:i + H, :] * g[i] for i in range(kernel))
    return out * orig_max / torch.amax(out, dim=(-2, -1), keepdim=True)


def taylor_refine(log_heatmaps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """DARK 'unbiased' refinement: one Newton step on the log heatmaps
    around each (N, K, 2) argmax, from finite differences, for interior
    peaks (1 < p < size - 2) with an invertible Hessian."""
    N, K, H, W = log_heatmaps.shape
    flat = log_heatmaps.reshape(N, K, H * W)
    px, py = coords[..., 0].to(torch.int64), coords[..., 1].to(torch.int64)

    def at(dy, dx):
        return _at(flat, py + dy, px + dx, H, W)

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = 0.25 * (at(0, 2) - 2.0 * at(0, 0) + at(0, -2))
    dxy = 0.25 * (at(1, 1) - at(-1, 1) - at(1, -1) + at(-1, -1))
    dyy = 0.25 * (at(2, 0) - 2.0 * at(0, 0) + at(-2, 0))
    det = dxx * dyy - dxy * dxy
    ok = (px > 1) & (px < W - 2) & (py > 1) & (py < H - 2) & (det != 0)
    safe = torch.where(det == 0, torch.ones_like(det), det)
    off_x = -(dyy * dx - dxy * dy) / safe
    off_y = -(dxx * dy - dxy * dx) / safe
    return coords + torch.stack([off_x, off_y], dim=-1) * ok[..., None]


def keypoints_from_heatmaps(heatmaps: torch.Tensor, center: torch.Tensor,
                            scale: torch.Tensor, *, post_process: Optional[str] = "default",
                            unbiased: bool = False, kernel: int = 11, use_udp: bool = False,
                            use_pallas: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mmpose-compatible decode front door (reference
    top_down_eval.py:493-641), with JAX's dispatch and arguments: UDP
    (``use_pallas`` runs the full-map K4 on CUDA heatmaps), 'unbiased'
    (DARK), 'default' (the 0.25 shift), 'megvii' (blurred maps, +0.5 inside
    the same gate, rescaled scores) or None (the raw argmax), then the
    image-space transform.  -> (preds (N, K, 2) xy, maxvals (N, K, 1))."""
    if unbiased:
        post_process = "unbiased"
    if use_udp:
        if post_process == "megvii":
            raise ValueError("megvii is a non-UDP post-process")
        return keypoints_from_heatmaps_udp(heatmaps, center, scale, kernel=kernel,
                                           use_pallas=use_pallas)
    N, K, H, W = heatmaps.shape
    if post_process == "megvii":
        heatmaps = modulate_gaussian_blur(heatmaps, kernel)
    if post_process == "unbiased":
        preds, maxvals = get_max_preds(heatmaps)
        logm = torch.log(torch.clamp(modulate_gaussian_blur(heatmaps, kernel), min=1e-10))
        preds = taylor_refine(logm, preds)
    elif post_process is None:
        preds, maxvals = get_max_preds(heatmaps)
    else:
        preds, maxvals, gate = default_shift_decode(heatmaps, return_gate=True)
        if post_process == "megvii":
            preds = preds + 0.5 * gate[..., None]
    preds = transform_preds(preds, center, scale, (W, H), use_udp=False)
    if post_process == "megvii":
        maxvals = maxvals / 255.0 + 0.5
    return preds, maxvals


def keypoints_from_heatmaps3d(heatmaps: torch.Tensor, center: torch.Tensor,
                              scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D argmax decode, the xy plane mapped to image space (z stays in
    heatmap depth units)."""
    N, K, D, H, W = heatmaps.shape
    preds, maxvals = get_max_preds_3d(heatmaps)
    xy = transform_preds(preds[..., :2], center, scale, (W, H), use_udp=False)
    return torch.cat([xy, preds[..., 2:]], dim=-1), maxvals


def newton_point_index(coords: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Where :func:`post_dark_udp` reads the modulated maps, as (N, K, 7)
    flat indices into the unpadded (N*K*H*W) maps, in the order i0, ix1,
    iy1, ix1y1, ix1_y1_, ix1_, iy1_: the decode kernel's index arithmetic.
    The flat take of the edge-padded batch, wrapped modulo its size, is a
    clamp of the padded row and column onto the map the index falls in."""
    N, K = coords.shape[:2]
    Wp = W + 2
    per_map, total = (H + 2) * Wp, N * K * (H + 2) * Wp
    maps = torch.arange(N * K, dtype=torch.int64, device=coords.device).reshape(N, K)
    base = (coords[..., 0].to(torch.int64) + 1 + (coords[..., 1].to(torch.int64) + 1) * Wp
            + per_map * maps)
    offsets = torch.tensor([0, 1, Wp, Wp + 1, -(Wp + 1), -1, -Wp], device=coords.device)
    f = (base[..., None] + offsets) % total
    m, rem = f // per_map, f % per_map
    y = torch.clamp(rem // Wp - 1, 0, H - 1)
    x = torch.clamp(rem % Wp - 1, 0, W - 1)
    return (m * H + y) * W + x


def decode_keypoints_plain(heat: torch.Tensor, geo: torch.Tensor, mask: torch.Tensor,
                           kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_keypoints`: the UDP decode
    with the padded crop's center (wp//2, hp//2) and size (wp, hp), the
    un-crop (x += x1 - left, y += y1 - top) and the mask, in eager ops."""
    from .preprocess import geometry_views

    g = geometry_views(geo)
    center = torch.stack([g["wp"] // 2, g["hp"] // 2], dim=-1).float()
    scale = torch.stack([g["wp"], g["hp"]], dim=-1).float()
    preds, maxvals = keypoints_from_heatmaps_udp(heat.float(), center, scale, kernel)
    off_x = (g["x1"] - g["left"]).float()[:, None]
    off_y = (g["y1"] - g["top"]).float()[:, None]
    kpts = torch.stack([preds[..., 1] + off_y, preds[..., 0] + off_x, maxvals[..., 0]], dim=-1)
    return torch.where(mask[:, None, None], kpts, torch.zeros_like(kpts))


def decode_task_groups(heats, geo: torch.Tensor, mask: torch.Tensor, slices, k_max: int,
                       plain: bool = False) -> torch.Tensor:
    """The decode of a step whose crops run through several heads: for
    each (head, first crop, end crop) of ``slices`` and its (n, K, H, W)
    heatmaps in ``heats``, :func:`decode_keypoints` (one launch on the card;
    ``plain=True`` or CPU maps: its plain version) over those crops' own K
    maps, geometry and mask.  -> (M, k_max, 3) float32 keypoints in the
    crops' order; rows past a crop's K and masked crops are zero."""
    decode = decode_keypoints_plain if plain else decode_keypoints
    out = torch.zeros((geo.shape[0], k_max, 3), dtype=torch.float32, device=geo.device)
    for (_, first, end), heat in zip(slices, heats):
        out[first:end, :heat.shape[1]] = decode(heat, geo[first:end], mask[first:end])
    return out


def decode_keypoints(heat: torch.Tensor, geo: torch.Tensor, mask: torch.Tensor,
                     kernel: int = 11, with_points: bool = False):
    """The pose step's decode: (M, K, H, W) heatmaps (float32, or bfloat16
    widened as ``.float()`` widens it), the packed (M, 8) int32 crop
    geometry (:func:`..ops.sampler.crop_normalize`) and the (M,) bool slot
    mask -> (M, K, 3) float32 keypoints (y, x, score) in frame coordinates;
    masked slots are zero.

    Heatmaps on the CPU take the plain version; CUDA heatmaps launch
    ``csrc/decode.cu`` once.  Its arithmetic is the plain version's, op for
    op: argmax and score are the same bits, and the seven modulated points
    are :func:`..ops.modulate.modulate_at_plain`'s.

    ``with_points=True`` also returns the (M, K, 7) modulated values the
    Newton step read (at :func:`newton_point_index`; zero in masked slots),
    to hold them against the full-map kernel.
    """
    from .modulate import check_kernel_size, modulate_at_plain, taps_struct

    if heat.device.type == "cpu":
        kpts = decode_keypoints_plain(heat, geo, mask, kernel)
        if not with_points:
            return kpts
        coords, _ = get_max_preds(heat.float())
        pts = modulate_at_plain(heat, newton_point_index(coords, *heat.shape[-2:]), kernel)
        return kpts, torch.where(mask[:, None, None], pts, torch.zeros_like(pts))
    from .. import kernels

    dev = kernels.require_cuda(heat, geo, mask)
    if heat.dim() != 4 or heat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"heatmaps must be (M, K, H, W) float32 or bfloat16, got "
                         f"{tuple(heat.shape)} {heat.dtype}")
    M, K, H, W = heat.shape
    if tuple(geo.shape) != (M, 8) or geo.dtype != torch.int32:
        raise ValueError(f"geometry must be ({M}, 8) int32, got {tuple(geo.shape)} {geo.dtype}")
    if tuple(mask.shape) != (M,) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({M},) bool, got {tuple(mask.shape)} {mask.dtype}")
    check_kernel_size(kernel, H, W)
    heat, geo, mask = heat.contiguous(), geo.contiguous(), mask.contiguous()
    out = torch.empty((M, K, 3), dtype=torch.float32, device=dev)
    pts = torch.zeros((M, K, 7), dtype=torch.float32, device=dev) if with_points else None
    if out.numel():
        kernels.call("decode", "evt_decode_keypoints", dev, heat.data_ptr(),
                     int(heat.dtype == torch.bfloat16), geo.data_ptr(), mask.data_ptr(),
                     taps_struct(kernel), out.data_ptr(), pts.data_ptr() if with_points else None,
                     M, K, H, W, kernel // 2)
        kernels.count_launch("decode")
    return (out, pts) if with_points else out
