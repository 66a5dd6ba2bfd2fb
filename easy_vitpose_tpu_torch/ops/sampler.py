"""K3: crop geometry, the crop sampler and the ImageNet normalize, fused.

Replaces ``easy_vitpose_tpu/ops/pallas_sampler.py::_sampler_kernel``
(``pl.pallas_call`` in ``sample_crops_pallas``), the TPU's window-streamed
crop sampler that interpolates with one-hot matmuls on the MXU.

On Hopper the natural form is the direct gather (``csrc/sampler.cu``), and
one launch takes the pose step from boxes to the backbone's input: a block
takes one box and a band of 16 output rows, computes the box's geometry
exactly as :func:`..ops.preprocess.crop_geometry` does, the taps of every
output column once and of each of its rows once, exactly as
:func:`..ops.preprocess.sample_crops` computes them.  A thread takes 8
whole output pixels (4 in float32): each pixel's four frame reads (its
three channels from the aligned 32-bit words that hold them) and taps
serve all three channels, the lerps run in the working dtype (in bf16 as
packed bf16x2 arithmetic with the same roundings), and the 24 values go
out in three 16-byte stores.  The first band of each box also writes its
packed geometry, which the decode reads.  What bounds it on the H100 is
bytes: the frame under the boxes read once through L2 (at most 6.2 MB at
1080p) and the crops written once (18.9 MB in bf16 at 64 slots), about 7
us at 3.35 TB/s; it does ~40 flops per output value, and those, with the
normalize's IEEE division, keep it several times above that bound.

Stacked frames: given (S, H, W, 3) frames and an (M,) int32 frame index,
each block reads its box's own frame (JAX's ``sample_crops(frame_idx=)``,
the gather over the stack axis); boxes stay frame-local and the geometry
uses the stack's (H, W).  The index is taken as JAX's gather takes it
(:func:`..ops.preprocess.clamp_frame_idx`), on the card, with no host check.

Numerics: the working dtype is the sampling dtype, as on JAX's main path
(``pipeline/pose_step.py``, ``sample_dtype=compute_dtype``).  In bfloat16
the kernel rounds where JAX's ``sample_crops`` rounds: the tap weight ``f``,
``1 - f``, each product and each sum of the x pass and of the y pass; it
then normalizes the bf16 crop value in float32 and rounds once more.  In
float32 nothing rounds before the normalize.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import kernels
from ..configs import IMAGE_SIZE
from .preprocess import (Geometry, crop_geometry, imagenet_mean_std, normalize_crops,
                         pack_geometry, sample_crops)

KERNEL = "sampler"
MAX_OUT_W = 2048        # the column taps stay within 48 KB of shared memory


def sample_normalize_plain(frame: torch.Tensor, geo: Geometry,
                           out_wh: Tuple[int, int] = IMAGE_SIZE,
                           dtype=torch.float32,
                           frame_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, OH, OW, 3) normalized crops of a :func:`crop_geometry`, sampled
    in ``dtype``: the plain version of the kernel's crops."""
    return normalize_crops(sample_crops(frame, geo, out_wh, sample_dtype=dtype,
                                        frame_idx=frame_idx), dtype)


def crop_normalize_plain(frame: torch.Tensor, boxes: torch.Tensor,
                         out_wh: Tuple[int, int] = IMAGE_SIZE,
                         dtype=torch.float32,
                         frame_idx: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ((M, OH, OW, 3) normalized
    crops, (M, 8) int32 packed geometry)."""
    geo = crop_geometry(boxes, tuple(frame.shape[-3:-1]))
    return sample_normalize_plain(frame, geo, out_wh, dtype, frame_idx), pack_geometry(geo)


@functools.lru_cache(maxsize=None)
def _mean_std() -> Tuple[float, ...]:
    mean, std = imagenet_mean_std()
    return (*mean.tolist(), *std.tolist())


def crop_normalize(frame: torch.Tensor, boxes: torch.Tensor,
                   out_wh: Tuple[int, int] = IMAGE_SIZE,
                   dtype=torch.float32,
                   frame_idx: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crops of every box, normalized, in ``dtype`` (float32 or bfloat16),
    and their packed geometry (rows [x1, y1, wc, hc, wp, hp, left, top];
    :func:`..ops.preprocess.geometry_views` names its columns).

    Args:
      frame: (H, W, 3) uint8 RGB frame, or a stack (S, H, W, 3) of frames
        of one size when ``frame_idx`` is given.
      boxes: (M, 4) float32 [x1, y1, x2, y2] frame-local boxes, before
        inflation.
      frame_idx: (M,) int32, the frame of each box in the stack.
    A frame on the CPU takes the plain version; a CUDA frame launches the
    kernel once.
    """
    if frame.device.type == "cpu":
        return crop_normalize_plain(frame, boxes, out_wh, dtype, frame_idx)
    tensors = (frame, boxes) if frame_idx is None else (frame, boxes, frame_idx)
    dev = kernels.require_cuda(*tensors)
    lead = 3 if frame_idx is None else 4
    if (frame.dtype != torch.uint8 or frame.dim() != lead or frame.shape[-1] != 3
            or frame.numel() == 0):
        want = "(H, W, 3)" if frame_idx is None else "(S, H, W, 3) with frame_idx"
        raise ValueError(f"frame must be {want} uint8, got {tuple(frame.shape)} {frame.dtype}")
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (M, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if frame_idx is not None and (frame_idx.dtype != torch.int32
                                  or tuple(frame_idx.shape) != (boxes.shape[0],)):
        raise ValueError(f"frame_idx must be (M,) int32, got {tuple(frame_idx.shape)} "
                         f"{frame_idx.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    OW, OH = out_wh
    if not 0 < OW <= MAX_OUT_W or OH <= 0:
        raise ValueError(f"output size {out_wh} is not supported")
    frame, boxes = frame.contiguous(), boxes.contiguous()
    H, W = frame.shape[-3:-1]
    S = 1 if frame_idx is None else frame.shape[0]
    fidx = None if frame_idx is None else frame_idx.contiguous()
    M = boxes.shape[0]
    out = torch.empty((M, OH, OW, 3), dtype=dtype, device=dev)
    geo = torch.empty((M, 8), dtype=torch.int32, device=dev)
    if M == 0:
        return out, geo
    kernels.call(KERNEL, "evt_crop_sample", dev, frame.data_ptr(),
                 None if fidx is None else fidx.data_ptr(), S, boxes.data_ptr(),
                 geo.data_ptr(), out.data_ptr(), M, H, W, OH, OW, *_mean_std(),
                 int(dtype == torch.bfloat16))
    kernels.count_launch(KERNEL)
    return out, geo
