"""K3: the crop sampler with the ImageNet normalize fused in.

Replaces ``easy_vitpose_tpu/ops/pallas_sampler.py::_sampler_kernel``
(``pl.pallas_call`` in ``sample_crops_pallas``), the TPU's window-streamed
crop sampler that interpolates with one-hot matmuls on the MXU.

On Hopper the natural form is the direct gather (``csrc/sampler.cu``): one
thread per output pixel computes its two x and two y taps from the integer
crop geometry exactly as :func:`..ops.preprocess.sample_crops` does, lerps
the four uint8 taps in the working dtype, normalizes and writes the
backbone's NHWC input in that dtype.  What bounds it on the H100 is bytes: the frame
is read once through L2 (6.2 MB at 1080p) and the crops are written once
(18.9 MB in bf16 at 64 slots), about 8 us at 3.35 TB/s; it does ~40 flops
per output value.  Neighbouring threads take neighbouring output pixels, so
the writes coalesce and the taps of a warp fall on a few frame rows.

Numerics: the working dtype is the sampling dtype, as on JAX's main path
(``pipeline/pose_step.py``, ``sample_dtype=compute_dtype``).  In bfloat16
the kernel rounds where JAX's ``sample_crops`` rounds: the tap weight ``f``,
``1 - f``, each product and each sum of the x pass and of the y pass; it
then normalizes the bf16 crop value in float32 and rounds once more.  In
float32 nothing rounds before the normalize.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..configs import IMAGE_SIZE
from .preprocess import (Geometry, imagenet_mean_std, normalize_crops,
                         pack_geometry, sample_crops)

KERNEL = "sampler"


def sample_normalize_plain(frame: torch.Tensor, geo: Geometry,
                           out_wh: Tuple[int, int] = IMAGE_SIZE,
                           dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, OH, OW, 3) normalized crops,
    sampled in ``dtype``."""
    return normalize_crops(sample_crops(frame, geo, out_wh, sample_dtype=dtype), dtype)


def sample_normalize(frame: torch.Tensor, geo: Geometry,
                     out_wh: Tuple[int, int] = IMAGE_SIZE,
                     dtype=torch.float32) -> torch.Tensor:
    """Crops of every box, normalized, in ``dtype`` (float32 or bfloat16).

    A frame on the CPU takes the plain version; a CUDA frame launches the
    kernel.
    """
    if frame.device.type == "cpu":
        return sample_normalize_plain(frame, geo, out_wh, dtype)
    dev = kernels.require_cuda(frame, geo["x1"])
    if frame.dtype != torch.uint8 or frame.dim() != 3 or frame.shape[2] != 3:
        raise ValueError(f"frame must be (H, W, 3) uint8, got {tuple(frame.shape)} {frame.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    frame = frame.contiguous()
    H, W = frame.shape[:2]
    OW, OH = out_wh
    g = pack_geometry(geo)
    M = g.shape[0]
    out = torch.empty((M, OH, OW, 3), dtype=dtype, device=dev)
    if M == 0:
        return out
    mean, std = imagenet_mean_std()
    kernels.call(KERNEL, "evt_sample_crops", dev,
                 frame.data_ptr(), g.data_ptr(), out.data_ptr(),
                 M, H, W, OH, OW, *mean.tolist(), *std.tolist(),
                 int(dtype == torch.bfloat16))
    kernels.count_launch(KERNEL)
    return out
