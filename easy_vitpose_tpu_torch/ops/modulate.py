"""K4: the UDP modulate — Gaussian blur, clip to [0.001, 50], log.

Replaces ``easy_vitpose_tpu/ops/pallas_kernels.py::_modulate_kernel_body``
(``pl.pallas_call`` in ``udp_modulate_pallas``), which blurs one pre-padded
map per grid step in VMEM.

``csrc/modulate.cu`` takes one block per map: it reads the map once into
shared memory, runs the horizontal and then the vertical 11-tap pass with
reflect-101 indexing done in the kernel (so the host pad pass of the TPU
version goes), clips, takes the log and writes the map once.  The taps are
``gaussian_kernel_1d(kernel)`` and are summed in the same order as
:func:`..ops.decode.gaussian_blur_2d`.  What bounds it on the H100 is
bytes: 1,088 maps of 64x48 float32 in and out at ViT-B/64 slots, 26.7 MB,
8 us at 3.35 TB/s; the 22 taps are ~44 flops per value.
"""
from __future__ import annotations

import torch

from .. import kernels
from .decode import gaussian_blur_2d, gaussian_kernel_1d

KERNEL = "modulate"
MAX_MAP_FLOATS = 232448 // 4    # the map and its horizontal pass, in shared memory


def udp_modulate_plain(heatmaps: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version: log(clip(blur(heatmaps), 0.001, 50)), float32."""
    return torch.log(torch.clamp(gaussian_blur_2d(heatmaps, kernel), 0.001, 50.0))


def udp_modulate(heatmaps: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Blur + clip + log of (N, K, H, W) heatmaps, in float32.

    Heatmaps on the CPU take the plain version; CUDA heatmaps launch the
    kernel.
    """
    if heatmaps.device.type == "cpu":
        return udp_modulate_plain(heatmaps, kernel)
    dev = kernels.require_cuda(heatmaps)
    if heatmaps.dtype != torch.float32 or heatmaps.dim() != 4:
        raise ValueError(f"heatmaps must be (N, K, H, W) float32, got "
                         f"{tuple(heatmaps.shape)} {heatmaps.dtype}")
    N, K, H, W = heatmaps.shape
    r = kernel // 2
    if (kernel % 2 == 0 or kernel > kernels.MAX_TAPS or r >= min(H, W)
            or 2 * H * W > MAX_MAP_FLOATS):
        raise ValueError(f"kernel {kernel} on {H}x{W} maps is not supported")
    x = heatmaps.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    taps = kernels.Taps()
    taps.v[:kernel] = gaussian_kernel_1d(kernel).tolist()
    kernels.call(KERNEL, "evt_udp_modulate", dev, x.data_ptr(), taps,
                 out.data_ptr(), N * K, H, W, r)
    kernels.count_launch(KERNEL)
    return out
