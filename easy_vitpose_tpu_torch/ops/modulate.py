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

The pose step does not run the full map: its fused decode
(:func:`..ops.decode.decode_keypoints`, ``csrc/decode.cu``) evaluates the
modulated map only at the seven points the Newton step reads, with the same
sums in the same order (:func:`modulate_at_plain`).
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from .decode import gaussian_blur_2d, gaussian_taps

KERNEL = "modulate"
MAX_MAP_FLOATS = 232448 // 4    # the map and its horizontal pass, in shared memory


def udp_modulate_plain(heatmaps: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version: log(clip(blur(heatmaps), 0.001, 50)), float32."""
    return torch.log(torch.clamp(gaussian_blur_2d(heatmaps, kernel), 0.001, 50.0))


def modulate_at_plain(maps: torch.Tensor, flat_idx: torch.Tensor,
                      kernel: int = 11) -> torch.Tensor:
    """The modulated maps at ``flat_idx`` of their flattened (N*K*H*W)
    values, each computed on its own as the decode kernel does: for each
    vertical tap, the horizontal sum of its reflect-101 row over the taps in
    order, then the vertical sum in order, then clip and log.  These are
    the products and sums of :func:`udp_modulate_plain`, in its order, so
    the values are its bits."""
    H, W = maps.shape[-2:]
    src = maps.float().reshape(-1, H, W)
    m, rem = flat_idx // (H * W), flat_idx % (H * W)
    y, x = rem // W, rem % W
    r = kernel // 2
    g = gaussian_taps(kernel)

    def reflect(i, n):
        return torch.where(i < 0, -i, torch.where(i >= n, 2 * (n - 1) - i, i))

    cols = [reflect(x + k - r, W) for k in range(kernel)]

    def row_sum(row):
        return sum(src[m, row, cols[k]] * g[k] for k in range(kernel))

    v = sum(row_sum(reflect(y + k - r, H)) * g[k] for k in range(kernel))
    return torch.log(torch.clamp(v, 0.001, 50.0))


@functools.lru_cache(maxsize=None)
def taps_struct(kernel: int) -> kernels.Taps:
    """The kernels' by-value taps for ``kernel``, made once."""
    taps = kernels.Taps()
    taps.v[:kernel] = gaussian_taps(kernel)
    return taps


@functools.lru_cache(maxsize=None)
def _allow_shared_memory(dev: torch.device) -> None:
    """Raise the full-map kernel's dynamic shared-memory limit, once per
    device."""
    kernels.call(KERNEL, "evt_udp_modulate_setup", dev, MAX_MAP_FLOATS * 4)


def check_kernel_size(kernel: int, H: int, W: int) -> None:
    if kernel % 2 == 0 or kernel > kernels.MAX_TAPS or kernel // 2 >= min(H, W):
        raise ValueError(f"kernel {kernel} on {H}x{W} maps is not supported")


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
    check_kernel_size(kernel, H, W)
    if 2 * H * W > MAX_MAP_FLOATS:
        raise ValueError(f"{H}x{W} maps do not fit the kernel's shared memory")
    x = heatmaps.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _allow_shared_memory(dev)
    kernels.call(KERNEL, "evt_udp_modulate", dev, x.data_ptr(), taps_struct(kernel),
                 out.data_ptr(), N * K, H, W, kernel // 2)
    kernels.count_launch(KERNEL)
    return out
