"""Top-down heatmap head (inference), in PyTorch.

Port of ``easy_vitpose_tpu/models/head.py::head_forward`` at inference:
each stage is one ``F.conv_transpose2d`` (k4 s2 p1, no bias), an eval
BatchNorm with float32 statistics (eps 1e-5) and a ReLU; a final conv gives
K heatmaps.  16x12 features -> 64x48 maps.  The TPU's phase, packed and
dilated lowerings of the transposed conv are not ported.

Modules are keyed by the reference's state-dict names
(``keypoint_head.deconv_layers.{3i}`` / ``{3i+1}``, ``keypoint_head.final_layer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import HeadConfig

BN_EPS = 1e-5   # torch BatchNorm2d default


class Head(nn.Module):
    def __init__(self, cfg: HeadConfig):
        super().__init__()
        layers, cin = [], cfg.in_channels
        for f, k in zip(cfg.deconv_filters, cfg.deconv_kernels):
            layers += [nn.ConvTranspose2d(cin, f, k, stride=2, padding=k // 2 - 1, bias=False),
                       nn.BatchNorm2d(f, eps=BN_EPS), nn.ReLU(inplace=True)]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        kf = cfg.final_conv_kernel
        self.final_layer = nn.Conv2d(cin, cfg.num_keypoints, kf, padding=(kf - 1) // 2)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm over NCHW in float32, cast back to x's dtype."""
    inv = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    y = (x.float() - bn.running_mean.float()[:, None, None]) * inv[:, None, None] \
        + bn.bias.float()[:, None, None]
    return y.to(x.dtype)


def head_forward(head: Head, x: torch.Tensor) -> torch.Tensor:
    """(B, D, Hp, Wp) features -> (B, K, 4*Hp, 4*Wp) heatmaps, NCHW."""
    layers = list(head.deconv_layers)
    for deconv, bn in zip(layers[0::3], layers[1::3]):
        x = F.conv_transpose2d(x, deconv.weight, stride=2, padding=deconv.padding)
        x = torch.relu(batch_norm_eval(x, bn))
    fl = head.final_layer
    return F.conv2d(x, fl.weight, fl.bias, padding=fl.padding)
