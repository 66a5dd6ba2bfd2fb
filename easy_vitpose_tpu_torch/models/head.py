"""Top-down heatmap head, in PyTorch.

Port of ``easy_vitpose_tpu/models/head.py::head_forward``: each stage is one
``F.conv_transpose2d`` (k4 s2 p1, no bias), a BatchNorm with float32
statistics (eps 1e-5) and a ReLU; a final conv gives K heatmaps.  16x12
features -> 64x48 maps.  The TPU's phase, packed and dilated lowerings of the
transposed conv are not ported; in training the conv's backward is torch's.

:func:`head_forward` serves (eval BatchNorm); :func:`head_forward_train`
trains, over a mapping from state-dict names to tensors, and returns the new
BatchNorm running statistics.

Modules are keyed by the reference's state-dict names
(``keypoint_head.deconv_layers.{3i}`` / ``{3i+1}``, ``keypoint_head.final_layer``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import HeadConfig

BN_EPS = 1e-5        # torch BatchNorm2d default
BN_MOMENTUM = 0.1    # torch default running-stat update rate


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


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor):
    """Train-mode BatchNorm over NCHW, as ``head.py::batch_norm(train=True)``:
    float32 batch statistics, the biased variance to normalize and the
    unbiased one (n / (n - 1)) in the running average, momentum 0.1.
    Returns (y in x's dtype, new running mean, new running var); the new
    statistics carry no gradient."""
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = (xf - mean[:, None, None]).square().mean((0, 2, 3))
    n = x.shape[0] * x.shape[2] * x.shape[3]
    with torch.no_grad():
        unbiased = var * n / torch.full_like(var, max(n - 1, 1))
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * unbiased
    inv = torch.rsqrt(var + BN_EPS) * weight.float()
    y = (xf - mean[:, None, None]) * inv[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype), new_mean, new_var


def head_forward_train(params, x: torch.Tensor, cfg: HeadConfig):
    """(B, D, Hp, Wp) features -> ((B, K, 4*Hp, 4*Wp) heatmaps, new BN
    running statistics by state-dict name), with train-mode BatchNorm;
    ``params`` maps the ``keypoint_head.*`` state-dict names (running
    statistics included) to tensors.  The final conv's bias is added after
    the conv, in the working dtype, as the JAX head adds it."""
    new_bn = {}
    for i, k in enumerate(cfg.deconv_kernels):
        dc, bn = f"keypoint_head.deconv_layers.{3 * i}", f"keypoint_head.deconv_layers.{3 * i + 1}"
        x = F.conv_transpose2d(x, params[f"{dc}.weight"], stride=2, padding=k // 2 - 1)
        y, mean, var = batch_norm_train(x, params[f"{bn}.weight"], params[f"{bn}.bias"],
                                        params[f"{bn}.running_mean"], params[f"{bn}.running_var"])
        new_bn[f"{bn}.running_mean"], new_bn[f"{bn}.running_var"] = mean, var
        x = torch.relu(y)
    fl = "keypoint_head.final_layer"
    kf = cfg.final_conv_kernel
    x = F.conv2d(x, params[f"{fl}.weight"], padding=(kf - 1) // 2)
    return x + params[f"{fl}.bias"][:, None, None], new_bn
