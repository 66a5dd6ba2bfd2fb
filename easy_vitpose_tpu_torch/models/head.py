"""Top-down heatmap head, in PyTorch.

Port of ``easy_vitpose_tpu/models/head.py::head_forward``: each stage is one
``F.conv_transpose2d`` (k4 s2 p1, no bias), a BatchNorm with float32
statistics (eps 1e-5) and a ReLU; a final conv gives K heatmaps.  16x12
features -> 64x48 maps.  The TPU's phase, packed and dilated lowerings of the
transposed conv are not ported; in training the conv's backward is torch's.

The "simple" variant (``HeadConfig.upsample``; reference
train_configs/ViTPose_base_simple_coco_256x192.py:63-67) has no deconv
stages: a bilinear x4 upsample (:func:`upsample_bilinear`) and a 3x3 final
conv.  ``jax.image.resize(..., "bilinear")`` samples at half-pixel centres
as ``F.interpolate(align_corners=False)`` does; at the border JAX drops the
taps outside the map and renormalises where torch clamps the source
coordinate, which at an integer factor gives the same taps with the same
weights (measured: 0 to float rounding, ``tests/test_torch_head_simple.py``).

:func:`head_forward` serves (eval BatchNorm), and :func:`heads_forward` runs
each of several heads over its own contiguous slice of a batch (a ViTPose+
step of mixed tasks); :func:`head_forward_train` trains, over a mapping from state-dict names to tensors, and returns the new
BatchNorm running statistics.

Modules are keyed by the reference's state-dict names
(``keypoint_head.deconv_layers.{3i}`` / ``{3i+1}``, ``keypoint_head.final_layer``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import HeadConfig
from ..utils.precision import float32_convolutions

BN_EPS = 1e-5        # torch BatchNorm2d default
BN_MOMENTUM = 0.1    # torch default running-stat update rate


class Head(nn.Module):
    def __init__(self, cfg: HeadConfig):
        super().__init__()
        self.cfg = cfg
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
    return _batch_norm_eval(x, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)


def _batch_norm_eval(x, weight, bias, mean, var, eps: float = BN_EPS) -> torch.Tensor:
    inv = torch.rsqrt(var.float() + eps) * weight.float()
    y = (x.float() - mean.float()[:, None, None]) * inv[:, None, None] \
        + bias.float()[:, None, None]
    return y.to(x.dtype)


def upsample_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, factor*H, factor*W), ``jax.image.resize``'s
    bilinear at half-pixel centres (see the module docstring)."""
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def head_forward(head: Head, x: torch.Tensor) -> torch.Tensor:
    """(B, D, Hp, Wp) features -> (B, K, 4*Hp, 4*Wp) heatmaps, NCHW."""
    params = dict(head.named_parameters())
    params.update(head.named_buffers())
    return head_forward_params(params, x, head.cfg)


_LAUNCHES: Dict[str, int] = {}     # head name -> launches by heads_forward


def heads_forward(heads, x: torch.Tensor, slices, names) -> list:
    """Several heads over one batch of features: for each (head index,
    first crop, end crop) of ``slices``, ``heads[i]`` over the contiguous
    crops ``x[first:end]`` (a ViTPose+ step in task order, ``models/moe.py``),
    each under its span ``evt.pose.head`` and counted under ``names[i]``
    (:func:`head_launches`): a list of (n, K_i, 4*Hp, 4*Wp) heatmaps, one a
    slice."""
    from ..utils.profiling import span

    out = []
    for i, first, end in slices:
        with span("evt.pose.head"):
            out.append(head_forward(heads[i], x[first:end]).contiguous())
        _LAUNCHES[names[i]] = _LAUNCHES.get(names[i], 0) + 1
    return out


def head_launches() -> Dict[str, int]:
    """Launches of each named head by :func:`heads_forward` since load."""
    return dict(_LAUNCHES)


def reset_head_launches() -> None:
    _LAUNCHES.clear()


def head_forward_params(params, x: torch.Tensor, cfg: HeadConfig, prefix: str = "") -> torch.Tensor:
    """:func:`head_forward` over a mapping from ``{prefix}.``-state-dict
    names to tensors (a ViTPose+ model's heads, ``models/moe.py``).  A
    float32 head's convolutions run in float32 and deterministically
    whatever cuDNN's flags say (``utils/precision.py``)."""
    with float32_convolutions(x.dtype):
        return _head_forward_params(params, x, cfg, prefix)


def _head_forward_params(params, x, cfg: HeadConfig, prefix: str) -> torch.Tensor:
    dot = f"{prefix}." if prefix else ""
    for i, k in enumerate(cfg.deconv_kernels):
        dc, bn = f"{dot}deconv_layers.{3 * i}", f"{dot}deconv_layers.{3 * i + 1}"
        x = F.conv_transpose2d(x, params[f"{dc}.weight"], stride=2, padding=k // 2 - 1)
        x = torch.relu(_batch_norm_eval(x, params[f"{bn}.weight"], params[f"{bn}.bias"],
                                        params[f"{bn}.running_mean"], params[f"{bn}.running_var"]))
    if cfg.upsample > 1:
        x = upsample_bilinear(x, cfg.upsample)
    kf = cfg.final_conv_kernel
    return F.conv2d(x, params[f"{dot}final_layer.weight"], params[f"{dot}final_layer.bias"],
                    padding=(kf - 1) // 2)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, group=None):
    """Train-mode BatchNorm over NCHW, as ``head.py::batch_norm(train=True)``:
    float32 batch statistics, the biased variance to normalize and the
    unbiased one (n / (n - 1)) in the running average, momentum 0.1.
    Returns (y in x's dtype, new running mean, new running var); the new
    statistics carry no gradient.

    With a process ``group`` the statistics are the global batch's, as
    JAX's ``batch_norm(axis_name=)``: the mean of the ranks' means, then the
    mean of their ``E[(x - mean)^2]`` around it, and ``n`` times the group's
    size in the unbiased variance; the all-reduces are differentiated."""
    xf = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    if group is None:
        mean = xf.mean((0, 2, 3))
        var = (xf - mean[:, None, None]).square().mean((0, 2, 3))
    else:
        from ..parallel.comm import all_reduce_mean, world
        mean = all_reduce_mean(xf.mean((0, 2, 3)), group)
        var = all_reduce_mean((xf - mean[:, None, None]).square().mean((0, 2, 3)), group)
        n *= world(group)
    with torch.no_grad():
        unbiased = var * n / torch.full_like(var, max(n - 1, 1))
        new_mean = (1 - BN_MOMENTUM) * running_mean + BN_MOMENTUM * mean
        new_var = (1 - BN_MOMENTUM) * running_var + BN_MOMENTUM * unbiased
    inv = torch.rsqrt(var + BN_EPS) * weight.float()
    y = (xf - mean[:, None, None]) * inv[:, None, None] + bias.float()[:, None, None]
    return y.to(x.dtype), new_mean, new_var


def head_forward_train(params, x: torch.Tensor, cfg: HeadConfig, prefix: str = "keypoint_head",
                       group=None):
    """(B, D, Hp, Wp) features -> ((B, K, 4*Hp, 4*Wp) heatmaps, new BN
    running statistics by state-dict name), with train-mode BatchNorm;
    ``params`` maps the ``keypoint_head.*`` state-dict names (running
    statistics included) to tensors (``{prefix}.*`` for another head, such
    as a ViTPose+ associate head).  The final conv's bias is added after
    the conv, in the working dtype, as the JAX head adds it.  ``group``:
    the global BatchNorm statistics of :func:`batch_norm_train`."""
    new_bn = {}
    for i, k in enumerate(cfg.deconv_kernels):
        dc, bn = f"{prefix}.deconv_layers.{3 * i}", f"{prefix}.deconv_layers.{3 * i + 1}"
        x = F.conv_transpose2d(x, params[f"{dc}.weight"], stride=2, padding=k // 2 - 1)
        y, mean, var = batch_norm_train(x, params[f"{bn}.weight"], params[f"{bn}.bias"],
                                        params[f"{bn}.running_mean"], params[f"{bn}.running_var"],
                                        group)
        new_bn[f"{bn}.running_mean"], new_bn[f"{bn}.running_var"] = mean, var
        x = torch.relu(y)
    if cfg.upsample > 1:
        x = upsample_bilinear(x, cfg.upsample)
    fl = f"{prefix}.final_layer"
    kf = cfg.final_conv_kernel
    x = F.conv2d(x, params[f"{fl}.weight"], padding=(kf - 1) // 2)
    return x + params[f"{fl}.bias"][:, None, None], new_bn
