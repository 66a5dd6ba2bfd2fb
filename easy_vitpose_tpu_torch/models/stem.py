"""The hybrid CNN stem (reference HybridEmbed), in PyTorch.

Port of ``easy_vitpose_tpu/models/stem.py``: ``len(stem_channels)`` stages of
[3x3 stride-2 conv -> LayerNorm over the channels -> GELU] on the NHWC crops,
then a flatten and a Linear to the embedding width.  Four stages give the
/16 token grid of PatchEmbed (256x192 -> 16x12), so the position embedding
and every block after it are unchanged, on all three block routes (the
serving blocks K1 and K2, the training block K5-K7, and their plain
versions).  Like JAX's stem it is plain framework code (cuDNN convs here,
XLA convs there), not a kernel.

What follows JAX exactly:

* padding: JAX's ``padding="SAME"`` at stride 2 pads ``total // 2`` before
  and the rest after (256 -> 128 pads 0 rows before and 1 after), where
  ``F.conv2d(padding=1)`` would pad one on each side and move every tap by
  a pixel; :func:`same_pad` computes the split from the size, so odd sizes
  pad (1, 1);
* the conv's bias is added after the conv in the working dtype, as JAX
  adds it, and the conv takes no float32 output (JAX's has none: its
  transpose rule needs matching dtypes);
* the LayerNorm runs over the channels-last axis with float32 statistics
  (``vit.layer_norm``), and the GELU is the exact erf, not the kernels'
  A&S erf;
* the projection accumulates in float32 and rounds to the working dtype.

The modules are keyed under ``backbone.patch_embed``: ``proj`` is the
reference HybridEmbed's Linear, (D, C_last); ``convs.{i}`` are the convs
(OIHW) and ``norms.{i}`` the LayerNorms.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import BackboneConfig


class Stem(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        chans = tuple(cfg.stem_channels)
        cins = (cfg.in_chans,) + chans[:-1]
        self.convs = nn.ModuleList(nn.Conv2d(ci, co, 3, stride=2) for ci, co in zip(cins, chans))
        self.norms = nn.ModuleList(nn.LayerNorm(co, eps=cfg.layer_norm_eps) for co in chans)
        self.proj = nn.Linear(chans[-1], cfg.embed_dim)


def same_pad(n: int, kernel: int = 3, stride: int = 2) -> Tuple[int, int]:
    """(before, after) padding of JAX's ``padding="SAME"`` on a size ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def stem_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: BackboneConfig,
                 prefix: str = "") -> torch.Tensor:
    """(B, H, W, C) normalized NHWC crops -> (B, Hp*Wp, D) tokens in the
    dtype of ``x``; ``params`` maps ``{prefix}.convs.{i}.weight`` and the
    others (see the module docstring) to tensors.  At float32 the
    convolutions run in float32 and deterministically whatever cuDNN's
    flags say (``utils/precision.py``)."""
    from ..utils.precision import float32_convolutions
    from .vit import layer_norm, linear_f32

    dot = f"{prefix}." if prefix else ""
    dt = x.dtype
    h = x
    for i in range(len(cfg.stem_channels)):
        top, bottom = same_pad(h.shape[1])
        left, right = same_pad(h.shape[2])
        hc = F.pad(h.permute(0, 3, 1, 2), (left, right, top, bottom))
        with float32_convolutions(dt):
            hc = F.conv2d(hc, params[f"{dot}convs.{i}.weight"].to(dt), stride=2)
        h = hc.permute(0, 2, 3, 1) + params[f"{dot}convs.{i}.bias"].to(dt)
        h = layer_norm(h, params[f"{dot}norms.{i}.weight"], params[f"{dot}norms.{i}.bias"],
                       cfg.layer_norm_eps)
        h = F.gelu(h).to(dt)
    B, Hf, Wf, C = h.shape
    tokens = h.reshape(B, Hf * Wf, C)
    return linear_f32(tokens, params[f"{dot}proj.weight"], params[f"{dot}proj.bias"]).to(dt)
