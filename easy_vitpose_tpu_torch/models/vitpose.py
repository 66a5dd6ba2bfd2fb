"""ViTPose = ViT backbone + heatmap head, in PyTorch.

Port of ``easy_vitpose_tpu/models/vitpose.py``.  A
:class:`ViTPose` is keyed by the reference's state-dict names, so the
reference's checkpoints (and ``convert.from_jax`` of the JAX params) load
with ``load_state_dict``.

The serving dtype is the only choice: :func:`serving_copy` makes the fp32,
bf16 or int8 copy of a float32 model, and the compute dtype of a model is
the dtype of its position embedding.

Training is functional: :func:`vitpose_forward_train` runs over a mapping
from state-dict names to tensors, so that a step can hand in bf16 casts of
float32 master weights that gradients flow through (``train/step.py``).
"""
from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..configs import ModelConfig
from .head import Head, head_forward, head_forward_train
from .vit import ViT, vit_forward, vit_forward_train

SERVING_DTYPES = ("fp32", "bf16", "int8")
BN_STATS = ("running_mean", "running_var")


class ViTPose(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.backbone)
        self.keypoint_head = Head(cfg.head)


def compute_dtype(model: ViTPose) -> torch.dtype:
    return model.backbone.pos_embed.dtype


def vitpose_forward(model: ViTPose, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """(B, 256, 192, 3) normalized NHWC crops -> (B, K, 64, 48) heatmaps.

    ``plain=True`` runs the kernels' plain versions on any device (see
    :func:`..models.vit.vit_forward`)."""
    feats = vit_forward(model.backbone, x, plain=plain)
    heat = head_forward(model.keypoint_head, feats.permute(0, 3, 1, 2))
    return heat.contiguous()


def vitpose_forward_train(params, x: torch.Tensor, cfg: ModelConfig, *,
                          drop_path_masks=None, generator=None,
                          block_impl: str = "fused_train", plain: bool = False):
    """Training forward over ``params`` (state-dict names to tensors, the
    head's BN running statistics included): (B, 256, 192, 3) normalized NHWC
    crops -> ((B, K, 64, 48) heatmaps, new BN running statistics by name).
    Drop-path, ``block_impl`` and ``plain``: see
    :func:`..models.vit.vit_forward_train`."""
    feats = vit_forward_train(params, x, cfg.backbone, drop_path_masks=drop_path_masks,
                              generator=generator, block_impl=block_impl, plain=plain)
    return head_forward_train(params, feats.permute(0, 3, 1, 2), cfg.head)


def cast_params(model: ViTPose, dtype: torch.dtype) -> ViTPose:
    """A copy with every floating parameter and buffer cast to ``dtype``,
    except the BN running statistics, which stay float32."""
    out = copy.deepcopy(model)
    for mod in out.modules():
        for _, p in mod.named_parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, b in mod.named_buffers(recurse=False):
            if b.is_floating_point() and name not in BN_STATS:
                setattr(mod, name, b.to(dtype))
    return out


def serving_copy(model: ViTPose, dtype: str) -> ViTPose:
    """The serving copy of a float32 model for ``dtype`` in
    :data:`SERVING_DTYPES`: fp32, bf16, or int8 blocks with a bf16 rest."""
    if dtype == "fp32":
        return cast_params(model, torch.float32)
    if dtype == "bf16":
        return cast_params(model, torch.bfloat16)
    if dtype == "int8":
        from .quant import quantize_vit_params
        return quantize_vit_params(model, torch.bfloat16)
    raise ValueError(f"dtype must be one of {SERVING_DTYPES}, got {dtype!r}")


def _trunc_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * std).astype(np.float32)


def init_params(cfg: ModelConfig, seed: int) -> ViTPose:
    """A float32 CPU model with random weights drawn with numpy from ``seed``.

    Linears and embeddings are truncated-normal 0.02 as in the reference;
    biases, LN and BN affines and BN statistics are random too, so that
    every term of every kernel is exercised.  The head's convs are scaled
    by 1/sqrt(fan-in) so the heatmaps span an O(1) range and the decode's
    clip and log see real values (the reference's 0.001 init leaves random
    maps below the 0.001 clip floor).
    """
    rng = np.random.default_rng(seed)
    model = ViTPose(cfg)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            sd[name] = np.zeros((), np.int64)
        elif name.endswith("running_var"):
            sd[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif "deconv_layers" in name and len(shape) == 4:      # (Cin, Cout, k, k)
            sd[name] = (rng.standard_normal(shape) / np.sqrt(shape[0] * 4)).astype(np.float32)
        elif "final_layer.weight" in name:                      # (K, Cin, k, k)
            sd[name] = (rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
        elif len(shape) >= 2 or name.endswith("pos_embed"):
            sd[name] = _trunc_normal(rng, shape, 0.02)
        elif name.endswith("weight"):                            # LN and BN scales
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:                                                   # biases, BN means
            sd[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model.eval()
