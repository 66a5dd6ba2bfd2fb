"""JAX params pytree -> the port's state dict.

The JAX package keeps ViTPose params as a pytree in its own layouts: linear
weights (in, out), the patch conv flattened to (P*P*C, D) in unfold order,
per-block params stacked on a leading depth axis, the deconvs pre-flipped in
HWIO and the final conv in HWIO.  This turns such a pytree, given as numpy
arrays (``np.asarray`` of each leaf), into a state dict with the
reference's names and torch layouts, which ``ViTPose.load_state_dict``
takes as it is.  Numpy only: the port does not import JAX.

The map is linear and elementwise, so it carries any tree of the params'
layout across: with ``bn_state=False`` it maps a tree without the head's
``bn_state`` (the trainable tree of a training state, its gradients, or the
Adam moments ``mu`` and ``nu``) to the port's trainable names.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs import ModelConfig


def _f32(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")


def patch_weight_to_torch(w, patch: int, in_chans: int, dim: int) -> np.ndarray:
    """(P*P*C, D) flattened patch weight -> conv (D, C, P, P)."""
    return _f32(_f32(w).reshape(patch, patch, in_chans, dim).transpose(3, 2, 0, 1))


def deconv_weight_to_torch(w) -> np.ndarray:
    """Pre-flipped HWIO (kh, kw, Cin, Cout) -> ConvTranspose2d (Cin, Cout, kh, kw)."""
    return _f32(_f32(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def conv_weight_to_torch(w) -> np.ndarray:
    """HWIO -> OIHW."""
    return _f32(_f32(w).transpose(3, 2, 0, 1))


def state_dict_from_jax(params: Mapping[str, Any], cfg: ModelConfig, *,
                        bn_state: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``{"backbone": ..., "head": ...}`` params -> reference-named
    float32 tensors for ``ViTPose.load_state_dict``; ``bn_state=False`` for
    a tree without the BN running statistics (grads, moments)."""
    bb = cfg.backbone
    bbp, head = params["backbone"], params["head"]
    sd: Dict[str, np.ndarray] = {
        "backbone.patch_embed.proj.weight": patch_weight_to_torch(
            bbp["patch_w"], bb.patch_size, bb.in_chans, bb.embed_dim),
        "backbone.patch_embed.proj.bias": _f32(bbp["patch_b"]),
        "backbone.pos_embed": _f32(bbp["pos_embed"]),
        "backbone.last_norm.weight": _f32(bbp["ln_s"]),
        "backbone.last_norm.bias": _f32(bbp["ln_b"]),
    }
    blocks, mlp = bbp["blocks"], bbp["blocks"]["mlp"]
    for i in range(bb.depth):
        p = f"backbone.blocks.{i}"
        for name, src in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[f"{p}.{name}.weight"] = _f32(blocks[f"{src}_s"][i])
            sd[f"{p}.{name}.bias"] = _f32(blocks[f"{src}_b"][i])
        for name, tree, src in (("attn.qkv", blocks, "qkv"), ("attn.proj", blocks, "proj"),
                                ("mlp.fc1", mlp, "fc1"), ("mlp.fc2", mlp, "fc2")):
            sd[f"{p}.{name}.weight"] = _f32(_f32(tree[f"{src}_w"][i]).T)
            sd[f"{p}.{name}.bias"] = _f32(tree[f"{src}_b"][i])
    for i, dc in enumerate(head["deconv"]):
        bn = f"keypoint_head.deconv_layers.{3 * i + 1}"
        sd[f"keypoint_head.deconv_layers.{3 * i}.weight"] = deconv_weight_to_torch(dc["w"])
        sd[f"{bn}.weight"] = _f32(dc["bn"]["scale"])
        sd[f"{bn}.bias"] = _f32(dc["bn"]["bias"])
        if bn_state:
            sd[f"{bn}.running_mean"] = _f32(head["bn_state"][i]["mean"])
            sd[f"{bn}.running_var"] = _f32(head["bn_state"][i]["var"])
    sd["keypoint_head.final_layer.weight"] = conv_weight_to_torch(head["final_w"])
    sd["keypoint_head.final_layer.bias"] = _f32(head["final_b"])
    return {k: torch.from_numpy(v) for k, v in sd.items()}
