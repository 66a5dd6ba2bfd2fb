"""Reference ViTPose checkpoints (.pth) for the port, with numpy only.

Port of ``easy_vitpose_tpu/convert/vitpose_torch.py``.  The port's
``ViTPose`` is keyed by the reference's state-dict names, so a reference
state dict loads into it as it is once :func:`normalize_state_dict` has
unwrapped it and :func:`audit_state_dict_keys` has checked its keys.
:func:`convert_vitpose_state_dict` is the JAX package's map from such a
state dict to its params tree (the layout of its ``.npz`` files), so a
random model of the port can be written as the JAX package writes one;
:func:`export_vitpose_state_dict` and :func:`save_torch_checkpoint` are its
inverse, the way back to a reference ``.pth`` (``cli/convert.py to-torch``).
Both directions go through ``convert/from_jax.py``'s one name map, and
move elements only, so a round trip is bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..configs import ModelConfig


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def normalize_state_dict(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Unwrap {'state_dict': ...} and strip 'module.' prefixes."""
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = _np(v)
    return out


def expected_vitpose_keys(cfg: ModelConfig):
    """The exact single-task state-dict key set of ``cfg`` (required,
    optional) — optional keys are torch bookkeeping buffers the math never
    reads (num_batches_tracked)."""
    req = {"backbone.patch_embed.proj.weight",
           "backbone.patch_embed.proj.bias",
           "backbone.pos_embed",
           "backbone.last_norm.weight", "backbone.last_norm.bias"}
    for i in range(cfg.backbone.depth):
        p = f"backbone.blocks.{i}"
        for mod in (".attn.qkv", ".attn.proj", ".mlp.fc1", ".mlp.fc2",
                    ".norm1", ".norm2"):
            req.add(p + mod + ".weight")
            req.add(p + mod + ".bias")
    opt = set()
    for i in range(len(cfg.head.deconv_kernels)):
        req.add(f"keypoint_head.deconv_layers.{3 * i}.weight")
        bn = f"keypoint_head.deconv_layers.{3 * i + 1}"
        req |= {bn + ".weight", bn + ".bias",
                bn + ".running_mean", bn + ".running_var"}
        opt.add(bn + ".num_batches_tracked")
    req |= {"keypoint_head.final_layer.weight",
            "keypoint_head.final_layer.bias"}
    return req, opt


def audit_state_dict_keys(sd: Mapping[str, Any], cfg: ModelConfig) -> None:
    """Fail loud on key-coverage drift (the reference loader's
    missing/unexpected-key report, hardened into an error): a checkpoint
    with extra tensors or another depth would otherwise load silently
    wrong."""
    req, opt = expected_vitpose_keys(cfg)
    have = set(sd)
    missing = sorted(req - have)
    unexpected = sorted(have - req - opt)
    if missing or unexpected:
        msg = [f"checkpoint layout does not match config {cfg.name!r}:"]
        if missing:
            msg.append(f"  missing {len(missing)} expected key(s): "
                       + ", ".join(missing[:8])
                       + (" ..." if len(missing) > 8 else ""))
        if unexpected:
            msg.append(f"  unexpected {len(unexpected)} source key(s) the "
                       "converter would silently drop: "
                       + ", ".join(unexpected[:8])
                       + (" ..." if len(unexpected) > 8 else ""))
        raise ValueError("\n".join(msg))


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference .pth -> float32 CPU tensors by the reference's names,
    audited against ``cfg``, for ``ViTPose.load_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = normalize_state_dict(ckpt)
    audit_state_dict_keys(sd, cfg)
    return {k: torch.from_numpy(np.array(v, np.float32 if v.dtype.kind == "f" else v.dtype))
            for k, v in sd.items()}


def convert_vitpose_state_dict(sd: Mapping[str, Any], cfg: ModelConfig,
                               dtype=np.float32) -> Dict[str, Any]:
    """A reference-format state dict -> the JAX package's params tree
    (linear weights (in, out), the patch conv flattened in unfold order,
    blocks stacked on a depth axis, deconvs pre-flipped HWIO), audited."""
    from .from_jax import state_dict_to_jax
    sd = normalize_state_dict(sd)
    audit_state_dict_keys(sd, cfg)
    return state_dict_to_jax(sd, cfg, dtype=dtype)


def export_vitpose_state_dict(params: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_vitpose_state_dict`: a JAX params tree
    -> a reference-format state dict of float32 numpy arrays (the
    reference's names and torch layouts, each BN's ``num_batches_tracked``
    0), which the reference and :func:`load_torch_checkpoint` load."""
    from ..models.vit import BLOCK_PARAMS
    from .from_jax import state_dict_from_jax
    tensors = state_dict_from_jax(params, cfg)
    # the reference's order: patch embedding, blocks, final LN, head
    order = ["backbone.patch_embed.proj.weight", "backbone.patch_embed.proj.bias",
             "backbone.pos_embed"]
    order += [f"backbone.blocks.{i}.{n}" for i in range(cfg.backbone.depth) for n in BLOCK_PARAMS]
    order += ["backbone.last_norm.weight", "backbone.last_norm.bias"]
    order += [k for k in tensors if k.startswith("keypoint_head.")]
    sd: Dict[str, np.ndarray] = {}
    for k in order:
        sd[k] = tensors[k].numpy()
        if k.endswith(".running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def save_torch_checkpoint(params: Mapping[str, Any], cfg: ModelConfig, path: str) -> None:
    """Write a JAX params tree as a reference-loadable ``{'state_dict': ...}``
    ``.pth``."""
    sd = export_vitpose_state_dict(params, cfg)
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
