"""ViTPose+ MoE checkpoint -> one multi-task params tree (unsplit), with
numpy only.

Port of ``easy_vitpose_tpu/convert/vitpose_plus.py``.  It complements
``convert/model_split.py`` (which flattens to six single-task checkpoints
like the reference): the tree keeps the shared and expert FFN slices and
every decode head, in the JAX package's layout, so one ``.npz`` serves
every task.  The port serves a task by splicing it into a single-task tree
with :func:`select_task` (``VitInference(task=...)``), so a ViTPose+ task
runs through the same blocks and kernels as any checkpoint.  Layout
transforms match ``convert/vitpose_torch.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from ..configs import ModelConfig
from .from_jax import tree_map
from .model_split import HEAD_TENSORS, SPLIT_DATASETS, SPLIT_NUM_KPTS, num_experts
from .vitpose_torch import normalize_state_dict


def convert_vitpose_plus_state_dict(sd: Mapping[str, Any], cfg: ModelConfig,
                                    dtype=np.float32) -> Dict[str, Any]:
    """Multi-expert state dict -> {"backbone": ..., "heads": {task: ...}}.

    The backbone blocks carry ``mlp.fc2_w`` (shared slice) plus stacked
    ``mlp.fc2_expert_w/b`` of shape (depth, E, hidden, D - D_shared).
    """
    sd = normalize_state_dict(sd)
    n_experts = num_experts(sd)
    bb = cfg.backbone
    D = bb.embed_dim

    def lin(name):
        return (sd[name + ".weight"].T.astype(dtype),
                sd[name + ".bias"].astype(dtype))

    pw = sd["backbone.patch_embed.proj.weight"]
    blocks = []
    for i in range(bb.depth):
        p = f"backbone.blocks.{i}"
        qkv_w, qkv_b = lin(p + ".attn.qkv")
        proj_w, proj_b = lin(p + ".attn.proj")
        fc1_w, fc1_b = lin(p + ".mlp.fc1")
        fc2_w, fc2_b = lin(p + ".mlp.fc2")          # shared slice only
        ew = np.stack([sd[f"{p}.mlp.experts.{e}.weight"].T.astype(dtype)
                       for e in range(n_experts)])  # (E, hidden, D_exp)
        eb = np.stack([sd[f"{p}.mlp.experts.{e}.bias"].astype(dtype)
                       for e in range(n_experts)])
        blocks.append({
            "ln1_s": sd[p + ".norm1.weight"].astype(dtype),
            "ln1_b": sd[p + ".norm1.bias"].astype(dtype),
            "qkv_w": qkv_w, "qkv_b": qkv_b,
            "proj_w": proj_w, "proj_b": proj_b,
            "ln2_s": sd[p + ".norm2.weight"].astype(dtype),
            "ln2_b": sd[p + ".norm2.bias"].astype(dtype),
            "mlp": {"fc1_w": fc1_w, "fc1_b": fc1_b,
                    "fc2_w": fc2_w, "fc2_b": fc2_b,
                    "fc2_expert_w": ew, "fc2_expert_b": eb},
        })
    backbone = {
        "patch_w": pw.transpose(2, 3, 1, 0).reshape(-1, D).astype(dtype),
        "patch_b": sd["backbone.patch_embed.proj.bias"].astype(dtype),
        "pos_embed": sd["backbone.pos_embed"].astype(dtype),
        "blocks": tree_map(lambda *xs: np.stack(xs), *blocks),
        "ln_s": sd["backbone.last_norm.weight"].astype(dtype),
        "ln_b": sd["backbone.last_norm.bias"].astype(dtype),
    }

    heads = {}
    for ei in range(min(n_experts, len(SPLIT_DATASETS))):
        task = SPLIT_DATASETS[ei]
        prefix = "keypoint_head" if ei == 0 else f"associate_keypoint_heads.{ei - 1}"
        if prefix + ".final_layer.weight" not in sd:
            continue
        heads[task] = _convert_head(sd, prefix, cfg, dtype, k_out=SPLIT_NUM_KPTS[task])
    return {"backbone": backbone, "heads": heads}


def _convert_head(sd, prefix: str, cfg: ModelConfig, dtype, k_out: int):
    """Head tensors under ``prefix`` -> the JAX head params (layout
    transforms as in ``convert_vitpose_state_dict``; the final layer
    truncated to ``k_out`` like the reference splitter, model_split.py:100-102)."""
    deconv, bn_state = [], []
    for i in range(len(cfg.head.deconv_kernels)):
        w = sd[f"{prefix}.deconv_layers.{3 * i}.weight"]
        w = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1).astype(dtype)
        bn = f"{prefix}.deconv_layers.{3 * i + 1}"
        deconv.append({
            "w": np.ascontiguousarray(w),
            "bn": {"scale": sd[bn + ".weight"].astype(dtype),
                   "bias": sd[bn + ".bias"].astype(dtype)},
        })
        bn_state.append({
            "mean": sd[bn + ".running_mean"].astype(np.float32),
            "var": sd[bn + ".running_var"].astype(np.float32),
        })
    fw = sd[prefix + ".final_layer.weight"][:k_out]
    return {
        "deconv": deconv,
        "bn_state": bn_state,
        "final_w": fw.transpose(2, 3, 1, 0).astype(dtype),
        "final_b": sd[prefix + ".final_layer.bias"][:k_out].astype(dtype),
    }


def select_task(params: Mapping[str, Any], task: str) -> Dict[str, Any]:
    """Multi-task params -> the single-task params of ``task``: the task's
    expert slice spliced onto the shared fc2 (the reference splitter's
    math, on converted trees) and the task's head.  ``VitInference`` then
    serves it like any single-task checkpoint."""
    heads = params["heads"]
    if task not in heads:
        raise KeyError(f"task {task!r} not in checkpoint (has: {sorted(heads)})")
    ei = SPLIT_DATASETS.index(task)
    bb = dict(params["backbone"])
    blocks = dict(bb["blocks"])
    mlp = dict(blocks["mlp"])
    ew = np.asarray(mlp.pop("fc2_expert_w"))[:, ei]   # (depth, hidden, D_exp)
    eb = np.asarray(mlp.pop("fc2_expert_b"))[:, ei]
    mlp["fc2_w"] = np.concatenate([np.asarray(mlp["fc2_w"]), ew], axis=-1)
    mlp["fc2_b"] = np.concatenate([np.asarray(mlp["fc2_b"]), eb], axis=-1)
    blocks["mlp"] = mlp
    bb["blocks"] = blocks
    return {"backbone": bb, "head": heads[task]}


def is_plus_params(params: Mapping[str, Any]) -> bool:
    return "heads" in params and "head" not in params


__all__ = ["convert_vitpose_plus_state_dict", "select_task", "is_plus_params", "HEAD_TENSORS"]
