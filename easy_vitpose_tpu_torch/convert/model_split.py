"""ViTPose+ multi-task checkpoint splitter, with numpy only.

Port of ``easy_vitpose_tpu/convert/model_split.py``.  The official ViTPose+
releases are multi-dataset MoE checkpoints: each block's FFN
down-projection is split into a shared part (``mlp.fc2``) plus one expert
slice per dataset (``mlp.experts.{i}``), and five extra
``associate_keypoint_heads.{i}`` decode heads ride along.  The reference
ships model_split.py (reference model_split.py:14-116) to flatten these into
six single-dataset single-head checkpoints; this is the equivalent,
producing reference-format state dicts or the JAX package's ``.npz`` files.

Expert order (reference :73-74): coco (expert 0, main head), then
aic (14), mpii (16), ap10k (17), apt36k (17), wholebody (133) with
associate head i-1 and the final layer truncated to K.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np

SPLIT_DATASETS = ("coco", "aic", "mpii", "ap10k", "apt36k", "wholebody")
SPLIT_NUM_KPTS = {"coco": 17, "aic": 14, "mpii": 16, "ap10k": 17,
                  "apt36k": 17, "wholebody": 133}

HEAD_TENSORS = (
    "keypoint_head.deconv_layers.0.weight",
    "keypoint_head.deconv_layers.1.weight",
    "keypoint_head.deconv_layers.1.bias",
    "keypoint_head.deconv_layers.1.running_mean",
    "keypoint_head.deconv_layers.1.running_var",
    "keypoint_head.deconv_layers.3.weight",
    "keypoint_head.deconv_layers.4.weight",
    "keypoint_head.deconv_layers.4.bias",
    "keypoint_head.deconv_layers.4.running_mean",
    "keypoint_head.deconv_layers.4.running_var",
    "keypoint_head.final_layer.weight",
    "keypoint_head.final_layer.bias",
)


def _np(v):
    return v if isinstance(v, np.ndarray) else v.detach().cpu().numpy()


def num_experts(sd: Mapping[str, Any]) -> int:
    """The number of expert slices of a ViTPose+ state dict; raises for a
    single-task one."""
    ids = [int(k.split("mlp.experts.")[1].split(".")[0]) for k in sd if "mlp.experts" in k]
    if not ids:
        raise ValueError("not a ViTPose+ MoE checkpoint (no mlp.experts keys)")
    return 1 + max(ids)


def split_vitpose_plus(sd: Mapping[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """Multi-expert state dict -> {dataset: single-head state dict}, in the
    reference single-model layout that ``convert_vitpose_state_dict`` and
    ``ViTPose.load_state_dict`` take."""
    sd = {k: _np(v) for k, v in sd.items()}
    n_experts = num_experts(sd)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for ei in range(min(n_experts, len(SPLIT_DATASETS))):
        ds = SPLIT_DATASETS[ei]
        new: Dict[str, np.ndarray] = {}
        for k, v in sd.items():
            if "mlp.experts" in k or "associate_keypoint_heads" in k:
                continue
            if "mlp.fc2." in k:
                # shared slice ++ this dataset's expert slice, along the
                # output dim (reference model_split.py:53-57)
                v = np.concatenate([v, sd[k.replace("fc2.", f"experts.{ei}.")]], axis=0)
            new[k] = v
        if ei > 0:
            # promote associate head i-1 (reference :97-99)
            for t in HEAD_TENSORS:
                src = t.replace("keypoint_head", f"associate_keypoint_heads.{ei - 1}")
                if src in sd:
                    new[t] = sd[src]
            k_out = SPLIT_NUM_KPTS[ds]
            for t in ("keypoint_head.final_layer.weight", "keypoint_head.final_layer.bias"):
                new[t] = new[t][:k_out]
        out[ds] = new
    return out


def split_checkpoint_file(path: str, out_dir: str, prefix: str = "vitpose-",
                          size: str = "b") -> Dict[str, str]:
    """Load a torch ViTPose+ checkpoint, split it, and write one JAX-format
    ``.npz`` per dataset, ``{out_dir}/{prefix}{size}-{dataset}.npz``."""
    import torch

    from ..configs import get_model_config
    from ..utils.checkpoint import save_params
    from .vitpose_torch import convert_vitpose_state_dict, normalize_state_dict

    sd = normalize_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for ds, split_sd in split_vitpose_plus(sd).items():
        params = convert_vitpose_state_dict(split_sd, get_model_config(ds, size))
        p = os.path.join(out_dir, f"{prefix}{size}-{ds}.npz")
        save_params(p, params)
        paths[ds] = p
    return paths
