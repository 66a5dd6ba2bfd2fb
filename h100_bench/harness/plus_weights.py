"""Random ViTPose+ weights made on the device from the seed.

The leaf rules are ``weights.py``'s (the port's ``init_tensor``): the
experts' rows as any linear's, each head's as the single-task head's.  The
state dict is the reference checkpoint's: ViTPose's backbone with each
``mlp.fc2`` cut to its shared rows and ``mlp.experts.{e}`` beside it, the
first task's head as ``keypoint_head`` and the others' as
``associate_keypoint_heads.{e - 1}``, each final layer at its task's K.
Two draws on one generator cover every element, as in ``weights.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

import ops_count
import ops_count_plus
from harness.weights import _leaf, generator, port_config


def plus_port_config(c: dict):
    """The port's ``ModelConfig`` of the configuration's sizes, its head at
    the first task's K (``models/moe.py`` takes each head's K from its
    weights)."""
    return port_config({**c, "num_keypoints": c["num_keypoints"][0]})


def head_prefix(e: int) -> str:
    return "keypoint_head" if e == 0 else f"associate_keypoint_heads.{e - 1}"


def plus_shapes(c: dict) -> List[Tuple[str, Tuple[int, ...], torch.dtype]]:
    """(name, shape, dtype) of every state-dict entry of the ViTPose+ model."""
    from easy_vitpose_tpu_torch.models.head import Head
    from easy_vitpose_tpu_torch.models.vitpose import ViTPose

    cfg = plus_port_config(c)
    ne, hd = ops_count_plus.expert_rows(c), ops_count.hidden(c)
    with torch.device("meta"):
        sd = ViTPose(cfg).state_dict()
    out = []
    for k, v in sd.items():
        if not k.startswith("backbone."):
            continue
        shape = tuple(v.shape)
        if k.endswith(("mlp.fc2.weight", "mlp.fc2.bias")):
            shape = (c["embed_dim"] - ne,) + shape[1:]
        out.append((k, shape, v.dtype))
        if k.endswith("mlp.fc2.bias"):
            pre = k[:-len("fc2.bias")]
            for e in range(len(c["tasks"])):
                out += [(f"{pre}experts.{e}.weight", (ne, hd), torch.float32),
                        (f"{pre}experts.{e}.bias", (ne,), torch.float32)]
    for e, k_out in enumerate(c["num_keypoints"]):
        with torch.device("meta"):
            head = Head(dataclasses.replace(cfg.head, num_keypoints=k_out)).state_dict()
        out += [(f"{head_prefix(e)}.{k}", tuple(v.shape), v.dtype) for k, v in head.items()]
    return out


def plus_weights(c: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 ViTPose+ state dict of configuration ``c`` from ``seed``."""
    shapes = plus_shapes(c)
    total = sum(math.prod(s) for _, s, dt in shapes if dt.is_floating_point)
    gen = generator(seed, device)
    z = torch.randn(total, generator=gen, device=device)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, dt in shapes:
        if not dt.is_floating_point:           # num_batches_tracked
            out[name] = torch.zeros(shape, dtype=dt, device=device)
            continue
        n = math.prod(shape)
        out[name] = _leaf(name, shape, z[at:at + n], u[at:at + n]).reshape(shape).clone()
        at += n
    return out
