"""Operation and byte counts of the mixed-task ViTPose+ pose step.

What the mathematics needs, as ``ops_count`` counts it: a multiply-add is
two operations, each input byte is read once and each output byte written
once, and every slot a step runs counts.  A ViTPose+ block is a ViT block
whose fc2 gives each token the shared rows and its own task's expert rows:
D output columns a token, as a plain block's fc2, so a crop's linears count
``ops_count.block_linear_ops``, minus nothing.  Each head counts at its own
K.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import ops_count
from ops_count import block_attention_ops, block_linear_ops, hidden, patch_ops


def expert_rows(cfg) -> int:
    """An expert's output rows: the configuration's share of D (320 of
    ViTPose+-H's 1280; a cut-down copy keeps the share)."""
    return cfg["embed_dim"] * cfg["expert_rows"] // (cfg["expert_rows"] + cfg["shared_fc2_rows"])


def shared_rows(cfg) -> int:
    return cfg["embed_dim"] - expert_rows(cfg)


def expert_gemm(cfg, rows: int, experts: int) -> Tuple[float, Dict[str, float]]:
    """(bytes, ops) of the routed expert product over ``rows`` token rows
    that meet ``experts`` distinct experts: int8 ops ``2 rows hidden NE``;
    bytes: the rows' int8 inputs, the experts' int8 weights, and the
    output's bf16 columns."""
    ne, hd = expert_rows(cfg), hidden(cfg)
    return (rows * hd + experts * ne * hd + rows * ne * 2.0, {"int8": 2.0 * rows * hd * ne})


def head_ops(cfg, k: int) -> float:
    """One crop's head at K = ``k`` (``ops_count.head_ops``'s count)."""
    return ops_count.head_ops({**cfg, "num_keypoints": k})


def crop_ops(cfg, k: int) -> Dict[str, float]:
    """One crop's model operations by precision, its head at K = ``k``:
    int8 (W8A8) linears, the rest in bf16."""
    d = cfg["depth"]
    return {"int8": d * block_linear_ops(cfg),
            "bf16": d * block_attention_ops(cfg) + patch_ops(cfg) + head_ops(cfg, k)}


def crops_ops_s(cfg, crops_by_k: Mapping[int, int]) -> float:
    """Seconds at the peaks for ``crops_by_k[k]`` crops at each K."""
    return sum(n * ops_count.ops_s(crop_ops(cfg, k)) for k, n in crops_by_k.items())

