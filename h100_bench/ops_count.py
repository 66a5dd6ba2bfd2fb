"""Frozen operation and byte counts from shapes, and the H100's peaks.

The counts are what a layer's mathematics needs, not what a kernel does:
a multiply-add is two operations, 3xTF32's three passes count once, masked
slots count as the slots a step runs, each input byte is read once and each
output byte written once.  Peaks: NVIDIA's H100 SXM data sheet, dense,
at the 700 W power limit.
"""
from __future__ import annotations

from typing import Dict, Tuple

PEAK = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12, "hbm": 3.35e12}


def bound_s(bytes_: float, ops: Dict[str, float]) -> float:
    """The least seconds the peaks allow: the larger of the bytes over the
    memory rate and the operations, each part at its precision's peak."""
    return max(bytes_ / PEAK["hbm"], sum(n / PEAK[k] for k, n in ops.items()))


def ops_s(ops: Dict[str, float]) -> float:
    """Seconds of ``ops`` at the peaks of their precisions."""
    return sum(n / PEAK[k] for k, n in ops.items())


# ------------------------------------------------------------------- ViT
def tokens(cfg) -> int:
    """Patch tokens of the 256x192 crop (padding 2, crop to whole patches)."""
    H, W = cfg["img_size"]
    P, pad = cfg["patch_size"], cfg["patch_padding"]
    return ((H + 2 * pad - P) // P + 1) * ((W + 2 * pad - P) // P + 1)


def hidden(cfg) -> int:
    return int(cfg["embed_dim"] * cfg["mlp_ratio"])


def block_linear_ops(cfg) -> float:
    """One block's four linears (qkv, proj, fc1, fc2), one crop."""
    N, D = tokens(cfg), cfg["embed_dim"]
    return 2.0 * N * (4 * D * D + 2 * D * hidden(cfg))


def block_attention_ops(cfg) -> float:
    """q k^T and p v over all heads, one crop."""
    N, D = tokens(cfg), cfg["embed_dim"]
    return 4.0 * N * N * D


def patch_ops(cfg) -> float:
    P = cfg["patch_size"]
    return 2.0 * tokens(cfg) * cfg["embed_dim"] * P * P * 3


def head_ops(cfg) -> float:
    """The deconvolutions (each input value meets a 4x4 window of every
    output channel) and the final 1x1 conv, one crop."""
    H, W = cfg["img_size"]
    P = cfg["patch_size"]
    h, w, cin = H // P, W // P, cfg["embed_dim"]
    ops = 0.0
    for f in cfg["deconv_filters"]:
        ops += 2.0 * cin * h * w * f * 16
        h, w, cin = 2 * h, 2 * w, f
    return ops + 2.0 * cin * h * w * cfg["num_keypoints"]


def serving_ops(cfg) -> Dict[str, float]:
    """One crop's model operations by the precision the serving copy runs
    them in: int8 (W8A8) linears, the rest in bf16; or all bf16 / tf32."""
    d = cfg["depth"]
    lin, rest = d * block_linear_ops(cfg), (d * block_attention_ops(cfg) + patch_ops(cfg)
                                            + head_ops(cfg))
    dt = cfg.get("serving_dtype", "bf16")
    if dt == "int8":
        return {"int8": lin, "bf16": rest}
    return {"tf32" if dt == "fp32" else "bf16": lin + rest}


def forward_ops(cfg) -> float:
    """One crop's forward operations, all precisions together."""
    return sum(serving_ops(cfg).values())


def k2_block(cfg, crops: int) -> Tuple[float, Dict[str, float]]:
    """(bytes, ops) of one int8 block over ``crops`` crops: int8 weights
    read once, bf16 tokens in and out; int8 linears, bf16 attention."""
    N, D = tokens(cfg), cfg["embed_dim"]
    weights = 4 * D * D + 2 * D * hidden(cfg)
    return (weights + 2.0 * crops * N * D * 2,
            {"int8": crops * block_linear_ops(cfg), "bf16": crops * block_attention_ops(cfg)})


def train_block_kernels(cfg, batch: int) -> Dict[str, Tuple[float, Dict[str, float]]]:
    """(bytes, bf16 ops) that the training block's mathematics needs, by the
    launch that does it, on one block at ``batch`` crops: K5 the forward
    (four linears, two attention products); K6b the MLP's backward to its
    input (the dx of fc2 and of fc1); K6c the MLP's two weight grads; K7 the
    attention half's backward (the dx and weight grad of qkv and of proj,
    and the four products of the attention's backward: dP, dV, dQ, dK).
    What a kernel recomputes (fc1 in K6b, qkv and the scores in K7) is not
    counted.  bf16 activations and weights, each read or written once."""
    N, D, Hd = tokens(cfg), cfg["embed_dim"], hidden(cfg)
    R = batch * N
    attn = 2.0 * R * N * D              # one attention product over all heads
    act, hid, wts = R * D * 2, R * Hd * 2, (4 * D * D + 2 * D * Hd) * 2
    gemm = 2.0 * R * D * Hd             # one MLP GEMM
    return {"K5": (3 * act + wts, {"bf16": 2.0 * R * (4 * D * D + 2 * D * Hd) + 2 * attn}),
            "K6b": (5 * act + 2 * hid + 2 * D * Hd * 2, {"bf16": 2 * gemm}),
            "K6c": (2 * act + 2 * hid + 2 * D * Hd * 2, {"bf16": 2 * gemm}),
            "K7": (3 * act + 2 * wts, {"bf16": 2 * 2.0 * R * 4 * D * D + 4 * attn})}


def train_ops(cfg) -> float:
    """One image's training operations: three times the forward's."""
    return 3.0 * forward_ops(cfg)


def adam_q8_bytes(params: int) -> float:
    """The norm kernel and K9, per element: the norm reads the float32
    gradient (4 B); K9 reads the gradient (4), the float32 parameter (4)
    and the two int8 moments (1 + 1), and writes the parameter (4) and the
    moments (1 + 1): 16 B.  20 B in all (the blockwise scales, one float
    per block of moments, are left out)."""
    return 20.0 * params
