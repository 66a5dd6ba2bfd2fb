"""K2: the int8 (W8A8) transformer block, and the int8 serving weights.

Replaces ``easy_vitpose_tpu/models/quant.py::_block_q8_kernel``
(``pl.pallas_call`` in ``fused_block_q8``), the shipping serving default at
ViT-B/L/H.  The four linears (qkv, proj, fc1, fc2) carry symmetric
per-output-channel int8 weights; their inputs are quantized per row on the
fly (``quant_rows``: s = amax/127, q = rint(h / s) clipped to +/-127, by
true division and round-half-even).  Attention stays in the working dtype
with float32 logits, and the LN statistics stay float32.

The block reuses K1's LayerNorm and attention launches (``csrc/block.cu``)
and adds two kernels of ``csrc/block_q8.cu``: the row quantisation, and an
int8 GEMM on the tensor cores (``mma.sync`` m16n8k32, int32 accumulation)
whose epilogue computes ``acc * sx * sw + b`` in float32 and then the GELU
or the residual add and the cast.  Per block:

  LN1 -> quant -> GEMM qkv -> attention -> quant -> GEMM proj (+residual)
      -> LN2 -> quant -> GEMM fc1 (GELU, float32) -> quant
      -> GEMM fc2 (+residual)

What bounds it on the H100 is operations: 174 GOP of int8 linears at 1,979
TOP/s and 7 GFLOP of bf16 attention, 0.095 ms at ViT-B and 64 crops.  The
float32 LN and GELU outputs round-trip device memory before their
quantisation (a row's scale needs the whole row), 150 MB per block at that
size; fusing them into the GEMMs is later work.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .. import kernels
from .fused_block import (EPI_GELU, EPI_NONE, EPI_RESIDUAL, attention_cuda,
                          check_attention_shape, check_gemm_shape, layernorm_cuda)
from .vit import Block, attention_core, gelu, layer_norm

KERNEL = "block_q8"


def quantize_linear(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantisation of an (out, in)
    weight: (int8 weight, float32 scale per output channel)."""
    wf = w.float()
    amax = wf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    wq = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return wq, s


def quant_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8 quantisation of activations:
    (int8 values, float32 scales with a trailing dim of 1)."""
    hf = h.float()
    amax = hf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor keeps the IEEE division of the kernel on CUDA too
    s = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    return torch.clamp(torch.round(hf / s), -127, 127).to(torch.int8), s


def linear_q8(h: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """float activations -> per-row int8 -> int8 matmul -> float32
    ``acc * sx * sw + b``.  The int32 sums are formed exactly in float64."""
    q, sx = quant_rows(h)
    acc = torch.matmul(q.double(), wq.double().t()).float()
    return acc * sx * sw + b


class QBlock(nn.Module):
    """A block's int8 serving weights: (out, in) int8 linears with float32
    per-channel scales and biases, and float32 LN affines."""

    def __init__(self, blk: Block):
        super().__init__()
        self.eps = blk.eps
        self.num_heads = blk.attn.num_heads
        f32 = lambda t: t.detach().float().clone()
        for name, ln in (("ln1", blk.norm1), ("ln2", blk.norm2)):
            self.register_buffer(f"{name}_s", f32(ln.weight))
            self.register_buffer(f"{name}_b", f32(ln.bias))
        lins = {"qkv": blk.attn.qkv, "proj": blk.attn.proj,
                "fc1": blk.mlp.fc1, "fc2": blk.mlp.fc2}
        for name, lin in lins.items():
            wq, s = quantize_linear(lin.weight.detach())
            self.register_buffer(f"{name}_wq", wq)
            self.register_buffer(f"{name}_s", s)
            self.register_buffer(f"{name}_b", f32(lin.bias))

    def linear(self, name: str):
        return (getattr(self, f"{name}_wq"), getattr(self, f"{name}_s"),
                getattr(self, f"{name}_b"))


def quantize_vit_params(model: nn.Module, compute_dtype=torch.bfloat16) -> nn.Module:
    """An int8 serving copy of a float32 ``ViTPose``: every block becomes a
    :class:`QBlock` quantized from the float32 weights, and everything else
    is cast to ``compute_dtype`` (BN running statistics stay float32)."""
    from .vitpose import cast_params
    out = cast_params(model, compute_dtype)
    for i, blk in enumerate(model.backbone.blocks):
        out.backbone.blocks[i] = QBlock(blk)
    return out


def block_q8(x: torch.Tensor, qb: QBlock) -> torch.Tensor:
    """Pre-LN block with int8 linears; the plain version of the int8 block
    kernel (A&S-erf GELU, rounding as ``_block_q8_kernel``)."""
    dt = x.dtype
    h = layer_norm(x, qb.ln1_s, qb.ln1_b, qb.eps, torch.float32)
    qkv = linear_q8(h, *qb.linear("qkv")).to(dt)
    o = attention_core(qkv, qb.num_heads)
    x = x + linear_q8(o, *qb.linear("proj")).to(dt)
    h = layer_norm(x, qb.ln2_s, qb.ln2_b, qb.eps, torch.float32)
    m = gelu(linear_q8(h, *qb.linear("fc1")))
    return x + linear_q8(m, *qb.linear("fc2")).to(dt)


def rowquant_cuda(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    R, C = h.shape
    q = torch.empty((R, C), dtype=torch.int8, device=h.device)
    s = torch.empty((R,), dtype=torch.float32, device=h.device)
    kernels.call(KERNEL, "evt_rowquant", h.device, h.data_ptr(), q.data_ptr(),
                 s.data_ptr(), R, C, int(h.dtype == torch.bfloat16))
    return q, s


def gemm_q8_cuda(h: torch.Tensor, wq, sw, b, out_dtype, epilogue: int = EPI_NONE,
                 residual=None) -> torch.Tensor:
    """Quantize the rows of ``h``, then ``epilogue(acc * sx * sw + b)``."""
    q, sx = rowquant_cuda(h)
    M, K = q.shape
    N = wq.shape[0]
    check_gemm_shape(N, K, 1, True)
    out = torch.empty((M, N), dtype=out_dtype, device=h.device)
    res = residual.data_ptr() if residual is not None else None
    kernels.call(KERNEL, "evt_gemm_q8", h.device, q.data_ptr(), wq.data_ptr(),
                 sx.data_ptr(), sw.data_ptr(), b.data_ptr(), res, out.data_ptr(),
                 M, N, K, epilogue, int(out_dtype == torch.bfloat16))
    return out


def fused_block_q8(x: torch.Tensor, qb: QBlock) -> torch.Tensor:
    """One int8 block over (B, N, D) tokens (float32 or bfloat16).

    Tokens on the CPU take the plain version; CUDA tokens launch the kernels.
    """
    if x.device.type == "cpu":
        return block_q8(x, qb)
    bufs = dict(qb.named_buffers())
    kernels.require_cuda(x, *bufs.values())
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tokens must be float32 or bfloat16, got {dt}")
    for name, t in bufs.items():
        want = torch.int8 if name.endswith("_wq") else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} must be {want}, got {t.dtype}")
    B, N, D = x.shape
    check_attention_shape(N, D, qb.num_heads)
    x = x.contiguous().reshape(B * N, D)
    h = layernorm_cuda(x, qb.ln1_s, qb.ln1_b, qb.eps, torch.float32)
    qkv = gemm_q8_cuda(h, *qb.linear("qkv"), dt)
    o = attention_cuda(qkv, B, N, qb.num_heads)
    x1 = gemm_q8_cuda(o, *qb.linear("proj"), dt, EPI_RESIDUAL, x)
    h = layernorm_cuda(x1, qb.ln2_s, qb.ln2_b, qb.eps, torch.float32)
    m = gemm_q8_cuda(h, *qb.linear("fc1"), torch.float32, EPI_GELU)
    out = gemm_q8_cuda(m, *qb.linear("fc2"), dt, EPI_RESIDUAL, x1)
    kernels.count_launch(KERNEL)
    return out.reshape(B, N, D)
