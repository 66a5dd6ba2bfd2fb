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
int8 GEMM on Hopper's warpgroup tensor cores (``csrc/gemm_q8.cuh``:
``wgmma`` m64nNk32 with int32 sums from a TMA ring, persistent blocks of
128 x 192 or 128 x 64 tiles picked from M, N and the epilogue, outputs
stored by TMA) whose epilogue computes ``acc * sx * sw + b`` in float32
and then the GELU or the residual add and the cast.  The int32 sums are
exact, so the outputs are the bits of the ``mma.sync`` kernel it replaced.
Per block:

  LN1 -> quant -> GEMM qkv -> attention -> quant -> GEMM proj (+residual)
      -> LN2 -> quant -> GEMM fc1 (GELU, float32) -> quant
      -> GEMM fc2 (+residual)

A ViTPose+ block on crops of mixed tasks (``models/moe.py``) swaps the last
GEMM for a routed fc2: the dense GEMM over the shared rows into the leading
columns of the output (``gemm_q8_rows_cuda(out=)``), and the grouped GEMM
(``gemm_q8_grouped_cuda``, ``grouped_gemm_kernel``) over each task's rows
and its own expert's rows into the rest, both with the residual epilogue.

What bounds it on the H100 is operations: 174 GOP of int8 linears at 1,979
TOP/s and 7 GFLOP of bf16 attention, 0.095 ms at ViT-B and 64 crops.  The
float32 LN and GELU outputs round-trip device memory before their
quantisation (a row's scale needs the whole row), 150 MB per block at that
size; fusing them into the GEMMs is later work.
"""
from __future__ import annotations

from typing import Mapping, Tuple

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


def load_q8_block(mod: nn.Module, p: Mapping[str, torch.Tensor], eps: float,
                  num_heads: int) -> None:
    """Register a block's int8 serving buffers on ``mod`` from its float
    tensors ``p``, keyed by the block's state-dict names: float32 LN
    affines; each linear's int8 weight, float32 per-channel scale and bias."""
    mod.eps, mod.num_heads = eps, num_heads
    f32 = lambda t: t.detach().float().clone()
    for name, key in (("ln1", "norm1"), ("ln2", "norm2")):
        mod.register_buffer(f"{name}_s", f32(p[f"{key}.weight"]))
        mod.register_buffer(f"{name}_b", f32(p[f"{key}.bias"]))
    for name, key in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
                      ("fc2", "mlp.fc2")):
        wq, s = quantize_linear(p[f"{key}.weight"].detach())
        mod.register_buffer(f"{name}_wq", wq)
        mod.register_buffer(f"{name}_s", s)
        mod.register_buffer(f"{name}_b", f32(p[f"{key}.bias"]))


class QBlock(nn.Module):
    """A block's int8 serving weights: (out, in) int8 linears with float32
    per-channel scales and biases, and float32 LN affines."""

    def __init__(self, blk: Block):
        super().__init__()
        load_q8_block(self, dict(blk.named_parameters()), blk.eps, blk.attn.num_heads)

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


def block_q8(x: torch.Tensor, qb: QBlock, fc2=None) -> torch.Tensor:
    """Pre-LN block with int8 linears; the plain version of the int8 block
    kernel (A&S-erf GELU, rounding as ``_block_q8_kernel``).  ``fc2``:
    (M, hidden) float32 rows -> their float32 fc2 product, in place of
    ``qb``'s fc2 (a routed ViTPose+ block, ``models/moe.py``)."""
    dt = x.dtype
    h = layer_norm(x, qb.ln1_s, qb.ln1_b, qb.eps, torch.float32)
    qkv = linear_q8(h, *qb.linear("qkv")).to(dt)
    o = attention_core(qkv, qb.num_heads)
    x = x + linear_q8(o, *qb.linear("proj")).to(dt)
    h = layer_norm(x, qb.ln2_s, qb.ln2_b, qb.eps, torch.float32)
    m = gelu(linear_q8(h, *qb.linear("fc1")))
    if fc2 is not None:
        B, N, _ = m.shape
        return x + fc2(m.reshape(B * N, -1)).reshape(B, N, -1).to(dt)
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
    return gemm_q8_rows_cuda(q, sx, wq, sw, b, out_dtype, epilogue, residual)


def check_q8_weight(wq: torch.Tensor, K: int) -> None:
    """The int8 GEMM's weight: (N, K) with N a multiple of 64 and K of 128,
    contiguous and 16-byte aligned (TMA reads whole 16-byte rows)."""
    N, Kw = wq.shape
    check_gemm_shape(N, Kw, 1)
    if K != Kw:
        raise ValueError(f"GEMM input depth {K} against a weight of depth {Kw}")
    if wq.data_ptr() % 16 or not wq.is_contiguous():
        raise ValueError("the int8 GEMM needs a contiguous, 16-byte aligned weight")


def gemm_q8_rows_cuda(q: torch.Tensor, sx: torch.Tensor, wq, sw, b, out_dtype,
                      epilogue: int = EPI_NONE, residual=None, out=None) -> torch.Tensor:
    """``epilogue(acc * sx * sw + b)`` of rows quantised by
    :func:`rowquant_cuda` (``q`` (M, K) int8, ``sx`` (M,) float32).  With
    ``out`` (M, L), L >= N, contiguous: written into its leading N columns
    (the residual is then (M, N) of its own)."""
    M, K = q.shape
    check_q8_weight(wq, K)
    N = wq.shape[0]
    res = residual.data_ptr() if residual is not None else None
    if out is None:
        out, ldo = torch.empty((M, N), dtype=out_dtype, device=q.device), 0
    elif out.shape[0] != M or out.shape[1] < N or out.dtype != out_dtype or not out.is_contiguous():
        raise ValueError(f"out must be contiguous ({M}, >= {N}) {out_dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    else:
        ldo = out.shape[1]
    kernels.call(KERNEL, "evt_gemm_q8", q.device, q.data_ptr(), wq.data_ptr(),
                 sx.data_ptr(), sw.data_ptr(), b.data_ptr(), res, out.data_ptr(),
                 M, N, K, epilogue, int(out_dtype == torch.bfloat16), ldo)
    return out


GROUPED_EXPERT_ROWS = (192, 256, 320)     # a quarter of D at ViTPose+-B, -L, -H


def gemm_q8_grouped_cuda(q: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw, b,
                         groups: torch.Tensor, n_groups: int, residual: torch.Tensor,
                         out: torch.Tensor, col0: int) -> torch.Tensor:
    """The routed expert product (``csrc/gemm_q8.cuh::grouped_gemm_kernel``):
    for each of the ``n_groups`` rows (first row, rows, expert, 0) of the
    int32 device table ``groups``, the group's rows of ``q`` (M, K) int8
    (``sx`` (M,) their scales) against expert ``wq[e]`` ((E, NE, K) int8,
    ``sw``, ``b`` (E, NE) float32), ``acc * sx * sw + b`` plus the
    residual, into ``out[:, col0:col0 + NE]``.  ``residual`` and ``out`` are
    (M, L) and contiguous; a group's first row and its rows are multiples of
    64.  Rows of no group are left as they are."""
    M, K = q.shape
    E, NE, Kw = wq.shape
    if NE not in GROUPED_EXPERT_ROWS or Kw != K or K % 128:
        raise ValueError(f"grouped GEMM: experts {tuple(wq.shape)} against rows of depth {K}")
    if not (wq.is_contiguous() and sw.is_contiguous() and b.is_contiguous()
            and tuple(sw.shape) == (E, NE) == tuple(b.shape)):
        raise ValueError("grouped GEMM: contiguous (E, NE, K) int8 weights, (E, NE) scales")
    L = out.shape[1]
    if (residual.shape != out.shape or out.shape[0] != M or not out.is_contiguous()
            or not residual.is_contiguous() or residual.dtype != out.dtype
            or col0 % 2 or L % 2 or col0 + NE > L):
        raise ValueError(f"grouped GEMM: out {tuple(out.shape)} and residual must match at "
                         f"({M}, L >= col0 + {NE})")
    if groups.dtype != torch.int32 or groups.shape[-1] != 4 or groups.shape[0] < n_groups:
        raise ValueError("grouped GEMM: groups must be (>= n_groups, 4) int32")
    kernels.call(KERNEL, "evt_gemm_q8_grouped", q.device, q.data_ptr(), wq.data_ptr(),
                 groups.data_ptr(), n_groups, sx.data_ptr(), sw.data_ptr(), b.data_ptr(),
                 residual.data_ptr(), out.data_ptr(), M, NE, K, E, L, col0,
                 int(out.dtype == torch.bfloat16))
    return out


def grouped_gemm_launches() -> int:
    """The grouped GEMM's launches since its library was loaded."""
    import ctypes
    n = (ctypes.c_longlong * 1)()
    kernels.lib(KERNEL).evt_gemm_q8_grouped_launches(n)
    return int(n[0])


GEMM_Q8_TILES = ("128x192", "128x64")


def gemm_q8_launches() -> dict:
    """The int8 GEMM's launches by tile since its library was loaded
    (``csrc/gemm_q8.cuh``; a CUDA graph's replay adds none)."""
    import ctypes
    n = (ctypes.c_longlong * len(GEMM_Q8_TILES))()
    kernels.lib(KERNEL).evt_gemm_q8_launches(n)
    return dict(zip(GEMM_Q8_TILES, n))


def fused_block_q8(x: torch.Tensor, qb: QBlock, fc2=None) -> torch.Tensor:
    """One int8 block over (B, N, D) tokens (float32 or bfloat16).

    Tokens on the CPU take the plain version; CUDA tokens launch the kernels.
    ``fc2``: (m, x1) -> the block's output, x1 plus the fc2 product of the
    float32 rows m, in place of ``qb``'s fc2 (a routed ViTPose+ block, whose
    plain version :func:`block_q8` takes with the CPU's ``fc2``).
    """
    if x.device.type == "cpu":
        return block_q8(x, qb, fc2)
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
    check_attention_shape(N, D, qb.num_heads, dt)
    x = x.contiguous().reshape(B * N, D)
    h = layernorm_cuda(x, qb.ln1_s, qb.ln1_b, qb.eps, torch.float32)
    qkv = gemm_q8_cuda(h, *qb.linear("qkv"), dt)
    o = attention_cuda(qkv, B, N, qb.num_heads)
    x1 = gemm_q8_cuda(o, *qb.linear("proj"), dt, EPI_RESIDUAL, x)
    h = layernorm_cuda(x1, qb.ln2_s, qb.ln2_b, qb.eps, torch.float32)
    m = gemm_q8_cuda(h, *qb.linear("fc1"), torch.float32, EPI_GELU)
    out = gemm_q8_cuda(m, *qb.linear("fc2"), dt, EPI_RESIDUAL, x1) if fc2 is None else fc2(m, x1)
    kernels.count_launch(KERNEL)
    return out.reshape(B, N, D)
