"""K1: the pre-LN transformer block for bf16 and fp32 serving.

Replaces ``easy_vitpose_tpu/models/fused_block.py::_block_kernel``
(``pl.pallas_call`` in ``fused_block``), which runs the whole block for a
tile of crops in VMEM.  Here the block is a short sequence of hand-written
launches from ``csrc/block.cu``, seven per block:

  LN1 -> GEMM qkv (+bias) -> attention -> GEMM proj (+bias, +residual)
      -> LN2 -> GEMM fc1 (+bias, GELU) -> GEMM fc2 (+bias, +residual)

* The GEMMs compute ``A @ W.T`` with W in torch's (out, in) layout: bf16 on
  the tensor cores with ``mma.sync`` m16n8k16 and float32 accumulation, or
  float32 FMA for fp32 serving (the parity mode: no TF32).  The bias, the
  A&S-erf GELU, the residual add and the cast run in the epilogue.
* Attention takes one block per (crop, head, 64-query tile); K and V of the
  head (N <= 256 tokens) and the 64 x N float32 logit tile live in shared
  memory, so the logits never reach device memory.

What bounds it on the H100 is operations: at ViT-B and 64 crops one block is
174 GFLOP of linears and 7 GFLOP of attention, 0.18 ms at the bf16 tensor
peak, against 52 MB of bytes (16 us).  This first version keeps each GEMM
simple (one 64x64 tile per block, no pipelining, no ``wgmma``/TMA), so it
sits far from that bound; the times are in PERF.md.

Rounding to the working dtype happens where the TPU kernel rounds
(``fused_block.py:58-100``), which :func:`..models.vit.block` (the plain
version) mirrors.
"""
from __future__ import annotations

import torch

from .. import kernels
from .vit import Block, block

KERNEL = "block"
EPI_NONE, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
GEMM_TILE_N = 64
GEMM_TILE_K_BYTES = 128      # the tensor-core GEMM's k-tile, in bytes of A
GEMM_TILE_K_F32 = 16


def attention_smem_bytes(tokens: int, head_dim: int) -> int:
    """Shared memory of one attention block: K and V (rows padded by one
    float), the 64-row q tile and the 64 x tokens logits."""
    return 4 * (2 * tokens * (head_dim + 1) + 64 * head_dim + 64 * tokens)


def check_gemm_shape(N: int, K: int, elem_bytes: int, tensor_cores: bool) -> None:
    if N % GEMM_TILE_N:
        raise ValueError(f"GEMM width {N} is not a multiple of {GEMM_TILE_N}")
    kt = GEMM_TILE_K_BYTES // elem_bytes if tensor_cores else GEMM_TILE_K_F32
    if K % kt:
        raise ValueError(f"GEMM depth {K} is not a multiple of {kt}")


def check_attention_shape(N: int, D: int, heads: int) -> None:
    if D % heads:
        raise ValueError(f"dim {D} does not split into {heads} heads")
    smem = attention_smem_bytes(N, D // heads)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{N} tokens x head dim {D // heads} needs {smem} B of "
                         f"shared memory in attention, more than {SMEM_LIMIT}")


def layernorm_cuda(x, weight, bias, eps: float, out_dtype) -> torch.Tensor:
    """LN over the last dim of a 2-D CUDA tensor (``csrc/block.cu``)."""
    R, D = x.shape
    out = torch.empty((R, D), dtype=out_dtype, device=x.device)
    kernels.call(KERNEL, "evt_layernorm", x.device, x.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), R, D, eps,
                 int(x.dtype == torch.bfloat16), int(weight.dtype == torch.bfloat16),
                 int(out_dtype == torch.bfloat16))
    return out


def attention_cuda(qkv: torch.Tensor, B: int, N: int, heads: int) -> torch.Tensor:
    """(B*N, 3D) qkv -> (B*N, D) attention output, in the dtype of qkv."""
    D = qkv.shape[1] // 3
    o = torch.empty((B * N, D), dtype=qkv.dtype, device=qkv.device)
    kernels.call(KERNEL, "evt_attention", qkv.device, qkv.data_ptr(), o.data_ptr(),
                 B, N, D, heads, float((D // heads) ** -0.5),
                 int(qkv.dtype == torch.bfloat16))
    return o


def gemm_cuda(a, weight, bias, epilogue: int = EPI_NONE, residual=None) -> torch.Tensor:
    """``epilogue(a @ weight.T + bias)`` in the dtype of ``a`` (bf16 on the
    tensor cores, or float32)."""
    M, K = a.shape
    N = weight.shape[0]
    bf16 = a.dtype == torch.bfloat16
    check_gemm_shape(N, K, a.element_size(), bf16)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    res = residual.data_ptr() if residual is not None else None
    kernels.call(KERNEL, "evt_gemm", a.device, a.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), res, out.data_ptr(), M, N, K, int(bf16), epilogue)
    return out


def fused_block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One transformer block over (B, N, D) tokens in float32 or bfloat16.

    Tokens on the CPU take the plain version; CUDA tokens launch the kernels.
    """
    if x.device.type == "cpu":
        return block(x, blk)
    a, m = blk.attn, blk.mlp
    weights = [blk.norm1.weight, blk.norm1.bias, a.qkv.weight, a.qkv.bias,
               a.proj.weight, a.proj.bias, blk.norm2.weight, blk.norm2.bias,
               m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias]
    kernels.require_cuda(x, *weights)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tokens must be float32 or bfloat16, got {dt}")
    bad = [w.dtype for w in weights if w.dtype != dt]
    if bad:
        raise ValueError(f"block weights must be {dt} like the tokens, got {bad[0]}")
    B, N, D = x.shape
    check_attention_shape(N, D, a.num_heads)
    x = x.contiguous().reshape(B * N, D)
    h = layernorm_cuda(x, blk.norm1.weight, blk.norm1.bias, blk.eps, dt)
    qkv = gemm_cuda(h, a.qkv.weight, a.qkv.bias)
    o = attention_cuda(qkv, B, N, a.num_heads)
    x1 = gemm_cuda(o, a.proj.weight, a.proj.bias, EPI_RESIDUAL, x)
    h = layernorm_cuda(x1, blk.norm2.weight, blk.norm2.bias, blk.eps, dt)
    hid = gemm_cuda(h, m.fc1.weight, m.fc1.bias, EPI_GELU)
    out = gemm_cuda(hid, m.fc2.weight, m.fc2.bias, EPI_RESIDUAL, x1)
    kernels.count_launch(KERNEL)
    return out.reshape(B, N, D)
