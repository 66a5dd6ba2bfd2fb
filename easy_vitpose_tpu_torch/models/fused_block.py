"""K1: the pre-LN transformer block for bf16 and fp32 serving.

Replaces ``easy_vitpose_tpu/models/fused_block.py::_block_kernel``
(``pl.pallas_call`` in ``fused_block``), which runs the whole block for a
tile of crops in VMEM.  Here the block is a short sequence of hand-written
launches from ``csrc/block.cu``, seven per block:

  LN1 -> GEMM qkv (+bias) -> attention -> GEMM proj (+bias, +residual)
      -> LN2 -> GEMM fc1 (+bias, GELU) -> GEMM fc2 (+bias, +residual)

* The GEMMs compute ``A @ W.T`` with W in torch's (out, in) layout: bf16 on
  the tensor cores (``csrc/gemm_mma.cuh``: ``mma.sync`` m16n8k16 with float32
  accumulation, 128x128 or 128x64 block tiles fed by a three-stage
  ``cp.async`` ring, ``ldmatrix`` fragments), or float32 FMA for fp32
  serving (the parity mode: no TF32).  The bias, the A&S-erf GELU, the
  residual add and the cast run in the epilogue.
* Attention at bf16 runs on the tensor cores (``csrc/attention_tc.cuh``):
  one block of 4 warps per (crop, head, 64-query tile), K and V of the head
  (N <= 256 tokens, head dim a multiple of 8 up to 128) in shared memory as
  bf16, the float32 logits of a warp's 16 rows in registers.  fp32 keeps a
  float32 FMA kernel with the 64 x N logit tile in shared memory.

What bounds it on the H100 is operations: at ViT-B and 64 crops one block is
174 GFLOP of linears and 7 GFLOP of attention, 0.18 ms at the bf16 tensor
peak, against 52 MB of bytes (16 us).  ``mma.sync`` reaches about a quarter
of that peak here; ``wgmma`` fed by TMA is the next step.  The times are in
PERF.md.

Rounding to the working dtype happens where the TPU kernel rounds
(``fused_block.py:58-100``), which :func:`..models.vit.block` (the plain
version) mirrors.
"""
from __future__ import annotations

import torch

from .. import kernels
from .vit import Block, BlockWeights, block_plain, block_weights, q_scale

KERNEL = "block"
EPI_NONE, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
GEMM_TILE_N = 64
GEMM_TILE_K_BYTES = 128      # the tensor-core GEMM's k-tile, in bytes of A
GEMM_TILE_K_F32 = 16
ATTN_MAX_TOKENS = 256        # the bf16 attention holds all keys of a head
ATTN_MAX_HEAD_DIM = 128      # ... and a head dim padded to 16, at most this


def attention_smem_bytes(tokens: int, head_dim: int) -> int:
    """Shared memory of one float32 attention block: K and V (rows padded by
    one float), the 64-row q tile and the 64 x tokens logits."""
    return 4 * (2 * tokens * (head_dim + 1) + 64 * head_dim + 64 * tokens)


def check_gemm_shape(N: int, K: int, elem_bytes: int, tensor_cores: bool) -> None:
    """The GEMMs take any row count M; N a multiple of 64 (the 128- or
    64-wide tile), and K a multiple of the k-tile: 128 bytes on the tensor
    cores (64 bf16, 128 int8), 16 in float32."""
    if N % GEMM_TILE_N:
        raise ValueError(f"GEMM width {N} is not a multiple of {GEMM_TILE_N}")
    kt = GEMM_TILE_K_BYTES // elem_bytes if tensor_cores else GEMM_TILE_K_F32
    if K % kt:
        raise ValueError(f"GEMM depth {K} is not a multiple of {kt}")


def check_attention_shape(N: int, D: int, heads: int, dtype=torch.float32) -> None:
    """bf16 (the tensor-core kernels of ``csrc/attention_tc.cuh``): a head
    dim that is a multiple of 8 up to 128 and 1 to 256 tokens.  float32: K,
    V, q and the logits of a 64-query tile within one block's shared memory."""
    if D % heads:
        raise ValueError(f"dim {D} does not split into {heads} heads")
    hd = D // heads
    if dtype == torch.bfloat16:
        if hd % 8 or not 0 < hd <= ATTN_MAX_HEAD_DIM:
            raise ValueError(f"head dim {hd}: the bf16 attention takes a multiple of 8 up to "
                             f"{ATTN_MAX_HEAD_DIM}")
        if not 0 < N <= ATTN_MAX_TOKENS:
            raise ValueError(f"{N} tokens: the bf16 attention takes 1 to {ATTN_MAX_TOKENS}")
        return
    smem = attention_smem_bytes(N, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{N} tokens x head dim {hd} needs {smem} B of "
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
    check_attention_shape(N, D, heads, qkv.dtype)
    o = torch.empty((B * N, D), dtype=qkv.dtype, device=qkv.device)
    kernels.call(KERNEL, "evt_attention", qkv.device, qkv.data_ptr(), o.data_ptr(),
                 B, N, D, heads, q_scale(D // heads, qkv.dtype),
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
    return fused_block_weights(x, block_weights(dict(blk.named_parameters()), ""),
                               blk.attn.num_heads, blk.eps)


def fused_block_weights(x: torch.Tensor, w: BlockWeights, num_heads: int,
                        eps: float) -> torch.Tensor:
    """:func:`fused_block` from the block's weights (a ViTPose+ task's block
    spliced from its shared and expert fc2 rows, ``models/moe.py``)."""
    if x.device.type == "cpu":
        return block_plain(x, w, num_heads, eps)
    kernels.require_cuda(x, *w)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tokens must be float32 or bfloat16, got {dt}")
    bad = [t.dtype for t in w if t.dtype != dt]
    if bad:
        raise ValueError(f"block weights must be {dt} like the tokens, got {bad[0]}")
    B, N, D = x.shape
    check_attention_shape(N, D, num_heads, dt)
    x = x.contiguous().reshape(B * N, D)
    h = layernorm_cuda(x, w.ln1_w, w.ln1_b, eps, dt)
    qkv = gemm_cuda(h, w.qkv_w, w.qkv_b)
    o = attention_cuda(qkv, B, N, num_heads)
    x1 = gemm_cuda(o, w.proj_w, w.proj_b, EPI_RESIDUAL, x)
    h = layernorm_cuda(x1, w.ln2_w, w.ln2_b, eps, dt)
    hid = gemm_cuda(h, w.fc1_w, w.fc1_b, EPI_GELU)
    out = gemm_cuda(hid, w.fc2_w, w.fc2_b, EPI_RESIDUAL, x1)
    kernels.count_launch(KERNEL)
    return out.reshape(B, N, D)
