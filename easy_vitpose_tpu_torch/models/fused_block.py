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
  ``cp.async`` ring, ``ldmatrix`` fragments); float32 (fp32 serving, the
  parity mode) on the tensor cores too, with float32 accuracy
  (``csrc/gemm_tf32.cuh``, 3xTF32: each operand split into two TF32
  halves, ``x = hi + lo``, and each product the float32 sum of
  ``a_lo.w_hi + a_hi.w_lo + a_hi.w_hi`` on ``wgmma`` m64n128k8 from a TMA
  ring).  The bias, the A&S-erf GELU, the residual add and the cast run in
  the epilogue.  W's halves are made once, with the fp32 serving copy on
  the card (:func:`split_block_weights`, a launch of the split kernel per
  weight; 2x the float32 block weights of device memory beside them), and
  held by the block as ``tf32_halves``; A's are made in registers.
* Attention at bf16 runs on the tensor cores (``csrc/attention_tc.cuh``):
  one block of 4 warps per (crop, head, 64-query tile), K and V of the head
  (N <= 256 tokens, head dim a multiple of 8 up to 128) in shared memory as
  bf16, the float32 logits of a warp's 16 rows in registers.  At fp32 the
  same shape in 3xTF32 (``csrc/attention_tf32.cuh``): K and V in shared
  memory as float32, each product three TF32 passes of ``mma.sync``
  m16n8k8, an online softmax over 64-key chunks.

What bounds it on the H100 is operations: at ViT-B and 64 crops one block is
174 GFLOP of linears and 7 GFLOP of attention, 0.18 ms at the bf16 tensor
peak and, at fp32, 3 x 181 GFLOP over the TF32 peak, 1.10 ms, against 52 MB
(bf16) of bytes.  The times are in PERF.md.

Rounding to the working dtype happens where the TPU kernel rounds
(``fused_block.py:58-100``), which :func:`..models.vit.block` (the plain
version) mirrors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .vit import Block, BlockWeights, block_plain, block_weights, q_scale

KERNEL = "block"
KERNEL_TF32 = "gemm_tf32"    # the float32 GEMM's own counter (4 a block)
KERNEL_SPLIT = "tf32_split"  # the split kernel's (a copy's weights once, MoE's each call)
EPI_NONE, EPI_GELU, EPI_RESIDUAL = 0, 1, 2
SMEM_LIMIT = 232448          # bytes of shared memory one block may use
GEMM_TILE_N = 64
GEMM_TILE_K_BYTES = 128      # the GEMMs' k-tile, in bytes of A: 64 bf16, 128 int8, 32 float32
TF32_MASK = -8192            # 0xFFFFE000: a TF32 number's bits of a float32
TF32_HALF = 0x1000           # half a TF32 ulp, in a float32's low bits
ATTN_MAX_TOKENS = 256        # the bf16 attention holds all keys of a head
ATTN_MAX_HEAD_DIM = 128      # ... and a head dim padded to 16, at most this


def attention_smem_bytes(tokens: int, head_dim: int) -> int:
    """Shared memory of one float32 attention block (``csrc/attention_tf32.cuh``):
    the head's K and V, tokens padded to 8 and rows to the head dim padded
    to 16 plus 4 floats."""
    return 4 * 2 * (-(-tokens // 8) * 8) * (-(-head_dim // 16) * 16 + 4)


def check_gemm_shape(N: int, K: int, elem_bytes: int) -> None:
    """The GEMMs take any row count M; N a multiple of 64 (the 128- or
    64-wide tile), and K a multiple of the k-tile of 128 bytes of A: 64
    bf16, 128 int8, 32 float32."""
    if N % GEMM_TILE_N:
        raise ValueError(f"GEMM width {N} is not a multiple of {GEMM_TILE_N}")
    kt = GEMM_TILE_K_BYTES // elem_bytes
    if K % kt:
        raise ValueError(f"GEMM depth {K} is not a multiple of {kt}")


def check_attention_shape(N: int, D: int, heads: int, dtype=torch.float32) -> None:
    """Both on the tensor cores take a head dim that is a multiple of 8 up
    to 128; bf16 (``csrc/attention_tc.cuh``) 1 to 256 tokens, float32
    (``csrc/attention_tf32.cuh``) any count whose K and V fit in one block's
    shared memory."""
    if D % heads:
        raise ValueError(f"dim {D} does not split into {heads} heads")
    hd = D // heads
    bf16 = dtype == torch.bfloat16
    if hd % 8 or not 0 < hd <= ATTN_MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the {'bf16' if bf16 else 'float32'} attention takes "
                         f"a multiple of 8 up to {ATTN_MAX_HEAD_DIM}")
    if bf16:
        if not 0 < N <= ATTN_MAX_TOKENS:
            raise ValueError(f"{N} tokens: the bf16 attention takes 1 to {ATTN_MAX_TOKENS}")
        return
    smem = attention_smem_bytes(N, hd)
    if N <= 0 or smem > SMEM_LIMIT:
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


class TF32Split(NamedTuple):
    """A float32 tensor as two TF32 numbers a float32 each, ``x = hi + lo
    + O(2^-22 |x|)``."""
    hi: torch.Tensor
    lo: torch.Tensor


def tf32_round_plain(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32, nearest with ties away from zero
    (``cvt.rna.tf32.f32``), as float32 with the low 13 bits zero;
    infinities stay and a NaN becomes 0x7FC00000.  The plain version of
    ``csrc/gemm_tf32.cuh::tf32_round``: adding half a TF32 ulp to the bits
    rounds the magnitude, a carry into the exponent included."""
    bits = x.contiguous().view(torch.int32)
    r = torch.where(torch.isinf(x), bits, (bits + TF32_HALF) & TF32_MASK)
    return torch.where(torch.isnan(x), torch.full_like(bits, 0x7FC00000), r).view(torch.float32)


def tf32_split_plain(x: torch.Tensor) -> TF32Split:
    """``hi = rna(x)``, ``lo = rna(x - hi)`` (0 for a non-finite ``x``):
    the plain version of the split kernel and of the GEMM's split of A."""
    x = x.contiguous().float()
    hi = tf32_round_plain(x)
    lo = torch.where(torch.isfinite(x), tf32_round_plain(x - hi), torch.zeros_like(x))
    return TF32Split(hi, lo)


def tf32_split_stacked(x: torch.Tensor) -> torch.Tensor:
    """(2, *x.shape): the TF32 halves of a float32 CUDA tensor, hi then lo,
    by one launch of the split kernel (``csrc/gemm_tf32.cuh::split_kernel``)."""
    kernels.require_cuda(x)
    if x.dtype != torch.float32:
        raise ValueError(f"the TF32 split takes float32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty((2,) + tuple(x.shape), dtype=torch.float32, device=x.device)
    kernels.call(KERNEL, "evt_split_tf32", x.device, x.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), x.numel())
    kernels.count_launch(KERNEL_SPLIT)
    return out


def tf32_split(x: torch.Tensor) -> TF32Split:
    """:func:`tf32_split_plain` of a CPU tensor; the split kernel's halves
    of a CUDA tensor (:func:`tf32_split_stacked`)."""
    if x.device.type == "cpu":
        return tf32_split_plain(x)
    return TF32Split(*tf32_split_stacked(x))


def split_weights(w: BlockWeights) -> Tuple[TF32Split, ...]:
    """The TF32 halves of a float32 block's four GEMM weights, qkv, proj,
    fc1 and fc2 (:func:`tf32_split` of each)."""
    return tuple(tf32_split(t.detach()) for t in (w.qkv_w, w.proj_w, w.fc1_w, w.fc2_w))


def split_block(blk: Block) -> None:
    """Give a float32 block on the card the TF32 halves of its GEMM weights
    (``blk.tf32_halves``, :func:`split_weights`), any other block none.
    The float32 block kernel reads the halves, not the weights: split a
    block again after moving it to another device or writing its weights."""
    w = blk.attn.qkv.weight
    blk.tf32_halves = (split_weights(block_weights(dict(blk.named_parameters()), ""))
                       if w.dtype == torch.float32 and w.device.type == "cuda" else None)


def split_block_weights(vit) -> None:
    """:func:`split_block` of each float32 block of a ViT (``serving_copy``
    calls it)."""
    for blk in vit.blocks:
        if isinstance(blk, Block):
            split_block(blk)


def gemm_tf32_cuda(a, w: TF32Split, bias, epilogue: int = EPI_NONE,
                   residual=None) -> torch.Tensor:
    """``epilogue(a @ w.T + bias)`` in float32 from the weight's TF32 halves
    (``csrc/gemm_tf32.cuh``): 3xTF32 on the warpgroup tensor cores, ``a``
    split in registers."""
    M, K = a.shape
    N = w.hi.shape[0]
    check_gemm_shape(N, K, 4)
    ops = (a, w.hi, w.lo, bias) + ((residual,) if residual is not None else ())
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ops):
        raise ValueError("the float32 GEMM takes contiguous float32 tensors")
    if any(t.device != a.device for t in ops):
        raise ValueError("the float32 GEMM's operands and weight halves are on different devices")
    if any(t.data_ptr() % 16 for t in ops if t is not bias):      # TMA's 16-byte rows
        raise ValueError("the float32 GEMM needs 16-byte aligned operands")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    res = residual.data_ptr() if residual is not None else None
    kernels.call(KERNEL, "evt_gemm_tf32", a.device, a.data_ptr(), w.hi.data_ptr(),
                 w.lo.data_ptr(), bias.data_ptr(), res, out.data_ptr(), M, N, K, epilogue)
    kernels.count_launch(KERNEL_TF32)
    return out


def gemm_cuda(a, weight, bias, epilogue: int = EPI_NONE, residual=None,
              split: Optional[TF32Split] = None) -> torch.Tensor:
    """``epilogue(a @ weight.T + bias)`` in the dtype of ``a``: bf16 on the
    tensor cores, or float32 through :func:`gemm_tf32_cuda` on ``split``,
    ``weight``'s TF32 halves, which float32 requires."""
    M, K = a.shape
    N = weight.shape[0]
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the GEMM takes float32 or bfloat16, got {a.dtype}")
    check_gemm_shape(N, K, a.element_size())
    if a.dtype == torch.float32:
        if split is None or split.hi.shape != weight.shape:
            raise ValueError("the float32 GEMM needs the TF32 halves of its weight "
                             "(tf32_split(weight))")
        return gemm_tf32_cuda(a, split, bias, epilogue, residual)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    res = residual.data_ptr() if residual is not None else None
    kernels.call(KERNEL, "evt_gemm", a.device, a.data_ptr(), weight.data_ptr(),
                 bias.data_ptr(), res, out.data_ptr(), M, N, K, epilogue)
    return out


def fused_block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """One transformer block over (B, N, D) tokens in float32 or bfloat16.

    Tokens on the CPU take the plain version; CUDA tokens launch the
    kernels, at float32 from the halves the block holds
    (:func:`split_block_weights`; a float32 block without them raises).
    """
    splits = None
    if x.dtype == torch.float32 and x.device.type != "cpu":
        splits = getattr(blk, "tf32_halves", None)
        if splits is None:
            raise RuntimeError("this float32 block holds no TF32 halves of its weights: make "
                               "its copy with serving_copy(model, 'fp32') on the card, or call "
                               "split_block(blk) after moving it there")
    return fused_block_weights(x, block_weights(dict(blk.named_parameters()), ""),
                               blk.attn.num_heads, blk.eps, splits)


def fused_block_weights(x: torch.Tensor, w: BlockWeights, num_heads: int, eps: float,
                        splits: Optional[Tuple[TF32Split, ...]] = None) -> torch.Tensor:
    """:func:`fused_block` from the block's weights (a ViTPose+ task's block
    spliced from its shared and expert fc2 rows, ``models/moe.py``); at
    float32 on the card ``splits`` are the TF32 halves of qkv, proj, fc1
    and fc2 (:func:`split_weights`), which float32 requires."""
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
    if dt == torch.float32 and splits is None:
        raise ValueError("the float32 block needs the TF32 halves of its weights")
    sq, sp, s1, s2 = splits or (None,) * 4
    x = x.contiguous().reshape(B * N, D)
    h = layernorm_cuda(x, w.ln1_w, w.ln1_b, eps, dt)
    qkv = gemm_cuda(h, w.qkv_w, w.qkv_b, split=sq)
    o = attention_cuda(qkv, B, N, num_heads)
    x1 = gemm_cuda(o, w.proj_w, w.proj_b, EPI_RESIDUAL, x, split=sp)
    h = layernorm_cuda(x1, w.ln2_w, w.ln2_b, eps, dt)
    hid = gemm_cuda(h, w.fc1_w, w.fc1_b, EPI_GELU, split=s1)
    out = gemm_cuda(hid, w.fc2_w, w.fc2_b, EPI_RESIDUAL, x1, split=s2)
    kernels.count_launch(KERNEL)
    return out.reshape(B, N, D)
