"""K5, K6a-K6e and K7: the pre-LN transformer block for training.

Port of ``easy_vitpose_tpu/models/fused_block_train.py`` with every flavor
of its backward, picked by the same environment switches (JAX ``:550-601``,
:func:`saved_flags`):

* K5, the forward (``_fwd_kernel`` :95): the serving block with a per-crop
  drop-path keep factor ``dp`` (already scaled by 1/keep_prob) on both
  residual branches, each branch kept in float32 until the residual add,
  ``round(x + dp * (acc + b))``; it also returns ``x1``, the output of the
  attention residual, which the backward starts from, and in the saved
  flavors the qkv projection and the pre-GELU fc1 output ``m`` rounded to
  the working dtype (JAX ``:120-150``; the forward's GELU still takes the
  float32 ``m``).
* K6a, the MLP backward when it is narrow (``_bwd_mlp_kernel`` :195; JAX's
  ``nj == 1``, :722-724: D <= 768, or a hidden dim that the chunk count
  does not divide): from (x1, dout) it recomputes LN2, fc1 and the GELU and
  gives dx1 and the fc1, fc2 and LN2 grads.  K6a ``_ms`` (``_bwd_mlp_kernel_ms``
  :267, ``EVT_TRAIN_MLP=saved``) reads the saved ``m`` instead of the fc1
  GEMM; ``g = gelu(m)`` and ``gelu'(m)`` then take the rounded ``m``, so at
  bf16 its gradients are not the recompute flavor's.
* K6b and K6c, the wide MLP backward (ViT-L/H), saved-operand flavor, the
  default there (``EVT_TRAIN_WIDE`` unset or ``saved``): K6b
  (``_bwd_mlp_dx_save_kernel`` :280, or ``_ms`` :327 with saved ``m``) runs
  K6a's work up to dx1 and the vector grads and keeps the four operands of
  the weight grads, h2, dm2c, dm1c and g; K6c (``_bwd_mlp_dw_saved_kernel``
  :340) forms dW1 and dW2 from them.  The TPU splits the two, and chunks
  K6c over the hidden dim, because a Pallas TPU output block may only be
  revisited on consecutive grid steps and the float32 weight-grad
  accumulators of a wide MLP do not fit VMEM.  CUDA has neither rule: K6c
  is one launch whose grid covers every 128x128 tile of both weight grads,
  each block summing its tile over all rows, so it needs no chunks.
* K6d and K6e, the wide recompute flavor (``EVT_TRAIN_WIDE=recompute``):
  K6d (``_bwd_mlp_dx_kernel`` :237) gives dx1, db2 and the LN2 grads,
  keeping nothing; K6e (``_bwd_mlp_dw_kernel`` :368) recomputes LN2, fc1,
  the GELU, dm2c and dm1c from (x1, dout) and gives dW1, db1 and dW2.  The
  recompute flavor has no use for a saved ``m``: :func:`saved_flags` saves
  none there, as JAX's does.
* K7, the attention backward (``_bwd_attn_kernel`` :404): from (x, dx1) it
  recomputes LN1, qkv and the softmax and gives dx and the qkv, proj and
  LN1 grads.  K7 ``_saved`` (``_bwd_attn_saved_kernel`` :507,
  ``EVT_TRAIN_ATTN=saved``) reads the forward's qkv instead of the qkv GEMM;
  LN1 is still recomputed, for dWqkv and the LN backward.

:class:`FusedBlockTrain` is the ``torch.autograd.Function`` in place of
``make_fused_block_train``'s ``jax.custom_vjp``: its forward reads the
switches once, saves (x, x1), the keep mask (which gets no gradient) and
the saved tensors of its flavor, and keeps the flavor for its backward,
which runs the MLP backward of that flavor, then K7 or K7 ``_saved``.  The
TPU's tile and VMEM knobs (``EVT_TRAIN_TILE*``, ``EVT_TRAIN_VMEM*``) have
no meaning here.  Weight grads come back in the dtype of the weights passed
in (bf16 under AMP, as ``like()`` casts them), and the cast's own backward
carries them to the float32 master weights.

On the card each is a sequence of launches from ``csrc/train_block.cu``
(GEMMs in the NT and NN layouts with their epilogues, the LayerNorm
backward, column sums, the attention backward, and one launch of a pair of
TN GEMMs for each backward's two weight grads) and K1's LayerNorm and
attention (``csrc/block.cu``).  K6a is K6b's launches followed by K6c's,
counted as one kernel; K6d then K6e give the same result bit for bit, as
K7 ``_saved`` gives K7's: the saved tensors come from the same launches on
the same inputs.  What bounds them on the H100 is operations: at ViT-B and
64 crops the forward is 181 GFLOP (as K1), the MLP backward five 58-GFLOP
products and the attention backward 181 GFLOP (five linear products of
14.5 or 43.5 GFLOP and the attention's recompute); 0.18, 0.29 and 0.18 ms
at the bf16 tensor peak.  At ViT-L K6b is three 103-GFLOP products (0.31
ms), K6c two (0.21 ms), K6d three and K6e four.  The bf16 training GEMMs
run on ``wgmma`` fed by a TMA ring (``csrc/gemm_wgmma.cuh``: 128x128
tiles, each operand read as stored), the bf16 attention backward on the
tensor cores (``csrc/attention_tc.cuh``); float32 keeps FMA kernels, but
for the forward attention, which is K1's (3xTF32, ``csrc/attention_tf32.cuh``).
The times are in PERF.md.

Each kernel has a plain version here (``*_plain``), written step by step as
the kernel's math, rounding to the working dtype where the TPU kernels
round: the tensors that a wrapper gets on the CPU go through it, and
``chip_smoke.py`` holds the kernels to it on the card.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from .. import kernels
from .fused_block import (SMEM_LIMIT, attention_cuda, check_attention_shape,
                          layernorm_cuda)
from .vit import (BlockWeights, attention_core, erf_as, gelu, layer_norm,
                  linear_f32, q_scale)

KERNEL = "train_block"
# launch counters, one per TPU kernel body
FWD, BWD_MLP, BWD_MLP_MS = "train_fwd", "train_bwd_mlp", "train_bwd_mlp_ms"
BWD_MLP_DX_SAVE, BWD_MLP_DX_SAVE_MS = "train_bwd_mlp_dx_save", "train_bwd_mlp_dx_save_ms"
BWD_MLP_DW_SAVED = "train_bwd_mlp_dw_saved"
BWD_MLP_DX, BWD_MLP_DW = "train_bwd_mlp_dx", "train_bwd_mlp_dw"
BWD_ATTN, BWD_ATTN_SAVED = "train_bwd_attn", "train_bwd_attn_saved"
WIDE_D = 768             # D above this may take the wide MLP backward (see mlp_chunks)
(TE_NONE, TE_GELU, TE_DP_RES, TE_GELU_SAVE, TE_GELU_GRAD, TE_F32, TE_GELU_SAVE_T,
 TE_GELU_GRAD_T, TE_GELU_GRAD_MS) = range(9)
COLSUM_CHUNK = 64        # rows per partial of the column sums
LN_ROWS, LN_MAXJ = 64, 48
ATTN_TILE = 32           # float32 backward: queries (kernel A) or keys (kernel B) per block
_INV_SQRT2PI = 0.3989422804014327

WeightGrads = Tuple[torch.Tensor, ...]


# ------------------------------------------------------------ flavor policy
def _wide_saved() -> bool:
    """Wide MLP backward flavor: saved operands (K6b, K6c; the default) or,
    with ``EVT_TRAIN_WIDE=recompute``, the recompute pair (K6d, K6e)."""
    return os.environ.get("EVT_TRAIN_WIDE", "saved") != "recompute"


def _attn_saved(D: int) -> bool:
    """Attention backward flavor: ``EVT_TRAIN_ATTN=saved`` saves the
    forward's qkv for K7 ``_saved``; unset, empty or ``recompute`` keeps K7.
    Any other value raises, as JAX's does."""
    ov = os.environ.get("EVT_TRAIN_ATTN")
    if ov not in (None, "", "saved", "recompute"):
        raise ValueError(f"EVT_TRAIN_ATTN={ov!r}: expected 'saved' or 'recompute'")
    return ov == "saved"


def _mlp_saved(D: int) -> bool:
    """MLP backward flavor: ``EVT_TRAIN_MLP=saved`` saves the forward's
    pre-GELU ``m`` for K6a or K6b ``_ms``."""
    return os.environ.get("EVT_TRAIN_MLP") == "saved"


def saved_flags(D: int) -> Tuple[bool, bool]:
    """(save_qkv, save_m) at width D: saved m only where a kernel reads it,
    the narrow MLP backward or the wide saved-operand one (JAX :601)."""
    return _attn_saved(D), _mlp_saved(D) and (D <= WIDE_D or _wide_saved())


def mlp_chunks(D: int, hidden: int) -> int:
    """The hidden-dim chunk count of JAX's ``_mlp_backward_padded``
    (:722-724); the MLP backward is narrow (K6a) where it is 1."""
    nj = 1 if D <= WIDE_D else (2 if D <= 1024 else 4)
    return 1 if hidden % nj else nj


# ---------------------------------------------------------------- plain math
def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx of the A&S-erf GELU, float32."""
    cdf = 0.5 * (1.0 + erf_as(x * 0.7071067811865476))
    pdf = torch.exp(-0.5 * x * x) * _INV_SQRT2PI
    return cdf + x * pdf


def ln_stats(x: torch.Tensor, eps: float):
    """(xhat, 1/sigma) of a LayerNorm over the last dim, float32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    return (xf - mean) * inv, inv


def ln_backward(dh: torch.Tensor, xhat: torch.Tensor, inv: torch.Tensor, w: torch.Tensor):
    """LayerNorm input grad for the upstream float32 ``dh``, and the scale and
    bias grads (float32 column sums)."""
    dxhat = dh * w.float()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (dh * xhat).sum(0), dh.sum(0)


def _rows(x: torch.Tensor, keep: torch.Tensor):
    """(B*N, D) rows of ``x`` and the (B*N, 1) float32 keep factor per row."""
    B, N, D = x.shape
    return x.reshape(B * N, D), keep.float().repeat_interleave(N)[:, None]


def train_forward_plain(x: torch.Tensor, keep: torch.Tensor, w: BlockWeights,
                        num_heads: int, eps: float, save_qkv: bool = False,
                        save_m: bool = False):
    """Plain version of K5: (B, N, D) tokens and (B,) keep -> (out, x1, qkv,
    m), the last two the (B, N, 3D) qkv and the (B, N, hidden) pre-GELU m
    rounded to the working dtype where ``save_qkv`` / ``save_m``, else None."""
    B, N, D = x.shape
    dt = x.dtype
    xr, dp = _rows(x, keep)
    h = layer_norm(xr, w.ln1_w, w.ln1_b, eps)
    qkv = linear_f32(h, w.qkv_w, w.qkv_b).to(dt)
    o = attention_core(qkv.reshape(B, N, 3 * D), num_heads).reshape(B * N, D)
    x1 = (xr.float() + linear_f32(o, w.proj_w, w.proj_b) * dp).to(dt)
    m = linear_f32(layer_norm(x1, w.ln2_w, w.ln2_b, eps), w.fc1_w, w.fc1_b)
    g = gelu(m).to(dt)
    out = (x1.float() + linear_f32(g, w.fc2_w, w.fc2_b) * dp).to(dt)
    return (out.reshape(B, N, D), x1.reshape(B, N, D),
            qkv.reshape(B, N, 3 * D) if save_qkv else None,
            m.to(dt).reshape(B, N, -1) if save_m else None)


def _mlp_core_plain(x1, dout, keep, w: BlockWeights, eps: float, m=None):
    """The recompute chain every MLP backward shares (JAX's
    ``_mlp_bwd_core``): LN2, fc1 (or the saved ``m`` read as float32), and
    dm2 -> dm1.  -> (doutf, xhat, inv, h2, m, dm2, dm2c, dm1, dm1c), rows."""
    B, N, D = x1.shape
    dt = x1.dtype
    x1r, dp = _rows(x1, keep)
    doutf = dout.reshape(B * N, D).float()
    xhat, inv = ln_stats(x1r, eps)
    h2 = (xhat * w.ln2_w.float() + w.ln2_b.float()).to(dt)
    m = linear_f32(h2, w.fc1_w, w.fc1_b) if m is None else m.reshape(B * N, -1).float()
    dm2 = doutf * dp
    dm2c = dm2.to(dt)
    dm1 = torch.matmul(dm2c.float(), w.fc2_w.float()) * gelu_grad(m)
    return doutf, xhat, inv, h2, m, dm2, dm2c, dm1, dm1.to(dt)


def _mlp_dx_plain(x1, doutf, xhat, inv, dm1c, w: BlockWeights):
    """dx1 and the LN2 grads from the chain's dm1c."""
    dh2 = torch.matmul(dm1c.float(), w.fc1_w.float())
    dx_ln, dln_w, dln_b = ln_backward(dh2, xhat, inv, w.ln2_w)
    return (doutf + dx_ln).to(x1.dtype).reshape(x1.shape), dln_w, dln_b


def mlp_backward_dx_save_plain(x1: torch.Tensor, dout: torch.Tensor, keep: torch.Tensor,
                               w: BlockWeights, eps: float, m: Optional[torch.Tensor] = None):
    """Plain version of K6b (or K6b ``_ms`` with the saved (B, N, hidden)
    ``m``): -> (dx1, h2, dm2c, dm1c, g, db1, db2, dln2_w, dln2_b), the four
    saved operands as (B*N, D or hidden) rows in the working dtype and the
    vector grads in it too."""
    dt = x1.dtype
    doutf, xhat, inv, h2, mf, dm2, dm2c, dm1, dm1c = _mlp_core_plain(x1, dout, keep, w, eps, m)
    g = gelu(mf).to(dt)
    dx1, dln_w, dln_b = _mlp_dx_plain(x1, doutf, xhat, inv, dm1c, w)
    return (dx1, h2, dm2c, dm1c, g,
            *(v.to(dt) for v in (dm1.sum(0), dm2.sum(0), dln_w, dln_b)))


def mlp_backward_dw_saved_plain(h2: torch.Tensor, dm2c: torch.Tensor, dm1c: torch.Tensor,
                                g: torch.Tensor):
    """Plain version of K6c: the saved operands -> (dW1 (hidden, D), dW2
    (D, hidden)), float32 sums over all rows rounded to the working dtype."""
    dt = h2.dtype
    dW1 = torch.matmul(dm1c.float().t(), h2.float())
    dW2 = torch.matmul(dm2c.float().t(), g.float())
    return dW1.to(dt), dW2.to(dt)


def mlp_backward_plain(x1: torch.Tensor, dout: torch.Tensor, keep: torch.Tensor,
                       w: BlockWeights, eps: float, m: Optional[torch.Tensor] = None):
    """Plain version of K6a (or K6a ``_ms`` with the saved ``m``): -> (dx1,
    (dW1, db1, dW2, db2, dln2_w, dln2_b)).  The same function as K6b then
    K6c, in one piece."""
    dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b = mlp_backward_dx_save_plain(
        x1, dout, keep, w, eps, m)
    dW1, dW2 = mlp_backward_dw_saved_plain(h2, dm2c, dm1c, g)
    return dx1, (dW1, db1, dW2, db2, dln_w, dln_b)


def mlp_backward_dx_plain(x1: torch.Tensor, dout: torch.Tensor, keep: torch.Tensor,
                          w: BlockWeights, eps: float):
    """Plain version of K6d: -> (dx1, db2, dln2_w, dln2_b)."""
    dt = x1.dtype
    doutf, xhat, inv, _, _, dm2, _, _, dm1c = _mlp_core_plain(x1, dout, keep, w, eps)
    dx1, dln_w, dln_b = _mlp_dx_plain(x1, doutf, xhat, inv, dm1c, w)
    return dx1, dm2.sum(0).to(dt), dln_w.to(dt), dln_b.to(dt)


def mlp_backward_dw_plain(x1: torch.Tensor, dout: torch.Tensor, keep: torch.Tensor,
                          w: BlockWeights, eps: float):
    """Plain version of K6e: -> (dW1, db1, dW2), the fc1/GELU chain
    recomputed from (x1, dout)."""
    _, _, _, h2, mf, _, dm2c, dm1, dm1c = _mlp_core_plain(x1, dout, keep, w, eps)
    dW1, dW2 = mlp_backward_dw_saved_plain(h2, dm2c, dm1c, gelu(mf).to(x1.dtype))
    return dW1, dm1.sum(0).to(x1.dtype), dW2


def attention_backward_core(qkv: torch.Tensor, do: torch.Tensor, num_heads: int):
    """Plain version of the attention backward launch: (B, N, 3D) qkv and
    (B, N, D) do, both in the working dtype -> o in that dtype and the
    float32 (B, N, 3D) dqkv."""
    dt = qkv.dtype
    B, N, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = (t.float() for t in qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4))
    qs = (q * q_scale(hd, dt)).to(dt).float()
    probs_f = torch.softmax(torch.matmul(qs, k.transpose(-1, -2)), dim=-1)
    probs = probs_f.to(dt).float()
    o = torch.matmul(probs, v).to(dt)
    dof = do.reshape(B, N, num_heads, hd).transpose(1, 2).float()
    dP = torch.matmul(dof, v.transpose(-1, -2))
    dv = torch.matmul(probs.transpose(-1, -2), dof)
    dlog = probs_f * (dP - (dP * probs_f).sum(-1, keepdim=True))
    dlogc = dlog.to(dt).float()
    scale = hd ** -0.5
    dq = torch.matmul(dlogc, k) * scale
    dk = torch.matmul(dlogc.transpose(-1, -2), q) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(B, N, 3 * D)
    return o.transpose(1, 2).reshape(B, N, D), dqkv


def attn_backward_plain(x: torch.Tensor, dx1: torch.Tensor, keep: torch.Tensor,
                        w: BlockWeights, num_heads: int, eps: float,
                        qkv: Optional[torch.Tensor] = None):
    """Plain version of K7 (or K7 ``_saved`` with the forward's (B, N, 3D)
    ``qkv``): -> (dx, (dWqkv, dbqkv, dWp, dbp, dln1_w, dln1_b))."""
    B, N, D = x.shape
    dt = x.dtype
    xr, dp = _rows(x, keep)
    dx1f = dx1.reshape(B * N, D).float()
    xhat, inv = ln_stats(xr, eps)
    h1 = (xhat * w.ln1_w.float() + w.ln1_b.float()).to(dt)
    if qkv is None:
        qkv = linear_f32(h1, w.qkv_w, w.qkv_b).to(dt)
    da = dx1f * dp
    dac = da.to(dt)
    do = torch.matmul(dac.float(), w.proj_w.float()).to(dt)
    o, dqkv = attention_backward_core(qkv.reshape(B, N, 3 * D), do.reshape(B, N, D), num_heads)
    dqkv = dqkv.reshape(B * N, 3 * D)
    dqkvc = dqkv.to(dt)
    dh1 = torch.matmul(dqkvc.float(), w.qkv_w.float())
    dx_ln, dln_w, dln_b = ln_backward(dh1, xhat, inv, w.ln1_w)
    dx = (dx1f + dx_ln).to(dt)
    dWqkv = torch.matmul(dqkvc.float().t(), h1.float())
    dWp = torch.matmul(dac.float().t(), o.reshape(B * N, D).float())
    grads = (dWqkv, dqkv.sum(0), dWp, da.sum(0), dln_w, dln_b)
    return dx.reshape(B, N, D), tuple(g.to(dt) for g in grads)


# ------------------------------------------------------------ CUDA launches
def _ptr(t):
    return None if t is None else t.data_ptr()


_T_OUT = (TE_NONE, TE_GELU, TE_DP_RES, TE_GELU_SAVE, TE_GELU_SAVE_T, TE_GELU_GRAD_T,
          TE_GELU_GRAD_MS)
_F32_OUT2 = (TE_GELU_SAVE, TE_GELU_GRAD, TE_F32, TE_GELU_GRAD_MS)


def _gemm(a, b, M, N, K, lda, ldb, b_kmaj, mode, *, bias=None, res=None, dp=None,
          tokens=1, aux=None):
    """``epilogue(sum_k A[m, k] B[n, k])`` (see ``evt_train_gemm``) in the
    dtype of ``a``; returns (out in that dtype or None, the second output:
    float32, in that dtype for TE_GELU_SAVE_T, or None)."""
    # 16-byte copies run along the contiguous dim of each operand
    contiguous = (K, lda, K if b_kmaj else N, ldb)
    if any(v % 8 for v in contiguous):
        raise ValueError(f"GEMM dims {(M, N, K)}, leading dims {(lda, ldb)}: each operand's "
                         f"contiguous dim must be a multiple of 8")
    _check_aligned(a, b, *(t for t in (res, aux) if t is not None))
    dt, dev = a.dtype, a.device
    out = torch.empty((M, N), dtype=dt, device=dev) if mode in _T_OUT else None
    out2 = (torch.empty((M, N), dtype=torch.float32, device=dev) if mode in _F32_OUT2 else
            torch.empty((M, N), dtype=dt, device=dev) if mode == TE_GELU_SAVE_T else None)
    kernels.call(KERNEL, "evt_train_gemm", dev, a.data_ptr(), b.data_ptr(), M, N, K, lda, ldb,
                 int(b_kmaj), int(dt == torch.bfloat16), mode, _ptr(bias),
                 _ptr(res), _ptr(dp), tokens, _ptr(aux), _ptr(out), _ptr(out2), N)
    return out, out2


def _check_aligned(*ops):
    """The GEMMs copy each operand and epilogue input 16 bytes at a time (by
    TMA at bf16)."""
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("GEMM operands and epilogue inputs must start at a multiple of 16 bytes")


def mma_probe(x, y):
    """float32 ``x (R, hd) . y (C, hd)^T`` of bf16 CUDA operands by
    ``mma.sync`` m16n8k16 summed from zero in k order, the steps by which
    ``csrc/attention_tc.cuh`` forms its logits: a probe of the instruction,
    not a kernel of the training path (no launch count).  R % 16, C % 8 and
    hd % 16 must be 0."""
    dev = kernels.require_cuda(x, y)
    (R, hd), (C, hd_y) = x.shape, y.shape
    if x.dtype != torch.bfloat16 or y.dtype != torch.bfloat16 or hd != hd_y:
        raise ValueError(f"bf16 (R, hd) and (C, hd) operands, got {x.dtype} {tuple(x.shape)}, "
                         f"{y.dtype} {tuple(y.shape)}")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    kernels.call(KERNEL, "evt_mma_probe", dev, x.data_ptr(), y.data_ptr(), out.data_ptr(), R, C,
                 hd)
    return out


def gemm_nt(a, w, mode, **epi):
    """a (M, K) . w (N, K)^T: the forward's products."""
    return _gemm(a, w, a.shape[0], w.shape[0], a.shape[1], a.shape[1], w.shape[1], 1,
                 mode, **epi)


def gemm_nn(a, w, mode, **epi):
    """a (M, K) . w (K, N): activation grads through a Linear weight."""
    return _gemm(a, w, a.shape[0], w.shape[1], a.shape[1], a.shape[1], w.shape[1], 0,
                 mode, **epi)


def gemm_tn2(a0, b0, a1, b1):
    """A block's two weight grads, a0 (R, M0)^T . b0 (R, N0) and a1 (R, M1)^T
    . b1 (R, N1), in one launch whose grid covers the output tiles of both
    (128x128 at bf16, 64x64 at float32); each block sums its tile over all
    R rows, so the result is deterministic without atomics.  One launch
    fills the card where two would each leave a partial wave (PERF.md).
    -> (out0, out1) in the operands' dtype."""
    ops = (a0, b0, a1, b1)
    dev = kernels.require_cuda(*ops)
    dt = a0.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(t.dtype != dt for t in ops):
        raise ValueError(f"TN operands must share one float32 or bfloat16 dtype, got "
                         f"{[t.dtype for t in ops]}")
    R = a0.shape[0]
    if any(t.dim() != 2 or t.shape[0] != R for t in ops) or any(t.shape[1] % 8 for t in ops):
        raise ValueError(f"TN operands {[tuple(t.shape) for t in ops]}: each (R, multiple of 8)")
    a0, b0, a1, b1 = (t.contiguous() for t in ops)
    _check_aligned(a0, b0, a1, b1)
    out0 = torch.empty((a0.shape[1], b0.shape[1]), dtype=dt, device=dev)
    out1 = torch.empty((a1.shape[1], b1.shape[1]), dtype=dt, device=dev)
    kernels.call(KERNEL, "evt_train_gemm_tn2", dev, a0.data_ptr(), b0.data_ptr(), *out0.shape,
                 out0.data_ptr(), a1.data_ptr(), b1.data_ptr(), *out1.shape, out1.data_ptr(), R,
                 int(dt == torch.bfloat16))
    return out0, out1


def colsum_cuda(src, dt, dp=None, tokens=1, sums=True):
    """The rows ``src * dp[row / tokens]`` rounded to ``dt``, and their
    column sums (float32, two stages) in ``dt``, or None without ``sums``."""
    R, C = src.shape
    dev = src.device
    n = -(-R // COLSUM_CHUNK)
    partial = torch.empty((n, C), dtype=torch.float32, device=dev)
    dst = torch.empty((R, C), dtype=dt, device=dev)
    kernels.call(KERNEL, "evt_scale_colsum", dev, src.data_ptr(),
                 int(src.dtype == torch.bfloat16), _ptr(dp), tokens, dst.data_ptr(),
                 int(dt == torch.bfloat16), partial.data_ptr(), R, C, COLSUM_CHUNK)
    return dst, colsum_finish(partial, dt) if sums else None


def colsum_finish(partial, out_dtype):
    n, C = partial.shape
    out = torch.empty((C,), dtype=out_dtype, device=partial.device)
    kernels.call(KERNEL, "evt_colsum_finish", partial.device, partial.data_ptr(), n, C,
                 out.data_ptr(), int(out_dtype == torch.bfloat16))
    return out


def ln_backward_cuda(x, w, dh, res, eps):
    """round(res + LN backward of ``dh``) and the LN scale and bias grads."""
    R, D = x.shape
    if D > 32 * LN_MAXJ:
        raise ValueError(f"LayerNorm backward takes D <= {32 * LN_MAXJ}, got {D}")
    dev, dt = x.device, x.dtype
    out = torch.empty((R, D), dtype=dt, device=dev)
    n = 8 * -(-R // LN_ROWS)
    pdw = torch.empty((n, D), dtype=torch.float32, device=dev)
    pdb = torch.empty((n, D), dtype=torch.float32, device=dev)
    kernels.call(KERNEL, "evt_ln_backward", dev, x.data_ptr(), w.data_ptr(), dh.data_ptr(),
                 res.data_ptr(), out.data_ptr(), pdw.data_ptr(), pdb.data_ptr(), R, D, eps,
                 int(dt == torch.bfloat16))
    return out, colsum_finish(pdw, dt), colsum_finish(pdb, dt)


def attention_backward_smem_bytes(tokens: int, head_dim: int) -> int:
    """Shared memory of the larger of the two float32 attention-backward
    blocks: all tokens' K and V (or q and do), rows padded by one float, the
    tile's two head-dim rows and its two tokens-wide float32 rows."""
    t, ld = ATTN_TILE, head_dim + 1
    return 4 * (2 * tokens * ld + 2 * t * ld + 2 * t * tokens)


def check_train_shapes(N: int, D: int, hidden: int, heads: int, dtype=torch.float32) -> None:
    """The forward's attention rule (:func:`check_attention_shape`); at bf16
    the attention backward takes the same shapes, in float32 its blocks must
    fit shared memory; the GEMMs take dims that are multiples of 8."""
    check_attention_shape(N, D, heads, dtype)
    if dtype != torch.bfloat16:
        smem = attention_backward_smem_bytes(N, D // heads)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{N} tokens x head dim {D // heads} needs {smem} B of shared "
                             f"memory in the attention backward, more than {SMEM_LIMIT}")
    if D % 8 or hidden % 8:
        raise ValueError(f"dims {D}, {hidden} must be multiples of 8")


def attention_backward_cuda(qkv, do, B, N, heads):
    """(B*N, 3D) qkv and (B*N, D) do -> o (B*N, D) and float32 dqkv (B*N, 3D)."""
    D = do.shape[1]
    dev, dt = qkv.device, qkv.dtype
    check_attention_shape(N, D, heads, dt)
    o = torch.empty((B * N, D), dtype=dt, device=dev)
    dqkv = torch.empty((B * N, 3 * D), dtype=torch.float32, device=dev)
    stats = torch.empty((B * heads * 3 * N,), dtype=torch.float32, device=dev)
    hd = D // heads
    kernels.call(KERNEL, "evt_attn_backward", dev, qkv.data_ptr(), do.data_ptr(), o.data_ptr(),
                 dqkv.data_ptr(), stats.data_ptr(), B, N, D, heads, q_scale(hd, dt),
                 hd ** -0.5, int(dt == torch.bfloat16))
    return o, dqkv


def _check(x, keep, w: BlockWeights, num_heads: int = 0):
    kernels.require_cuda(x, keep, *w)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tokens must be float32 or bfloat16, got {dt}")
    bad = [t.dtype for t in w if t.dtype != dt]
    if bad:
        raise ValueError(f"block weights must be {dt} like the tokens, got {bad[0]}")
    if not all(t.is_contiguous() for t in w):
        raise ValueError("block weights must be contiguous")
    B, N, D = x.shape
    if keep.shape != (B,):
        raise ValueError(f"keep must be ({B},), got {tuple(keep.shape)}")
    if num_heads:
        check_train_shapes(N, D, w.fc1_w.shape[0], num_heads, dt)
    return B, N, D, dt


def _saved_rows(t, B, N, C, dt, what):
    """A saved (B, N, C) tensor as contiguous (B*N, C) rows of ``dt``."""
    kernels.require_cuda(t)
    if t.shape != (B, N, C) or t.dtype != dt:
        raise ValueError(f"saved {what} must be ({B}, {N}, {C}) {dt}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return t.contiguous().reshape(B * N, C)


def train_forward_cuda(x, keep, w: BlockWeights, num_heads: int, eps: float,
                       save_qkv: bool = False, save_m: bool = False):
    B, N, D, dt = _check(x, keep, w, num_heads)
    xr = x.contiguous().reshape(B * N, D)
    dp = keep.float().contiguous()
    h = layernorm_cuda(xr, w.ln1_w, w.ln1_b, eps, dt)
    qkv = gemm_nt(h, w.qkv_w, TE_NONE, bias=w.qkv_b)[0]
    o = attention_cuda(qkv, B, N, num_heads)
    x1 = gemm_nt(o, w.proj_w, TE_DP_RES, bias=w.proj_b, res=xr, dp=dp, tokens=N)[0]
    h2 = layernorm_cuda(x1, w.ln2_w, w.ln2_b, eps, dt)
    g, m = gemm_nt(h2, w.fc1_w, TE_GELU_SAVE_T if save_m else TE_GELU, bias=w.fc1_b)
    out = gemm_nt(g, w.fc2_w, TE_DP_RES, bias=w.fc2_b, res=x1, dp=dp, tokens=N)[0]
    kernels.count_launch(FWD)
    return (out.reshape(B, N, D), x1.reshape(B, N, D),
            qkv.reshape(B, N, 3 * D) if save_qkv else None,
            m.reshape(B, N, -1) if save_m else None)


def _mlp_rows(x1, dout, keep, w: BlockWeights):
    B, N, D, dt = _check(x1, keep, w)
    kernels.require_cuda(dout)
    return (B, N, dt, x1.contiguous().reshape(B * N, D),
            dout.to(dt).contiguous().reshape(B * N, D), keep.float().contiguous())


def _mlp_dx_launches(x1, dout, keep, w: BlockWeights, eps: float, m=None):
    """The launches of the MLP backward up to dx1, shared by K6a and K6b
    (their ``_ms`` flavors with the saved ``m``): -> (dx1 rows, h2, dm2c,
    dm1c, g, db1, db2, dln2_w, dln2_b)."""
    B, N, dt, x1r, doutr, dp = _mlp_rows(x1, dout, keep, w)
    h2 = layernorm_cuda(x1r, w.ln2_w, w.ln2_b, eps, dt)
    if m is None:
        g, mf = gemm_nt(h2, w.fc1_w, TE_GELU_SAVE, bias=w.fc1_b)
        dm2c, db2 = colsum_cuda(doutr, dt, dp, N)
        dm1 = gemm_nn(dm2c, w.fc2_w, TE_GELU_GRAD, aux=mf)[1]
        del mf
    else:
        # the NN GEMM's epilogue reads the saved m once for gelu'(m) and g
        m = _saved_rows(m, B, N, w.fc1_w.shape[0], dt, "m")
        dm2c, db2 = colsum_cuda(doutr, dt, dp, N)
        g, dm1 = gemm_nn(dm2c, w.fc2_w, TE_GELU_GRAD_MS, aux=m)
    dm1c, db1 = colsum_cuda(dm1, dt)
    del dm1
    dh2 = gemm_nn(dm1c, w.fc1_w, TE_F32)[1]
    dx1, dln_w, dln_b = ln_backward_cuda(x1r, w.ln2_w, dh2, doutr, eps)
    return dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b


def mlp_backward_cuda(x1, dout, keep, w: BlockWeights, eps: float, m=None):
    dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b = _mlp_dx_launches(x1, dout, keep, w, eps, m)
    dW1, dW2 = gemm_tn2(dm1c, h2, dm2c, g)
    kernels.count_launch(BWD_MLP if m is None else BWD_MLP_MS)
    return dx1.reshape(x1.shape), (dW1, db1, dW2, db2, dln_w, dln_b)


def mlp_backward_dx_save_cuda(x1, dout, keep, w: BlockWeights, eps: float, m=None):
    dx1, *rest = _mlp_dx_launches(x1, dout, keep, w, eps, m)
    kernels.count_launch(BWD_MLP_DX_SAVE if m is None else BWD_MLP_DX_SAVE_MS)
    return (dx1.reshape(x1.shape), *rest)


def mlp_backward_dw_saved_cuda(h2, dm2c, dm1c, g):
    R, D = h2.shape
    H = g.shape[1]
    if dm2c.shape != (R, D) or dm1c.shape != (R, H) or g.shape != (R, H):
        raise ValueError(f"saved operands {[tuple(t.shape) for t in (h2, dm2c, dm1c, g)]}")
    dW1, dW2 = gemm_tn2(dm1c, h2, dm2c, g)
    kernels.count_launch(BWD_MLP_DW_SAVED)
    return dW1, dW2


def mlp_backward_dx_cuda(x1, dout, keep, w: BlockWeights, eps: float):
    """K6d: K6b's launches keeping nothing: fc1 writes m alone, and the NN
    GEMM's epilogue rounds dm1 itself (no column sum, so no db1)."""
    B, N, dt, x1r, doutr, dp = _mlp_rows(x1, dout, keep, w)
    h2 = layernorm_cuda(x1r, w.ln2_w, w.ln2_b, eps, dt)
    mf = gemm_nt(h2, w.fc1_w, TE_F32, bias=w.fc1_b)[1]
    del h2
    dm2c, db2 = colsum_cuda(doutr, dt, dp, N)
    dm1c = gemm_nn(dm2c, w.fc2_w, TE_GELU_GRAD_T, aux=mf)[0]
    del mf, dm2c
    dh2 = gemm_nn(dm1c, w.fc1_w, TE_F32)[1]
    dx1, dln_w, dln_b = ln_backward_cuda(x1r, w.ln2_w, dh2, doutr, eps)
    kernels.count_launch(BWD_MLP_DX)
    return dx1.reshape(x1.shape), db2, dln_w, dln_b


def mlp_backward_dw_cuda(x1, dout, keep, w: BlockWeights, eps: float):
    """K6e: K6b's launches up to dm1c (dm2c without its column sums), then
    K6c's pair launch."""
    B, N, dt, x1r, doutr, dp = _mlp_rows(x1, dout, keep, w)
    h2 = layernorm_cuda(x1r, w.ln2_w, w.ln2_b, eps, dt)
    g, mf = gemm_nt(h2, w.fc1_w, TE_GELU_SAVE, bias=w.fc1_b)
    dm2c = colsum_cuda(doutr, dt, dp, N, sums=False)[0]
    dm1 = gemm_nn(dm2c, w.fc2_w, TE_GELU_GRAD, aux=mf)[1]
    del mf
    dm1c, db1 = colsum_cuda(dm1, dt)
    del dm1
    dW1, dW2 = gemm_tn2(dm1c, h2, dm2c, g)
    kernels.count_launch(BWD_MLP_DW)
    return dW1, db1, dW2


def attn_backward_cuda(x, dx1, keep, w: BlockWeights, num_heads: int, eps: float, qkv=None):
    B, N, D, dt = _check(x, keep, w, num_heads)
    kernels.require_cuda(dx1)
    xr = x.contiguous().reshape(B * N, D)
    dx1r = dx1.contiguous().reshape(B * N, D)
    dp = keep.float().contiguous()
    h1 = layernorm_cuda(xr, w.ln1_w, w.ln1_b, eps, dt)
    saved = qkv is not None
    if saved:
        qkv = _saved_rows(qkv, B, N, 3 * D, dt, "qkv")
    else:
        qkv = gemm_nt(h1, w.qkv_w, TE_NONE, bias=w.qkv_b)[0]
    dac, dbp = colsum_cuda(dx1r, dt, dp, N)
    do = gemm_nn(dac, w.proj_w, TE_NONE)[0]
    o, dqkv = attention_backward_cuda(qkv, do, B, N, num_heads)
    dqkvc, dbqkv = colsum_cuda(dqkv, dt)
    dh1 = gemm_nn(dqkvc, w.qkv_w, TE_F32)[1]
    dx, dln_w, dln_b = ln_backward_cuda(xr, w.ln1_w, dh1, dx1r, eps)
    dWqkv, dWp = gemm_tn2(dqkvc, h1, dac, o)
    kernels.count_launch(BWD_ATTN_SAVED if saved else BWD_ATTN)
    return dx.reshape(B, N, D), (dWqkv, dbqkv, dWp, dbp, dln_w, dln_b)


# ----------------------------------------------------------------- wrappers
def train_forward(x, keep, w: BlockWeights, num_heads: int, eps: float, plain: bool = False,
                  save_qkv: bool = False, save_m: bool = False):
    """K5: (B, N, D) tokens, (B,) float32 keep -> (out, x1, qkv or None, m
    or None), qkv and m (B, N, 3D) and (B, N, hidden) in the working dtype
    where ``save_qkv`` / ``save_m``.  CPU tokens (or ``plain``) take the
    plain version; CUDA tokens launch the kernels."""
    if plain or x.device.type == "cpu":
        return train_forward_plain(x, keep, w, num_heads, eps, save_qkv, save_m)
    return train_forward_cuda(x, keep, w, num_heads, eps, save_qkv, save_m)


def mlp_backward(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False, m=None):
    """K6a, or K6a ``_ms`` given the saved (B, N, hidden) ``m``: -> (dx1,
    (dW1, db1, dW2, db2, dln2_w, dln2_b))."""
    if plain or x1.device.type == "cpu":
        return mlp_backward_plain(x1, dout, keep, w, eps, m)
    return mlp_backward_cuda(x1, dout, keep, w, eps, m)


def attn_backward(x, dx1, keep, w: BlockWeights, num_heads: int, eps: float,
                  plain: bool = False, qkv=None):
    """K7, or K7 ``_saved`` given the forward's (B, N, 3D) ``qkv``: -> (dx,
    (dWqkv, dbqkv, dWp, dbp, dln1_w, dln1_b))."""
    if plain or x.device.type == "cpu":
        return attn_backward_plain(x, dx1, keep, w, num_heads, eps, qkv)
    return attn_backward_cuda(x, dx1, keep, w, num_heads, eps, qkv)


def mlp_backward_dx_save(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False,
                         m=None):
    """K6b, or K6b ``_ms`` given the saved ``m``: -> (dx1, h2, dm2c, dm1c,
    g, db1, db2, dln2_w, dln2_b)."""
    if plain or x1.device.type == "cpu":
        return mlp_backward_dx_save_plain(x1, dout, keep, w, eps, m)
    return mlp_backward_dx_save_cuda(x1, dout, keep, w, eps, m)


def mlp_backward_dw_saved(h2, dm2c, dm1c, g, plain: bool = False):
    """K6c: the saved operands -> (dW1, dW2)."""
    if plain or h2.device.type == "cpu":
        return mlp_backward_dw_saved_plain(h2, dm2c, dm1c, g)
    return mlp_backward_dw_saved_cuda(h2, dm2c, dm1c, g)


def mlp_backward_dx(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False):
    """K6d: -> (dx1, db2, dln2_w, dln2_b)."""
    if plain or x1.device.type == "cpu":
        return mlp_backward_dx_plain(x1, dout, keep, w, eps)
    return mlp_backward_dx_cuda(x1, dout, keep, w, eps)


def mlp_backward_dw(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False):
    """K6e: -> (dW1, db1, dW2)."""
    if plain or x1.device.type == "cpu":
        return mlp_backward_dw_plain(x1, dout, keep, w, eps)
    return mlp_backward_dw_cuda(x1, dout, keep, w, eps)


def wide_mlp_backward(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False,
                      m=None):
    """K6b (``_ms`` given ``m``) then K6c, with K6a's signature: -> (dx1,
    (dW1, db1, dW2, db2, dln2_w, dln2_b))."""
    dx1, h2, dm2c, dm1c, g, db1, db2, dln_w, dln_b = mlp_backward_dx_save(
        x1, dout, keep, w, eps, plain, m)
    dW1, dW2 = mlp_backward_dw_saved(h2, dm2c, dm1c, g, plain)
    return dx1, (dW1, db1, dW2, db2, dln_w, dln_b)


def wide_mlp_backward_recompute(x1, dout, keep, w: BlockWeights, eps: float,
                                plain: bool = False):
    """K6d then K6e, with K6a's signature."""
    dx1, db2, dln_w, dln_b = mlp_backward_dx(x1, dout, keep, w, eps, plain)
    dW1, db1, dW2 = mlp_backward_dw(x1, dout, keep, w, eps, plain)
    return dx1, (dW1, db1, dW2, db2, dln_w, dln_b)


def block_mlp_backward(x1, dout, keep, w: BlockWeights, eps: float, plain: bool = False,
                       m=None, wide_saved: bool = True):
    """The MLP backward that ``_mlp_backward_padded`` picks: K6a where it
    is narrow, else K6b then K6c (``wide_saved``) or K6d then K6e; ``m``,
    the saved pre-GELU activation, selects the ``_ms`` flavor of the first
    two (the recompute pair has none)."""
    if mlp_chunks(x1.shape[-1], w.fc1_w.shape[0]) == 1:
        return mlp_backward(x1, dout, keep, w, eps, plain, m)
    if wide_saved:
        return wide_mlp_backward(x1, dout, keep, w, eps, plain, m)
    if m is not None:
        raise ValueError("the wide recompute MLP backward takes no saved m")
    return wide_mlp_backward_recompute(x1, dout, keep, w, eps, plain)


class FusedBlockTrain(torch.autograd.Function):
    """``FusedBlockTrain.apply(x, keep, num_heads, eps, plain, *weights)``:
    the training block with the forward of K5 and the backward of the
    flavor the switches pick (:func:`saved_flags`, :func:`block_mlp_backward`),
    then K7 or K7 ``_saved``; ``weights`` in :class:`..models.vit.BlockWeights`
    order.  The switches are read once, in the forward."""

    @staticmethod
    def forward(ctx, x, keep, num_heads, eps, plain, *weights):
        w = BlockWeights(*weights)
        save_qkv, save_m = saved_flags(x.shape[-1])
        out, x1, qkv, m = train_forward(x, keep, w, num_heads, eps, plain, save_qkv, save_m)
        ctx.save_for_backward(x, x1, keep, qkv, m, *weights)
        ctx.num_heads, ctx.eps, ctx.plain = num_heads, eps, plain
        ctx.wide_saved = _wide_saved()
        return out

    @staticmethod
    def backward(ctx, dout):
        x, x1, keep, qkv, m, *weights = ctx.saved_tensors
        w = BlockWeights(*weights)
        dx1, (dW1, db1, dW2, db2, dln2_w, dln2_b) = block_mlp_backward(
            x1, dout.contiguous(), keep, w, ctx.eps, ctx.plain, m, ctx.wide_saved)
        dx, (dWqkv, dbqkv, dWp, dbp, dln1_w, dln1_b) = attn_backward(
            x, dx1, keep, w, ctx.num_heads, ctx.eps, ctx.plain, qkv)
        grads = BlockWeights(dln1_w, dln1_b, dWqkv, dbqkv, dWp, dbp, dln2_w, dln2_b,
                             dW1, db1, dW2, db2)
        return (dx, None, None, None, None, *grads)


def fused_block_train(x, keep, w: BlockWeights, num_heads: int, eps: float,
                      plain: bool = False) -> torch.Tensor:
    """The differentiable training block (see :class:`FusedBlockTrain`)."""
    return FusedBlockTrain.apply(x, keep, num_heads, eps, plain, *w)
