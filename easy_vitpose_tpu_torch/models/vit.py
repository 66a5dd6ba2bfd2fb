"""ViTPose backbone (serving), in PyTorch.

Port of ``easy_vitpose_tpu/models/vit.py``.  The modules are keyed by the
reference's state-dict names (``backbone.blocks.{i}.attn.qkv.weight``, ...),
so a reference checkpoint loads with ``load_state_dict``; they hold the
parameters, and the functions below compute with them.  Linear weights keep
torch's (out, in) layout, which is the K-contiguous operand the GEMM
kernels read.

The plain functions here (``layer_norm``, ``attention``, ``mlp``, ``block``)
are the plain version of the fused block kernel (``models/fused_block.py``):
float32 LayerNorm statistics, float32 accumulation, float32 logits, the
Abramowitz-Stegun erf in the GELU, and rounding to the working dtype at the
points where the TPU kernel rounds (LN output, qkv, q*scale, probs, the
attention output, the GELU output and each residual add).

Reference quirks kept: the patch conv's padding=2 with a crop to a multiple
of the patch, and the position embedding applied as ``pe[:, 1:] + pe[:, :1]``.

Training (port of ``vit.py:110-259``) is functional over a mapping from the
state-dict names to tensors, so that a step can hand in bf16 casts of the
float32 master weights that gradients flow through:
:func:`vit_forward_train` with per-layer drop-path masks
(:func:`draw_drop_path_masks`) runs each block through the training block
(``models/fused_block_train.py``, the kernels' path) or through
:func:`block_train`, the JAX package's XLA block under autograd.
"""
from __future__ import annotations

import functools
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs import BackboneConfig


# ------------------------------------------------------------------ modules
class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        D = cfg.embed_dim
        self.eps = cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.attn = Attention(D, cfg.num_heads, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        self.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                              stride=cfg.patch_size, padding=cfg.patch_padding)


class ViT(nn.Module):
    def __init__(self, cfg: BackboneConfig):
        super().__init__()
        if cfg.stem_channels:
            raise NotImplementedError("the hybrid CNN stem is not ported yet (ROADMAP A12)")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens + 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.layer_norm_eps)


BLOCK_PARAMS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
                "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
                "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


class BlockWeights(NamedTuple):
    """One block's tensors in the order of :data:`BLOCK_PARAMS`."""
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


def block_weights(params: Mapping[str, torch.Tensor], prefix: str) -> BlockWeights:
    """The block at ``prefix`` (e.g. ``backbone.blocks.3``) of a state-dict
    mapping; ``block_weights(dict(blk.named_parameters()), "")`` for a
    :class:`Block`."""
    dot = f"{prefix}." if prefix else ""
    return BlockWeights(*(params[dot + n] for n in BLOCK_PARAMS))


# ---------------------------------------------------------------- functions
def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last dim with float32 statistics; the result is
    cast to ``out_dtype`` (default: the dtype of ``x``)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype if out_dtype is None else out_dtype)


def linear_f32(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``h @ weight.T + bias`` accumulated and returned in float32."""
    return torch.matmul(h.float(), weight.float().t()) + bias.float()


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 erf (max abs error 1.5e-7), the erf of the
    TPU kernels and of the CUDA kernels."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """torch's exact-erf GELU, through :func:`erf_as`."""
    return 0.5 * x * (1.0 + erf_as(x * 0.7071067811865476))


def patch_embed(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                patch: int, pad: int) -> torch.Tensor:
    """(B, H, W, C) NHWC image -> (B, Hp*Wp, D) tokens, as pad + unfold +
    matmul; ``weight`` is the conv's (D, C, P, P)."""
    B, H, W, C = x.shape
    x = F.pad(x, (0, 0, pad, pad, pad, pad))
    Hp = (H + 2 * pad - patch) // patch + 1
    Wp = (W + 2 * pad - patch) // patch + 1
    x = x[:, :Hp * patch, :Wp * patch, :]     # stride == kernel after the crop
    x = x.reshape(B, Hp, patch, Wp, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B * Hp * Wp, patch * patch * C)
    w = weight.permute(2, 3, 1, 0).reshape(patch * patch * C, -1).to(x.dtype)
    return torch.addmm(bias.to(x.dtype), x, w).reshape(B, Hp * Wp, -1)


def q_scale(head_dim: int, dtype: torch.dtype) -> float:
    """The softmax scale ``head_dim ** -0.5`` as JAX multiplies q by it: a
    Python float meeting a ``dtype`` array is first rounded to ``dtype``
    (bf16 at head_dim 32 or 80, where the scale is not exact in bf16)."""
    return float(torch.tensor(head_dim ** -0.5, dtype=dtype))


def attention_core(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, 3D) fused qkv -> (B, N, D) per-head softmax(q k^T / sqrt(d)) v
    with float32 logits; q*scale (the scale in the dtype of ``qkv``), the
    probs and the output are rounded to the dtype of ``qkv``."""
    dt = qkv.dtype
    B, N, D3 = qkv.shape
    D = D3 // 3
    hd = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * q_scale(hd, dt)).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(dt)
    o = torch.matmul(probs.float(), v.float()).to(dt)          # (B, h, N, hd)
    return o.transpose(1, 2).reshape(B, N, D)


def attention(h: torch.Tensor, attn: Attention) -> torch.Tensor:
    """Fused-QKV multi-head self-attention with its output projection."""
    dt = h.dtype
    qkv = linear_f32(h, attn.qkv.weight, attn.qkv.bias).to(dt)
    o = attention_core(qkv, attn.num_heads)
    return linear_f32(o, attn.proj.weight, attn.proj.bias).to(dt)


def mlp(h: torch.Tensor, m: Mlp) -> torch.Tensor:
    dt = h.dtype
    a = gelu(linear_f32(h, m.fc1.weight, m.fc1.bias)).to(dt)
    return linear_f32(a, m.fc2.weight, m.fc2.bias).to(dt)


def block(x: torch.Tensor, blk: Block) -> torch.Tensor:
    """Pre-LN transformer block on (B, N, D) tokens; the plain version of
    the fused block kernel."""
    x = x + attention(layer_norm(x, blk.norm1.weight, blk.norm1.bias, blk.eps), blk.attn)
    return x + mlp(layer_norm(x, blk.norm2.weight, blk.norm2.bias, blk.eps), blk.mlp)


def vit_forward(vit: ViT, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """(B, H, W, 3) normalized NHWC crops -> (B, Hp, Wp, D) features.

    Each block goes through its kernel's wrapper: the fused block for float
    weights, the int8 block for blocks made by ``quantize_vit_params``.
    ``plain=True`` calls the wrappers' plain versions instead, on any
    device: the reference the kernels are held to.
    """
    from .fused_block import fused_block
    from .quant import QBlock, block_q8, fused_block_q8

    cfg = vit.cfg
    tokens = patch_embed(x, vit.patch_embed.proj.weight, vit.patch_embed.proj.bias,
                         cfg.patch_size, cfg.patch_padding)
    pe = vit.pos_embed
    tokens = tokens + (pe[:, 1:] + pe[:, :1]).to(tokens.dtype)
    for blk in vit.blocks:
        if isinstance(blk, QBlock):
            tokens = (block_q8 if plain else fused_block_q8)(tokens, blk)
        else:
            tokens = (block if plain else fused_block)(tokens, blk)
    tokens = layer_norm(tokens, vit.last_norm.weight, vit.last_norm.bias,
                        cfg.layer_norm_eps)
    Hp, Wp = cfg.patch_shape
    return tokens.reshape(x.shape[0], Hp, Wp, cfg.embed_dim)


# ----------------------------------------------------------------- training
@functools.lru_cache(maxsize=None)
def _keep_probs(depth: int, rate: float, device: torch.device) -> torch.Tensor:
    """(depth, 1, 1, 1) float32 ``1 - linspace(0, rate, depth)``, made once
    per device (a CUDA tensor built from host data makes the host wait for
    the card).  Callers must not write to it."""
    dpr = np.linspace(0.0, rate, depth).astype(np.float32)
    return (1.0 - torch.from_numpy(dpr)).reshape(-1, 1, 1, 1).to(device)


def draw_drop_path_masks(cfg: BackboneConfig, batch: int, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """Per-layer stochastic-depth keep masks pre-scaled by 1/keep_prob,
    (depth, B, 1, 1) float32: ``floor(kp + U) / kp`` with
    ``kp = 1 - linspace(0, drop_path_rate, depth)`` and U uniform from
    ``generator``.  The draws are not JAX's (another generator); the tests
    hand JAX's masks to :func:`vit_forward_train` instead."""
    kp = _keep_probs(cfg.depth, cfg.drop_path_rate, torch.device(device or "cpu"))
    u = torch.rand((cfg.depth, batch, 1, 1), generator=generator,
                   device=generator.device).to(device)
    return torch.floor(kp + u) / kp


def block_train(x: torch.Tensor, w: BlockWeights, num_heads: int, eps: float,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's XLA training block (``vit.py::block``) under
    autograd: bf16 logits, the exact-erf GELU, each branch rounded to the
    working dtype, times the (B, 1, 1) float32 keep mask, rounded again and
    added.  The tests' second reference; the step's path is the training
    block of ``models/fused_block_train.py``."""
    dt = x.dtype
    B, N, D = x.shape
    hd = D // num_heads
    h = layer_norm(x, w.ln1_w, w.ln1_b, eps)
    qkv = linear_f32(h, w.qkv_w, w.qkv_b).to(dt)
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * q_scale(hd, dt)).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(dt)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    o = torch.matmul(probs.float(), v.float()).to(dt).transpose(1, 2).reshape(B, N, D)
    a = linear_f32(o, w.proj_w, w.proj_b).to(dt)
    if keep is not None:
        a = (a.float() * keep).to(dt)
    x = x + a
    h = layer_norm(x, w.ln2_w, w.ln2_b, eps)
    m = F.gelu(linear_f32(h, w.fc1_w, w.fc1_b)).to(dt)
    m = linear_f32(m, w.fc2_w, w.fc2_b).to(dt)
    if keep is not None:
        m = (m.float() * keep).to(dt)
    return x + m


def vit_forward_train(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: BackboneConfig,
                      *, drop_path_masks: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      block_impl: str = "fused_train", plain: bool = False) -> torch.Tensor:
    """Training forward of the backbone over ``params`` (state-dict names,
    ``backbone.*``): (B, H, W, 3) normalized NHWC crops -> (B, Hp, Wp, D).

    Drop-path runs when ``cfg.drop_path_rate > 0``: masks are drawn from
    ``generator``, unless pre-drawn (depth, B, 1, 1) ``drop_path_masks`` are
    given, which then always apply (as ``vit.py:194-198``).
    ``block_impl``: "fused_train" (the training block: K5, K6a, K7 on the
    card; ``plain=True`` takes their plain versions on any device) or "xla"
    (:func:`block_train`).
    """
    from .fused_block_train import fused_block_train

    if block_impl not in ("fused_train", "xla"):
        raise ValueError(f"block_impl must be 'fused_train' or 'xla', got {block_impl!r}")
    B = x.shape[0]
    tokens = patch_embed(x, params["backbone.patch_embed.proj.weight"],
                         params["backbone.patch_embed.proj.bias"],
                         cfg.patch_size, cfg.patch_padding)
    pe = params["backbone.pos_embed"]
    tokens = tokens + (pe[:, 1:] + pe[:, :1]).to(tokens.dtype)
    masks = drop_path_masks
    if masks is None and cfg.drop_path_rate > 0.0:
        if generator is None:
            raise ValueError("drop-path needs a torch.Generator (or drop_path_masks)")
        masks = draw_drop_path_masks(cfg, B, generator, x.device)
    for i in range(cfg.depth):
        w = block_weights(params, f"backbone.blocks.{i}")
        keep = None if masks is None else masks[i].reshape(B).float()
        if block_impl == "xla":
            tokens = block_train(tokens, w, cfg.num_heads, cfg.layer_norm_eps,
                                 None if keep is None else keep[:, None, None])
        else:
            if keep is None:
                keep = torch.ones((B,), dtype=torch.float32, device=x.device)
            tokens = fused_block_train(tokens, keep, w, cfg.num_heads, cfg.layer_norm_eps, plain)
    tokens = layer_norm(tokens, params["backbone.last_norm.weight"],
                        params["backbone.last_norm.bias"], cfg.layer_norm_eps)
    Hp, Wp = cfg.patch_shape
    return tokens.reshape(B, Hp, Wp, cfg.embed_dim)
