"""The live ViTPose+ multi-task model, in PyTorch.

Port of ``easy_vitpose_tpu/models/moe.py``.  A ViTPose+ checkpoint is a
part-shared-FFN model: each block's down-projection has a shared slice and
one expert slice per dataset, and there are six decode heads.  The weights
here are a mapping by the reference checkpoint's names (float32 on the CPU
from :func:`init_vitpose_plus_params`; on the card at a serving dtype from
:func:`plus_params`):

* ``backbone.*`` as a single-task ViT, except that
  ``backbone.blocks.{i}.mlp.fc2.*`` is the shared slice, (D_shared, hidden),
  and ``backbone.blocks.{i}.mlp.experts.{e}.*`` are the expert slices,
  (D_exp, hidden), in the reference's dataset order
  (``convert/model_split.py::SPLIT_DATASETS``);
* ``keypoint_head.*`` is the coco head and ``associate_keypoint_heads.{j}.*``
  the head of dataset j + 1, its final layer cut to the dataset's K.

The forwards:

* a task-homogeneous batch splices the task's expert rows onto the shared
  fc2 of each layer (:func:`spliced_block`): each output column is the same
  sum as JAX's separate expert product, so the splice equals JAX's
  selection column for column (what ``select_task`` and ``VitInference(task=)``
  rest on).  Serving runs the spliced blocks through the block kernel (K1,
  ``fused_block_weights``; at float32 with the TF32 halves of the spliced
  weights, split anew each call: four split launches a block) on the card
  and its plain version on the CPU;
  ``plain=True`` runs :func:`moe_block`, JAX's XLA block, on any device;
* a mixed batch (``expert_onehot``, (B, E) weights) computes every expert
  and mixes them per sample in float32, as JAX's two einsums do
  (``moe.py:59-66``); that is XLA code outside any Pallas kernel in JAX,
  and plain torch matmuls here on every device;
* training (:func:`vitpose_plus_forward_train`) splices the task's fc2 with
  ``torch.cat`` outside the block and runs the training block (K5, the MLP
  backward of its flavor, K7) with no drop-path; autograd returns the fc2
  gradient to the shared slice and to the active expert only, and the other
  experts and heads are not in the graph at all.  ``block_impl="xla"`` runs
  :func:`moe_block` under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import ModelConfig
from ..convert.model_split import SPLIT_DATASETS
from .head import head_forward_params, head_forward_train
from .vit import (BLOCK_PARAMS, BlockWeights, attention_train, embed, layer_norm,
                  linear_f32)

Tensors = Dict[str, torch.Tensor]
TRAIN_BLOCK_IMPLS = ("pallas_train", "pallas_train_interpret", "xla")


def head_prefix(task: str) -> str:
    """The state-dict prefix of ``task``'s head."""
    ei = SPLIT_DATASETS.index(task)
    return "keypoint_head" if ei == 0 else f"associate_keypoint_heads.{ei - 1}"


def num_experts(params: Mapping[str, torch.Tensor]) -> int:
    n = 0
    while f"backbone.blocks.0.mlp.experts.{n}.weight" in params:
        n += 1
    return n


def plus_tasks(params: Mapping[str, torch.Tensor]) -> list:
    """The tasks whose heads ``params`` holds, in the reference's order."""
    return [t for t in SPLIT_DATASETS if f"{head_prefix(t)}.final_layer.weight" in params]


def task_head_config(cfg: ModelConfig, params: Mapping[str, torch.Tensor], task: str):
    """``cfg.head`` with the K of ``task``'s head."""
    k = params[f"{head_prefix(task)}.final_layer.weight"].shape[0]
    return dataclasses.replace(cfg.head, num_keypoints=k)


def spliced_block(params: Mapping[str, torch.Tensor], i: int, expert: int) -> BlockWeights:
    """Block ``i`` as a single-task block: the shared fc2 rows with expert
    ``expert``'s rows under them (``torch.cat``, differentiable)."""
    p = f"backbone.blocks.{i}"
    w = [params[f"{p}.{n}"] for n in BLOCK_PARAMS[:-2]]
    e = f"{p}.mlp.experts.{expert}"
    return BlockWeights(*w, torch.cat([params[f"{p}.mlp.fc2.weight"], params[f"{e}.weight"]], 0),
                        torch.cat([params[f"{p}.mlp.fc2.bias"], params[f"{e}.bias"]], 0))


def moe_mlp(x: torch.Tensor, params: Mapping[str, torch.Tensor], prefix: str,
            expert_idx: Optional[int] = None,
            expert_onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The part-shared FFN of the block at ``prefix``: ``[h @ fc2_shared |
    h @ expert]`` (+ biases), each half rounded to the working dtype, with
    the exact-erf GELU (JAX's ``moe_mlp``).  Exactly one of ``expert_idx``
    (a task-homogeneous batch) or ``expert_onehot`` ((B, E) per-sample
    weights) is given."""
    dt = x.dtype
    h = F.gelu(linear_f32(x, params[f"{prefix}.mlp.fc1.weight"],
                          params[f"{prefix}.mlp.fc1.bias"])).to(dt)
    shared = linear_f32(h, params[f"{prefix}.mlp.fc2.weight"],
                        params[f"{prefix}.mlp.fc2.bias"]).to(dt)
    if expert_idx is not None:
        e = f"{prefix}.mlp.experts.{expert_idx}"
        exp = linear_f32(h, params[f"{e}.weight"], params[f"{e}.bias"]).to(dt)
    else:
        if expert_onehot is None:
            raise ValueError("moe_mlp needs expert_idx or expert_onehot")
        n = expert_onehot.shape[1]
        ws = torch.stack([params[f"{prefix}.mlp.experts.{e}.weight"] for e in range(n)]).float()
        bs = torch.stack([params[f"{prefix}.mlp.experts.{e}.bias"] for e in range(n)]).float()
        one = expert_onehot.float()
        all_e = torch.einsum("bnh,edh->bned", h.float(), ws)    # every expert, then the mix
        exp = (torch.einsum("bned,be->bnd", all_e, one)
               + torch.einsum("ed,be->bd", bs, one)[:, None, :]).to(dt)
    return torch.cat([shared, exp], dim=-1)


def moe_block(x: torch.Tensor, params: Mapping[str, torch.Tensor], i: int, num_heads: int,
              eps: float, expert_idx: Optional[int] = None,
              expert_onehot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block ``i``: JAX's XLA ``moe_block`` (the attention of
    :func:`..models.vit.block_train`, then :func:`moe_mlp`)."""
    p = f"backbone.blocks.{i}"
    w = BlockWeights(*(params[f"{p}.{n}"] for n in BLOCK_PARAMS))
    x = x + attention_train(x, w, num_heads, eps)
    h = layer_norm(x, w.ln2_w, w.ln2_b, eps)
    return x + moe_mlp(h, params, p, expert_idx=expert_idx, expert_onehot=expert_onehot)


def vit_plus_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                     expert_idx: Optional[int] = None,
                     expert_onehot: Optional[torch.Tensor] = None, *,
                     plain: bool = False) -> torch.Tensor:
    """The MoE backbone for serving: (B, H, W, 3) -> (B, Hp, Wp, D)."""
    from .fused_block import fused_block_weights, split_weights

    bb = cfg.backbone
    tokens = embed(params, x, bb, "backbone")
    for i in range(bb.depth):
        if expert_onehot is not None or plain:
            tokens = moe_block(tokens, params, i, bb.num_heads, bb.layer_norm_eps,
                               expert_idx=None if expert_onehot is not None else expert_idx,
                               expert_onehot=expert_onehot)
        else:
            w = spliced_block(params, i, expert_idx)
            # float32 on the card: the spliced weights' TF32 halves, made each call
            splits = split_weights(w) if tokens.dtype == torch.float32 and tokens.is_cuda else None
            tokens = fused_block_weights(tokens, w, bb.num_heads, bb.layer_norm_eps, splits)
    tokens = layer_norm(tokens, params["backbone.last_norm.weight"],
                        params["backbone.last_norm.bias"], bb.layer_norm_eps)
    Hp, Wp = bb.patch_shape
    return tokens.reshape(x.shape[0], Hp, Wp, bb.embed_dim)


def vitpose_plus_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                         cfg: ModelConfig, task: str,
                         expert_onehot: Optional[torch.Tensor] = None, *,
                         plain: bool = False) -> torch.Tensor:
    """The multi-task serving forward: (B, 256, 192, 3) normalized NHWC
    crops -> (B, K_task, 64, 48) heatmaps from ``task``'s head, with eval
    BatchNorm.  Without ``expert_onehot`` the FFN takes ``task``'s expert
    (the block kernel on the card; ``plain=True`` :func:`moe_block`); with
    it, the mixed batch."""
    ei = SPLIT_DATASETS.index(task)
    feats = vit_plus_forward(params, x, cfg, expert_idx=ei, expert_onehot=expert_onehot,
                             plain=plain)
    heat = head_forward_params(params, feats.permute(0, 3, 1, 2),
                               task_head_config(cfg, params, task), head_prefix(task))
    return heat.contiguous()


def vitpose_plus_forward_train(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                               cfg: ModelConfig, task: str, block_impl: str = "pallas_train",
                               plain: bool = False, group=None):
    """The training forward of one task over ``params`` (the head's BN
    running statistics included): -> ((B, K, 64, 48) heatmaps, the new BN
    running statistics of ``task``'s head by name).  ``block_impl``:
    "pallas_train" (the training block: K5-K7 on the card, their plain
    versions on the CPU or with ``plain=True``), "pallas_train_interpret"
    (the plain versions on any device) or "xla" (:func:`moe_block` under
    autograd).  No drop-path: the MoE recipe has none.  ``group``: the
    head's global BatchNorm statistics over a data-parallel process group."""
    from .fused_block_train import fused_block_train

    if block_impl not in TRAIN_BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {TRAIN_BLOCK_IMPLS}, got {block_impl!r}")
    bb = cfg.backbone
    ei = SPLIT_DATASETS.index(task)
    B = x.shape[0]
    tokens = embed(params, x, bb, "backbone")
    if block_impl != "xla":
        keep = torch.ones((B,), dtype=torch.float32, device=x.device)
    for i in range(bb.depth):
        if block_impl == "xla":
            tokens = moe_block(tokens, params, i, bb.num_heads, bb.layer_norm_eps, expert_idx=ei)
        else:
            tokens = fused_block_train(tokens, keep, spliced_block(params, i, ei), bb.num_heads,
                                       bb.layer_norm_eps, plain or block_impl != "pallas_train")
    tokens = layer_norm(tokens, params["backbone.last_norm.weight"],
                        params["backbone.last_norm.bias"], bb.layer_norm_eps)
    Hp, Wp = bb.patch_shape
    feats = tokens.reshape(B, Hp, Wp, bb.embed_dim).permute(0, 3, 1, 2)
    return head_forward_train(params, feats, task_head_config(cfg, params, task),
                              head_prefix(task), group=group)


def plus_params(sd: Mapping, device=None, dtype: torch.dtype = torch.float32) -> Tensors:
    """A ViTPose+ state dict (the reference's names, a ``.pth``'s tensors or
    numpy arrays) -> the mapping the forwards take, on ``device`` (CUDA
    unless the caller passes ``device="cpu"``) with floating weights at
    ``dtype`` (the BN running statistics stay float32).  Each head's final
    layer is cut to its dataset's K, as the reference splitter does
    (model_split.py:100-102)."""
    from ..convert.model_split import SPLIT_NUM_KPTS
    from ..convert.vitpose_torch import normalize_state_dict
    from ..kernels import resolve_device

    dev = resolve_device(device)
    sd = normalize_state_dict({k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                               for k, v in sd.items()})
    out = {}
    for name, a in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(a))
        for task in SPLIT_DATASETS:
            if name.startswith(f"{head_prefix(task)}.final_layer."):
                t = t[:SPLIT_NUM_KPTS[task]]
        if t.is_floating_point():
            t = t.to(torch.float32 if name.endswith(("running_mean", "running_var")) else dtype)
        out[name] = t.to(dev)
    return out


def init_vitpose_plus_params(cfg: ModelConfig, seed: int,
                             tasks: Sequence[str] = ("coco", "aic"),
                             expert_frac: float = 0.25) -> Tensors:
    """A random float32 multi-task ViTPose+ mapping on the CPU, drawn with
    numpy from ``seed`` by the rules of :func:`..models.vitpose.init_params`:
    the backbone of ``init_params(cfg, seed)`` with each fc2 cut to its
    first ``D - D_exp`` rows, ``D_exp = max(int(D * expert_frac), 1)`` rows
    per expert (0.25 gives ViTPose+-B's 576 + 6 x 192 split) and a head per
    task at its K.  ``tasks`` must be a prefix of the reference's dataset
    order (``SPLIT_DATASETS``)."""
    from ..skeletons import num_keypoints
    from .head import Head
    from .vitpose import ViTPose, init_tensor

    for i, t in enumerate(tasks):
        if SPLIT_DATASETS[i] != t:
            raise ValueError(f"tasks must be a prefix of {SPLIT_DATASETS}, got {tuple(tasks)}")
    rng = np.random.default_rng(seed)
    D = cfg.backbone.embed_dim
    d_exp = max(int(D * expert_frac), 1)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in ViTPose(cfg).state_dict().items()
                  if k.startswith("backbone.")}
    out = {}
    for name, shape in shapes.items():
        if name.endswith("mlp.fc2.weight") or name.endswith("mlp.fc2.bias"):
            shape = (D - d_exp,) + shape[1:]
        out[name] = init_tensor(rng, name, shape)
        if name.endswith("mlp.fc2.bias"):
            prefix = name[:-len("fc2.bias")]
            hidden = shapes[prefix + "fc2.weight"][1]
            for e in range(len(tasks)):
                out[f"{prefix}experts.{e}.weight"] = init_tensor(rng, "w", (d_exp, hidden))
                out[f"{prefix}experts.{e}.bias"] = init_tensor(rng, "b", (d_exp,))
    for t in tasks:
        hc = dataclasses.replace(cfg.head, num_keypoints=num_keypoints(t))
        with torch.device("meta"):
            head = Head(hc).state_dict()
        for k, v in head.items():
            if not k.endswith("num_batches_tracked"):
                name = f"{head_prefix(t)}.{k}"
                out[name] = init_tensor(rng, name, tuple(v.shape))
    return {k: torch.from_numpy(v) for k, v in out.items()}
