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
* a mixed batch with soft weights (``expert_onehot``, (B, E)) computes
  every expert and mixes them per sample in float32, as JAX's two einsums
  do (``moe.py:59-66``): XLA code outside any Pallas kernel in JAX, plain
  torch matmuls here on every device, the path held to JAX;
* a batch of mixed tasks is served on the card by the int8 serving copy
  (:class:`PlusQ8`) through
  ``pipeline/pose_step.py::pose_step(..., tasks=)``: the crops in task order
  (:class:`Routing`), each block K2 with a routed fc2
  (:func:`routed_block_q8`): the shared rows as the dense int8 GEMM over
  every crop, each task's expert rows as the grouped int8 GEMM
  (``csrc/gemm_q8.cuh::grouped_gemm_kernel``) over that task's crops alone;
  then each task's head over its crops.  A crop's features are the bits of
  the task-spliced int8 model's;
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
from torch import nn

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
    (model_split.py:100-102).  At float32 it also feeds :class:`PlusQ8`,
    the int8 copy that serves mixed tasks."""
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
    order (``SPLIT_DATASETS``).  :class:`PlusQ8` makes the int8 serving
    copy of it (on the CPU here, or after ``.to(device)`` of every
    tensor) for ``pose_step(..., tasks=)``."""
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


# --------------------------------------------------------- mixed-task serving
def task_model(params: Mapping[str, torch.Tensor], cfg: ModelConfig, task: str):
    """The float32 single-task ``ViTPose`` of ``task`` on the params' device:
    each fc2 spliced (:func:`spliced_block`) and ``task``'s head, what
    ``select_task`` makes of a converted tree."""
    from .vitpose import ViTPose

    ei = SPLIT_DATASETS.index(task)
    c = dataclasses.replace(cfg, head=task_head_config(cfg, params, task))
    with torch.device("meta"):
        model = ViTPose(c)
    sd = {}
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith("keypoint_head."):
            sd[k] = params[f"{head_prefix(task)}.{k[len('keypoint_head.'):]}"]
        elif k.endswith(("mlp.fc2.weight", "mlp.fc2.bias")):
            i = int(k.split(".")[2])
            w = spliced_block(params, i, ei)
            sd[k] = w.fc2_w if k.endswith("weight") else w.fc2_b
        else:
            sd[k] = params[k]
    model = model.to_empty(device=params["backbone.pos_embed"].device)
    model.load_state_dict(sd, strict=False)
    return model.eval()


class QBlockPlus(nn.Module):
    """A ViTPose+ block's int8 serving weights: :class:`.quant.QBlock`'s
    buffers, with ``fc2_*`` the shared rows (D - D_exp, hidden), and the
    experts' rows stacked, ``ex_wq`` (E, D_exp, hidden) int8, ``ex_s`` and
    ``ex_b`` (E, D_exp) float32.  Each row is quantized on its own, so the
    scales are those of the task-spliced fc2's rows."""

    def __init__(self, params: Mapping[str, torch.Tensor], prefix: str, num_heads: int,
                 eps: float):
        from .quant import load_q8_block, quantize_linear

        super().__init__()
        dot = prefix + "."
        load_q8_block(self, {k[len(dot):]: v for k, v in params.items() if k.startswith(dot)},
                      eps, num_heads)
        E = 0
        while f"{dot}mlp.experts.{E}.weight" in params:
            E += 1
        ew = torch.stack([params[f"{dot}mlp.experts.{e}.weight"] for e in range(E)])
        wq, s = quantize_linear(ew.reshape(-1, ew.shape[-1]).detach())
        self.register_buffer("ex_wq", wq.reshape(ew.shape).contiguous())
        self.register_buffer("ex_s", s.reshape(ew.shape[:2]).contiguous())
        self.register_buffer("ex_b", torch.stack([params[f"{dot}mlp.experts.{e}.bias"].detach()
                                                  .float() for e in range(E)]))

    def linear(self, name: str):
        from .quant import QBlock
        return QBlock.linear(self, name)


class PlusQ8(nn.Module):
    """The int8 serving copy of a ViTPose+ mapping (:func:`plus_params`,
    :func:`init_vitpose_plus_params`), made on the params' device: the
    patch embedding, position embedding and last norm cast to bf16, every
    block a :class:`QBlockPlus`, and one head per
    task cast like ``models/vitpose.py::serving_copy``'s (BN statistics in
    float32).  ``pipeline/pose_step.py::pose_step(model, ..., tasks=)``
    serves it on a batch of boxes of mixed tasks (:func:`routed_backbone`)."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: ModelConfig):
        from .head import Head
        from .vit import ViT
        from .vitpose import cast_params

        super().__init__()
        bb = cfg.backbone
        if bb.stem_channels:
            raise ValueError("the ViTPose+ serving copy takes the patch embedding, not a stem")
        self.cfg = cfg
        self.tasks = tuple(plus_tasks(params))
        dev = params["backbone.pos_embed"].device
        with torch.device("meta"):
            vit = ViT(dataclasses.replace(bb, depth=0))
        vit = vit.to_empty(device=dev)
        vit.load_state_dict({k: params[f"backbone.{k}"] for k in vit.state_dict()})
        vit = cast_params(vit, torch.bfloat16)
        vit.cfg = bb
        vit.blocks = nn.ModuleList(QBlockPlus(params, f"backbone.blocks.{i}", bb.num_heads,
                                              bb.layer_norm_eps) for i in range(bb.depth))
        self.backbone = vit
        heads = []
        for t in self.tasks:
            with torch.device("meta"):
                h = Head(task_head_config(cfg, params, t))
            h = h.to_empty(device=dev)
            h.load_state_dict({k: params[f"{head_prefix(t)}.{k}"] for k in h.state_dict()
                               if not k.endswith("num_batches_tracked")}, strict=False)
            heads.append(cast_params(h.eval(), torch.bfloat16))
        self.heads = nn.ModuleList(heads)
        self.num_keypoints = tuple(h.cfg.num_keypoints for h in heads)


_ROUTED: Dict[str, int] = {}       # task -> rows routed to its expert


def routed_rows() -> Dict[str, int]:
    """Rows routed to each task's expert by the routed fc2 since load (a
    row a block; every block counts, the plain version's too, which also
    multiplies each row by its own expert alone), and ``"padded"``, rows
    run past a group's end to fill a tile: 0, since a tile is one 64-row
    slice of one crop (``csrc/gemm_q8.cuh::grouped_gemm_kernel``, whose
    launches ``quant.grouped_gemm_launches()`` counts)."""
    return {"padded": 0, **_ROUTED}


def head_launches() -> Dict[str, int]:
    """Launches of each task's head since load (one a task a step that has
    crops of the task; counted in ``models/head.py::heads_forward``)."""
    from .head import head_launches as launches
    return launches()


def reset_routing_counts() -> None:
    from .head import reset_head_launches
    _ROUTED.clear()
    reset_head_launches()


class Routing:
    """Where the boxes of a mixed-task step go, from the host's task ids
    alone, so that the host waits for nothing: ``order`` sorts the boxes by
    task (stable: box order within a task), ``inverse`` puts them back;
    ``slices`` holds (task, first crop, end crop) of each task with crops;
    ``groups`` the grouped GEMM's table, (first row, rows, expert, 0) a task
    with crops, ``tokens`` rows a crop.  :meth:`to` uploads ``order``,
    ``inverse`` and ``groups`` in one copy from pinned memory."""

    def __init__(self, tasks, n_tasks: int, tokens: int):
        t = np.asarray(tasks)
        if t.ndim != 1 or not np.issubdtype(t.dtype, np.integer):
            raise ValueError(f"tasks must be a (M,) integer array, got {t.shape} {t.dtype}")
        if t.size and (t.min() < 0 or t.max() >= n_tasks):
            raise ValueError(f"task ids must lie in [0, {n_tasks}), got {t.min()}..{t.max()}")
        self.tokens = tokens
        self.order = np.argsort(t, kind="stable")
        self.inverse = np.argsort(self.order, kind="stable")
        counts = np.bincount(t, minlength=n_tasks)
        ends = np.cumsum(counts)
        self.slices = [(e, int(ends[e] - counts[e]), int(ends[e]))
                       for e in range(n_tasks) if counts[e]]
        self.groups = np.array([[s * tokens, (end - s) * tokens, e, 0]
                                for e, s, end in self.slices], np.int32).reshape(-1, 4)
        self.device = torch.device("cpu")

    def to(self, device) -> "Routing":
        device = torch.device(device)
        M, G = len(self.order), len(self.groups)
        host = np.concatenate([self.order, self.inverse,
                               np.ascontiguousarray(self.groups).view(np.int64).reshape(-1)])
        buf = torch.from_numpy(host.astype(np.int64))
        if device.type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        self.order_t, self.inverse_t = buf[:M], buf[M:2 * M]
        self.groups_t = buf[2 * M:].view(torch.int32).reshape(G, 4)
        self.device = device
        return self

    def count(self, tasks: Sequence[str]) -> None:
        for e, s, end in self.slices:
            _ROUTED[tasks[e]] = _ROUTED.get(tasks[e], 0) + (end - s) * self.tokens


def routed_fc2_plain(m: torch.Tensor, qb: QBlockPlus, routing: Routing) -> torch.Tensor:
    """The routed fc2 of (M, hidden) float32 rows in task order: the shared
    rows over every row, each task's expert rows over its own rows only,
    ``acc * sx * sw + b`` as :func:`.quant.linear_q8`; (M, D) float32."""
    from .quant import quant_rows

    q, sx = quant_rows(m)
    qd = q.double()
    shared = torch.matmul(qd, qb.fc2_wq.double().t()).float() * sx * qb.fc2_s + qb.fc2_b
    exp = torch.empty((m.shape[0], qb.ex_wq.shape[1]), dtype=torch.float32, device=m.device)
    for r0, rows, e, _ in routing.groups.tolist():
        acc = torch.matmul(qd[r0:r0 + rows], qb.ex_wq[e].double().t()).float()
        exp[r0:r0 + rows] = acc * sx[r0:r0 + rows] * qb.ex_s[e] + qb.ex_b[e]
    return torch.cat([shared, exp], -1)


def routed_fc2_cuda(m: torch.Tensor, x1: torch.Tensor, qb: QBlockPlus,
                    routing: Routing) -> torch.Tensor:
    """x1 + the routed fc2 of (M, hidden) float32 rows in task order, on the
    card: one row quantisation; the shared rows as the dense int8 GEMM over
    every row into the output's leading columns (its residual a copy of x1's
    leading columns, since the dense kernel reads a residual as wide as its
    output); the experts' rows as the grouped GEMM into the rest."""
    from .fused_block import EPI_RESIDUAL
    from .quant import gemm_q8_grouped_cuda, gemm_q8_rows_cuda, rowquant_cuda

    q, sx = rowquant_cuda(m)
    ns = qb.fc2_wq.shape[0]
    out = torch.empty_like(x1)
    gemm_q8_rows_cuda(q, sx, *qb.linear("fc2"), x1.dtype, EPI_RESIDUAL,
                      x1[:, :ns].contiguous(), out=out)
    return gemm_q8_grouped_cuda(q, sx, qb.ex_wq, qb.ex_s, qb.ex_b, routing.groups_t,
                                len(routing.groups), x1, out, ns)


def routed_block_q8(x: torch.Tensor, qb: QBlockPlus, routing: Routing, tasks: Sequence[str],
                    plain: bool = False) -> torch.Tensor:
    """One ViTPose+ int8 block over (B, N, D) tokens of crops in task order:
    K2 with the routed fc2 (:func:`routed_fc2_cuda`) on the card, the plain
    version (:func:`routed_fc2_plain`) on the CPU or with ``plain=True``."""
    from .quant import block_q8, fused_block_q8

    routing.count(tasks)
    if plain or x.device.type == "cpu":
        return block_q8(x, qb, lambda m: routed_fc2_plain(m, qb, routing))
    return fused_block_q8(x, qb, lambda m, x1: routed_fc2_cuda(m, x1, qb, routing))


def routed_backbone(model: PlusQ8, x: torch.Tensor, routing: Routing,
                    plain: bool = False) -> torch.Tensor:
    """(B, 256, 192, 3) normalized crops in task order -> (B, Hp, Wp, D)
    features, each crop's tokens through its own task's expert."""
    vit = model.backbone
    cfg = vit.cfg
    tokens = embed({**dict(vit.patch_embed.named_parameters(prefix="patch_embed")),
                    "pos_embed": vit.pos_embed}, x, cfg)
    for blk in vit.blocks:
        tokens = routed_block_q8(tokens, blk, routing, model.tasks, plain)
    tokens = layer_norm(tokens, vit.last_norm.weight, vit.last_norm.bias, cfg.layer_norm_eps)
    Hp, Wp = cfg.patch_shape
    return tokens.reshape(x.shape[0], Hp, Wp, cfg.embed_dim)
