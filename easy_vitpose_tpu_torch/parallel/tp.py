"""Tensor and expert parallelism for ViTPose training, over process groups.

Port of ``easy_vitpose_tpu/parallel/tp.py``.  JAX annotates the weight tree
with ``NamedSharding`` over a 2-D ``(data, model)`` mesh and GSPMD derives
the collectives; here the same Megatron layout is explicit:

* :func:`make_mesh_2d` splits one process group into ``data`` and
  ``model`` subgroups, rank ``d * n_model + m`` at row d, column m (JAX's
  reshape of the device list);
* :data:`RULES` (JAX's ``_RULES``, by the port's state-dict names):
  ``attn.qkv`` and ``mlp.fc1`` are column-parallel, each model rank holding
  its heads' rows of q, k and v and its block of hidden units;
  ``attn.proj`` and ``mlp.fc2`` are row-parallel over the same heads and
  units; everything else is replicated.  The optimizer moments that mirror
  a leaf are sliced with it (:func:`shard_state`);
* :func:`make_tp_train_step` is JAX's ``jit_tensor_parallel(make_train_step
  (...))``: JAX's TP runs the plain XLA block (``block_impl="xla"``), so this
  step composes the plain block ops of ``models/vit.py::block_train`` on
  its shards, with :func:`..parallel.comm.copy_to_group` before each
  column-parallel layer and :func:`..parallel.comm.reduce_from_group` after
  each row-parallel one (before the bias and the residual).  The head's
  BatchNorm statistics are global over ``data``; the gradients are
  averaged over ``data`` as one flat buffer; the clip's norm adds the
  shards' squares over ``model``.  It launches none of the port's kernels.

Expert parallelism (JAX's ``fc2_expert_*`` rules, ``models/moe.py:21-22``):
:func:`shard_experts` keeps on each rank of a model group the E/m expert
slices it owns (contiguous blocks, expert e on rank ``e // (E/m)``), and
:func:`fetch_experts` broadcasts a task's expert from its owner to the
group, with autograd: the owner keeps the gradient (every rank of the
group computes the same loss from the same rows).  The forward over the
fetched weights is ``models/moe.py``'s, so it equals the unsharded
``vitpose_plus_forward``.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs import ModelConfig
from ..convert.model_split import SPLIT_DATASETS
from ..models.head import head_forward_train
from ..models.vit import BLOCK_PARAMS, BlockWeights, embed, layer_norm, linear_f32, q_scale
from ..train.losses import joints_mse_loss
from . import comm
from .mesh import Mesh, local_device

Tensors = Dict[str, torch.Tensor]

# sharding rule by trailing state-dict name: (dim, sections).  The dim is
# split model-ways within each of ``sections`` equal parts (q, k and v)
RULES = {
    "attn.qkv.weight": (0, 3),
    "attn.qkv.bias": (0, 3),
    "mlp.fc1.weight": (0, 1),
    "mlp.fc1.bias": (0, 1),
    "attn.proj.weight": (1, 1),
    "mlp.fc2.weight": (1, 1),
}
_EXPERT = re.compile(r"^(backbone\.blocks\.\d+\.mlp\.experts)\.(\d+)\.(weight|bias)$")


@dataclass(frozen=True)
class Mesh2D:
    """A ``(data, model)`` layout of one process group: this rank's row and
    column meshes."""
    data: Mesh
    model: Mesh

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_mesh_2d(n_data: int, n_model: int, device=None) -> Mesh2D:
    """The ``(data, model)`` mesh over a world of ``n_data * n_model``
    ranks, this rank on ``device`` (default ``cuda:LOCAL_RANK``).  Every
    rank must call it (it makes the subgroups)."""
    n = n_data * n_model
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 1
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {n} ranks, have {have}")
    r = dist.get_rank()
    data_group = model_group = None
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if r // n_model == d:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if r % n_model == m:
            data_group = g
    dev = (local_device(device),)
    return Mesh2D(Mesh("data", dev, data_group), Mesh("model", dev, model_group))


def _rule(name: str) -> Optional[Tuple[int, int]]:
    for suffix, rule in RULES.items():
        if name.endswith(suffix):
            return rule
    return None


def shard_tensor(t: torch.Tensor, rule: Tuple[int, int], n: int, i: int) -> torch.Tensor:
    """Shard ``i`` of ``n`` of a leaf under ``rule``."""
    dim, sections = rule
    if t.shape[dim] % (sections * n):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {sections} x {n} ways")
    parts = t.chunk(sections, dim)
    return torch.cat([p.chunk(n, dim)[i] for p in parts], dim).contiguous()


def unshard_tensor(shards, rule: Tuple[int, int]) -> torch.Tensor:
    """The leaf whose shards in order are ``shards``."""
    dim, sections = rule
    parts = [s.chunk(sections, dim) for s in shards]
    return torch.cat([torch.cat([p[j] for p in parts], dim) for j in range(sections)], dim)


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh2D) -> Tensors:
    """This model rank's shards of ``params`` (state-dict names), on the
    mesh's device; unruled leaves whole."""
    n, i = mesh.model.size, mesh.model.rank
    out = {}
    for k, v in params.items():
        rule = _rule(k)
        out[k] = (shard_tensor(v, rule, n, i) if rule else v).to(mesh.device)
    return out


def shard_state(state: Mapping[str, Any], mesh: Mesh2D) -> Dict[str, Any]:
    """A train state (``train/step.py::init_train_state`` of an
    :class:`..train.step.Optimizer`) with its params and the moments that
    mirror them sharded by :data:`RULES` (JAX's ``shard_state``)."""
    opt = state["opt_state"]
    if not isinstance(opt.mu, Mapping) or "q_tree" in opt.mu:
        raise ValueError("tensor parallelism shards float moments by name")
    out = dict(state)
    out["params"] = shard_params(state["params"], mesh)
    out["opt_state"] = opt._replace(mu=shard_params(opt.mu, mesh), nu=shard_params(opt.nu, mesh))
    out["bn_state"] = {k: v.to(mesh.device) for k, v in state["bn_state"].items()}
    out["step"] = state["step"].to(mesh.device)
    return out


def gather_params(params: Mapping[str, torch.Tensor], mesh: Mesh2D) -> Tensors:
    """The whole leaves of model-sharded ``params`` on every rank of the
    model group (one all-gather per sharded leaf)."""
    out = {}
    for k, v in params.items():
        rule = _rule(k)
        if rule is None or mesh.model.group is None:
            out[k] = v
            continue
        shards = [torch.empty_like(v) for _ in range(mesh.model.size)]
        dist.all_gather(shards, v.contiguous(), group=mesh.model.group)
        out[k] = unshard_tensor(shards, rule)
    return out


# ------------------------------------------------------------------ the step
def tp_block(x: torch.Tensor, w: BlockWeights, num_heads: int, eps: float, group,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`..models.vit.block_train` on a model rank's shards: ``w`` holds
    its heads' qkv rows and proj columns and its hidden units' fc1 rows and
    fc2 columns; ``num_heads`` is its local head count."""
    dt = x.dtype
    B, N, _ = x.shape
    h = comm.copy_to_group(layer_norm(x, w.ln1_w, w.ln1_b, eps), group)
    qkv = linear_f32(h, w.qkv_w, w.qkv_b).to(dt)
    dl = qkv.shape[-1] // 3
    hd = dl // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q = (q.float() * q_scale(hd, dt)).to(dt)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)).to(dt)
    probs = torch.softmax(logits.float(), dim=-1).to(dt)
    o = torch.matmul(probs.float(), v.float()).to(dt).transpose(1, 2).reshape(B, N, dl)
    a = comm.reduce_from_group(torch.matmul(o.float(), w.proj_w.float().t()), group)
    a = (a + w.proj_b.float()).to(dt)
    if keep is not None:
        a = (a.float() * keep).to(dt)
    x = x + a
    h = comm.copy_to_group(layer_norm(x, w.ln2_w, w.ln2_b, eps), group)
    m = F.gelu(linear_f32(h, w.fc1_w, w.fc1_b)).to(dt)
    m = comm.reduce_from_group(torch.matmul(m.float(), w.fc2_w.float().t()), group)
    m = (m + w.fc2_b.float()).to(dt)
    if keep is not None:
        m = (m.float() * keep).to(dt)
    return x + m


def tp_backbone_forward_train(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                              cfg: ModelConfig, mesh: Mesh2D) -> torch.Tensor:
    """The backbone's training forward over a model rank's shards (no
    drop-path): (B, H, W, 3) -> (B, D, Hp, Wp) features, whole on every
    rank of the model group."""
    bb = cfg.backbone
    n_model = mesh.model.size
    if bb.num_heads % n_model:
        raise ValueError(f"{bb.num_heads} heads do not split over {n_model} model ranks")
    B = x.shape[0]
    tokens = embed(params, x, bb, "backbone")
    for i in range(bb.depth):
        w = BlockWeights(*(params[f"backbone.blocks.{i}.{n}"] for n in BLOCK_PARAMS))
        tokens = tp_block(tokens, w, bb.num_heads // n_model, bb.layer_norm_eps, mesh.model.group)
    tokens = layer_norm(tokens, params["backbone.last_norm.weight"],
                        params["backbone.last_norm.bias"], bb.layer_norm_eps)
    Hp, Wp = bb.patch_shape
    return tokens.reshape(B, Hp, Wp, bb.embed_dim).permute(0, 3, 1, 2)


def tp_vitpose_forward_train(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                             cfg: ModelConfig, mesh: Mesh2D):
    """The training forward over a model rank's shards (no drop-path):
    -> ((B, K, 64, 48) heatmaps, new BN running statistics), the BatchNorm
    statistics global over the ``data`` group."""
    feats = tp_backbone_forward_train(params, x, cfg, mesh)
    return head_forward_train(params, feats, cfg.head, group=mesh.data.group)


def sharded_global_norm(grads: Mapping[str, torch.Tensor], mesh: Mesh2D) -> torch.Tensor:
    """The global norm of the whole gradient tree from a model rank's
    shards: the replicated leaves' squares plus the shards' squares summed
    over the model group."""
    rep = [torch.sum(torch.square(g.float())) for k, g in grads.items() if _rule(k) is None]
    shd = [torch.sum(torch.square(g.float())) for k, g in grads.items() if _rule(k) is not None]
    zero = torch.zeros((), device=mesh.device)
    s = sum(shd, zero)
    if mesh.model.group is not None:
        s = s.clone()
        dist.all_reduce(s, group=mesh.model.group)
    return torch.sqrt(sum(rep, zero) + s)


def make_tp_train_step(cfg: ModelConfig, tx, mesh: Mesh2D, *, use_amp: bool = True,
                       loss_fn=joints_mse_loss):
    """The tensor-parallel step ``(state, batch) -> (new_state, {"loss",
    "grad_norm"})`` over a :func:`shard_state` state (JAX's
    ``jit_tensor_parallel(make_train_step(cfg, tx))``; the batch is this
    data rank's rows, the same on every rank of its model group).  ``tx`` is
    an :class:`..train.step.Optimizer`: its clip takes the sharded tree's
    global norm, its Adam is elementwise on the shards.  No drop-path."""
    from ..train.step import all_reduce_grads, apply_optimizer, render_batch_on_device

    if cfg.backbone.drop_path_rate > 0.0:
        raise ValueError("the tensor-parallel step has no drop-path")

    def step(state, batch):
        batch = render_batch_on_device(batch, state["step"].device)
        dt = torch.bfloat16 if use_amp else torch.float32
        leaves = {k: v.detach().requires_grad_(True) for k, v in state["params"].items()}
        fwd = {k: v.to(dt) for k, v in leaves.items()}
        fwd.update(state["bn_state"])
        heat, new_bn = tp_vitpose_forward_train(fwd, batch["images"].to(dt), cfg, mesh)
        loss = loss_fn(heat, batch["targets"], batch["target_weights"])
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        loss, grads = all_reduce_grads(loss.detach(), grads, names, mesh.data.group)
        g_norm = sharded_global_norm(grads, mesh)
        new_params, new_opt, gnorm = apply_optimizer(tx, grads, state["opt_state"],
                                                     state["params"], g_norm=g_norm)
        return ({"params": new_params, "opt_state": new_opt, "bn_state": new_bn,
                 "step": state["step"] + 1}, {"loss": loss, "grad_norm": gnorm})

    return step


# ------------------------------------------------------ expert parallelism
def expert_owner(e: int, n_experts: int, mesh: Mesh) -> int:
    """The rank of ``mesh``'s group that holds expert ``e``."""
    if n_experts % mesh.size:
        raise ValueError(f"{n_experts} experts do not split over {mesh.size} ranks")
    return e // (n_experts // mesh.size)


def shard_experts(params: Mapping[str, torch.Tensor], mesh: Mesh) -> Tensors:
    """A ViTPose+ mapping (``models/moe.py``) with only the expert slices
    this rank of the model group owns, on its device."""
    from ..models.moe import num_experts
    n = num_experts(params)
    out = {}
    for k, v in params.items():
        m = _EXPERT.match(k)
        if m is None or expert_owner(int(m.group(2)), n, mesh) == mesh.rank:
            out[k] = v.to(mesh.device)
    return out


def fetch_experts(params: Mapping[str, torch.Tensor], cfg: ModelConfig, task: str, mesh: Mesh,
                  n_experts: int) -> Tensors:
    """``params`` (this rank's :func:`shard_experts`) with ``task``'s expert
    slices of every layer, broadcast from the rank that owns them (one
    collective per leaf, differentiated: the gradient returns to the
    owner)."""
    e = SPLIT_DATASETS.index(task)
    owner = expert_owner(e, n_experts, mesh)
    src = comm.group_ranks(mesh.group)[owner]
    D = params["backbone.pos_embed"].shape[-1]
    out = dict(params)
    for i in range(cfg.backbone.depth):
        blk = f"backbone.blocks.{i}.mlp"
        d_exp = D - params[f"{blk}.fc2.bias"].shape[0]
        hidden = params[f"{blk}.fc1.weight"].shape[0]
        for part, shape in (("weight", (d_exp, hidden)), ("bias", (d_exp,))):
            name = f"{blk}.experts.{e}.{part}"
            if mesh.rank == owner:
                t = params[name]
            else:       # the buffer the owner's slice arrives in
                ref = params[f"{blk}.fc2.{part}"]
                t = torch.zeros(shape, dtype=ref.dtype, device=ref.device,
                                requires_grad=ref.requires_grad)
            out[name] = comm.broadcast(t, src, mesh.group)
    return out


def ep_vitpose_plus_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                            cfg: ModelConfig, task: str, mesh: Mesh, n_experts: int, *,
                            plain: bool = False) -> torch.Tensor:
    """``models/moe.py::vitpose_plus_forward`` with the experts sharded over
    ``mesh``'s model group: the task's expert fetched from its owner."""
    from ..models.moe import vitpose_plus_forward
    return vitpose_plus_forward(fetch_experts(params, cfg, task, mesh, n_experts), x, cfg, task,
                                plain=plain)
