"""Multi-task (ViTPose+) finetuning steps, in PyTorch.

Port of ``easy_vitpose_tpu/train/moe_step.py``.  The ViTPose+
recipe trains task-homogeneous batches, alternating tasks across steps: a
step of task t reaches the shared backbone, t's expert slices and t's head.
One optimizer state covers the whole model, and a step leaves the other
tasks' heads and expert slices bit-frozen: their parameters and their Adam
moments, as JAX's ``_mask_inactive`` and ``_restore_inactive_opt`` keep them
(torch's optimizers skip a parameter whose grad is None, which is what the
reference recipe relies on).  Adam's count, and so the bias correction and
a schedule's learning rate, advances once per step whatever the task, as
JAX's global count does.

The port gets there more directly: the inactive leaves are not in the
step's graph (each expert and head is its own tensor by the reference's
names, ``models/moe.py``), so the step takes the gradients of the active
leaves only and runs the optimizer over them alone.  Their clip norm is
JAX's norm over every leaf, whose inactive gradients are exact zeros, up
to summation order.  On the card a step is, per block, K5, the MLP
backward of the flavor (K6a; K6b then K6c at D > 768), then K7; then the
norm kernel and one K8 (or K9) launch over the active leaves.

``tx`` is an :class:`..train.step.Optimizer` (``make_optimizer``), which
JAX's step takes too, or ``make_fused_adam``'s optimizer, f32, bf16 or
int8 moments, which JAX's step cannot take: JAX's ``FusedAdam`` has no
``update`` (ROADMAP C16).  The port codes int8 moments per leaf, so an
inactive expert's codes and scales are its own and stay bit-frozen.

State, a dict of tensors on one device (CUDA unless
:func:`init_moe_train_state` is asked for the CPU):

  params      float32 master weights by the reference's names (no BN statistics)
  opt_state   the optimizer's state over ``params``
  bn_state    {task: that head's BN running mean and var by name}
  step        int32

Usage::

    state = init_moe_train_state(init_vitpose_plus_params(cfg, 0, tasks), tx)
    steps = {t: make_moe_train_step(cfg, tx, t) for t in tasks}
    for batch, task in schedule:
        state, metrics = steps[task](state, batch)

``make_moe_train_step_sharded`` is the same step over a ``data`` mesh of
processes (JAX's shard_map twin): each rank runs its rows of the global
batch, the head's BatchNorm statistics are global, and the mean loss and
the active leaves' gradients are all-reduced as one flat buffer before the
optimizer, so every rank updates alike and the inactive tasks stay
bit-frozen everywhere.  Expert parallelism is ``parallel/tp.py``'s.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from ..configs import ModelConfig
from ..convert.model_split import SPLIT_DATASETS
from ..kernels import resolve_device
from ..models.moe import TRAIN_BLOCK_IMPLS, head_prefix, plus_tasks, vitpose_plus_forward_train
from ..models.vitpose import BN_STATS
from .losses import joints_mse_loss
from .step import all_reduce_grads, apply_optimizer, backward, render_batch_on_device

Tensors = Dict[str, torch.Tensor]
_EXPERT = re.compile(r"\.mlp\.experts\.(\d+)\.")
_HEADS = ("keypoint_head.", "associate_keypoint_heads.")


def split_bn_states_plus(params: Mapping[str, torch.Tensor]) -> Tuple[Tensors, Dict[str, Tensors]]:
    """A ViTPose+ mapping -> (trainable floating tensors, {task: its
    head's BN running statistics by name}); the MoE analogue of
    ``train/step.py::split_bn_state``."""
    trainable, bn = {}, {t: {} for t in plus_tasks(params)}
    for k, v in params.items():
        if k.rsplit(".", 1)[-1] in BN_STATS:
            bn[next(t for t in bn if k.startswith(head_prefix(t) + "."))][k] = v
        elif v.is_floating_point():
            trainable[k] = v
    return trainable, bn


def merge_bn_states_plus(trainable: Mapping[str, torch.Tensor],
                         bn_states: Mapping[str, Mapping[str, torch.Tensor]]) -> Tensors:
    out = dict(trainable)
    for bn in bn_states.values():
        out.update(bn)
    return out


def init_moe_train_state(params: Mapping[str, torch.Tensor], tx, device=None) -> Dict[str, Any]:
    """The training state of a ViTPose+ mapping: float32 copies of its
    weights on ``device``, which is CUDA unless the caller passes
    ``device="cpu"``; raises when that is CUDA and there is none."""
    dev = resolve_device(device)
    trainable, bn = split_bn_states_plus(params)
    to = lambda v: v.detach().to(device=dev, dtype=torch.float32, copy=True)  # noqa: E731
    trainable = {k: to(v) for k, v in trainable.items()}
    return {"params": trainable, "opt_state": tx.init(trainable),
            "bn_state": {t: {k: to(v) for k, v in s.items()} for t, s in bn.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def is_active(name: str, task: str) -> bool:
    """Whether a step of ``task`` trains the leaf ``name``: every shared
    leaf, ``task``'s expert slices and ``task``'s head."""
    if name.startswith(_HEADS):
        return name.startswith(head_prefix(task) + ".")
    m = _EXPERT.search(name)
    return m is None or int(m.group(1)) == SPLIT_DATASETS.index(task)


def _subset(moments, names):
    """The moments of ``names`` (f32 or bf16 leaves by name, or int8 codes
    and scales); names without moments (a frozen backbone) are left out."""
    if isinstance(moments, Mapping) and "q_tree" in moments:
        return {part: _subset(moments[part], names) for part in ("q_tree", "s_tree")}
    return {k: moments[k] for k in names if k in moments}


def _merged(old, new):
    """``old`` moments with ``new``'s leaves in their place."""
    if isinstance(old, Mapping) and "q_tree" in old:
        return {part: _merged(old[part], new[part]) for part in ("q_tree", "s_tree")}
    out = dict(old)
    out.update(new)
    return out


def loss_and_grads(cfg: ModelConfig, state: Mapping[str, Any], batch: Mapping[str, torch.Tensor],
                   task: str, *, use_amp: bool = True, loss_fn: Callable = joints_mse_loss,
                   block_impl: str = "pallas_train", plain: bool = False, group=None):
    """The forward and backward of one rendered batch of ``task``: (loss,
    the new BN running statistics of its head, float32 grads of the active
    leaves by name); ``group``: global BatchNorm statistics."""
    names = [k for k in state["params"] if is_active(k, task)]
    leaves = {k: state["params"][k].detach().requires_grad_(True) for k in names}
    dt = torch.bfloat16 if use_amp else torch.float32
    fwd = {k: v.to(dt) for k, v in leaves.items()}
    fwd.update(state["bn_state"][task])
    heat, new_bn = vitpose_plus_forward_train(fwd, batch["images"].to(dt), cfg, task,
                                              block_impl=block_impl, plain=plain, group=group)
    loss = loss_fn(heat, batch["targets"], batch["target_weights"])
    return loss.detach(), new_bn, backward(loss, leaves)


def make_moe_train_step(cfg: ModelConfig, tx, task: str, *, use_amp: bool = True,
                        loss_fn: Callable = joints_mse_loss, block_impl: str = "pallas_train",
                        plain: bool = False):
    """One task's step ``(state, batch) -> (new_state, {"loss",
    "grad_norm"})`` over the shared multi-task state; ``batch`` is a
    host-rendered (``images``, ``targets``, ``target_weights``) or a
    device-input batch (see ``train/step.py::render_batch_on_device``) on
    the device of the state.  ``block_impl`` (JAX's values): "pallas_train"
    (the training block; ``plain=True`` its plain versions on any device),
    "pallas_train_interpret" (the plain versions) or "xla"
    (``models/moe.py::moe_block`` under autograd).  No drop-path: the
    recipe has none."""
    return _make_step(cfg, tx, task, None, use_amp=use_amp, loss_fn=loss_fn,
                      block_impl=block_impl, plain=plain)


def make_moe_train_step_sharded(cfg: ModelConfig, tx, mesh, task: str, *, use_amp: bool = True,
                                loss_fn: Callable = joints_mse_loss,
                                block_impl: str = "pallas_train", plain: bool = False):
    """:func:`make_moe_train_step` over a ``data`` mesh (``parallel/mesh.py``),
    one process per device: ``(state, batch) -> (new_state, metrics)`` with
    ``batch`` this rank's rows of the global batch and the state
    replicated.  The head's BatchNorm statistics are global; the mean loss
    and the active leaves' mean gradients, in the optimizer's leaf order,
    are all-reduced as one flat buffer; then every rank runs the same
    optimizer launches (the norm kernel and one K8 or K9 on the card)."""
    return _make_step(cfg, tx, task, mesh.group, use_amp=use_amp, loss_fn=loss_fn,
                      block_impl=block_impl, plain=plain)


def _make_step(cfg: ModelConfig, tx, task: str, group, *, use_amp: bool, loss_fn: Callable,
               block_impl: str, plain: bool):
    if block_impl not in TRAIN_BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {TRAIN_BLOCK_IMPLS}, got {block_impl!r}")
    if task not in SPLIT_DATASETS:
        raise ValueError(f"task must be one of {SPLIT_DATASETS}, got {task!r}")

    def step(state, batch):
        batch = render_batch_on_device(batch, state["step"].device)
        loss, new_bn, grads = loss_and_grads(cfg, state, batch, task, use_amp=use_amp,
                                             loss_fn=loss_fn, block_impl=block_impl, plain=plain,
                                             group=group)
        names = list(grads)
        if group is not None:
            loss, grads = all_reduce_grads(loss, grads, names, group)
        opt = state["opt_state"]
        sub_opt = opt._replace(mu=_subset(opt.mu, names), nu=_subset(opt.nu, names))
        new_sub, new_opt, gnorm = apply_optimizer(tx, grads, sub_opt,
                                                  {k: state["params"][k] for k in names})
        params = dict(state["params"])
        params.update(new_sub)
        new_opt = new_opt._replace(mu=_merged(opt.mu, new_opt.mu), nu=_merged(opt.nu, new_opt.nu))
        bn = dict(state["bn_state"])
        bn[task] = new_bn
        return ({"params": params, "opt_state": new_opt, "bn_state": bn,
                 "step": state["step"] + 1},
                {"loss": loss, "grad_norm": gnorm})

    return step
