"""The training and evaluation steps, in PyTorch.

Port of ``easy_vitpose_tpu/train/step.py`` for one device: ``make_train_step``
with bf16 AMP, the head's BatchNorm running statistics carried outside the
trainable tree, the device-input batch (uint8 crops and joints, rendered on
the device, with the renderer's ``render_kwargs``) or a host-rendered one, a
loss function, gradient accumulation over micro-batches and an EMA of the
weights; ``make_eval_step``; and the optimizers: the fused clip + Adam
(``train/fused_opt.py``) and the optax chains of the JAX package in plain
torch (:func:`make_optimizer`, :func:`make_adamw_layer_decay_optimizer`
with :func:`layerwise_lr_decay` and :func:`make_step_lr_schedule`), which
JAX computes in XLA.

State is a plain dict of tensors on one device, where the step runs; it is
CUDA unless :func:`init_train_state` is asked for the CPU:

  params      float32 master weights, by state-dict name
  opt_state   :class:`..train.fused_opt.FusedAdamState` or :class:`AdamState`
  bn_state    the head's BatchNorm running mean and var (float32)
  step        int32
  ema_params  float32 EMA of ``params``, with ``ema_decay`` only

Under AMP the step casts the master weights to bf16 with ``Tensor.to``, so
gradients flow back through the cast to the float32 masters, and the BN
running statistics stay float32, as ``cast_params`` keeps them.  Each
backbone block is the training block of ``models/fused_block_train.py``:
on the card its forward is K5 and its backward the MLP backward of the
flavor that the ``EVT_TRAIN_*`` switches pick (K6a by default, K6b then
K6c at ViT-L/H) then K7; the optimizer runs K8 per leaf, or K9 for int8
moments.  ``block_impl`` keeps the JAX package's values:
``"pallas_train"`` (the training block above), ``"pallas_train_interpret"``
(its plain versions on any device, as ``plain=True``: the on-card
reference) and ``"xla"`` (the JAX package's XLA block under autograd).  The
evaluation step runs the serving forward (K1 blocks on the card, eval-mode
BatchNorm).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from ..convert.from_jax import jax_leaves
from ..kernels import resolve_device
from ..models.vitpose import BN_STATS, ViTPose, vitpose_forward, vitpose_forward_train
from ..ops.heatmap import generate_gaussian_targets
from .fused_opt import global_norm, sqrt_rn
from .losses import joints_mse_loss

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

Tensors = Dict[str, torch.Tensor]
BLOCK_IMPLS = ("pallas_train", "pallas_train_interpret", "xla")


def split_bn_state(params: Mapping[str, torch.Tensor]) -> Tuple[Tensors, Tensors]:
    """State-dict tensors -> (trainable floating tensors, BN running
    statistics); other buffers (``num_batches_tracked``) are dropped."""
    trainable, bn_state = {}, {}
    for k, v in params.items():
        if k.rsplit(".", 1)[-1] in BN_STATS:
            bn_state[k] = v
        elif v.is_floating_point():
            trainable[k] = v
    return trainable, bn_state


def merge_bn_state(trainable: Mapping[str, torch.Tensor],
                   bn_state: Mapping[str, torch.Tensor]) -> Tensors:
    return {**trainable, **bn_state}


def init_train_state(params, tx, ema_decay: float = 0.0, device=None) -> Dict[str, Any]:
    """The training state of a :class:`..models.vitpose.ViTPose` or its
    state dict: float32 copies of its weights on ``device``, which is CUDA
    unless the caller passes ``device="cpu"``; raises when that is CUDA and
    there is none.  With ``ema_decay`` the state also holds ``ema_params``,
    a float32 copy of the trainable weights (the BN running statistics are
    already a moving average, shared by both)."""
    dev = resolve_device(device)
    if isinstance(params, nn.Module):
        params = params.state_dict()
    trainable, bn_state = ({k: v.detach().to(device=dev, dtype=torch.float32, copy=True)
                            for k, v in part.items()} for part in split_bn_state(params))
    state = {"params": trainable, "opt_state": tx.init(trainable), "bn_state": bn_state,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if ema_decay:
        state["ema_params"] = {k: v.clone() for k, v in trainable.items()}
    return state


def _ema_update(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float) -> Tensors:
    """``e' = decay * e + (1 - decay) * p`` per leaf."""
    names = list(ema)
    new = torch._foreach_add(torch._foreach_mul([ema[k] for k in names], decay),
                             torch._foreach_mul([params[k] for k in names], 1.0 - decay))
    return dict(zip(names, new))


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet mean and std on the [0, 1] scale, float32, made once per
    device.  Callers must not write to them."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32).to(device))


def _upload(v, device: torch.device) -> torch.Tensor:
    """An array or tensor on ``device``; host data reaches the card through
    pinned memory, so the copy does not make the host wait."""
    if not isinstance(v, torch.Tensor):
        a = np.ascontiguousarray(v)
        v = torch.from_numpy(a if a.flags.writeable else a.copy())
    if device.type == "cuda" and v.device.type == "cpu":
        return v.pin_memory().to(device, non_blocking=True)
    return v.to(device)


def render_batch_on_device(batch: Mapping[str, Any], device=None,
                           render_kwargs: Optional[Mapping[str, Any]] = None) -> Tensors:
    """A batch as the step's tensors on ``device`` (default: where its
    images are if they are a tensor, else CUDA, which raises without a card;
    pass ``device="cpu"`` for the CPU); its ``meta`` is dropped.

    A device-input batch (``images_u8`` (B, H, W, 3) uint8, ``joints``
    (B, K, 2), ``joints_vis`` (B, K, 2)) becomes normalized float32 images,
    Gaussian targets and their weights; ``render_kwargs`` go to
    :func:`..ops.heatmap.generate_gaussian_targets` (sizes, sigma, joint
    weights).  A host-rendered batch (``images``, ``targets``,
    ``target_weights``) passes through, so every step accepts either form."""
    first = batch["images_u8" if "images_u8" in batch else "images"]
    device = resolve_device(device, like=first)
    batch = {k: _upload(v, device) for k, v in batch.items() if k != "meta"}
    if "images_u8" not in batch:
        return batch
    x = batch["images_u8"].float()
    x = x / torch.full((1,), 255.0, device=device)
    mean, std = _mean_std(device)
    targets, weights = generate_gaussian_targets(batch["joints"], batch["joints_vis"],
                                                 **(render_kwargs or {}))
    return {"images": (x - mean) / std, "targets": targets, "target_weights": weights}


def forward_loss(cfg: ModelConfig, trainable: Mapping[str, torch.Tensor],
                 bn_state: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor], *,
                 use_amp: bool = True, loss_fn: LossFn = joints_mse_loss,
                 block_impl: str = "fused_train", plain: bool = False,
                 generator: Optional[torch.Generator] = None,
                 drop_path_masks: Optional[torch.Tensor] = None):
    """The forward and loss of one rendered batch from fresh leaves that
    require grad: -> (loss, new BN running statistics, leaves by name).
    ``loss_fn(heatmaps, targets, target_weights)`` gives the loss."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
    dt = torch.bfloat16 if use_amp else torch.float32
    params = merge_bn_state({k: v.to(dt) for k, v in leaves.items()}, bn_state)
    heat, new_bn = vitpose_forward_train(params, batch["images"].to(dt), cfg,
                                         drop_path_masks=drop_path_masks, generator=generator,
                                         block_impl=block_impl, plain=plain)
    return loss_fn(heat, batch["targets"], batch["target_weights"]), new_bn, leaves


def backward(loss: torch.Tensor, leaves: Mapping[str, torch.Tensor]) -> Tensors:
    """float32 grads of ``loss`` by leaf name."""
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def loss_and_grads(cfg: ModelConfig, trainable: Mapping[str, torch.Tensor],
                   bn_state: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor],
                   **forward_kw):
    """(loss, new BN running statistics, float32 grads by name) of one
    rendered batch: the ``grad_one`` of ``make_train_step``.  ``forward_kw``
    are those of :func:`forward_loss`."""
    loss, new_bn, leaves = forward_loss(cfg, trainable, bn_state, batch, **forward_kw)
    return loss.detach(), new_bn, backward(loss, leaves)


# ------------------------------------------------------- the optax chains
class AdamState(NamedTuple):
    """The state of the optax-chain optimizers: Adam's moments of the
    trained leaves (float32, by name) and the ``inject_hyperparams`` learning
    rate of the last update."""
    count: torch.Tensor                 # int32 updates so far
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    hyperparams: Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    """``init(params) -> AdamState``; ``update(grads, state, params) ->
    (updates of the trained leaves, new state)``, added to the params by
    :func:`apply_optimizer`."""
    init: Callable
    update: Callable


B1, B2, EPS = np.float32(0.9), np.float32(0.999), np.float32(1e-8)
# optax holds b1 and b2 as float32 hyperparameters, so 1 - b is a float32 difference
ONE_MINUS_B1, ONE_MINUS_B2 = float(np.float32(1) - B1), float(np.float32(1) - B2)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on either device (see
    :func:`..train.fused_opt.sqrt_rn`; CUDA's float32 root is already)."""
    return x.sqrt() if x.is_cuda else sqrt_rn(x)


def _clip_by_global_norm(gs: Sequence[torch.Tensor], max_norm: float) -> list:
    """``optax.clip_by_global_norm``: each leaf, or ``(g / ||g||) * max_norm``
    where the norm (``optax.global_norm``) reaches ``max_norm``, chosen on
    the device."""
    g_norm = global_norm(gs)
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in gs]


def _adam_chain(learning_rate, max_grad_norm: float, trained: Callable[[str], bool],
                weight_decay: float = 0.0, decay_mask: Callable[[str], bool] = None,
                scale: Callable[[str], float] = None) -> Optimizer:
    """clip_by_global_norm -> inject_hyperparams(adam or adamw) [->
    layerwise_lr_decay] over the leaves ``trained`` selects; the others get
    no moments and no update (``optax.multi_transform`` with
    ``set_to_zero``).  Each leaf runs optax's float32 operations in optax's
    order: ``mu' = (1-b1) g + b1 mu``, ``nu' = (1-b2) g^2 + b2 nu``,
    ``u = (mu'/c1) / (sqrt(nu'/c2) + eps)``, ``u += wd p`` where
    ``decay_mask``, ``u *= -lr``, ``u *= scale``.  A schedule is evaluated
    at the state's count before the update."""

    def init(params: Tensors) -> AdamState:
        names = [k for k in params if trained(k)]
        dev = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=dev)
        lr0 = learning_rate(count) if callable(learning_rate) else learning_rate
        zeros = lambda: {k: torch.zeros_like(params[k], dtype=torch.float32)  # noqa: E731
                         for k in names}
        return AdamState(count, zeros(), zeros(),
                         {"learning_rate": torch.as_tensor(lr0, dtype=torch.float32).to(dev)})

    def update(grads: Tensors, state: AdamState, params: Tensors):
        names = list(state.mu)
        gs = _clip_by_global_norm([grads[k].float() for k in names], max_grad_norm)
        lr = (learning_rate(state.count).float() if callable(learning_rate)
              else state.hyperparams["learning_rate"])
        count = state.count + 1
        cf = count.float()
        c1 = 1.0 - torch.pow(torch.full_like(cf, float(B1)), cf)
        c2 = 1.0 - torch.pow(torch.full_like(cf, float(B2)), cf)
        mu = torch._foreach_add(torch._foreach_mul(gs, ONE_MINUS_B1),
                                torch._foreach_mul([state.mu[k] for k in names], float(B1)))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), ONE_MINUS_B2),
                                torch._foreach_mul([state.nu[k] for k in names], float(B2)))
        updates, neg_lr = {}, -lr
        for k, m, v in zip(names, mu, nu):
            u = (m / c1) / (_sqrt(v / c2) + float(EPS))
            if weight_decay and decay_mask(k):
                u = u + weight_decay * params[k]
            u = neg_lr * u
            if scale is not None:
                u = u * scale(k)
            updates[k] = u
        return updates, AdamState(count, dict(zip(names, mu)), dict(zip(names, nu)),
                                  {"learning_rate": lr})

    return Optimizer(init, update)


def make_optimizer(learning_rate, max_grad_norm: float = 1.0,
                   freeze_backbone: bool = False) -> Optimizer:
    """Adam + global-norm clip (reference train_valid_fn.py:76-79, :130):
    ``optax.chain(clip_by_global_norm, inject_hyperparams(adam))``.

    ``freeze_backbone`` reproduces the reference's full-backbone freeze
    (train.py:118-123) as JAX's ``optax.multi_transform`` does: the chain
    runs over the head's leaves only, so the clip's norm is the head
    gradients' norm, and the backbone gets no moments and no updates."""
    trained = ((lambda k: not k.startswith("backbone.")) if freeze_backbone
               else (lambda k: True))
    return _adam_chain(learning_rate, max_grad_norm, trained)


def layerwise_lr_decay(layer_decay_rate: float, cfg: ModelConfig) -> Callable[[str], float]:
    """The per-leaf update scale of JAX's ``layerwise_lr_decay(rate,
    depth)``, by state-dict name: ``rate ** (depth - 1 - i)`` for block i
    (JAX scales its depth-stacked leaves by ``rate ** (depth - arange(1,
    depth + 1))`` in float32), ``rate ** depth`` for the patch and position
    embeddings and the last norm, 1 for the head."""
    depth = cfg.backbone.depth
    block = (np.float32(layer_decay_rate)
             ** (np.float32(depth) - np.arange(1, depth + 1, dtype=np.float32)))
    scales = {}
    for name, leaf in jax_leaves(cfg, bn_state=False).items():
        if leaf.path[0] == "head":
            scales[name] = 1.0
        elif leaf.layer is not None:
            scales[name] = float(block[leaf.layer])
        else:
            scales[name] = float(np.float32(layer_decay_rate ** depth))
    return scales.__getitem__


def weight_decay_mask(cfg: ModelConfig) -> Callable[[str], bool]:
    """Which leaves the AdamW recipe decays, by state-dict name: the rule of
    JAX's ``make_adamw_layer_decay_optimizer`` (biases, norms, the position
    embedding and the patch bias get none; reference common.py:7-12)
    applied to each leaf's JAX name through :func:`..convert.from_jax.jax_leaves`."""
    mask = {}
    for name, leaf in jax_leaves(cfg, bn_state=False).items():
        keys = [k for k in leaf.path if isinstance(k, str)]
        last = keys[-1]
        no_decay = (last.endswith("_b") or "ln" in last or last in ("pos_embed", "patch_b")
                    or last in ("bias", "scale") or last == "b" or "lns" in keys)
        mask[name] = not no_decay
    return mask.__getitem__


def make_step_lr_schedule(base_lr: float = 5e-4, steps_per_epoch: int = 1,
                          milestones=(170, 200), gamma: float = 0.1,
                          warmup_iters: int = 500, warmup_ratio: float = 1e-3):
    """The reference from-scratch LR policy (train_configs/
    ViTPose_base_coco_256x192.py:24-29): mmcv ``StepLrUpdaterHook`` with
    linear warmup.  Per-iteration LR:

      regular(epoch) = base_lr * gamma^(# milestones passed)   [by epoch]
      it < warmup_iters:
          lr = regular * (1 - (1 - it/warmup_iters) * (1 - warmup_ratio))
      else: lr = regular

    Returns a schedule: the int32 step count (a tensor, or an int for the
    CPU) -> the float32 learning rate on the count's device, computed there
    without a host wait, to pass as the ``learning_rate`` of
    :func:`make_adamw_layer_decay_optimizer` or ``make_fused_adam``."""
    ms_host = torch.tensor(list(milestones), dtype=torch.int32)
    ms_on = {}      # the milestones on each device, copied there once

    def sched(count) -> torch.Tensor:
        count = torch.as_tensor(count, dtype=torch.int32)
        ms = ms_on.get(count.device)
        if ms is None:
            ms = ms_on[count.device] = ms_host.to(count.device)
        epoch = torch.div(count, steps_per_epoch, rounding_mode="floor")
        n_passed = torch.sum(epoch >= ms).float()
        regular = base_lr * torch.pow(torch.full_like(n_passed, gamma), n_passed)
        cf = count.float()
        frac = torch.clamp(cf / torch.full_like(cf, float(warmup_iters)), max=1.0)
        return regular * (1.0 - (1.0 - frac) * (1.0 - warmup_ratio))

    return sched


def make_adamw_layer_decay_optimizer(learning_rate=5e-4, weight_decay: float = 0.1,
                                     layer_decay_rate: float = 0.75, *, cfg: ModelConfig,
                                     max_grad_norm: float = 1.0) -> Optimizer:
    """The reference's from-scratch AdamW recipe (train_configs/
    ViTPose_base_coco_256x192.py:7-31): AdamW(lr=5e-4, wd=0.1) + layer
    decay (:func:`layerwise_lr_decay`) + grad clip; biases, norms and the
    position embedding get no weight decay (:func:`weight_decay_mask`).
    ``learning_rate`` is a float or a schedule (:func:`make_step_lr_schedule`
    for the full recipe).  ``cfg`` gives the depth and the leaves' names.

    JAX's version hands its mask to ``optax.inject_hyperparams``, which
    takes a callable for a schedule and so decays every leaf; the port
    applies the mask the recipe names (ROADMAP queue C)."""
    return _adam_chain(learning_rate, max_grad_norm, lambda k: True,
                       weight_decay=weight_decay, decay_mask=weight_decay_mask(cfg),
                       scale=layerwise_lr_decay(layer_decay_rate, cfg))


def apply_optimizer(tx, grads, opt_state, params):
    """(grads, opt_state, params) -> (new params, new opt_state, grad norm):
    the fused optimizer's one pass (anything with ``fused_apply``), or an
    :class:`Optimizer`'s updates added to the params (leaves it does not
    train are kept) and the global norm of every gradient."""
    if hasattr(tx, "fused_apply"):
        return tx.fused_apply(grads, opt_state, params)
    updates, new_opt = tx.update(grads, opt_state, params)
    names = list(updates)
    new = dict(params)
    new.update(zip(names, torch._foreach_add([params[k] for k in names],
                                             [updates[k] for k in names])))
    return new, new_opt, global_norm(grads)


def make_train_step(cfg: ModelConfig, tx, *, use_amp: bool = True,
                    loss_fn: LossFn = joints_mse_loss, block_impl: str = "pallas_train",
                    ema_decay: float = 0.0, grad_accum: int = 1,
                    render_kwargs: Optional[Mapping[str, Any]] = None, plain: bool = False):
    """The step ``(state, batch, generator=None, drop_path_masks=None) ->
    (new_state, {"loss", "grad_norm"})``.  ``batch`` is a device-input or a
    host-rendered batch (see :func:`render_batch_on_device`, which takes
    ``render_kwargs``) of tensors or numpy arrays, on the device of the
    state.  Drop-path masks are drawn from ``generator``, unless pre-drawn
    (depth, B, 1, 1) masks are given.  ``tx`` is ``make_fused_adam``'s
    optimizer or an :class:`Optimizer`; ``block_impl`` is one of
    :data:`BLOCK_IMPLS`.

    ``grad_accum = k`` splits the batch into k micro-batches of B / k rows
    in order (a batch that k does not divide raises): each takes its own
    drop-path draw (or its rows of the given masks), the BN running
    statistics are chained through them, their float32 gradients and
    losses are summed and divided by k, and the optimizer updates once.
    With ``ema_decay`` the state's ``ema_params`` follow the new params
    (``e' = d e + (1 - d) p'``), after the optimizer.  ``plain=True`` runs
    the blocks' plain versions on any device: the on-card reference of a
    whole step."""
    k = int(grad_accum)
    if k < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got {block_impl!r}")
    forward_kw = dict(use_amp=use_amp, loss_fn=loss_fn,
                      block_impl="xla" if block_impl == "xla" else "fused_train",
                      plain=plain or block_impl == "pallas_train_interpret")

    def step(state, batch, generator=None, drop_path_masks=None):
        dev = state["step"].device
        batch = render_batch_on_device(batch, dev, render_kwargs)
        B = batch["images"].shape[0]
        if B % k:
            raise ValueError(f"batch {B} not divisible by grad_accum {k}")
        rows, bn_state, loss, grads = B // k, state["bn_state"], None, None
        for i in range(k):
            part = slice(i * rows, (i + 1) * rows)
            masks = None if drop_path_masks is None else drop_path_masks[:, part]
            l_i, bn_state, g_i = loss_and_grads(
                cfg, state["params"], bn_state, {n: v[part] for n, v in batch.items()},
                generator=generator, drop_path_masks=masks, **forward_kw)
            if grads is None:
                loss, grads = l_i, g_i
            else:
                loss, grads = loss + l_i, {n: g + g_i[n] for n, g in grads.items()}
        if k > 1:
            kt = torch.full((), float(k), device=dev)
            loss, grads = loss / kt, {n: g / kt for n, g in grads.items()}
        new_params, new_opt, gnorm = apply_optimizer(tx, grads, state["opt_state"],
                                                     state["params"])
        new_state = {"params": new_params, "opt_state": new_opt, "bn_state": bn_state,
                     "step": state["step"] + 1}
        if ema_decay:
            new_state["ema_params"] = _ema_update(state["ema_params"], new_params, ema_decay)
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def serving_model(cfg: ModelConfig, params: Mapping[str, torch.Tensor],
                  bn_state: Mapping[str, torch.Tensor], dtype: torch.dtype) -> ViTPose:
    """A :class:`ViTPose` that holds ``params`` cast to ``dtype`` (no copy
    where they are of it already) and the float32 BN running statistics,
    for the serving forward; built on the meta device and filled by
    assignment, so nothing is initialised."""
    with torch.device("meta"):
        model = ViTPose(cfg)
    dev = next(iter(params.values())).device
    sd = {k: v.detach().to(dtype) for k, v in params.items()}
    sd.update(bn_state)
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.long, device=dev)
    model.load_state_dict(sd, assign=True)
    return model.eval()


def make_eval_step(cfg: ModelConfig, *, use_amp: bool = True, loss_fn: LossFn = joints_mse_loss,
                   return_heatmaps: bool = False,
                   render_kwargs: Optional[Mapping[str, Any]] = None):
    """The validation step ``(state, batch) -> loss``, or ``(loss, float32
    heatmaps)`` with ``return_heatmaps``: the serving forward of the state's
    weights (bf16 under AMP) with eval-mode BatchNorm, on the device of the
    state, and the loss against the batch's rendered targets."""

    def step(state, batch):
        dev = state["step"].device
        batch = render_batch_on_device(batch, dev, render_kwargs)
        dt = torch.bfloat16 if use_amp else torch.float32
        model = serving_model(cfg, state["params"], state["bn_state"], dt)
        with torch.no_grad():
            heat = vitpose_forward(model, batch["images"].to(dt)).float()
            loss = loss_fn(heat, batch["targets"], batch["target_weights"])
        return (loss, heat) if return_heatmaps else loss

    return step


def set_learning_rate(opt_state, lr: float):
    """The optimizer state (fused or :class:`AdamState`) with its learning
    rate set to ``lr`` (the epoch loop's ReduceLROnPlateau controller)."""
    cur = opt_state.hyperparams["learning_rate"]
    return opt_state._replace(hyperparams={
        **opt_state.hyperparams,
        "learning_rate": torch.tensor(lr, dtype=torch.float32, device=cur.device)})


def get_learning_rate(opt_state) -> float:
    """The learning rate of the last update (a schedule's value at the
    count before it), a host read."""
    return float(opt_state.hyperparams["learning_rate"])
