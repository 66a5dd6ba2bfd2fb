"""The training and evaluation steps, in PyTorch.

Port of ``easy_vitpose_tpu/train/step.py`` for one device: ``make_train_step``
with bf16 AMP, the fused clip + Adam optimizer (``train/fused_opt.py``), the
head's BatchNorm running statistics carried outside the trainable tree, the
device-input batch (uint8 crops and joints, rendered on the device, with
the renderer's ``render_kwargs``), a loss function, gradient accumulation
over micro-batches and an EMA of the weights; and ``make_eval_step``.

State is a plain dict of tensors on one device, where the step runs; it is
CUDA unless :func:`init_train_state` is asked for the CPU:

  params      float32 master weights, by state-dict name
  opt_state   :class:`..train.fused_opt.FusedAdamState`
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
moments.  The references go through :func:`loss_and_grads`: ``plain=True``
takes the kernels' plain versions on any device (the on-card reference),
``block_impl="xla"`` the JAX package's XLA block under autograd (a second
reference for the tests).  The evaluation step runs the serving forward
(K1 blocks on the card, eval-mode BatchNorm).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from ..kernels import resolve_device
from ..models.vitpose import BN_STATS, ViTPose, vitpose_forward, vitpose_forward_train
from ..ops.heatmap import generate_gaussian_targets
from .losses import joints_mse_loss

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

Tensors = Dict[str, torch.Tensor]


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


def render_batch_on_device(batch: Mapping[str, Any], device=None,
                           render_kwargs: Optional[Mapping[str, Any]] = None) -> Tensors:
    """A device-input batch (``images_u8`` (B, H, W, 3) uint8, ``joints``
    (B, K, 2), ``joints_vis`` (B, K, 2)) -> normalized float32 images,
    Gaussian targets and their weights, on ``device`` (default: where the
    images are if they are a tensor, else CUDA, which raises without a
    card; pass ``device="cpu"`` for the CPU).  ``render_kwargs`` go to
    :func:`..ops.heatmap.generate_gaussian_targets` (sizes, sigma, joint
    weights)."""
    device = resolve_device(device, like=batch["images_u8"])
    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                device=device) for k, v in batch.items()}
    x = batch["images_u8"].float()
    x = x / torch.full((1,), 255.0, device=device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
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


def apply_optimizer(tx, grads, opt_state, params):
    """(grads, opt_state, params) -> (new params, new opt_state, grad norm)
    through the fused optimizer (the optax chain is not ported)."""
    if not hasattr(tx, "fused_apply"):
        raise TypeError("the port's step takes the fused optimizer (make_fused_adam)")
    return tx.fused_apply(grads, opt_state, params)


def make_train_step(cfg: ModelConfig, tx, *, use_amp: bool = True,
                    loss_fn: LossFn = joints_mse_loss, ema_decay: float = 0.0,
                    grad_accum: int = 1, render_kwargs: Optional[Mapping[str, Any]] = None,
                    plain: bool = False):
    """The step ``(state, batch, generator=None, drop_path_masks=None) ->
    (new_state, {"loss", "grad_norm"})``.  ``batch`` is a device-input
    batch (see :func:`render_batch_on_device`, which takes
    ``render_kwargs``) of tensors or numpy arrays, rendered on the device of
    the state.  Drop-path masks are drawn from ``generator``, unless
    pre-drawn (depth, B, 1, 1) masks are given.

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
                use_amp=use_amp, loss_fn=loss_fn, plain=plain, generator=generator,
                drop_path_masks=masks)
            if grads is None:
                loss, grads = l_i, g_i
            else:
                loss, grads = loss + l_i, {n: g + g_i[n] for n, g in grads.items()}
        if k > 1:
            kt = torch.tensor(float(k), device=dev)
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
    """The optimizer state with its learning rate set to ``lr`` (the epoch
    loop's ReduceLROnPlateau controller)."""
    cur = opt_state.hyperparams["learning_rate"]
    return opt_state._replace(hyperparams={
        **opt_state.hyperparams,
        "learning_rate": torch.tensor(lr, dtype=torch.float32, device=cur.device)})


def get_learning_rate(opt_state) -> float:
    """The learning rate of the last update (a host read)."""
    return float(opt_state.hyperparams["learning_rate"])
