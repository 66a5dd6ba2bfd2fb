"""The training step, in PyTorch.

Port of ``easy_vitpose_tpu/train/step.py`` for one device, one micro-batch
and no EMA (``make_train_step`` with ``grad_accum=1``, ``ema_decay=0``):
bf16 AMP, the fused clip + Adam optimizer (``train/fused_opt.py``), the
head's BatchNorm running statistics carried outside the trainable tree, and
the device-input batch (uint8 crops and joints, rendered on the device).

State is a plain dict of tensors on one device, where the step runs; it is
CUDA unless :func:`init_train_state` is asked for the CPU:

  params     float32 master weights, by state-dict name
  opt_state  :class:`..train.fused_opt.FusedAdamState`
  bn_state   the head's BatchNorm running mean and var (float32)
  step       int32

Under AMP the step casts the master weights to bf16 with ``Tensor.to``, so
gradients flow back through the cast to the float32 masters, and the BN
running statistics stay float32, as ``cast_params`` keeps them.  Each
backbone block is the training block of ``models/fused_block_train.py``:
on the card its forward is K5 and its backward K6a (K6b then K6c at
D > 768) then K7; the optimizer runs K8 per leaf, or K9 for int8 moments.
The references go through :func:`loss_and_grads`: ``plain=True`` takes the
kernels' plain versions on any device (the on-card reference),
``block_impl="xla"`` the JAX package's XLA block under autograd (a second
reference for the tests).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import IMAGENET_MEAN, IMAGENET_STD, ModelConfig
from ..kernels import resolve_device
from ..models.vitpose import BN_STATS, vitpose_forward_train
from ..ops.heatmap import generate_gaussian_targets
from .losses import joints_mse_loss

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


def init_train_state(params, tx, device=None) -> Dict[str, Any]:
    """The training state of a :class:`..models.vitpose.ViTPose` or its
    state dict: float32 copies of its weights on ``device``, which is CUDA
    unless the caller passes ``device="cpu"``; raises when that is CUDA and
    there is none."""
    dev = resolve_device(device)
    if isinstance(params, nn.Module):
        params = params.state_dict()
    trainable, bn_state = ({k: v.detach().to(device=dev, dtype=torch.float32, copy=True)
                            for k, v in part.items()} for part in split_bn_state(params))
    return {"params": trainable, "opt_state": tx.init(trainable), "bn_state": bn_state,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def render_batch_on_device(batch: Mapping[str, Any], device=None) -> Tensors:
    """A device-input batch (``images_u8`` (B, H, W, 3) uint8, ``joints``
    (B, K, 2), ``joints_vis`` (B, K, 2)) -> normalized float32 images,
    Gaussian targets and their weights, on ``device`` (default: where the
    images are)."""
    if device is None:
        first = batch["images_u8"]
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    batch = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                device=device) for k, v in batch.items()}
    x = batch["images_u8"].float()
    x = x / torch.full((1,), 255.0, device=device)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    targets, weights = generate_gaussian_targets(batch["joints"], batch["joints_vis"])
    return {"images": (x - mean) / std, "targets": targets, "target_weights": weights}


def forward_loss(cfg: ModelConfig, trainable: Mapping[str, torch.Tensor],
                 bn_state: Mapping[str, torch.Tensor], batch: Mapping[str, torch.Tensor], *,
                 use_amp: bool = True, block_impl: str = "fused_train", plain: bool = False,
                 generator: Optional[torch.Generator] = None,
                 drop_path_masks: Optional[torch.Tensor] = None):
    """The forward and loss of one rendered batch from fresh leaves that
    require grad: -> (loss, new BN running statistics, leaves by name)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in trainable.items()}
    dt = torch.bfloat16 if use_amp else torch.float32
    params = merge_bn_state({k: v.to(dt) for k, v in leaves.items()}, bn_state)
    heat, new_bn = vitpose_forward_train(params, batch["images"].to(dt), cfg,
                                         drop_path_masks=drop_path_masks, generator=generator,
                                         block_impl=block_impl, plain=plain)
    return joints_mse_loss(heat, batch["targets"], batch["target_weights"]), new_bn, leaves


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


def make_train_step(cfg: ModelConfig, tx, *, use_amp: bool = True):
    """The step ``(state, batch, generator=None, drop_path_masks=None) ->
    (new_state, {"loss", "grad_norm"})``.  ``batch`` is a device-input
    batch (see :func:`render_batch_on_device`) of tensors or numpy arrays,
    rendered on the device of the state.  Drop-path masks are drawn from
    ``generator``, unless pre-drawn (depth, B, 1, 1) masks are given."""

    def step(state, batch, generator=None, drop_path_masks=None):
        dev = state["step"].device
        batch = render_batch_on_device(batch, dev)
        loss, new_bn, grads = loss_and_grads(
            cfg, state["params"], state["bn_state"], batch, use_amp=use_amp,
            generator=generator, drop_path_masks=drop_path_masks)
        new_params, new_opt, gnorm = apply_optimizer(tx, grads, state["opt_state"],
                                                     state["params"])
        new_state = {"params": new_params, "opt_state": new_opt, "bn_state": new_bn,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm}

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
