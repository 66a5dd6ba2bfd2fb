"""JAX params pytree <-> the port's state dict.

The JAX package keeps ViTPose params as a pytree in its own layouts: linear
weights (in, out), the patch conv flattened to (P*P*C, D) in unfold order,
per-block params stacked on a leading depth axis, the deconvs pre-flipped in
HWIO and the final conv in HWIO.  This turns such a pytree, given as numpy
arrays (``np.asarray`` of each leaf), into a state dict with the
reference's names and torch layouts, which ``ViTPose.load_state_dict``
takes as it is; :func:`state_dict_to_jax` is its inverse.  Both go through
one name map, :func:`jax_leaves`.  Numpy only: the port does not import
JAX.

The map is linear and elementwise, so it carries any tree of the params'
layout across: with ``bn_state=False`` it maps a tree without the head's
``bn_state`` (the trainable tree of a training state, its gradients, or the
Adam moments ``mu`` and ``nu``) to the port's trainable names.
:func:`opt_state_from_jax` carries a whole fused-Adam state across, int8
moments included, which are codes with per-block scales and so not
elementwise, and :func:`train_state_from_jax` a whole training state (its
EMA weights too).
"""
from __future__ import annotations

import functools
import operator
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import ModelConfig


def _f32(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")


def patch_weight_to_torch(w, patch: int, in_chans: int, dim: int) -> np.ndarray:
    """(P*P*C, D) flattened patch weight -> conv (D, C, P, P)."""
    return _f32(_f32(w).reshape(patch, patch, in_chans, dim).transpose(3, 2, 0, 1))


def deconv_weight_to_torch(w) -> np.ndarray:
    """Pre-flipped HWIO (kh, kw, Cin, Cout) -> ConvTranspose2d (Cin, Cout, kh, kw)."""
    return _f32(_f32(w).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def conv_weight_to_torch(w) -> np.ndarray:
    """HWIO -> OIHW."""
    return _f32(_f32(w).transpose(3, 2, 0, 1))


class JaxLeaf(NamedTuple):
    """Where a state-dict tensor lives in the JAX params tree."""
    path: Tuple[Union[str, int], ...]   # keys (and list indices) from the root
    layer: Optional[int]                # its index on the stacked depth axis
    kind: str                           # its layout: a key of _TO_TORCH


# each layout's map from the JAX array to the torch one (``cfg`` for the patch)
_TO_TORCH = {
    "copy": lambda x, cfg: _f32(x),
    "linear": lambda x, cfg: _f32(_f32(x).T),
    "patch": lambda x, cfg: patch_weight_to_torch(x, cfg.backbone.patch_size,
                                                  cfg.backbone.in_chans, cfg.backbone.embed_dim),
    "deconv": lambda x, cfg: deconv_weight_to_torch(x),
    "conv": lambda x, cfg: conv_weight_to_torch(x),
}
# ... and back: exact inverses (transposes, flips and reshapes only)
_TO_JAX = {
    "copy": lambda x, cfg: x,
    "linear": lambda x, cfg: x.T,
    "patch": lambda x, cfg: x.transpose(2, 3, 1, 0).reshape(-1, cfg.backbone.embed_dim),
    "deconv": lambda x, cfg: x[:, :, ::-1, ::-1].transpose(2, 3, 0, 1),
    "conv": lambda x, cfg: x.transpose(2, 3, 1, 0),
}


def jax_leaves(cfg: ModelConfig, *, bn_state: bool = True) -> Dict[str, JaxLeaf]:
    """The name map between the port's state dict and the JAX params tree,
    in the state dict's order: each reference name -> its :class:`JaxLeaf`.
    ``bn_state=False`` leaves out the head's BN running statistics (the
    trainable tree: params, grads, Adam moments)."""
    bb = cfg.backbone
    out = {"backbone.patch_embed.proj.weight": JaxLeaf(("backbone", "patch_w"), None, "patch"),
           "backbone.patch_embed.proj.bias": JaxLeaf(("backbone", "patch_b"), None, "copy"),
           "backbone.pos_embed": JaxLeaf(("backbone", "pos_embed"), None, "copy"),
           "backbone.last_norm.weight": JaxLeaf(("backbone", "ln_s"), None, "copy"),
           "backbone.last_norm.bias": JaxLeaf(("backbone", "ln_b"), None, "copy")}
    blocks = ("backbone", "blocks")
    for i in range(bb.depth):
        p = f"backbone.blocks.{i}"
        for name, src in (("norm1", "ln1"), ("norm2", "ln2")):
            out[f"{p}.{name}.weight"] = JaxLeaf(blocks + (f"{src}_s",), i, "copy")
            out[f"{p}.{name}.bias"] = JaxLeaf(blocks + (f"{src}_b",), i, "copy")
        for name, tree, src in (("attn.qkv", blocks, "qkv"), ("attn.proj", blocks, "proj"),
                                ("mlp.fc1", blocks + ("mlp",), "fc1"),
                                ("mlp.fc2", blocks + ("mlp",), "fc2")):
            out[f"{p}.{name}.weight"] = JaxLeaf(tree + (f"{src}_w",), i, "linear")
            out[f"{p}.{name}.bias"] = JaxLeaf(tree + (f"{src}_b",), i, "copy")
    for i in range(len(cfg.head.deconv_filters)):
        bn, dc = f"keypoint_head.deconv_layers.{3 * i + 1}", ("head", "deconv", i)
        out[f"keypoint_head.deconv_layers.{3 * i}.weight"] = JaxLeaf(dc + ("w",), None, "deconv")
        out[f"{bn}.weight"] = JaxLeaf(dc + ("bn", "scale"), None, "copy")
        out[f"{bn}.bias"] = JaxLeaf(dc + ("bn", "bias"), None, "copy")
        if bn_state:
            out[f"{bn}.running_mean"] = JaxLeaf(("head", "bn_state", i, "mean"), None, "copy")
            out[f"{bn}.running_var"] = JaxLeaf(("head", "bn_state", i, "var"), None, "copy")
    out["keypoint_head.final_layer.weight"] = JaxLeaf(("head", "final_w"), None, "conv")
    out["keypoint_head.final_layer.bias"] = JaxLeaf(("head", "final_b"), None, "copy")
    return out


def state_dict_from_jax(params: Mapping[str, Any], cfg: ModelConfig, *,
                        bn_state: bool = True) -> Dict[str, torch.Tensor]:
    """JAX ``{"backbone": ..., "head": ...}`` params -> reference-named
    float32 tensors for ``ViTPose.load_state_dict``; ``bn_state=False`` for
    a tree without the BN running statistics (grads, moments)."""
    sd = {}
    for name, leaf in jax_leaves(cfg, bn_state=bn_state).items():
        x = functools.reduce(operator.getitem, leaf.path, params)
        if leaf.layer is not None:
            x = x[leaf.layer]
        sd[name] = torch.from_numpy(_TO_TORCH[leaf.kind](x, cfg))
    return sd


def state_dict_to_jax(sd: Mapping[str, Any], cfg: ModelConfig, *, bn_state: bool = True,
                      dtype=np.float32) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`: reference-named tensors
    (or numpy arrays) -> the JAX params tree at ``dtype`` (the BN running
    statistics stay float32), the layout of the JAX package's ``.npz``
    files; bit for bit, since the map only moves elements."""
    head: Dict[str, Any] = {"deconv": [{"bn": {}} for _ in cfg.head.deconv_filters]}
    if bn_state:
        head["bn_state"] = [{} for _ in cfg.head.deconv_filters]
    tree = {"backbone": {"blocks": {"mlp": {}}}, "head": head}
    stacks: Dict[Tuple, list] = {}
    for name, leaf in jax_leaves(cfg, bn_state=bn_state).items():
        x = sd[name]
        x = x.detach().to("cpu", torch.float32).numpy() if isinstance(x, torch.Tensor) else x
        x = np.ascontiguousarray(_TO_JAX[leaf.kind](np.asarray(x), cfg).astype(
            np.float32 if "bn_state" in leaf.path else dtype))
        if leaf.layer is None:
            functools.reduce(operator.getitem, leaf.path[:-1], tree)[leaf.path[-1]] = x
        else:
            stacks.setdefault(leaf.path, []).append(x)
    for path, xs in stacks.items():
        functools.reduce(operator.getitem, path[:-1], tree)[path[-1]] = np.stack(xs)
    return tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists of arrays."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def opt_state_from_jax(opt_state, params: Mapping[str, Any], cfg: ModelConfig):
    """A JAX ``FusedAdamState`` (f32, bf16 or int8 moments, leaves as numpy
    or JAX arrays) -> the port's :class:`..train.fused_opt.FusedAdamState`
    on the CPU.  ``params`` is the JAX trainable tree the state belongs to
    (for the shapes of int8 leaves).

    f32 and bf16 moments map elementwise, bit for bit.  int8 moments are
    decoded (``_q8_decode``), mapped, and coded again in the port's blocks:
    each torch-layout leaf flattened and padded to whole 2048-element
    blocks, where JAX codes its depth-stacked (in, out) leaves.  A block's
    new absmax puts the values on another grid of levels, so the re-encode
    can move a code by one level, and a value under 1e-6 of its new block's
    absmax codes to 0."""
    from ..train.fused_opt import FusedAdamState, q8_decode, q8_encode

    def moments(tree, levels):
        if isinstance(tree, Mapping) and "q_tree" in tree:
            values = tree_map(lambda q, sc, p: q8_decode(
                torch.from_numpy(np.array(q)), torch.from_numpy(np.array(sc, np.float32)),
                levels, np.shape(p)).numpy(), tree["q_tree"], tree["s_tree"], params)
            codes = {"q_tree": {}, "s_tree": {}}
            for k, v in state_dict_from_jax(values, cfg, bn_state=False).items():
                codes["q_tree"][k], codes["s_tree"][k] = q8_encode(v, levels)
            return codes
        bf16 = str(np.asarray(tree["backbone"]["pos_embed"]).dtype) == "bfloat16"
        return {k: v.to(torch.bfloat16) if bf16 else v
                for k, v in state_dict_from_jax(tree, cfg, bn_state=False).items()}

    return FusedAdamState(
        count=torch.tensor(int(np.asarray(opt_state.count)), dtype=torch.int32),
        mu=moments(opt_state.mu, 127), nu=moments(opt_state.nu, 255),
        hyperparams={"learning_rate": torch.tensor(
            np.float32(np.asarray(opt_state.hyperparams["learning_rate"])))})


def train_state_from_jax(state: Mapping[str, Any], cfg: ModelConfig, device=None):
    """A JAX training state (``init_train_state``'s dict after any steps,
    with a fused-Adam ``opt_state``) -> the port's training state on
    ``device``, CUDA unless the caller passes ``device="cpu"``: params, BN
    running statistics, the optimizer state (:func:`opt_state_from_jax`),
    the step count, and ``ema_params`` where the state keeps them."""
    from ..kernels import resolve_device
    from ..train.step import split_bn_state

    dev = resolve_device(device)
    params = state["params"]
    full = state_dict_from_jax({"backbone": params["backbone"],
                                "head": {**params["head"], "bn_state": state["bn_state"]}}, cfg)
    trainable, bn_state = split_bn_state(full)
    opt = opt_state_from_jax(state["opt_state"], params, cfg)
    to = lambda t: t.to(dev)  # noqa: E731
    out = {"params": {k: to(v) for k, v in trainable.items()},
           "opt_state": opt._replace(count=to(opt.count),
                                     mu=tree_map(to, opt.mu), nu=tree_map(to, opt.nu),
                                     hyperparams=tree_map(to, opt.hyperparams)),
           "bn_state": {k: to(v) for k, v in bn_state.items()},
           "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=dev)}
    if "ema_params" in state:
        out["ema_params"] = {k: to(v) for k, v in
                             state_dict_from_jax(state["ema_params"], cfg, bn_state=False).items()}
    return out
