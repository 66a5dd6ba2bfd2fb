"""Pipeline parallelism for the ViT block stack: GPipe over a ``pipe`` group.

Port of ``easy_vitpose_tpu/parallel/pp.py``.  Stage p of P holds the
contiguous layers ``[p * depth / P, (p + 1) * depth / P)`` (a depth that P
does not divide raises).  Micro-batches flow stage to stage on JAX's
schedule of ``n_micro + P - 1`` ticks: at tick t stage p works micro-batch
``t - p``.  Where JAX moves the activations with ``lax.ppermute`` inside
``shard_map`` and lets autodiff reverse the ring, a stage here hands its
output to the next with a send inside an ``autograd.Function``
(``parallel/comm.py``), whose backward receives the gradient from that
stage; the receiving stage's backward sends it back.  Each message carries
its micro-batch as a tag, so the backward pipeline, which autograd runs in
reverse, meets its activations.

The last stage's output reaches every stage by a broadcast (JAX's
``psum`` of zeros and the last stage's rows): the embeddings and the last
norm are replicated and run on every stage, the tokens entering the
pipeline through :func:`..parallel.comm.copy_to_group`, so the
embeddings' gradient (which only stage 0 computes) is summed to every
stage.  Every stage therefore ends a backward with the whole gradient of
each replicated leaf and its own layers' gradients.  A backward must ask
every stage for the gradients of all its leaves (as a train step does):
the messages of the backward pipeline run where autograd reaches them.

The blocks are the plain block (``models/vit.py::block_train``), as JAX's
pipeline runs its XLA ``block``: this path launches none of the port's
kernels.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist

from ..configs import BackboneConfig
from ..models.vit import BLOCK_PARAMS, BlockWeights, block_train, embed, layer_norm
from . import comm
from .mesh import Mesh, local_device


def make_pipe_mesh(n_stages: Optional[int] = None, device=None, group=None) -> Mesh:
    """The ``pipe`` mesh over ``group`` (default: the world), this rank on
    ``device`` (default ``cuda:LOCAL_RANK``); ``n_stages``, if given, must
    be the group's size."""
    if group is None:
        if not dist.is_initialized():
            raise ValueError("a pipeline needs a process group")
        group = dist.group.WORLD
    mesh = Mesh("pipe", (local_device(device),), group)
    if n_stages is not None and n_stages != mesh.size:
        raise ValueError(f"the pipe group has {mesh.size} ranks, asked for {n_stages}")
    return mesh


def stage_layers(depth: int, mesh: Mesh) -> range:
    """The layers this stage holds."""
    P = mesh.size
    if depth % P:
        raise ValueError(f"depth {depth} not divisible by {P} stages")
    per = depth // P
    return range(mesh.rank * per, (mesh.rank + 1) * per)


def stage_params(params: Mapping[str, torch.Tensor], depth: int, mesh: Mesh) -> dict:
    """``params`` without the blocks of other stages, on this stage's
    device."""
    mine = {f"backbone.blocks.{i}." for i in stage_layers(depth, mesh)}
    return {k: v.to(mesh.device) for k, v in params.items()
            if not k.startswith("backbone.blocks.") or any(k.startswith(p) for p in mine)}


def pipeline_blocks(params: Mapping[str, torch.Tensor], tokens: torch.Tensor,
                    cfg: BackboneConfig, mesh: Mesh, n_micro: int) -> torch.Tensor:
    """The block stack as a P-stage GPipe over ``n_micro`` micro-batches:
    (B, N, D) tokens (the same on every stage) -> (B, N, D) on every stage.
    ``params`` holds this stage's blocks by state-dict name."""
    layers = stage_layers(cfg.depth, mesh)
    B = tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} micro-batches")
    P, p = mesh.size, mesh.rank
    ranks = comm.group_ranks(mesh.group)
    weights = [BlockWeights(*(params[f"backbone.blocks.{i}.{n}"] for n in BLOCK_PARAMS))
               for i in layers]
    micro = comm.copy_to_group(tokens, mesh.group).chunk(n_micro)
    outs, sends = [None] * n_micro, []
    for t in range(n_micro + P - 1):
        i = t - p                          # the micro-batch this stage works at tick t
        if not 0 <= i < n_micro:
            continue
        x = (micro[i] if p == 0 else
             comm.recv_from(micro[i].shape, tokens.dtype, ranks[p - 1], i, micro[i], mesh.group))
        for w in weights:
            x = block_train(x, w, cfg.num_heads, cfg.layer_norm_eps)
        if p == P - 1:
            outs[i] = x
        else:
            sends.append(comm.send_to(x, ranks[p + 1], i, mesh.group))
    if p == P - 1:
        out = torch.cat(outs)
    else:      # a placeholder the broadcast fills; the sends ride in its graph
        out = torch.zeros_like(tokens) + sum(sends).to(tokens.dtype)
    return comm.broadcast(out, ranks[P - 1], mesh.group)


def pipeline_vit_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                         cfg: BackboneConfig, mesh: Mesh, n_micro: int = 4) -> torch.Tensor:
    """The backbone with its block stack pipelined: (B, H, W, 3) NHWC ->
    (B, Hp, Wp, D) on every stage.  The embeddings and the last norm are
    replicated."""
    B = x.shape[0]
    tokens = embed(params, x, cfg, "backbone")
    tokens = pipeline_blocks(params, tokens, cfg, mesh, n_micro)
    tokens = layer_norm(tokens, params["backbone.last_norm.weight"],
                        params["backbone.last_norm.bias"], cfg.layer_norm_eps)
    Hp, Wp = cfg.patch_shape
    return tokens.reshape(B, Hp, Wp, cfg.embed_dim)
