"""Fused clip + Adam: one pass over each parameter leaf (K8).

Port of ``easy_vitpose_tpu/train/fused_opt.py`` at float32 moments:
``make_fused_adam(lr).init(params)`` and ``.fused_apply(grads, state,
params)`` over dicts of float32 tensors keyed by state-dict name.  The
update rule is optax's clip_by_global_norm -> adam (eps_root 0), with
optax's defaults b1 0.9, b2 0.999, eps 1e-8:

  s   = min(1, max_norm / (||g|| + 1e-16))
  mu' = b1*mu + (1-b1)*(s*g)
  nu' = b2*nu + ((1-b2)*(s*g))*(s*g)
  p'  = p - (lr * (mu'/(1-b1^t))) / (sqrt(nu'/(1-b2^t)) + eps)

The global norm, the clip scale and the bias corrections are float32
tensors on the device of the parameters (the norm is plain torch, as it is
XLA in JAX); they reach the kernel as a 4-float device buffer
``(s, lr, 1-b1^t, 1-b2^t)``, so a step never waits on the host.

K8 (``csrc/adam.cu``) replaces ``_adam_leaf_pallas``: it reads g, mu, nu and
p once and writes mu', nu' and p' once, 28 bytes per element, which is what
bounds it on the H100 (86M parameters of ViT-B: 2.4 GB, 0.72 ms at 3.35
TB/s).  On the card every leaf goes through it, whatever its length: the
Pallas kernel's >= 1M-element, %128 and %8 gate is a TPU tiling rule.  Its
plain version :func:`adam_leaf_plain` (``_adam_leaf_xla``) takes CPU leaves,
and the two agree bit for bit: the kernel rounds each operation where the
plain version does, with IEEE division and square root.

bf16 and int8 moments (K9) are not ported yet (ROADMAP.md, queue B).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from .. import kernels

KERNEL = "adam"
B1, B2, EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]


class FusedAdamState(NamedTuple):
    count: torch.Tensor        # int32 step counter
    mu: Tensors                # first moments, float32, like the params
    nu: Tensors                # second moments
    hyperparams: Dict[str, torch.Tensor]   # {"learning_rate": float32} of the last update


class FusedAdam(NamedTuple):
    init: Callable
    fused_apply: Callable


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: torch's vectorized CPU
    sqrt is not (it misses by one ulp in ~0.5% of values); the float64 root
    of a float32 value rounds to the IEEE float32 one."""
    return torch.sqrt(x.double()).float()


def adam_leaf_plain(g, mu, nu, p, scal):
    """Plain version of K8 (``_adam_leaf_xla``): -> (mu', nu', p')."""
    s, lr, c1, c2 = scal.unbind()
    gs = g.float() * s
    mu_n = B1 * mu + (1.0 - B1) * gs
    nu_n = B2 * nu + (1.0 - B2) * gs * gs
    p_n = p - lr * (mu_n / c1) / (sqrt_rn(nu_n / c2) + EPS)
    return mu_n, nu_n, p_n


def adam_leaf(g, mu, nu, p, scal):
    """K8 on one float32 leaf of any shape: CPU tensors take the plain
    version, CUDA tensors launch the kernel.  -> new (mu', nu', p')."""
    if p.device.type == "cpu":
        return adam_leaf_plain(g, mu, nu, p, scal)
    dev = kernels.require_cuda(g, mu, nu, p, scal)
    bad = [t.dtype for t in (g, mu, nu, p, scal) if t.dtype != torch.float32]
    if bad:
        raise ValueError(f"fused Adam takes float32 tensors, got {bad[0]}")
    # autograd may hand back a strided grad (e.g. through a permute)
    g, mu, nu, p = (t.contiguous() for t in (g, mu, nu, p))
    if not (g.shape == mu.shape == nu.shape == p.shape) or scal.numel() != 4:
        raise ValueError(f"leaf shapes {g.shape} {mu.shape} {nu.shape} {p.shape}, "
                         f"scalars {tuple(scal.shape)}")
    mu_o, nu_o, p_o = (torch.empty_like(p) for _ in range(3))
    kernels.call(KERNEL, "evt_adam", dev, g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                 p.data_ptr(), scal.data_ptr(), mu_o.data_ptr(), nu_o.data_ptr(),
                 p_o.data_ptr(), p.numel(), B1, 1.0 - B1, B2, 1.0 - B2, EPS)
    kernels.count_launch(KERNEL)
    return mu_o, nu_o, p_o


def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def make_fused_adam(learning_rate: float, max_grad_norm: float = 1.0,
                    moment_dtype: str = "f32") -> FusedAdam:
    """The fused clip + Adam optimizer at a learning rate that
    :func:`..train.step.set_learning_rate` may change between steps.  Only
    float32 moments are ported."""
    if moment_dtype in ("bf16", "int8"):
        raise NotImplementedError(f"{moment_dtype} Adam moments are not ported yet "
                                  "(ROADMAP.md queue B, K9)")
    if moment_dtype != "f32":
        raise ValueError(f"moment_dtype must be 'f32', 'bf16' or 'int8', got {moment_dtype!r}")

    def init(params: Tensors) -> FusedAdamState:
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros(), nu=zeros(),
            hyperparams={"learning_rate": torch.tensor(learning_rate, dtype=torch.float32, device=dev)})

    def fused_apply(grads: Tensors, state: FusedAdamState, params: Tensors):
        """-> (new params, new state, global norm)."""
        gnorm = global_norm(grads)
        ratio = torch.full_like(gnorm, max_grad_norm) / (gnorm + 1e-16)
        s = torch.minimum(torch.ones_like(ratio), ratio)
        count = state.count + 1
        cf = count.float()
        c1 = 1.0 - torch.pow(torch.full_like(cf, B1), cf)
        c2 = 1.0 - torch.pow(torch.full_like(cf, B2), cf)
        lr = state.hyperparams["learning_rate"]
        scal = torch.stack([s, lr, c1, c2]).float()
        mu, nu, new = {}, {}, {}
        for k, p in params.items():
            mu[k], nu[k], new[k] = adam_leaf(grads[k], state.mu[k], state.nu[k], p, scal)
        return new, FusedAdamState(count, mu, nu, {"learning_rate": lr}), gnorm

    return FusedAdam(init=init, fused_apply=fused_apply)
