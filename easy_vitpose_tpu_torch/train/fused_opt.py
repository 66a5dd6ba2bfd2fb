"""Fused clip + Adam: one pass over each parameter leaf (K8, K9).

Port of ``easy_vitpose_tpu/train/fused_opt.py``:
``make_fused_adam(lr, max_grad_norm, moment_dtype).init(params)``
and ``.fused_apply(grads, state, params)`` over dicts of float32 tensors
keyed by state-dict name.  The update rule is optax's clip_by_global_norm ->
adam (eps_root 0), with optax's defaults b1 0.9, b2 0.999, eps 1e-8 as
constants (the reference's callers pass no others):

  s   = min(1, max_norm / (||g|| + 1e-16))
  mu' = b1*mu + (1-b1)*(s*g)
  nu' = b2*nu + ((1-b2)*(s*g))*(s*g)
  p'  = p - (lr * (mu'/(1-b1^t))) / (sqrt(nu'/(1-b2^t)) + eps)

The global norm, the clip scale and the bias corrections are float32
tensors on the device of the parameters (the norm is plain torch, as it is
XLA in JAX); they reach the kernels as a 4-float device buffer
``(s, lr, 1-b1^t, 1-b2^t)``, so a step never waits on the host.

The moments are stored at ``moment_dtype``:

* ``"f32"``: K8 (``csrc/adam.cu``) replaces ``_adam_leaf_pallas``: it reads
  g, mu, nu and p once and writes mu', nu' and p' once, 28 bytes per
  element, which is what bounds it on the H100 (86M parameters of ViT-B:
  2.4 GB, 0.72 ms at 3.35 TB/s).
* ``"bf16"``: the moments are cast to bfloat16 between steps and the update
  runs in float32, in plain torch (JAX has no kernel for it either).
* ``"int8"``: blockwise geometric 8-bit moments (:func:`q8_encode`): per
  block of 2048 elements one float32 absmax scale and a log-spaced code,
  mu signed with 127 levels, sqrt(nu) unsigned with 255, bounding the
  decode error at ~5.6% and ~2.8% relative.  K9 (``csrc/adam_q8.cu``)
  replaces ``_adam_leaf_pallas_q8``: decode, update, re-encode in one pass,
  16 bytes per element (ViT-L's 308M parameters: 4.9 GB, 1.47 ms).  The
  state is ``{"q_tree": {name: codes}, "s_tree": {name: scales}}`` for each
  moment, as JAX's.  The port codes its own leaves: each leaf flattened in
  torch's (out, in) layout and padded with zeros to whole blocks, where JAX
  codes its depth-stacked (in, out) leaves; the same moments are so grouped
  into other blocks with other scales (ROADMAP.md queue C 9).

On the card every leaf goes through its kernel, whatever its length: the
Pallas kernels' gates (>= 1M elements, K8's %128 and %8, K9's nb % 32) are
TPU tiling rules.  The plain versions :func:`adam_leaf_plain`
(``_adam_leaf_xla``) and :func:`adam_leaf_q8_plain` (the Pallas body, step
by step) take CPU leaves, and each kernel agrees with its plain version bit
for bit: it rounds each operation where the plain version does, with IEEE
division and square root.  JAX's codec divides by its constants, which XLA
folds into a multiply by the float32 reciprocal; the port multiplies by the
same reciprocals.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels

KERNEL, KERNEL_Q8 = "adam", "adam_q8"
MOMENT_DTYPES = ("f32", "bf16", "int8")
B1, B2, EPS = 0.9, 0.999, 1e-8
Tensors = Dict[str, torch.Tensor]

# the int8 codec (``_q8_encode`` / ``_q8_decode``), every constant a float32
Q8_BLOCK = 2048
Q8_LN_EPS = float(np.float32(np.log(1e-6)))     # magnitudes under 1e-6 * absmax code to 0
Q8_INV_LN_EPS = float(np.float32(1) / np.float32(Q8_LN_EPS))
Q8_TINY, Q8_ZERO_BELOW = float(np.float32(1e-30)), float(np.float32(1e-6))


def q8_inv_steps(levels: int) -> float:
    """float32 1 / (levels - 1), XLA's reciprocal of the codec's divisor."""
    return float(np.float32(1) / np.float32(levels - 1))


class FusedAdamState(NamedTuple):
    count: torch.Tensor        # int32 step counter
    mu: dict                   # first moments: {name: tensor}, or int8 {"q_tree", "s_tree"}
    nu: dict                   # second moments, likewise (int8: sqrt(nu), unsigned codes)
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


# --------------------------------------------------------------- int8 codec
def q8_blocks(n: int) -> int:
    return -(-n // Q8_BLOCK)


def _pad_blocks(x: torch.Tensor, nb: int) -> torch.Tensor:
    """``x`` flattened to float32 and padded with zeros to (nb, 2048)."""
    return F.pad(x.float().reshape(-1), (0, nb * Q8_BLOCK - x.numel())).reshape(nb, Q8_BLOCK)


def _q8_levels(r: torch.Tensor, levels: int) -> torch.Tensor:
    """The code level (float32, 0..levels) of magnitudes ``r = |x| / absmax``."""
    t = torch.log(r.clamp_min(Q8_TINY)) * Q8_INV_LN_EPS
    idx = (1.0 + torch.round((1.0 - t) * float(levels - 1))).clamp(1.0, float(levels))
    return torch.where(r < Q8_ZERO_BELOW, 0.0, idx)


def _q8_values(mag: torch.Tensor, levels: int) -> torch.Tensor:
    """The magnitude (relative to absmax) of code level ``mag`` >= 1."""
    return torch.exp(Q8_LN_EPS * (1.0 - (mag - 1.0) * q8_inv_steps(levels)))


def q8_encode(x: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_q8_encode``: flatten, pad with zeros to whole blocks, code each
    magnitude on the geometric map -> (codes (nb*2048,), scales (nb, 1)
    float32).  ``levels`` 127: signed int8 codes; 255: unsigned uint8."""
    xf = _pad_blocks(x, q8_blocks(x.numel()))
    absx = xf.abs()
    scale = absx.amax(1, keepdim=True)
    idx = _q8_levels(absx / scale.clamp_min(Q8_TINY), levels)
    if levels == 127:
        return (torch.sign(xf) * idx).to(torch.int8).reshape(-1), scale
    return idx.to(torch.uint8).reshape(-1), scale


def q8_decode(codes: torch.Tensor, scale: torch.Tensor, levels: int, shape) -> torch.Tensor:
    """``_q8_decode``: the inverse of :func:`q8_encode` -> float32 of ``shape``."""
    cf = codes.float().reshape(-1, Q8_BLOCK)
    mag = cf.abs()
    x = torch.where(mag < 0.5, 0.0, torch.sign(cf) * _q8_values(mag, levels) * scale)
    return x.reshape(-1)[:int(np.prod(shape, dtype=np.int64))].reshape(shape)


def adam_leaf_q8_plain(g, mq, ms, nq, ns, p, scal):
    """Plain version of K9, the Pallas body of ``_adam_leaf_pallas_q8``
    operation by operation on any leaf length (g and p padded with zeros to
    whole blocks): decode, clip + Adam with mu' and nu' before they are
    coded, re-encode.  -> (mu codes, mu scales, nu codes, nu scales, p')."""
    s, lr, c1, c2 = scal.unbind()
    n = p.numel()
    nb = q8_blocks(n)
    mqf = mq.float().reshape(nb, Q8_BLOCK)
    mag = mqf.abs()
    mu = torch.where(mag < 0.5, 0.0, torch.sign(mqf) * _q8_values(mag, 127) * ms)
    nqf = nq.float().reshape(nb, Q8_BLOCK)   # JAX's int8 bitcast and +256 give these values
    vs = torch.where(nqf < 0.5, 0.0, _q8_values(nqf, 255) * ns)
    gs = _pad_blocks(g, nb) * s
    mu_n = B1 * mu + (1.0 - B1) * gs
    nu_n = B2 * (vs * vs) + (1.0 - B2) * gs * gs
    p_n = _pad_blocks(p, nb) - lr * (mu_n / c1) / (sqrt_rn(nu_n / c2) + EPS)
    am = mu_n.abs().amax(1, keepdim=True)
    idx = _q8_levels(mu_n.abs() / am.clamp_min(Q8_TINY), 127)
    mq_n = (torch.sign(mu_n) * idx).to(torch.int8).reshape(-1)
    vs_n = sqrt_rn(nu_n)
    an = vs_n.amax(1, keepdim=True)
    idxn = _q8_levels(vs_n / an.clamp_min(Q8_TINY), 255)
    wrapped = torch.where(idxn > 127.5, idxn - 256.0, idxn)          # the uint8 wrap
    nq_n = wrapped.to(torch.int8).view(torch.uint8).reshape(-1)
    return mq_n, am, nq_n, an, p_n.reshape(-1)[:n].reshape(p.shape)


def adam_leaf_q8(g, mq, ms, nq, ns, p, scal):
    """K9 on one float32 leaf of any shape: CPU tensors take the plain
    version, CUDA tensors launch the kernel.  -> (mu codes, mu scales, nu
    codes, nu scales, p')."""
    if p.device.type == "cpu":
        return adam_leaf_q8_plain(g, mq, ms, nq, ns, p, scal)
    dev = kernels.require_cuda(g, mq, ms, nq, ns, p, scal)
    n, nb = p.numel(), q8_blocks(p.numel())
    want = ((g, torch.float32, n), (p, torch.float32, n), (mq, torch.int8, nb * Q8_BLOCK),
            (nq, torch.uint8, nb * Q8_BLOCK), (ms, torch.float32, nb), (ns, torch.float32, nb),
            (scal, torch.float32, 4))
    for t, dt, size in want:
        if t.dtype != dt or t.numel() != size:
            raise ValueError(f"int8 Adam leaf of {n}: got {t.dtype} x {t.numel()}, "
                             f"expected {dt} x {size}")
    g, mq, ms, nq, ns, p = (t.contiguous() for t in (g, mq, ms, nq, ns, p))
    p_o, mq_o, nq_o = torch.empty_like(p), torch.empty_like(mq), torch.empty_like(nq)
    ms_o, ns_o = torch.empty_like(ms), torch.empty_like(ns)
    kernels.call(KERNEL_Q8, "evt_adam_q8", dev, g.data_ptr(), p.data_ptr(), mq.data_ptr(),
                 ms.data_ptr(), nq.data_ptr(), ns.data_ptr(), scal.data_ptr(), p_o.data_ptr(),
                 mq_o.data_ptr(), ms_o.data_ptr(), nq_o.data_ptr(), ns_o.data_ptr(), n,
                 B1, 1.0 - B1, B2, 1.0 - B2, EPS, Q8_LN_EPS, Q8_INV_LN_EPS, q8_inv_steps(127),
                 q8_inv_steps(255), Q8_TINY, Q8_ZERO_BELOW)
    kernels.count_launch(KERNEL_Q8)
    return mq_o, ms_o, nq_o, ns_o, p_o


def moment_bytes(state: FusedAdamState) -> int:
    """Device bytes of the two moments (codes and scales for int8)."""
    def tensors(tree):
        for v in tree.values():
            yield from (tensors(v) if isinstance(v, dict) else (v,))
    return sum(t.numel() * t.element_size() for m in (state.mu, state.nu) for t in tensors(m))


# ---------------------------------------------------------------- optimizer
def global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def make_fused_adam(learning_rate: float, max_grad_norm: float = 1.0,
                    moment_dtype: str = "f32") -> FusedAdam:
    """The fused clip + Adam optimizer at a learning rate that
    :func:`..train.step.set_learning_rate` may change between steps, with
    moments stored at ``moment_dtype`` ("f32", "bf16" or "int8")."""
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {MOMENT_DTYPES}, got {moment_dtype!r}")

    def zeros_q8(params: Tensors, dt) -> dict:
        return {"q_tree": {k: torch.zeros(q8_blocks(v.numel()) * Q8_BLOCK, dtype=dt,
                                          device=v.device) for k, v in params.items()},
                "s_tree": {k: torch.zeros((q8_blocks(v.numel()), 1), dtype=torch.float32,
                                          device=v.device) for k, v in params.items()}}

    def init(params: Tensors) -> FusedAdamState:
        dev = next(iter(params.values())).device
        if moment_dtype == "int8":
            mu, nu = zeros_q8(params, torch.int8), zeros_q8(params, torch.uint8)
        else:
            dt = torch.bfloat16 if moment_dtype == "bf16" else torch.float32
            mu, nu = ({k: torch.zeros_like(v, dtype=dt) for k, v in params.items()}
                      for _ in range(2))
        return FusedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev), mu=mu, nu=nu,
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
        new = {}
        if moment_dtype == "int8":
            mu, nu = ({"q_tree": {}, "s_tree": {}} for _ in range(2))
            for k, p in params.items():
                (mu["q_tree"][k], mu["s_tree"][k], nu["q_tree"][k], nu["s_tree"][k],
                 new[k]) = adam_leaf_q8(grads[k], state.mu["q_tree"][k], state.mu["s_tree"][k],
                                        state.nu["q_tree"][k], state.nu["s_tree"][k], p, scal)
        else:
            mu, nu = {}, {}
            for k, p in params.items():
                if moment_dtype == "bf16":
                    m, v, new[k] = adam_leaf_plain(grads[k], state.mu[k].float(),
                                                   state.nu[k].float(), p, scal)
                    mu[k], nu[k] = m.to(torch.bfloat16), v.to(torch.bfloat16)
                else:
                    mu[k], nu[k], new[k] = adam_leaf(grads[k], state.mu[k], state.nu[k], p,
                                                     scal)
        return new, FusedAdamState(count, mu, nu, {"learning_rate": lr}), gnorm

    return FusedAdam(init=init, fused_apply=fused_apply)
