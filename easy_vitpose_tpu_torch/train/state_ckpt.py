"""Full training-state checkpoints with ``torch.save``.

The port's counterpart of ``easy_vitpose_tpu/train/orbax_ckpt.py`` (orbax
is JAX's): the complete train state (params, optimizer moments and count,
learning rate, BN statistics, step, EMA weights) so an interrupted run
resumes exactly.  ``path`` is a directory, as orbax's, holding one
``state.pt`` that is written to a temporary file and renamed into place.

``torch.load`` reads with ``weights_only=True``, which takes plain
containers of tensors and no other class, so the file holds plain dicts:
the optimizer state is ``{"kind", "count", "mu", "nu", "hyperparams"}``
with each moment a dict of per-leaf tensors (int8 moments as their
``q_tree`` of codes and ``s_tree`` of scales).  :func:`restore_train_state`
copies the file's tensors into a template's (a freshly initialized state)
in place, on the template's device, so the state keeps the template's
layout.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from .fused_opt import FusedAdamState
from .step import AdamState

FILE = "state.pt"
_KINDS = {"fused_adam": FusedAdamState, "adam": AdamState}


def _host(tree):
    """Nested dicts of tensors -> the same of compact CPU copies (a view of
    a flat buffer is saved as its own elements, not the whole buffer)."""
    if isinstance(tree, Mapping):
        return {k: _host(v) for k, v in tree.items()}
    return torch.empty_like(tree, device="cpu").copy_(tree)


def _kind(opt) -> str:
    return "fused_adam" if isinstance(opt, FusedAdamState) else "adam"


def host_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A train state as plain dicts of CPU tensors, the snapshot
    :func:`save_train_state` writes (the caller may write it on another
    thread while the next steps run)."""
    out = {k: _host(v) for k, v in state.items() if k != "opt_state"}
    opt = state["opt_state"]
    out["opt_state"] = {**_host(opt._asdict()), "kind": _kind(opt)}
    return out


def save_train_state(path: str, state: Mapping[str, Any]) -> None:
    """Write the full train state (or its :func:`host_state`) to the
    directory ``path``."""
    if not (isinstance(state.get("opt_state"), Mapping) and "kind" in state["opt_state"]):
        state = host_state(state)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, FILE + ".tmp")
    torch.save(dict(state), tmp)
    os.replace(tmp, os.path.join(path, FILE))


def _fill(tmpl, saved, where: str):
    """Copy ``saved`` into the template's tensors, checking the structure."""
    if isinstance(tmpl, Mapping):
        if not isinstance(saved, Mapping) or set(tmpl) != set(saved):
            have = set(saved) if isinstance(saved, Mapping) else set()
            raise ValueError(f"train state structure mismatch at {where or 'the root'}: "
                             f"missing {sorted(set(tmpl) - have)}, "
                             f"unexpected {sorted(have - set(tmpl))}")
        return {k: _fill(tmpl[k], saved[k], f"{where}/{k}") for k in tmpl}
    if not isinstance(saved, torch.Tensor) or saved.shape != tmpl.shape \
            or saved.dtype != tmpl.dtype:
        raise ValueError(f"train state leaf {where}: saved "
                         f"{getattr(saved, 'dtype', type(saved))} "
                         f"{tuple(getattr(saved, 'shape', ()))}, expected {tmpl.dtype} "
                         f"{tuple(tmpl.shape)}")
    return tmpl.copy_(saved)


def restore_train_state(path: str, template: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Read the train state in the directory ``path``.  With ``template``
    (a freshly initialized state), the file's tensors are copied into
    tensors like the template's, on its device, and a structure that
    differs raises ``ValueError`` naming the keys (a template with
    ``ema_params`` and a checkpoint without them: ``ema_params``).
    Without one, the state comes back on the CPU."""
    saved = torch.load(os.path.join(path, FILE), map_location="cpu", weights_only=True)
    if template is None:
        out = dict(saved)
        opt = dict(out["opt_state"])
        out["opt_state"] = _KINDS[opt.pop("kind")](**opt)
        return out
    tmpl = dict(template)
    opt = tmpl["opt_state"]
    kind = saved.get("opt_state", {}).get("kind")
    if kind != _kind(opt):
        raise ValueError(f"train state optimizer mismatch: the checkpoint holds {kind!r}, "
                         f"the template {_kind(opt)!r}")
    tmpl["opt_state"] = opt._asdict()
    sv = dict(saved)
    sv["opt_state"] = {k: v for k, v in saved["opt_state"].items() if k != "kind"}
    with torch.no_grad():
        out = _fill(tmpl, sv, "")
    out["opt_state"] = type(opt)(**out["opt_state"])
    return out
