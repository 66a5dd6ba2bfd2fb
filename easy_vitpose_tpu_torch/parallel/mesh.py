"""Device meshes: a process group for training, local devices for serving.

Port of ``easy_vitpose_tpu/parallel/mesh.py``.  JAX lays one
``jax.sharding.Mesh`` over its devices and lets XLA place the collectives;
PyTorch's idiom is a process per GPU for training and, within one process,
a model replica per device for serving.  One small :class:`Mesh` covers
JAX's two uses:

* the ``data`` axis (and the ``model`` and ``pipe`` axes of ``tp.py`` and
  ``pp.py``): a process group, one device per rank.  Collectives are
  NCCL's on CUDA and gloo's where the mesh is explicitly on the CPU;
* the ``batch`` axis: a list of local devices in this process, each
  holding a replica (stream-parallel serving, data-parallel evaluation).
  Entries may name one device more than once.

JAX's ``replicated`` and ``batch_sharded`` shardings have no torch
meaning: a mesh's :meth:`Mesh.shard` and :func:`replicate` do what
``device_put`` with them does, so both fold into :class:`Mesh`.

Multi-process: :func:`initialize_distributed` first (``torchrun`` sets
its variables; a ``tcp://`` or ``file://`` address works too), then
:func:`make_mesh`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import resolve_device
from . import comm


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh.  ``devices`` are the local devices: this rank's one for a
    process-group axis, one per shard for ``batch``.  ``group`` is the
    process group of a process-group axis (None for ``batch``, and for a
    single process without a group)."""
    axis: str
    devices: Tuple[torch.device, ...]
    group: Any = None

    @property
    def device(self) -> torch.device:
        """This process's (first) device."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """The number of shards along the axis."""
        return comm.world(self.group) if self.group is not None else len(self.devices)

    @property
    def rank(self) -> int:
        """This process's index along a process-group axis (0 otherwise)."""
        return comm.rank(self.group)

    def shard(self, n: int, i: int) -> slice:
        """The rows of shard ``i`` of ``n`` rows, in order."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over the mesh's {self.size} shards")
        per = n // self.size
        return slice(per * i, per * (i + 1))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device=None,
                           backend: Optional[str] = None) -> None:
    """Join the process group (a no-op for one process).

    The counts default to ``torchrun``'s ``WORLD_SIZE`` and ``RANK``, the
    address to its ``env://`` rendezvous; ``coordinator_address`` is
    ``host:port`` (``tcp://``) or a ``tcp://``/``file://`` URL.  The backend
    is NCCL for a CUDA ``device`` (the default, which raises without a
    card) and gloo only for an explicit CPU device, unless ``backend`` is
    named."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)


def local_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:LOCAL_RANK``
    (raises without a card)."""
    if device is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")          # raises with the port's message
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(device)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """A 1-D mesh.

    ``axis="batch"``: over ``devices`` (default: every local CUDA device,
    the first ``n_devices`` of them; raises without a card).
    Other axes: over the world's process group when one is initialized,
    else this process alone, with this rank on ``device`` (default
    ``cuda:LOCAL_RANK``); ``n_devices``, if given, must be the group's
    size.  ``parallel/tp.py`` and ``parallel/pp.py`` make their subgroups'
    meshes."""
    if axis == "batch":
        if devices is None:
            if not torch.cuda.is_available():
                resolve_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = tuple(resolve_device(d) for d in devices)
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"need {n_devices} devices, have {len(devs)}")
            devs = devs[:n_devices]
        return Mesh(axis, devs)
    group = dist.group.WORLD if dist.is_initialized() else None
    mesh = Mesh(axis, (local_device(device),), group)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a {axis!r} mesh spans its process group: {mesh.size} ranks, "
                         f"asked for {n_devices}")
    return mesh


def _to(v, device: torch.device) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.ascontiguousarray(v))
    return v.to(device)


def shard_batch(mesh: Mesh, tree):
    """A host batch's rows on the mesh (JAX's ``shard_batch``): on a
    process-group axis, this rank's rows on its device; on ``batch``, a
    list of each device's rows on it, in the devices' order.  ``meta``
    entries (per-row lists) are sliced too."""
    n = len(next(iter(tree.values())))

    def rows(sl, dev):
        return {k: (v[sl] if k == "meta" else _to(v[sl], dev)) for k, v in tree.items()}

    if mesh.axis == "batch":
        return [rows(mesh.shard(n, i), d) for i, d in enumerate(mesh.devices)]
    return rows(mesh.shard(n, mesh.rank), mesh.device)


def replicate(mesh: Mesh, tree):
    """A tree of tensors everywhere on the mesh (JAX's ``replicate``): on a
    process-group axis rank 0's values broadcast into this rank's tensors
    on its device (collectives in place, one per tensor); on ``batch``, a
    list of copies, one per device (a device named twice shares one)."""
    if mesh.axis == "batch":
        copies = {}
        for d in mesh.devices:
            if d not in copies:
                copies[d] = _map(tree, lambda t: _to(t, d))
        return [copies[d] for d in mesh.devices]
    out = _map(tree, lambda t: _to(t, mesh.device).clone())
    if mesh.group is not None:
        src = comm.group_ranks(mesh.group)[0]
        _map(out, lambda t: dist.broadcast(t, src, group=mesh.group))
    return out


def _map(tree, fn):
    """``fn`` over the tensors and arrays of nested dicts, lists, tuples
    and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def is_main_process() -> bool:
    """Rank 0, or no process group (the reference's ``master_only``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> slice:
    """This process's rows of a global batch (the reference's
    ``DistributedSampler`` role): ``global_batch // size`` rows from
    ``per * rank``, as JAX's slice over its processes; over ``mesh``'s group,
    else the world's."""
    if mesh is not None:
        size, r = mesh.size, mesh.rank
    elif dist.is_initialized():
        size, r = dist.get_world_size(), dist.get_rank()
    else:
        size, r = 1, 0
    per = global_batch // size
    return slice(per * r, per * (r + 1))
