"""One CUDA graph per program that JAX jits on the serving paths.

JAX runs a detection frame as one jitted XLA program (``detect_pose_jit``,
``detect_pose_multi_jit``, ``detect_frame_jit``, ``detect_batch_jit``) and
the host dispatches it once.  Eagerly, the same frame is hundreds of
launches that the host issues one by one (YOLOv8n/320 alone is about 300),
and the host, not the card, sets the pace.  The port's counterpart of one
jitted program is one CUDA graph replay: :class:`GraphCache` captures a
program the first time it sees a key (the frame shape, the stack size, the
slot count, the dtypes: what JAX's jit would retrace on), after one eager
warm-up call that builds the kernels and fills the per-device constant
caches, and replays it from then on.  Every graph of a cache shares one
memory pool.

Capture and replay run with ``torch.cuda.set_sync_debug_mode("error")``: a
program that made the host wait could not be captured, and a replay must
not make it wait either.  A replay copies its inputs into the graph's
static buffers on the card and returns clones of the graph's outputs, so
the next replay cannot overwrite a result the caller has not fetched yet
(pipelined ticks queue tick t before they fetch tick t-1).

The kernels' launch counters fire when a wrapper is called, which during a
capture records a launch and runs nothing; so the cache takes back the
counts a capture made and adds them again at every replay, when the
captured kernels do run.

Only the card takes graphs: ``plain=True`` and the CPU run the same
programs eagerly, and the eager programs stay callable directly
(``pipeline/fused_detect.py::detect_pose`` etc.), which is what the checks
compare a replay with.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Hashable, Sequence, Tuple, Union

import torch

from .. import kernels

Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


@contextlib.contextmanager
def no_host_sync():
    """PyTorch's synchronisation check set to raise, restored after."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class _Graph:
    """One captured program: static inputs, static outputs, and the kernel
    launches it makes per replay."""

    def __init__(self, fn: Callable[..., Outputs], inputs: Sequence[torch.Tensor], pool):
        self.inputs = [x.clone() for x in inputs]
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        torch.cuda.synchronize()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            with no_host_sync():
                out = fn(*self.inputs)
        after = kernels.launch_counts()
        self.launches = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)

    def replay(self, inputs: Sequence[torch.Tensor]) -> Outputs:
        with no_host_sync():
            for static, x in zip(self.inputs, inputs):
                static.copy_(x)
            self.graph.replay()
            out = tuple(o.clone() for o in self.outputs)
        kernels.add_launch_counts(self.launches)
        return out[0] if self.single else out


class GraphCache:
    """CUDA graphs of programs keyed by what their shapes depend on, in one
    shared memory pool.  ``run(key, fn, *inputs)`` returns ``fn(*inputs)``:
    on a key's first call from an eager warm-up call followed by a capture,
    afterwards from a replay.  ``inputs`` are CUDA tensors whose shapes and
    dtypes the key determines; ``fn`` returns a tensor or a tuple of them
    and makes the host wait for nothing."""

    def __init__(self):
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, fn: Callable[..., Outputs], *inputs: torch.Tensor) -> Outputs:
        g = self._graphs.get(key)
        if g is None:
            out = fn(*inputs)                        # the eager warm-up
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._graphs[key] = _Graph(fn, inputs, self._pool)
            return out
        return g.replay(inputs)

    def launches(self, key: Hashable) -> Dict[str, int]:
        """The kernel launches one replay of ``key``'s graph makes."""
        return dict(self._graphs[key].launches)
