"""PyTorch + CUDA port of easy_vitpose_tpu for NVIDIA Hopper (H100).

The JAX package ``easy_vitpose_tpu`` is the reference; this package imports
nothing of it and nothing of JAX.  Its layout mirrors the JAX package
(``configs``, ``ops``, ``models``, ``pipeline``, ``convert``); the
hand-written CUDA kernels live in ``csrc/`` and are built and bound by
``kernels``.  Entry points run on CUDA unless the caller asks for the CPU,
where each kernel's wrapper takes its plain PyTorch version.

The public API is the reference's one symbol, ``VitInference``
(``from easy_vitpose_tpu_torch import VitInference``), resolved on first
use so that importing the package loads no model code and touches no
device.
"""
from .version import __version__

__all__ = ["VitInference", "__version__"]


def __getattr__(name):
    if name == "VitInference":
        from .pipeline.inference import VitInference
        return VitInference
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
