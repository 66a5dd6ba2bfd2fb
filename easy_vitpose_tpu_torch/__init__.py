"""PyTorch + CUDA port of easy_vitpose_tpu for NVIDIA Hopper (H100).

The JAX package ``easy_vitpose_tpu`` is the reference; this package imports
nothing of it and nothing of JAX.  Its layout mirrors the JAX package
(``configs``, ``ops``, ``models``, ``pipeline``, ``convert``); the
hand-written CUDA kernels live in ``csrc/`` and are built and bound by
``kernels``.  Entry points run on CUDA unless the caller asks for the CPU,
where each kernel's wrapper takes its plain PyTorch version.
"""
