"""Parallelism: data-parallel training over a process group, stream- and
batch-parallel serving over local devices, and tensor, expert and pipeline
parallelism (``mesh``, ``comm``, ``tp``, ``pp``)."""
