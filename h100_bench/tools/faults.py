"""Faults planted in the port under the harness, to show that ``correct``
catches them (the tests, and ``readings.py --fault`` for the readings at a
cell's own size).  Each is a context manager that patches one entry of the
port and restores it.

* ``pose_half``: the pose step poses the first half of its people; the
  rest read 0.
* ``pose_swap``: two slots' answers trade places where they are produced.
* ``pose_shift``: every keypoint moved 4 frame pixels right.
* ``train_unchanged``: the step returns its state unchanged.
* ``train_half``: the step takes half of the batch, the mean over it.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name, wrap):
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _pose_fault(edit):
    @contextlib.contextmanager
    def fault():
        import easy_vitpose_tpu_torch.pipeline.pose_step as ps

        def wrap(real):
            def step(model, frame, boxes, mask, **kw):
                return edit(real, model, frame, boxes, mask, **kw)
            return step

        with patched(ps, "pose_step", wrap):
            yield
    return fault


def _half(real, model, frame, boxes, mask, **kw):
    # the second half of the people the step is given (its valid slots)
    n = torch.cumsum(mask.int(), 0)
    return real(model, frame, boxes, mask & (2 * n <= n[-1]), **kw)


def _swap(real, model, frame, boxes, mask, **kw):
    kp = real(model, frame, boxes, mask, **kw)
    return torch.cat([kp[1:2], kp[0:1], kp[2:]])


def _shift(real, model, frame, boxes, mask, **kw):
    kp = real(model, frame, boxes, mask, **kw).clone()
    kp[..., 1] += 4.0 * mask[:, None].to(kp.dtype)
    return kp


@contextlib.contextmanager
def train_unchanged():
    import easy_vitpose_tpu_torch.train.step as tstep

    def wrap(real):
        def make(*a, **kw):
            step = real(*a, **kw)
            return lambda state, batch, g=None, m=None: (state, step(state, batch, g, m)[1])
        return make

    with patched(tstep, "make_train_step", wrap):
        yield


@contextlib.contextmanager
def train_half():
    import easy_vitpose_tpu_torch.train.step as tstep

    def wrap(real):
        def make(*a, **kw):
            step = real(*a, **kw)

            def run(state, batch, g=None, m=None):
                n = batch["images_u8"].shape[0] // 2
                return step(state, {k: v[:n] for k, v in batch.items()}, g, m[:, :n])
            return run
        return make

    with patched(tstep, "make_train_step", wrap):
        yield


FAULTS = {"pose_half": _pose_fault(_half), "pose_swap": _pose_fault(_swap),
          "pose_shift": _pose_fault(_shift), "train_unchanged": train_unchanged,
          "train_half": train_half}
