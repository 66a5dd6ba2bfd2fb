"""Fault-tolerant training wrapper (beyond the reference).

The port's counterpart of ``easy_vitpose_tpu/train/resilient.py``.  The
reference has no failure detection or elastic recovery (SURVEY.md §5:
"Failure detection: none" — training dies on error and the only
resilience is best-ckpt retention).  Here, exact resume from the full train
state (train/state_ckpt.py) makes auto-recovery cheap: run the epoch loop,
and on a *transient* failure (preemption, a lost connection, a worker
killed for memory) restore the newest saved full train state — optimizer
moments, LR-schedule count, BN stats, epoch position — and continue.

Deliberately NOT retried:
* ``FloatingPointError`` — the loop's NaN fail-loud signal: a diverged
  step poisons the optimizer state; restarting from the same state with
  the same data would diverge again.  Fix LR/data instead.
* ``KeyboardInterrupt`` — the user meant it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

from .dataset import CocoPoseDataset
from .loop import TrainSettings, _as_state_dict, train_model


def train_model_resilient(params, cfg, train_ds: CocoPoseDataset,
                          val_ds: Optional[CocoPoseDataset],
                          settings: TrainSettings,
                          log: Callable[[str], None] = print,
                          max_restarts: int = 3, device=None) -> Dict:
    """train_model with automatic resume-on-failure.

    Forces ``save_full_state`` on (the full state every ``save_interval``
    epochs under ``work_dir/train_state``); on a transient exception,
    restores from that state and re-enters the loop at the epoch derived
    from the restored step count.  Gives up after ``max_restarts``
    consecutive failed attempts (a failure that survives a clean restart
    is not transient).
    """
    # host snapshot of the starting weights: every attempt starts from it,
    # whatever an attempt did to the tensors it was given
    params = {k: v.detach().to("cpu", copy=True) for k, v in _as_state_dict(params).items()}

    settings = dataclasses.replace(settings, save_full_state=True,
                                   save_interval=max(settings.save_interval,
                                                     1))
    state_dir = os.path.join(settings.work_dir, "train_state")

    def ckpt_mtime():
        try:
            return max(os.path.getmtime(os.path.join(r, f))
                       for r, _, fs in os.walk(state_dir) for f in fs)
        except ValueError:
            return None

    restarts = 0
    last_seen = ckpt_mtime()
    while True:
        try:
            return train_model(params, cfg, train_ds, val_ds, settings,
                               log=log, device=device)
        except (FloatingPointError, KeyboardInterrupt):
            raise
        except Exception as e:  # transient: preemption/connection/worker death
            now = ckpt_mtime()
            if now is not None and (last_seen is None or now > last_seen):
                restarts = 0  # checkpoint advanced since last failure
            last_seen = now
            restarts += 1
            if restarts > max_restarts:
                log(f"!! giving up after {max_restarts} consecutive "
                    f"no-progress restarts: {e!r}")
                raise
            if now is None:
                log(f"!! failed before the first checkpoint ({e!r}); "
                    f"restarting from scratch "
                    f"({restarts}/{max_restarts})")
                continue
            log(f"!! transient failure ({e!r}); resuming from {state_dir} "
                f"({restarts}/{max_restarts})")
            settings = dataclasses.replace(settings,
                                           resume_state_dir=state_dir)
