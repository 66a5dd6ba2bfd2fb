"""Training presets — typed equivalents of the reference's
configs/train_configs/*.py recipes.

The port's own copy of ``easy_vitpose_tpu/train/presets.py``:

* ``from_scratch(size)``: 210-epoch AdamW layer-decay recipe
  (reference train_configs/ViTPose_base_coco_256x192.py:7-31 and the l/h
  variants; ``make_adamw_layer_decay_optimizer``).
* ``finetune(size)``: the *_custom recipe — Adam 3.75e-4 +
  ReduceLROnPlateau, save_interval/early stop
  (reference train_configs/ViTPose_large_coco_256x192_custom.py:7-21).
"""
from __future__ import annotations

from .loop import TrainSettings

# layer-decay rates per size (reference train_configs: b 0.75, l 0.8, h 0.85
# in the upstream recipes; the reference repo pins 1-2e-4 in common.py which
# is the finetune-ish variant — we expose both)
LAYER_DECAY = {"s": 0.75, "b": 0.75, "l": 0.8, "h": 0.85}
DEPTHS = {"s": 12, "b": 12, "l": 24, "h": 32}


def finetune(size: str = "b", **overrides) -> TrainSettings:
    """The reference's custom finetune recipe (Adam + plateau scheduler)."""
    base = dict(lr=3.75e-4, total_epochs=210, batch_size=64, use_amp=True,
                lr_factor=0.1, lr_patience=4, save_interval=10,
                early_stop_patience=15)
    base.update(overrides)
    return TrainSettings(**base)


def from_scratch(size: str = "b", **overrides) -> TrainSettings:
    """The reference's full 210-epoch from-scratch recipe
    (train_configs/ViTPose_base_coco_256x192.py:7-29 and l/h variants):
    AdamW lr=5e-4 wd=0.1 + per-layer decay + grad clip 1.0, LR policy
    'step' with linear warmup (500 iters from ratio 1e-3) and x0.1
    milestones at epochs [170, 200].  train_model builds
    make_adamw_layer_decay_optimizer(make_step_lr_schedule(...)) from
    these settings."""
    base = dict(lr=5e-4, total_epochs=210, batch_size=64, use_amp=True,
                optimizer="adamw_layer_decay", lr_policy="step",
                lr_milestones=(170, 200), lr_gamma=0.1,
                warmup_iters=500, warmup_ratio=1e-3,
                weight_decay=0.1, layer_decay_rate=LAYER_DECAY[size],
                save_interval=10, early_stop_patience=10 ** 9)
    base.update(overrides)
    return TrainSettings(**base)
