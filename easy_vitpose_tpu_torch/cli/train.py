"""Finetuning CLI (reference easy_ViTPose/train.py:31-171 workflow), on
the card.

Port of ``easy_vitpose_tpu/cli/train.py``: session work dirs
runs/train/NNN, seeds, yaml config merge, partial ckpt resume (drops the
head final layer on shape mismatch), optional backbone freeze, then the
epoch loop.  Runs on CUDA unless ``--device cpu`` is given; the dataset
reads its images with cv2.

Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) each
process trains on ``cuda:LOCAL_RANK`` in an NCCL group (with ``--device
cpu``, on the CPU in a gloo group), data-parallel (``train/loop.py``):
``--batch-size`` is the global batch.  The main process picks the session
directory and writes the files.  Without ``torchrun`` it is one process.

Usage:
  python -m easy_vitpose_tpu_torch.cli.train --data-root datasets/COCO \
      --model-name b --dataset coco [--resume-from ckpt.npz] \
      [--config config.yaml] [--freeze-backbone] [--fused-block --fused-opt]
  torchrun --nproc-per-node 8 -m easy_vitpose_tpu_torch.cli.train ... \
      --fused-block --fused-opt --batch-size 512
"""
from __future__ import annotations

import argparse
import json
import os

from ..configs import get_model_config, with_stem
from ..kernels import resolve_device
from ..models.vitpose import init_params
from ..parallel import mesh as meshlib
from ..skeletons import flip_pairs, num_keypoints
from ..train.dataset import CocoPoseDataset
from ..train.loop import partial_load_for_finetune, train_model


def next_session_dir(base: str = "runs/train") -> str:
    """runs/train/000, 001, ... (reference train.py:59-68)."""
    os.makedirs(base, exist_ok=True)
    existing = [int(d) for d in os.listdir(base) if d.isdigit()]
    n = max(existing) + 1 if existing else 0
    path = os.path.join(base, f"{n:03d}")
    os.makedirs(path)
    return path


def _session_dir() -> str:
    """A new session directory, made by the main process and shared with
    the other ranks of a process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return next_session_dir()
    path = [next_session_dir() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, 0)
    return path[0]


def _fused_train_impl(device, say=print) -> str:
    """--fused-block's implementation on ``device``: the training block's
    kernels on CUDA, their plain versions on the CPU."""
    if device.type == "cuda":
        return "pallas_train"
    say(">>> --fused-block on a non-CUDA device: running the fused "
        "kernels' plain versions (correct but slow; intended "
        "for functional verification only)")
    return "pallas_train_interpret"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--train-version", default="train2017")
    p.add_argument("--val-version", default="val2017")
    p.add_argument("--train-ann", default=None)
    p.add_argument("--val-ann", default=None)
    p.add_argument("--model-name", required=True, choices=["s", "b", "l", "h"])
    p.add_argument("--dataset", default="coco")
    p.add_argument("--config", default=None, help="yaml overrides")
    p.add_argument("--resume-from", default=None, help=".npz or .pth ckpt")
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--preset", default="finetune",
                   choices=["finetune", "from-scratch"],
                   help="finetune: Adam + ReduceLROnPlateau (reference "
                        "*_custom recipe); from-scratch: AdamW layer-decay "
                        "+ linear warmup + step LR (reference 210-epoch "
                        "train_configs recipe)")
    p.add_argument("--lr", type=float, default=None,
                   help="override the preset LR (finetune 3.75e-4, "
                        "from-scratch 5e-4)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=210)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-amp", action="store_true")
    p.add_argument("--fused-block", action="store_true",
                   help="the training block's hand-written kernels (K5-K7, "
                        "models/fused_block_train.py)")
    p.add_argument("--fused-opt", action="store_true",
                   help="clip+Adam as one table launch after one norm launch "
                        "(train/fused_opt.py); same math as the default Adam "
                        "(finetune preset only)")
    p.add_argument("--opt-moments", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="Adam moment storage (implies --fused-opt when not "
                        "f32): bf16 halves / int8 quarters the moment "
                        "memory — blockwise 8-bit moments for large-model "
                        "single-card training (train/fused_opt.py)")
    p.add_argument("--workers", type=int, default=0,
                   help="spawn-pool dataset workers (the reference's "
                        "workers_per_gpu; 0 = background thread)")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--eval-ap-interval", type=int, default=0,
                   help="run in-loop COCO AP over the val split's gt crops "
                        "every N epochs (0 = off; COCO-17 only)")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="EMA shadow weights, e.g. 0.999 (0 = off); "
                        "validation and checkpoints then use the EMA")
    p.add_argument("--best-metric", default="loss", choices=["loss", "pck"],
                   help="best.npz / early-stop criterion (default: val "
                        "loss, the reference behavior)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="micro-batches per optimizer step: --batch-size is "
                        "split into this many sequential micro-batches "
                        "inside the step (one optimizer update). "
                        "Reproduces the reference's 8-GPU from-scratch "
                        "batch (64x8=512) on fewer cards")
    p.add_argument("--resume-state", default=None, metavar="DIR",
                   help="resume a FULL train state (optimizer moments, LR "
                        "schedule position, BN stats, EMA) from a "
                        "train_state dir — e.g. work_dir/train_state after "
                        "a preemption; implies periodic full-state saves")
    p.add_argument("--device-input", action="store_true",
                   help="ship uint8 crops + joint coords and render "
                        "normalization + Gaussian targets inside the train "
                        "step, on the device")
    p.add_argument("--resilient", action="store_true",
                   help="auto-resume from the newest full train state on "
                        "transient failures (train/resilient.py); SIGTERM "
                        "preemption is always handled gracefully")
    p.add_argument("--device", default=None,
                   help="torch device to train on; default CUDA ('cpu' runs the kernels' "
                        "plain versions)")
    args = p.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # one process per device: cuda:LOCAL_RANK in an NCCL group, or
        # the CPU in a gloo group where asked
        device = meshlib.local_device(args.device)
        meshlib.initialize_distributed(device=device)
    else:
        device = resolve_device(args.device)
    say = print if meshlib.is_main_process() else (lambda *a, **k: None)

    overrides = {}
    if args.config:
        import yaml
        with open(args.config) as f:
            overrides = yaml.safe_load(f) or {}
    cfg = get_model_config(args.dataset, args.model_name)
    if overrides.get("stem_channels"):
        # the hybrid CNN stem (reference HybridEmbed, ``models/stem.py``):
        # yaml ``stem_channels: [64, 128, 256, 512]`` replaces PatchEmbed
        cfg = with_stem(cfg, overrides["stem_channels"])
    work_dir = args.work_dir or _session_dir()
    from ..train import presets
    preset_fn = (presets.from_scratch if args.preset == "from-scratch"
                 else presets.finetune)
    preset_kw = dict(
        total_epochs=overrides.get("total_epochs", args.epochs),
        batch_size=overrides.get("batch_size", args.batch_size),
        use_amp=overrides.get("use_amp", not args.no_amp),
        block_impl=(_fused_train_impl(device, say) if args.fused_block
                    or overrides.get("fused_block") else "xla"),
        save_interval=overrides.get("save_interval", 10),
        freeze_backbone=args.freeze_backbone or
        overrides.get("freeze_backbone", False),
        seed=overrides.get("seed", args.seed),
        workers=overrides.get("workers", args.workers),
        eval_ap_interval=overrides.get("eval_ap_interval",
                                       args.eval_ap_interval),
        ema_decay=overrides.get("ema_decay", args.ema_decay),
        best_metric=overrides.get("best_metric", args.best_metric),
        grad_accum=overrides.get("grad_accum", args.grad_accum),
        device_input=args.device_input or overrides.get("device_input",
                                                        False),
        work_dir=work_dir)
    if args.resume_state:
        preset_kw["resume_state_dir"] = args.resume_state
    if args.resume_state or args.resilient \
            or overrides.get("save_full_state"):
        preset_kw["save_full_state"] = True
    lr = overrides.get("lr", args.lr)
    if lr is not None:
        preset_kw["lr"] = lr
    if args.preset == "finetune":
        preset_kw["early_stop_patience"] = overrides.get(
            "early_stop_patience", 15)
    elif "early_stop_patience" in overrides:
        # from-scratch default is no-early-stop, but an explicit yaml
        # override must win for either preset
        preset_kw["early_stop_patience"] = overrides["early_stop_patience"]
    settings = preset_fn(args.model_name, **preset_kw)
    if args.opt_moments != "f32":
        args.fused_opt = True  # quantized moments live in the fused path
    if args.fused_opt or overrides.get("fused_opt"):
        if settings.optimizer != "adam":
            raise SystemExit("--fused-opt implements the Adam recipe; the "
                             "from-scratch AdamW layer-decay preset keeps "
                             "the optax-chain optimizer")
        if settings.freeze_backbone:
            raise SystemExit("--fused-opt does not support "
                             "--freeze-backbone (masked optimizer)")
        settings.optimizer = "fused_adam"
        settings.opt_moments = args.opt_moments

    params = init_params(cfg, settings.seed).state_dict()
    if args.resume_from:
        if args.resume_from.endswith(".pth"):
            from ..convert.vitpose_torch import load_torch_checkpoint
            loaded = load_torch_checkpoint(args.resume_from, cfg)
        else:
            from ..convert.from_jax import state_dict_from_jax
            from ..utils.checkpoint import load_params
            loaded = state_dict_from_jax(load_params(args.resume_from), cfg)
        params = partial_load_for_finetune(params, loaded)
        say(f">>> resumed from {args.resume_from}")

    K = num_keypoints(args.dataset) if args.dataset != "custom" else cfg.head.num_keypoints
    fp = [list(pr) for pr in flip_pairs(args.dataset)]
    ds_kw = dict(num_joints=K, flip_pairs=fp,
                 heatmap_sigma=overrides.get("heatmap_sigma", 3.0))
    train_ds = CocoPoseDataset(args.data_root, args.train_version,
                               is_train=True, ann_file=args.train_ann,
                               seed=settings.seed, **ds_kw)
    val_ds = CocoPoseDataset(args.data_root, args.val_version,
                             is_train=False, ann_file=args.val_ann, **ds_kw)
    say(f">>> train {len(train_ds)} instances, val {len(val_ds)}; "
        f"work dir {work_dir}")

    if args.resilient:
        from ..train.resilient import train_model_resilient
        out = train_model_resilient(params, cfg, train_ds, val_ds, settings, device=device)
    else:
        out = train_model(params, cfg, train_ds, val_ds, settings, device=device)
    if not meshlib.is_main_process():
        return
    with open(os.path.join(work_dir, "history.json"), "w") as f:
        json.dump(out["history"], f, indent=1)
    if out.get("preempted"):
        say(f">>> preempted; resume with "
            f"--resume-state {os.path.join(work_dir, 'train_state')} "
            f"--work-dir {work_dir}")
    else:
        say(f">>> done; checkpoints in {work_dir}")


if __name__ == "__main__":
    main()
