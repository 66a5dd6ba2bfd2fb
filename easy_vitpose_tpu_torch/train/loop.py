"""Epoch training loop (reference vit_utils/train_valid_fn.py:41-166).

Port of ``easy_vitpose_tpu/train/loop.py`` for one device (CUDA unless the
caller passes ``device="cpu"``).  Semantics parity: Adam + grad-clip, bf16
mixed precision, ReduceLROnPlateau on the validation loss, checkpoint every
``save_interval`` epochs, best-checkpoint retention after
``ckpt_topk_epoch`` epochs, early stop on ``early_stop_patience``, all
driven from the host while each step runs on the card.  A step's loss and
gradient norm stay on the device; the loop reads them once, at the end of
the epoch.

Checkpoints: the JAX package's ``.npz`` of serving params
(``convert.from_jax.state_dict_to_jax``; both ``VitInference``s load it),
and the full train state with ``torch.save`` (``train/state_ckpt.py``),
plus partial resume that drops the head's final layer on a K mismatch
(reference train.py:112-116).

Drop-path masks come from one ``torch.Generator`` on the device, reseeded
at the start of each epoch from ``(settings.seed, epoch)`` in place of
JAX's ``PRNGKey`` splits: the draws differ from JAX's, and a run resumed at
an epoch draws what the uninterrupted run drew there (JAX's resumed run
starts its key chain again from the seed).
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..configs import ModelConfig
from ..convert.from_jax import state_dict_to_jax
from ..kernels import resolve_device
from ..utils.checkpoint import save_params
from . import step as steplib
from .dataset import CocoPoseDataset, batch_iterator


@dataclass
class TrainSettings:
    lr: float = 3.75e-4                  # reference *_custom config lr
    total_epochs: int = 210
    batch_size: int = 64
    use_amp: bool = True
    block_impl: str = "xla"              # 'pallas_train' = the training block's kernels
    optimizer: str = "adam"              # | 'fused_adam' | 'adamw_layer_decay' (from-scratch)
    opt_moments: str = "f32"             # 'bf16'|'int8' Adam moment storage
    #                                      (optimizer='fused_adam' only;
    #                                      int8 = 4x moment memory cut for
    #                                      large-model single-card training)
    lr_policy: str = "plateau"           # | 'step' (mmcv warmup+milestones)
    lr_factor: float = 0.1               # ReduceLROnPlateau factor
    lr_patience: int = 4                 # epochs without val improvement
    # 'step' policy (reference train_configs/*.py:24-29) + AdamW recipe
    lr_milestones: tuple = (170, 200)
    lr_gamma: float = 0.1
    warmup_iters: int = 500
    warmup_ratio: float = 1e-3
    weight_decay: float = 0.1
    layer_decay_rate: float = 0.75
    save_interval: int = 10
    early_stop_patience: int = 15
    ckpt_topk_epoch: int = 10            # start tracking best after this
    freeze_backbone: bool = False
    seed: int = 0
    work_dir: str = "runs/train/exp"
    save_full_state: bool = False     # full train-state saves for exact resume
    resume_state_dir: str = ""        # restore a full train state
    tensorboard: bool = True          # scalar event files under work_dir/tb
    workers: int = 0                  # spawn-pool dataset workers (0=thread)
    eval_ap_interval: int = 0         # epochs between in-loop COCO AP evals
    #                                   over the val split's gt crops (0=off;
    #                                   needs a K=17 val_ds with .ann_file)
    ema_decay: float = 0.0            # EMA shadow weights (0=off); when on,
    #                                   validation + checkpoints use the EMA
    best_metric: str = "loss"         # best.npz / early-stop criterion:
    #                                   'loss' (reference) | 'pck' (val PCK)
    grad_accum: int = 1               # micro-batches per optimizer step;
    #                                   batch_size is the LOGICAL per-step
    #                                   batch, split inside the step
    device_input: bool = False        # ship uint8 crops + joint coords and
    #                                   render normalize + Gaussian targets
    #                                   inside the train step (validation
    #                                   batches keep host rendering: the PCK/
    #                                   AP bookkeeping reads host targets)
    handle_sigterm: bool = True       # graceful preemption: on SIGTERM,
    #                                   finish the in-flight step, save the
    #                                   full train state + last.npz and
    #                                   return {'preempted': True} (resume
    #                                   with resume_state_dir / the CLI's
    #                                   --resume-state)


class _BgWriter:
    """Single background thread for checkpoint serialization + disk IO.

    Only the device->host snapshot is synchronous (the loop's next steps
    make new state tensors, but the snapshot must be of this epoch's); the
    file write happens here, overlapped with the next epoch.  Writes execute
    in submission order; the first failure is re-raised at the next
    ``drain()`` (a checkpoint that silently failed to persist must not look
    durable)."""

    def __init__(self):
        # bounded: submit() blocks once 4 writes are pending, so multi-GB
        # state snapshots do not pile up in host RAM when the disk is slower
        # than the epochs
        self._q = queue.Queue(maxsize=4)
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                fn()
            except BaseException as e:  # surfaced at drain()
                if self._err is None:
                    self._err = e
            finally:
                # also acks the shutdown sentinel — a sentinel that never
                # reached task_done() would deadlock a later q.join()
                self._q.task_done()

    def submit(self, fn):
        if self._err is not None:
            self.drain()
        self._q.put(fn)

    def drain(self):
        """Block until every submitted write hit disk; re-raise errors."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self):
        """Drain and stop the thread; idempotent (the success path closes
        for error visibility and the caller's finally closes again)."""
        self.drain()
        if self._t.is_alive():
            self._q.put(None)
            self._t.join()


class PlateauScheduler:
    """ReduceLROnPlateau (mode=min) equivalent of the torch scheduler the
    reference uses (train_valid_fn.py:79)."""

    def __init__(self, lr: float, factor: float, patience: int,
                 min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr


FINAL_LAYER = ("keypoint_head.final_layer.weight", "keypoint_head.final_layer.bias")


def partial_load_for_finetune(params: Mapping[str, torch.Tensor],
                              ckpt_params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Resume from a checkpoint's state dict, keeping ``params``' head
    final layer where its shape differs (K-mismatch finetunes; reference
    train.py:112-116)."""
    out = dict(ckpt_params)
    for k in FINAL_LAYER:
        if tuple(ckpt_params[k].shape) != tuple(params[k].shape):
            out[k] = params[k]
    return out


def _as_state_dict(params) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, torch.nn.Module) else params


def train_model(params, cfg: ModelConfig, train_ds: CocoPoseDataset,
                val_ds: Optional[CocoPoseDataset], settings: TrainSettings,
                log: Callable[[str], None] = print, device=None) -> Dict:
    """Run the full training session on ``device`` (CUDA unless the caller
    passes ``"cpu"``; raises without a card) from ``params``, a
    :class:`..models.vitpose.ViTPose` or its state dict.

    Returns {'params', 'history', 'preempted'} ('params': the final
    serving params as the JAX package's tree).  With
    ``settings.handle_sigterm`` (default), SIGTERM checkpoints the full
    train state and returns cleanly with ``preempted=True`` instead of
    dying mid-epoch (the reference has no preemption story at all).
    """
    dev = resolve_device(device)
    stop_sig = {"n": None}
    old_sigterm = None
    if settings.handle_sigterm:
        import signal
        if threading.current_thread() is threading.main_thread():
            def _request_stop(signum, frame):
                stop_sig["n"] = signum
                log("!! SIGTERM: checkpointing at the next step boundary")
            old_sigterm = signal.signal(signal.SIGTERM, _request_stop)
    writer = _BgWriter()
    try:
        out = _train_model(_as_state_dict(params), cfg, train_ds, val_ds, settings, log,
                           stop_sig, writer, dev)
        writer.close()   # success path: write failures must surface
        return out
    finally:
        try:
            # exception path: finish in-flight writes so a resilient
            # retry never reads a half-written checkpoint, but don't let
            # a write error mask the original exception
            writer.close()
        except Exception as e:  # pragma: no cover - double-fault path
            log(f"!! background checkpoint write failed: {e!r}")
        # restore even on an exception path — a leaked handler would
        # outlive this call and shadow the caller's disposition
        if old_sigterm is not None:
            import signal
            signal.signal(signal.SIGTERM, old_sigterm)


def build_optimizer(cfg: ModelConfig, settings: TrainSettings, steps_per_epoch: int):
    """The optimizer ``settings`` name, with JAX's checks of the options
    that go together."""
    if settings.lr_policy == "step" \
            and settings.optimizer != "adamw_layer_decay":
        raise ValueError(
            "lr_policy='step' (warmup+milestones) is realized inside the "
            "AdamW layer-decay optimizer; set optimizer='adamw_layer_decay' "
            "(or use presets.from_scratch) — with optimizer='adam' the "
            "schedule would silently never run")
    if settings.optimizer == "adamw_layer_decay":
        if settings.freeze_backbone:
            raise ValueError("freeze_backbone is a finetune option; the "
                             "from-scratch AdamW recipe trains everything")
        lr = settings.lr
        if settings.lr_policy == "step":
            lr = steplib.make_step_lr_schedule(
                settings.lr, steps_per_epoch,
                milestones=settings.lr_milestones, gamma=settings.lr_gamma,
                warmup_iters=settings.warmup_iters,
                warmup_ratio=settings.warmup_ratio)
        return steplib.make_adamw_layer_decay_optimizer(
            lr, weight_decay=settings.weight_decay,
            layer_decay_rate=settings.layer_decay_rate, cfg=cfg)
    if settings.optimizer == "fused_adam":
        # clip + Adam in two launches over a table of every leaf (K8 or K9
        # and the norm kernel, train/fused_opt.py) — same math as 'adam'
        if settings.freeze_backbone:
            raise ValueError("freeze_backbone needs the optax masked "
                             "optimizer; use optimizer='adam'")
        from .fused_opt import make_fused_adam
        return make_fused_adam(settings.lr, moment_dtype=settings.opt_moments)
    return steplib.make_optimizer(settings.lr, freeze_backbone=settings.freeze_backbone)


def epoch_generator_seed(seed: int, epoch: int) -> int:
    """The drop-path generator's seed for ``epoch`` of a run seeded ``seed``."""
    return seed * 1_000_003 + epoch


def fetch_mean(values) -> float:
    """The host mean (float64) of a list of float32 device scalars: one
    read of the device for the whole list."""
    return float(np.mean(torch.stack(values).cpu().numpy().astype(np.float64)))


def _train_model(params, cfg: ModelConfig, train_ds: CocoPoseDataset,
                 val_ds: Optional[CocoPoseDataset], settings: TrainSettings,
                 log: Callable[[str], None], stop_sig: Dict, writer: _BgWriter,
                 dev: torch.device) -> Dict:
    os.makedirs(settings.work_dir, exist_ok=True)
    k_accum = max(int(settings.grad_accum), 1)
    if settings.batch_size % k_accum:
        raise ValueError(f"batch {settings.batch_size} not divisible by "
                         f"{k_accum} grad-accum micro-batches")

    steps_per_epoch = max(len(train_ds) // settings.batch_size, 1)
    tx = build_optimizer(cfg, settings, steps_per_epoch)
    state = steplib.init_train_state(params, tx, ema_decay=settings.ema_decay, device=dev)
    start_epoch = 0
    if settings.resume_state_dir:
        from .state_ckpt import restore_train_state
        try:
            state = restore_train_state(settings.resume_state_dir, template=state)
        except ValueError as e:
            # only the specific "checkpoint predates --ema-decay" structure
            # mismatch is recoverable; anything else (corrupt file, optimizer
            # switch) must surface with its real error
            if not settings.ema_decay or "ema_params" not in str(e):
                raise
            # restore without the shadow tree, then seed the EMA from the
            # restored params
            tmpl = {k: v for k, v in state.items() if k != "ema_params"}
            state = restore_train_state(settings.resume_state_dir, template=tmpl)
            state["ema_params"] = {k: v.clone() for k, v in state["params"].items()}
            log("resume: pre-EMA checkpoint — EMA seeded from params")
        start_epoch = int(state["step"]) // steps_per_epoch
        log(f"resumed full train state from {settings.resume_state_dir} "
            f"(step {int(state['step'])} -> epoch {start_epoch})")
    render_kwargs = None
    if settings.device_input:
        # train batches arrive raw (uint8 + joint coords); the step renders
        # targets on device with the dataset's exact geometry/sigma/weights
        train_ds.device_input = True
        render_kwargs = dict(
            heatmap_size=train_ds.heatmap_size,
            image_size=train_ds.image_size,
            sigma=train_ds.heatmap_sigma,
            joints_weight=train_ds.joints_weight,
            use_different_joints_weight=train_ds.use_different_joints_weight)
    train_step = steplib.make_train_step(cfg, tx, use_amp=settings.use_amp,
                                         block_impl=settings.block_impl,
                                         ema_decay=settings.ema_decay, grad_accum=k_accum,
                                         render_kwargs=render_kwargs)
    eval_step = steplib.make_eval_step(cfg, use_amp=settings.use_amp, return_heatmaps=True)

    sched = PlateauScheduler(settings.lr, settings.lr_factor,
                             settings.lr_patience)
    gen = torch.Generator(device=dev)
    history = []
    ap_gt = None  # parsed-once annotation json for in-loop AP
    best_val = float("inf")
    patience = 0
    loop_ctl_path = os.path.join(settings.work_dir, "loop_state.json")
    ctl_src = loop_ctl_path
    if settings.resume_state_dir and not os.path.exists(ctl_src):
        # resuming into a FRESH work dir (the CLI's next_session_dir flow):
        # the controllers were written next to the train_state being
        # resumed — without this the plateau LR / best-val / patience
        # silently reset and the first epoch-end snaps the LR to base
        ctl_src = os.path.join(
            os.path.dirname(os.path.abspath(settings.resume_state_dir)),
            "loop_state.json")
    if settings.resume_state_dir and os.path.exists(ctl_src):
        # host-side loop controllers are NOT in the train state: restore
        # the plateau scheduler (else the first resumed epoch would reset
        # the LR to base), best-val and early-stop patience
        with open(ctl_src) as f:
            ctl = json.load(f)
        sched.lr = ctl["sched_lr"]
        sched.best = ctl["sched_best"]
        sched.bad_epochs = ctl["sched_bad_epochs"]
        best_val = ctl["best_val"]
        patience = ctl["patience"]
        # the optimizer's realized LR itself came back with the train
        # state; only the host-side controllers needed restoring
        log(f"restored loop controllers (lr {sched.lr:.2e}, "
            f"best_val {best_val:.5f}, patience {patience})")

    # TensorBoard scalars (SURVEY §5 observability; the reference only uses
    # TB for image grids and never wires scalars). Optional dependency.
    tb = None
    if settings.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter
            tb = SummaryWriter(os.path.join(settings.work_dir, "tb"))
        except ImportError:  # pragma: no cover
            log("tensorboard writer unavailable; scalars disabled")

    log(f"#== train: 1 device ({dev}), batch {settings.batch_size}, "
        f"lr {settings.lr}, amp {settings.use_amp}, "
        f"{sum(v.numel() for v in state['params'].values()):,d} params ==#")

    def _loop_ctl_payload(epoch):
        """Snapshot the host-side controllers NOW (callers hand the dict
        to the background writer; reading sched/patience at write time
        could capture a later epoch's values)."""
        return {"sched_lr": sched.lr,
                "sched_best": sched.best,
                "sched_bad_epochs": sched.bad_epochs,
                "best_val": best_val,
                "patience": patience,
                "epoch": epoch}

    def _save_loop_ctl(payload):
        with open(loop_ctl_path, "w") as f:
            json.dump(payload, f)

    def _serving_snapshot():
        """The serving params (EMA when on) as the JAX package's tree, on
        the host."""
        snap = state["ema_params"] if settings.ema_decay else state["params"]
        return state_dict_to_jax(steplib.merge_bn_state(snap, state["bn_state"]), cfg)

    def _save_full_state(sd):
        from .state_ckpt import host_state, save_train_state
        hs = host_state(state)
        writer.submit(lambda: save_train_state(sd, hs))

    preempted = False
    for epoch in range(start_epoch, settings.total_epochs):
        t0 = time.time()
        losses = []
        it = batch_iterator(train_ds, settings.batch_size, shuffle=True,
                            seed=settings.seed + epoch,
                            workers=settings.workers)
        gen.manual_seed(epoch_generator_seed(settings.seed, epoch))
        gnorms = []
        for batch in it:
            # checked BEFORE dispatch: a signal that lands during the
            # previous step/validation stops without burning another step
            if stop_sig["n"] is not None:
                break
            state, metrics = train_step(state, batch, gen)
            losses.append(metrics["loss"])
            gnorms.append(metrics["grad_norm"])
        if stop_sig["n"] is not None:
            # preemption: persist everything an exact resume needs (the
            # resumed run re-enters this epoch from its start, with the
            # mid-epoch optimizer state — same contract as the reference's
            # epoch-granular resume, minus the lost work)
            snap = _serving_snapshot()
            sd = os.path.join(settings.work_dir, "train_state")
            _save_full_state(sd)
            writer.submit(lambda p=_loop_ctl_payload(epoch):
                          _save_loop_ctl(p))
            writer.submit(lambda: save_params(
                os.path.join(settings.work_dir, "last.npz"), snap))
            writer.drain()   # the log below must not lie to the scheduler
            log(f"!! preempted at epoch {epoch} step {int(state['step'])}: "
                f"full train state saved to {sd}")
            preempted = True
            break
        train_loss = fetch_mean(losses) if losses else float("nan")
        if losses and not np.isfinite(train_loss):
            # failure detection: a diverged/NaN step poisons the optimizer
            # state irreversibly — fail loudly instead of training on garbage
            raise FloatingPointError(
                f"non-finite training loss at epoch {epoch} "
                f"({train_loss}); check LR/data (last ckpt in "
                f"{settings.work_dir})")

        val_loss = train_loss
        val_acc = None
        val_ap = None
        # in-loop COCO AP over the val split's gt crops (the reference runs
        # AP only in the standalone evaluation_on_coco.py harness); gated to
        # COCO-17 — CocoKeypointEval's sigma table is the COCO-17 one
        ap_due = bool(settings.eval_ap_interval and val_ds is not None
                      and (epoch + 1) % settings.eval_ap_interval == 0
                      and getattr(val_ds, "ann_file", None)
                      # must be the COCO person skeleton: K=17 alone would
                      # admit the 17-joint ANIMAL datasets (ap10k/apt36k)
                      # to COCO-sigma person scoring
                      and cfg.dataset == "coco"
                      and cfg.head.num_keypoints == 17)
        ap_results = []
        if val_ds is not None and len(val_ds):
            from ..eval.metrics import pose_pck_accuracy
            # with EMA on, validate (and checkpoint, below) the shadow
            # weights — the weights one would actually deploy
            eval_state = ({**state, "params": state["ema_params"]}
                          if settings.ema_decay else state)
            vlosses = []
            acc_w, acc_n = 0.0, 0
            # one device: the tail batch runs as it is, unpadded
            for batch in batch_iterator(val_ds, settings.batch_size,
                                        shuffle=False, drop_last=False,
                                        prefetch=1):
                loss, heat = eval_step(eval_state, batch)
                heat_np = heat.cpu().numpy()
                vlosses.append(float(loss))
                # in-loop PCK@0.05 (the reference loop never fills its
                # accuracy slot, train_valid_fn.py:25)
                _, avg, cnt = pose_pck_accuracy(
                    heat_np, np.asarray(batch["targets"]),
                    np.asarray(batch["target_weights"])[:, :, 0] > 0)
                acc_w += avg * cnt
                acc_n += cnt
                if ap_due:
                    from ..ops.decode import keypoints_from_heatmaps_udp
                    from .dataset import PIXEL_STD
                    metas = batch["meta"]
                    centers = np.stack([m["center"] for m in metas])
                    scales = np.stack([m["scale"] for m in metas]) * PIXEL_STD
                    preds, maxv = keypoints_from_heatmaps_udp(
                        heat, torch.from_numpy(centers).to(dev),
                        torch.from_numpy(scales.astype(np.float32)).to(dev))
                    preds, maxv = preds.cpu().numpy(), maxv.cpu().numpy()
                    for i, m in enumerate(metas):
                        flat = np.concatenate([preds[i], maxv[i]], -1)
                        ap_results.append({
                            "image_id": int(m["imgId"]), "category_id": 1,
                            "keypoints": [float(v) for v in flat.ravel()],
                            "score": float(maxv[i].mean())})
            val_loss = float(np.mean(vlosses)) if vlosses else train_loss
            val_acc = acc_w / acc_n if acc_n else None
            if ap_due and ap_results:
                from ..eval.cocoeval import CocoKeypointEval
                if ap_gt is None:  # parse the annotation json once per run
                    with open(val_ds.ann_file) as f:
                        ap_gt = json.load(f)
                val_ap = float(
                    CocoKeypointEval(ap_gt, ap_results).accumulate()["AP"])

        if settings.lr_policy == "step":
            # warmup/milestone schedule lives inside the optimizer (driven
            # by the step count); just report the realized LR
            new_lr = steplib.get_learning_rate(state["opt_state"])
        else:
            new_lr = sched.step(val_loss)
            state = dict(state)
            state["opt_state"] = steplib.set_learning_rate(state["opt_state"],
                                                           new_lr)
        dt = time.time() - t0
        history.append({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "val_acc": val_acc,
                        "val_ap": val_ap, "lr": new_lr, "seconds": dt})
        acc_txt = f"pck {val_acc:.3f}  " if val_acc is not None else ""
        ap_txt = f"AP {val_ap:.3f}  " if val_ap is not None else ""
        log(f"[ep {epoch:03d}] train {train_loss:.5f}  val {val_loss:.5f}  "
            f"{acc_txt}{ap_txt}lr {new_lr:.2e}  ({dt:.1f}s)")
        if tb is not None:
            tb.add_scalar("loss/train", train_loss, epoch)
            tb.add_scalar("loss/val", val_loss, epoch)
            if val_acc is not None:
                tb.add_scalar("acc/val_pck", val_acc, epoch)
            if val_ap is not None:
                tb.add_scalar("acc/val_ap", val_ap, epoch)
            tb.add_scalar("lr", new_lr, epoch)
            if gnorms:
                tb.add_scalar("grad_norm", fetch_mean(gnorms), epoch)
            tb.add_scalar("epoch_seconds", dt, epoch)
            tb.flush()

        serving = _serving_snapshot()
        if settings.save_interval and \
                (epoch + 1) % settings.save_interval == 0:
            # host snapshots are taken synchronously; serialization + disk
            # IO overlap the next epoch on the writer thread
            writer.submit(lambda e=epoch, s=serving: save_params(
                os.path.join(settings.work_dir, f"epoch{e:03d}.npz"), s))
            if settings.save_full_state:
                _save_full_state(os.path.join(settings.work_dir, "train_state"))
                writer.submit(lambda p=_loop_ctl_payload(epoch):
                              _save_loop_ctl(p))
        if epoch > settings.ckpt_topk_epoch:
            # best-checkpoint / early-stop criterion: val loss (reference
            # behavior) or negated val PCK (best_metric='pck'; falls back
            # to loss when no val split produced an accuracy)
            crit = (-val_acc if settings.best_metric == "pck"
                    and val_acc is not None else val_loss)
            if crit < best_val:
                best_val = crit
                patience = 0
                writer.submit(lambda s=serving: save_params(
                    os.path.join(settings.work_dir, "best.npz"), s))
            else:
                patience += 1
                if patience >= settings.early_stop_patience:
                    log(f"early stop at epoch {epoch} "
                        f"(no val improvement for {patience})")
                    break

    if tb is not None:
        tb.close()
    final = _serving_snapshot()
    if not preempted:
        writer.submit(lambda: save_params(
            os.path.join(settings.work_dir, "last.npz"), final))
    # the caller (train_model) drains the writer before returning, so
    # every file above is durable by the time the session ends
    return {"params": final, "history": history, "preempted": preempted}
