"""Where the gradient gap of the ``grad_accum=2`` train step comes from.

``chip_smoke.py`` holds one ViT-B AMP step of 64 crops in two micro-batches
(with an EMA) through the kernels against the plain step, reading each
side's gradients back from its first Adam moment.  This script splits the
gap between the two paths, on one card, from one state, one batch and one
draw of drop-path masks made from ``--seed`` (``chip_smoke.train_batch``):

* each micro-batch's float32 gradients through ``train/step.py::
  loss_and_grads`` on the kernel and the plain path, both from the state's
  BN statistics; micro-batch 2 also from each path's own BN statistics
  chained through micro-batch 1 (train-mode BN normalises by the batch's
  own statistics, so the chain moves only the running statistics);
* the float32 mean of the two micro-batches' gradients on each path;
* the step itself (``make_train_step(grad_accum=2, ema_decay=0.999)``) with
  its gradients read back from the first Adam moment as the smoke reads
  them, against the plain step's, and against its own path's mean;
* the whole batch of 64 as one micro-batch, on both paths and against the
  plain path in float32 (no AMP), and each path run twice on micro-batch 1
  (the floor that the card's non-deterministic sums set).

Each figure is the largest, over the leaves, of max |a - b| over max |b|
of the leaf (b the plain path's), as ``chip_smoke.py`` measures it; the
three leaves that set it are named.  Prints one JSON line.

Usage (repository root, one CUDA card):
    python3 scripts/measure_accum_grads.py [--seed 0] [--out FILE]
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    cs.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vit import draw_drop_path_masks
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    kernels.build()
    dev = torch.device("cuda")
    cfg = get_model_config("coco", "b")
    model = init_params(cfg, args.seed).to(dev)
    rng = np.random.default_rng(args.seed)
    B, accum, ema = cs.SLOTS, 2, 0.999
    raw = cs.train_batch(torch, rng, B, dev)
    batch = tstep.render_batch_on_device(raw, dev)
    masks = draw_drop_path_masks(cfg.backbone, B,
                                 torch.Generator(device=dev).manual_seed(args.seed), dev)
    tx = fused_opt.make_fused_adam(cs.TRAIN_LR, max_grad_norm=cs.TRAIN_CLIP)
    state = tstep.init_train_state(model, tx, ema_decay=ema, device=dev)
    rows = B // accum

    def grads(plain, part, bn):
        sl = slice(part * rows, (part + 1) * rows) if part is not None else slice(0, B)
        loss, new_bn, g = tstep.loss_and_grads(
            cfg, state["params"], bn, {k: v[sl] for k, v in batch.items()}, use_amp=True,
            plain=plain, drop_path_masks=masks[:, sl])
        return float(loss), new_bn, g

    def gap(a, b):
        errs = {n: cs.max_rel_err(torch, a[n], b[n])[1] for n in b}
        worst = sorted(errs.items(), key=lambda kv: kv[1])[-3:]
        return {"max": max(errs.values()), "worst": [[n, e] for n, e in worst]}

    out = {"card": torch.cuda.get_device_name(0)}
    g, bn_after = {}, {}
    for plain in (False, True):
        l1, bn1, g1 = grads(plain, 0, state["bn_state"])
        _, _, g2 = grads(plain, 1, state["bn_state"])
        _, bn2, g2c = grads(plain, 1, bn1)
        g[plain] = {"mb1": g1, "mb2": g2, "mb2_chained": g2c,
                    "mean": {n: (g1[n] + g2c[n]) / torch.tensor(2.0, device=dev) for n in g1}}
        bn_after[plain] = bn2
        out[f"mb2_chain_changes_grads_{'plain' if plain else 'kernel'}"] = not all(
            torch.equal(g2[n], g2c[n]) for n in g2)
    k, p = g[False], g[True]
    out["micro_batch_1"] = gap(k["mb1"], p["mb1"])
    out["micro_batch_2"] = gap(k["mb2"], p["mb2"])
    out["micro_batch_2_chained"] = gap(k["mb2_chained"], p["mb2_chained"])
    out["mean_of_two"] = gap(k["mean"], p["mean"])
    out["bn_statistics"] = max(cs.max_rel_err(torch, bn_after[False][n], bn_after[True][n])[1]
                               for n in bn_after[True])
    out["whole_batch"] = gap(grads(False, None, state["bn_state"])[2],
                             grads(True, None, state["bn_state"])[2])
    # both paths against the float32 plain path (no AMP) on the whole batch
    _, _, g32 = tstep.loss_and_grads(cfg, state["params"], state["bn_state"], batch,
                                     use_amp=False, plain=True, drop_path_masks=masks)
    out["whole_batch_kernel_vs_f32"] = gap(grads(False, None, state["bn_state"])[2], g32)
    out["whole_batch_plain_vs_f32"] = gap(grads(True, None, state["bn_state"])[2], g32)
    del g32
    out["kernel_twice_mb1"] = gap(grads(False, 0, state["bn_state"])[2], k["mb1"])
    out["plain_twice_mb1"] = gap(grads(True, 0, state["bn_state"])[2], p["mb1"])

    # the step as the smoke runs it, read back from the first Adam moment
    readback = {}
    for plain in (False, True):
        st = tstep.init_train_state(model, tx, ema_decay=ema, device=dev)
        step = tstep.make_train_step(cfg, tx, use_amp=True, ema_decay=ema, grad_accum=accum,
                                     plain=plain)
        new, m = step(st, raw, drop_path_masks=masks)
        scale = 0.1 * min(1.0, cs.TRAIN_CLIP / float(m["grad_norm"]))
        readback[plain] = {n: v / scale for n, v in new["opt_state"].mu.items()}
        del st, new
    out["step_readback"] = gap(readback[False], readback[True])
    out["readback_vs_mean_kernel"] = gap(readback[False], k["mean"])
    out["readback_vs_mean_plain"] = gap(readback[True], p["mean"])
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
