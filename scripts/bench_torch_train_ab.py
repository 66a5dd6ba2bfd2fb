"""Time the default training path of one checkout of the PyTorch port.

For the checkout at ``--root`` (default: this repository) it imports that
checkout's ``chip_smoke.py`` and package, and on one CUDA card:

* times K5, K6a, K7 and K8 on ViT-B's block 0 (``check_train_kernels``) and
  K6b, K6c and K9 on ViT-L's (``check_wide_kernels``) at 64 crops, as that
  checkout's smoke does (CUDA events, median of five windows), K6d and K6e
  (the wide recompute flavor's pair) on ViT-L's block 0 at bf16, and the bf16
  attention backward alone (``attention_backward_cuda``, both its kernels)
  at each model's shapes on seeded qkv and output grads;
* times the bf16 training GEMM per launch in its three layouts (NT, NN and
  the TN pair) at each model's MLP shapes and 64 crops, with the cases of
  this script's own ``chip_smoke.check_train_gemms`` run on the checkout's
  package (the wrappers ``gemm_nt``, ``gemm_nn`` and ``gemm_tn2`` keep one
  interface), with TFLOP/s and ``torch.matmul``'s ms on the same operands;
* times ``make_fused_adam(...).fused_apply`` through the public API, float32
  moments on ViT-B's 157 leaves and int8 on ViT-L's 301, from non-zero
  moments, on seeded gradients: device time as the smoke times a kernel,
  and the host time of one call (median of five);
* times the ViT-B (float32 moments) and ViT-L (int8 moments) AMP train
  steps of 64 crops with no ``EVT_TRAIN_*`` switch set: host clock around
  synchronized steps, median of five windows of three steps after two
  warm-up steps.

It prints one JSON line.  To compare two checkouts on one card, run it on
each in turns in one call, A, B, B, A:

    python3 scripts/bench_torch_train_ab.py --root PARENT_DIR
    python3 scripts/bench_torch_train_ab.py --root .
"""
import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np


def time_fused_apply(torch, cs, fused_opt, model, moments, seed):
    """(device ms, host ms) of one ``fused_apply`` on the model's trainable
    leaves (see the module doc)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {k: v.detach().float().clone() for k, v in model.named_parameters()}
    grads = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3 for k, v in params.items()}
    tx = fused_opt.make_fused_adam(cs.TRAIN_LR, max_grad_norm=cs.TRAIN_CLIP, moment_dtype=moments)
    params, state, _ = tx.fused_apply(grads, tx.init(params), params)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.fused_apply(grads, state, params)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return cs.time_ms(torch, lambda: tx.fused_apply(grads, state, params)), statistics.median(host)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "smoke_gemms", os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "chip_smoke.py"))
    gemm_cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gemm_cases)
    for var in ("EVT_TRAIN_ATTN", "EVT_TRAIN_MLP", "EVT_TRAIN_WIDE"):
        os.environ.pop(var, None)

    import torch
    import chip_smoke as cs
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from easy_vitpose_tpu_torch import kernels
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.check(os.path.dirname(kernels.__file__).startswith(root), "imported another checkout")
    kernels.build()
    dev = torch.device("cuda")
    out = {"root": root}
    for size, moments, check in (("b", "f32", cs.check_train_kernels),
                                 ("l", "int8", cs.check_wide_kernels)):
        model = init_params(get_model_config("coco", size), args.seed).to(dev)
        meas = check(torch, model, np.random.default_rng(args.seed), dev)
        out.update({f"{k}_ms": v["ms"] for k, v in meas.items()})
        out[f"gemm_vit_{size}"] = gemm_cases.check_train_gemms(
            torch, model, np.random.default_rng(args.seed), dev)
        if size == "l":
            _, w, x1, dout, keep = cs.block_inputs(torch, model, np.random.default_rng(args.seed),
                                                   dev, torch.bfloat16, cs.SLOTS, 0.5)
            eps = model.cfg.backbone.layer_norm_eps
            out["K6d_ms"] = cs.time_ms(torch, lambda: fbt.mlp_backward_dx(x1, dout, keep, w, eps))
            out["K6e_ms"] = cs.time_ms(torch, lambda: fbt.mlp_backward_dw(x1, dout, keep, w, eps))
            del w, x1, dout, keep
        bb = model.cfg.backbone
        rows, g = cs.SLOTS * bb.num_tokens, np.random.default_rng(args.seed)
        qkv, do = (torch.from_numpy((g.standard_normal((rows, c)) * sc).astype(np.float32))
                   .to(dev, torch.bfloat16) for c, sc in ((3 * bb.embed_dim, 1.0),
                                                          (bb.embed_dim, 0.02)))
        out[f"attn_backward_vit_{size}_ms"] = cs.time_ms(torch, lambda: fbt.attention_backward_cuda(
            qkv, do, cs.SLOTS, bb.num_tokens, bb.num_heads))
        del qkv, do
        key = f"fused_apply_vit_{size}_{moments}"
        out[f"{key}_ms"], out[f"{key}_host_ms"] = time_fused_apply(torch, cs, fused_opt, model,
                                                                   moments, args.seed)
        batch = cs.train_batch(torch, np.random.default_rng(args.seed), cs.SLOTS, dev)
        tx = fused_opt.make_fused_adam(cs.TRAIN_LR, max_grad_norm=cs.TRAIN_CLIP,
                                       moment_dtype=moments)
        state = tstep.init_train_state(model, tx, device=dev)
        step = tstep.make_train_step(model.cfg, tx, use_amp=True)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        for _ in range(2):
            state, _ = step(state, batch, gen)

        def window():
            nonlocal state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / 3

        out[f"step_vit_{size}_ms"] = statistics.median(window() for _ in range(5))
        del model, state
        torch.cuda.empty_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
