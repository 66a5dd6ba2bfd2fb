"""Time each launch of the wide MLP backward and each bf16 GEMM epilogue.

On one CUDA card, for ViT-L's and ViT-B's block 0 (random weights from
``--seed``) at 64 crops and bf16, as ``chip_smoke.py`` builds its inputs:

* each launch of K6e's sequence (``fused_block_train.mlp_backward_dw_cuda``):
  the LayerNorm, the fc1 recompute (NT, GELU saving the float32
  pre-activation), the column sums of dout, the grad through fc2 (NN,
  GELU-gradient epilogue), the column sums of dm1 and the weight-grad pair
  (TN), and K6e and K6b whole;
* the same NT and NN products under the other epilogues (none, GELU,
  float32 out, the flavors' rounded GELU save and GELU gradients), the NN
  product through fc1 (float32 out) and the forward's fc2 (drop-path
  residual), so that each epilogue's cost reads against the plain store.

CUDA events, the median of five windows of at least 50 ms
(``chip_smoke.time_ms``).  Then the host's time per call of the GEMM
wrappers at a tiny shape (128 x 64 x 128, where the card's time is
negligible): ``gemm_nt`` with one output and with two, ``gemm_tn2``, the
serving block's ``gemm_cuda`` and ``torch.matmul``, host clock over 500
calls without a synchronize.  Prints one JSON line per model and one for
the host.

Usage (repository root, one CUDA card):
    python3 scripts/bench_train_gemm_epilogues.py [--seed 0]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke as cs  # noqa: E402  (repo root; the smoke's inputs and timing)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    cs.check(torch.cuda.is_available(), "no CUDA device")
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train as fbt
    from easy_vitpose_tpu_torch.models.fused_block import layernorm_cuda
    from easy_vitpose_tpu_torch.models.vitpose import init_params

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    for size in ("l", "b"):
        model = init_params(get_model_config("coco", size), args.seed).to(dev)
        _, w, x1, dout, keep = cs.block_inputs(torch, model, np.random.default_rng(args.seed),
                                               dev, torch.bfloat16, cs.SLOTS, 0.5)
        eps = model.cfg.backbone.layer_norm_eps
        _, N, dt, x1r, doutr, dp = fbt._mlp_rows(x1, dout, keep, w)
        h2 = layernorm_cuda(x1r, w.ln2_w, w.ln2_b, eps, dt)
        g, mf = fbt.gemm_nt(h2, w.fc1_w, fbt.TE_GELU_SAVE, bias=w.fc1_b)
        dm2c = fbt.colsum_cuda(doutr, dt, dp, N, sums=False)[0]
        dm1 = fbt.gemm_nn(dm2c, w.fc2_w, fbt.TE_GELU_GRAD, aux=mf)[1]
        dm1c = fbt.colsum_cuda(dm1, dt)[0]
        m = g.clone()                         # a saved pre-activation of the right shape
        nt = lambda mode, **kw: lambda: fbt.gemm_nt(h2, w.fc1_w, mode, **kw)  # noqa: E731
        nn = lambda mode, **kw: lambda: fbt.gemm_nn(dm2c, w.fc2_w, mode, **kw)  # noqa: E731
        cases = {
            "ln": lambda: layernorm_cuda(x1r, w.ln2_w, w.ln2_b, eps, dt),
            "nt_gelu_save": nt(fbt.TE_GELU_SAVE, bias=w.fc1_b),
            "colsum_dout": lambda: fbt.colsum_cuda(doutr, dt, dp, N, sums=False),
            "nn_gelu_grad": nn(fbt.TE_GELU_GRAD, aux=mf),
            "colsum_dm1": lambda: fbt.colsum_cuda(dm1, dt),
            "tn_pair": lambda: fbt.gemm_tn2(dm1c, h2, dm2c, g),
            "K6e": lambda: fbt.mlp_backward_dw(x1, dout, keep, w, eps),
            "K6b": lambda: fbt.mlp_backward_dx_save(x1, dout, keep, w, eps),
            "nt_none": nt(fbt.TE_NONE),
            "nt_gelu": nt(fbt.TE_GELU, bias=w.fc1_b),
            "nt_f32": nt(fbt.TE_F32, bias=w.fc1_b),
            "nt_gelu_save_t": nt(fbt.TE_GELU_SAVE_T, bias=w.fc1_b),
            "nn_none": nn(fbt.TE_NONE),
            "nn_f32": nn(fbt.TE_F32),
            "nn_gelu_grad_t": nn(fbt.TE_GELU_GRAD_T, aux=mf),
            "nn_gelu_grad_ms": nn(fbt.TE_GELU_GRAD_MS, aux=m),
            "nn_dh2_f32": lambda: fbt.gemm_nn(dm1c, w.fc1_w, fbt.TE_F32),
            "nt_fc2_dp_res": lambda: fbt.gemm_nt(g, w.fc2_w, fbt.TE_DP_RES, bias=w.fc2_b,
                                                 res=x1r, dp=dp, tokens=N),
        }
        ms = {k: cs.time_ms(torch, f) for k, f in cases.items()}
        print(json.dumps({"card": card, "model": f"vit_{size}", "ms": ms}))
        del model, w, x1, dout, keep, h2, g, mf, dm2c, dm1, dm1c, m
        torch.cuda.empty_cache()

    from easy_vitpose_tpu_torch.models import fused_block as fb
    a, wt = (torch.randn(128, 64, device=dev).bfloat16() for _ in range(2))
    b = torch.zeros(128, device=dev, dtype=torch.bfloat16)
    r1, r2 = (torch.randn(256, 64, device=dev).bfloat16() for _ in range(2))
    calls = {
        "gemm_nt_none": lambda: fbt.gemm_nt(a, wt, fbt.TE_NONE),
        "gemm_nt_gelu_save": lambda: fbt.gemm_nt(a, wt, fbt.TE_GELU_SAVE, bias=b),
        "gemm_tn2": lambda: fbt.gemm_tn2(r1, r2, r1, r2),
        "serving_gemm_cuda": lambda: fb.gemm_cuda(a, wt, b),
        "torch_matmul": lambda: torch.matmul(a, wt.t()),
    }
    host = {}
    for k, f in calls.items():
        for _ in range(20):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            f()
        host[k] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    print(json.dumps({"card": card, "host_us_per_call": host}))


if __name__ == "__main__":
    main()
