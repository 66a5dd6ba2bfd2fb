"""Traffic kind ``train_step``: the training entry, queued back to back.

Set-up builds one training state (the configuration's optimizer, its
moments at the stated dtype) and one step from ``make_train_step``, and a
pool of ``batches`` device-input batches (uint8 crops, joints, visibility,
each row its own draw) with their stochastic-depth masks, all on the card.
The first ``check_steps`` steps run through the window's own call on
distinct batches; the state after the first and after the last of them is
kept for the comparison, and that same state goes on into the window.  The
window queues steps on the next pool batch with no host sync, and the loss
is fetched once when it closes; images per second count every image of
every step, up to the end of the last one.
"""
from __future__ import annotations

import time

from harness import inputs, weights
from harness.trace import WINDOW, span
from reference import compare, vitpose_ref


def made(ctx, n: int):
    """The benchmark's weights, and the first ``n`` of its batches and
    masks (all ``batches`` of them with ``n`` None)."""
    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    B = c["training"]["batch"]
    p0 = weights.vitpose_weights(weights.port_config(c), ctx.seed, dev)
    data = inputs.train_batches(ctx.seed, tr["batches"], B, c["num_keypoints"], c["img_size"],
                                dev)
    masks = inputs.drop_path_masks(ctx.seed, tr["batches"], c["depth"], B, c["drop_path_rate"],
                                   dev)
    return p0, {k: v[:n] for k, v in data.items()}, masks[:n]


def reference(ctx, p0, data, masks, fp8: bool = False) -> dict:
    """The reference's readings of the first steps, leaves read by name."""
    ref = vitpose_ref.train_steps(p0, data, masks, ctx.config, ctx.traffic["check_steps"], fp8)
    return dict(ref, mu1=ref["mu1"].__getitem__, p3=ref["p3"].__getitem__)


def control(ctx) -> dict:
    """The control: the reference with fp8 (e4m3) operands, the next
    precision down from bf16, in the program's place."""
    n = ctx.traffic["check_steps"]
    p0, data, masks = made(ctx, n)
    ref = reference(ctx, p0, data, masks)
    nums, losses = compare.train_numbers(reference(ctx, p0, data, masks, fp8=True), ref, p0)
    return {**nums, **losses}


def run(ctx):
    from easy_vitpose_tpu_torch.train import fused_opt, step as tstep

    c, tr, dev = ctx.config, ctx.traffic, ctx.device
    tc = c["training"]
    cfg = weights.port_config(c)
    p0, data, masks = made(ctx, None)
    ctx.mark("inputs")
    tx = fused_opt.make_fused_adam(tc["lr"], max_grad_norm=tc["max_grad_norm"],
                                   moment_dtype=tc["moments"])
    state = tstep.init_train_state(p0, tx, device=dev)
    step = tstep.make_train_step(cfg, tx, use_amp=tc["amp"] == "bf16",
                                 render_kwargs={"sigma": tc["sigma"]})
    P, B, n = tr["batches"], tc["batch"], tr["check_steps"]
    ctx.mark("program")

    def one(state, i):
        j = i % P
        with span("bench.step"):
            return step(state, {k: v[j] for k, v in data.items()}, None, masks[j])

    losses = []
    for i in range(n):
        state, m = one(state, i)
        losses.append(m["loss"])
        if i == 0:      # the first moment's codes after one step
            mu = state["opt_state"].mu
            mu1 = {k: (mu["q_tree"][k].clone(), mu["s_tree"][k].clone(), tuple(v.shape))
                   for k, v in state["params"].items()}
    p3 = {k: v.clone() for k, v in state["params"].items()}
    ctx.mark("first_steps")
    n_params = sum(v.numel() for v in p3.values())
    with ctx.profiled() as prof:
        with span(WINDOW):
            ctx.start_window()
            t0 = time.perf_counter()
            deadline, i = t0 + ctx.seconds, n
            while time.perf_counter() < deadline:
                state, m = one(state, i)
                i += 1
            with span("bench.fetch"):
                last = float(m["loss"])
            t1 = time.perf_counter()
    ctx.end_window(prof)
    steps = i - n
    prog = {"losses": [float(v) for v in losses], "p3": p3.__getitem__,
            "mu1": lambda k: vitpose_ref.q8_decode(*mu1[k])}
    del state, step, mu, m
    ctx.free()
    ref = reference(ctx, p0, {k: v[:n] for k, v in data.items()}, masks[:n])
    nums, losses = compare.train_numbers(prog, ref, p0)
    return ctx.result(setup_s=ctx.setup_s, window_s=t1 - t0, units=steps * B, steps=steps,
                      attempted=steps, failed=int(last != last or abs(last) == float("inf")),
                      numbers=nums, params=n_params,
                      diag={**losses, "loss_last": last, "losses": prog["losses"],
                            "ref_losses": ref["losses"]})
