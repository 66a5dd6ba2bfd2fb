"""Ranks of the port's multi-process tests (tests/test_torch_parallel_*.py).

The tests start ``world`` processes with the ``spawn`` start method (the
test process holds JAX's threads, which ``fork`` would copy mid-flight);
they meet through a ``FileStore`` under the test's ``tmp_path`` (a
``file://`` address for ``parallel/mesh.py::initialize_distributed``, gloo
on the CPU), each with one torch thread, run a scenario of this module and
save its result with ``torch.save``.  This module imports the port and
numpy only, so a rank does not pay for importing JAX; the JAX references
are computed in the test process while the ranks run.

A rank's exception is written next to its result and fails the test; a
rank that does not finish within the join timeout is killed and fails it
too.
"""
from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

JOIN_TIMEOUT = 110.0


# ------------------------------------------------------------------ harness
class Ranks:
    """``world`` spawned ranks running ``scenario(rank, world, payload,
    wait)``; :meth:`join` returns their results in rank order."""

    def __init__(self, world: int, scenario: str, tmp_path, payload: Dict[str, Any]):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.dir = str(tmp_path)
        store = os.path.join(self.dir, "store")
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, store, scenario, payload, self.dir),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def provide(self, name: str, value) -> None:
        """Hand the ranks a value they :func:`wait` for (a reference the
        test process computes while they run)."""
        tmp = os.path.join(self.dir, f".{name}.tmp")
        torch.save(value, tmp)
        os.replace(tmp, os.path.join(self.dir, f"{name}.given"))

    def join(self, timeout: float = JOIN_TIMEOUT) -> List[Any]:
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        errors = []
        for r in range(len(self.procs)):
            err = os.path.join(self.dir, f"{r}.err")
            if os.path.exists(err):
                errors.append(f"rank {r}:\n" + open(err).read())
        if errors or hung:
            raise AssertionError(f"ranks {hung} did not finish in {timeout:.0f} s\n"
                                 + "\n".join(errors))
        bad = [(r, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode != 0]
        assert not bad, f"ranks exited with {bad}"
        return [torch.load(os.path.join(self.dir, f"{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]


def _entry(rank, world, store, scenario, payload, out_dir):
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist
        from easy_vitpose_tpu_torch.parallel.mesh import initialize_distributed

        initialize_distributed("file://" + store, world, rank, device="cpu")

        def wait(name: str, timeout: float = JOIN_TIMEOUT):
            path = os.path.join(out_dir, f"{name}.given")
            deadline = time.monotonic() + timeout
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no {name} from the test process")
                time.sleep(0.05)
            return torch.load(path, weights_only=False)

        t0 = time.perf_counter()
        result = SCENARIOS[scenario](rank, world, payload, wait)
        result["seconds"] = time.perf_counter() - t0
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the test, which fails
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def tensors(d) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def numpy(d) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


class SGD:
    """Plain SGD as an ``Optimizer`` of the port (``optax.sgd``): the
    update is linear in the gradients, so a comparison of two steps is not
    magnified by Adam's ``g / (|g| + eps)`` on near-zero gradients."""

    def __new__(cls, lr: float):
        from easy_vitpose_tpu_torch.train.step import AdamState, Optimizer

        def init(params):
            z = torch.zeros((), dtype=torch.int32)
            return AdamState(z, {}, {}, {"learning_rate": torch.tensor(lr)})

        def update(grads, state, params, g_norm=None):
            return ({k: g * (-lr) for k, g in grads.items()},
                    state._replace(count=state.count + 1))

        return Optimizer(init, update)


# ---------------------------------------------------------------- scenarios
def dp(rank, world, p, wait):
    """The data-parallel step at float32, with ``grad_accum=2`` and with an
    EMA, two steps each from the same state with the given global masks;
    then two steps drawing the global masks from a seeded generator."""
    from easy_vitpose_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from easy_vitpose_tpu_torch.train import step as ps

    mesh = make_mesh(device="cpu")
    assert mesh.size == world and mesh.rank == rank
    tx = SGD(p["lr"])
    out = {}
    for name, kw in p["variants"].items():
        state = ps.init_train_state(tensors(p["params"]), tx,
                                    ema_decay=kw.get("ema_decay", 0.0), device="cpu")
        step = ps.make_train_step_sharded(p["cfg"], tx, mesh, use_amp=False, **kw)
        losses = []
        for t in range(2):
            gen = None
            masks = torch.from_numpy(p["masks"][t]) if name != "generator" else None
            if name == "generator":
                gen = torch.Generator().manual_seed(p["seed"] + t)
            state, m = step(state, shard_batch(mesh, p["batches"][t]), gen, masks)
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "params": numpy(state["params"]),
                     "bn": numpy(state["bn_state"]),
                     "ema": numpy(state["ema_params"]) if "ema_params" in state else None}
    out["moe"] = _moe(rank, world, p["moe"], wait, mesh)
    return out


def _moe(rank, world, p, wait, mesh):
    """The sharded MoE step: coco from the initial state, then aic."""
    from easy_vitpose_tpu_torch.parallel.mesh import shard_batch
    from easy_vitpose_tpu_torch.train import moe_step as pm
    from easy_vitpose_tpu_torch.train import step as ps

    tx = ps.make_optimizer(p["lr"])
    cfg = p["cfg"]
    state = pm.init_moe_train_state(tensors(p["params"]), tx, device="cpu")
    s1, m1 = pm.make_moe_train_step_sharded(cfg, tx, mesh, "coco", use_amp=False)(
        state, shard_batch(mesh, p["batches"]["coco"]))
    s2, m2 = pm.make_moe_train_step_sharded(cfg, tx, mesh, "aic", use_amp=False)(
        s1, shard_batch(mesh, p["batches"]["aic"]))
    return {"losses": [float(m1["loss"]), float(m2["loss"])], "coco": s1, "aic": s2}


def model_parallel(rank, world, p, wait):
    """Tensor parallelism in layouts (2, 2) and (1, 4), two steps each;
    expert parallelism over the (2, 2) layout's model groups; the pipeline
    at 2 stages (ranks {0, 1} and {2, 3}) and 4 stages."""
    import torch.distributed as dist
    from easy_vitpose_tpu_torch.parallel import pp, tp
    from easy_vitpose_tpu_torch.train import step as ps

    out = {"tp": {}}
    for layout in ((2, 2), (1, 4)):
        mesh = tp.make_mesh_2d(*layout, device="cpu")
        tx = SGD(p["tp"]["lr"])
        state = tp.shard_state(ps.init_train_state(tensors(p["tp"]["params"]), tx, device="cpu"),
                               mesh)
        step = tp.make_tp_train_step(p["tp"]["cfg"], tx, mesh, use_amp=False)
        batch = p["tp"]["batch"]
        rows = mesh.data.shard(len(batch["images"]), mesh.data.rank)
        metrics = []
        for _ in range(2):
            state, m = step(state, {k: v[rows] for k, v in batch.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        shard = state["params"]["backbone.blocks.0.attn.qkv.weight"].shape
        out["tp"][layout] = {"metrics": metrics, "qkv_shard": tuple(shard),
                             "params": numpy(tp.gather_params(state["params"], mesh))}
        if layout == (2, 2):
            out["ep"] = _ep(p["ep"], mesh.model)
    out["pp"] = {}
    for stages in (2, 4):
        groups = [dist.new_group(list(range(g, g + stages))) for g in range(0, world, stages)]
        group = groups[rank // stages]
        mesh = pp.make_pipe_mesh(stages, device="cpu", group=group)
        out["pp"][stages] = _pp(p["pp"], mesh)
    try:
        pp.stage_layers(6, mesh)
        out["pp_depth_raises"] = False
    except ValueError as e:
        out["pp_depth_raises"] = "not divisible" in str(e)
    return out


def _ep(p, mesh):
    """Each task's forward with its expert fetched from its owner, and the
    expert's gradient, which reaches only the owner, against the unsharded
    forward's under autograd."""
    from easy_vitpose_tpu_torch.models import moe
    from easy_vitpose_tpu_torch.parallel import tp

    cfg, full = p["cfg"], tensors(p["params"])
    local = tp.shard_experts(full, mesh)
    x = torch.from_numpy(p["crops"])
    out = {"held": sorted(k for k in local if ".experts." in k)}
    for task in ("coco", "aic"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in local.items()}
        heat = tp.ep_vitpose_plus_forward(leaves, x, cfg, task, mesh, 2, plain=True)
        cot = torch.from_numpy(p["cot"][task])
        (heat * cot).sum().backward()
        ref_leaves = {k: v.clone().requires_grad_(True) for k, v in full.items()}
        ref = moe.vitpose_plus_forward(ref_leaves, x, cfg, task, plain=True)
        (ref * cot).sum().backward()
        e = ("coco", "aic").index(task)
        names = [f"backbone.blocks.{i}.mlp.experts.{e}.{w}" for i in range(cfg.backbone.depth)
                 for w in ("weight", "bias")]
        grads = {k: (leaves[k].grad, ref_leaves[k].grad) for k in names if k in leaves}
        out[task] = {
            "heat": heat.detach().numpy(), "equal_to_unsharded": bool(torch.equal(heat, ref)),
            "expert_grad_err": max((float((a - b).abs().max()) for a, b in grads.values()),
                                   default=None),
            "expert_grad_scale": max((float(b.abs().max()) for _, b in grads.values()),
                                     default=None)}
    return out


def _pp(p, mesh):
    """The pipelined backbone's output and the gradients of every leaf this
    stage holds, of ``sum(out * cot)``."""
    from easy_vitpose_tpu_torch.parallel import pp

    cfg = p["cfg"].backbone
    local = {k: v.requires_grad_(True) for k, v in
             pp.stage_params(tensors(p["params"]), cfg.depth, mesh).items()
             if k.startswith("backbone.")}
    out = pp.pipeline_vit_forward(local, torch.from_numpy(p["x"]), cfg, mesh, n_micro=p["n_micro"])
    (out * torch.from_numpy(p["cot"])).sum().backward()
    return {"out": out.detach().numpy(), "layers": list(pp.stage_layers(cfg.depth, mesh)),
            "grads": {k: v.grad.numpy() for k, v in local.items()}}


def cuda_hand_off(rank, world, p, wait):
    """Two gloo ranks sharing cuda:0 (tests/test_torch_cuda.py): the
    pipeline's hand-off of CUDA tensors, staged through host memory (each
    of ``p["messages"]`` sent from rank 0 and received by rank 1, whose
    gradient comes back), then the pipelined backbone at float32 and the
    gradients of every leaf its stage holds, beside the one-process plain
    backbone's on the card."""
    from easy_vitpose_tpu_torch.models.vit import vit_forward_train
    from easy_vitpose_tpu_torch.parallel import comm, pp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {"messages": []}
    for tag, (x, cot) in enumerate(p["messages"]):
        x, cot = torch.from_numpy(x).to(dev), torch.from_numpy(cot).to(dev)
        if rank == 0:
            leaf = x.clone().requires_grad_(True)
            zero = comm.send_to(leaf, 1, tag)
            zero.backward()
            out["messages"].append({"grad": leaf.grad.cpu().numpy(), "zero": float(zero)})
        else:
            anchor = torch.zeros((), device=dev, requires_grad=True)
            y = comm.recv_from(x.shape, x.dtype, 0, tag, anchor)
            (y.float() * cot.float()).sum().backward()
            out["messages"].append({"got": y.detach().cpu().numpy(), "device": str(y.device)})
    cfg = p["cfg"].backbone
    mesh = pp.make_pipe_mesh(world, device=dev)
    full = {k: torch.from_numpy(v).to(dev) for k, v in p["params"].items()
            if k.startswith("backbone.")}
    x, cot = torch.from_numpy(p["x"]).to(dev), torch.from_numpy(p["cot"]).to(dev)
    local = {k: v.clone().requires_grad_(True)
             for k, v in pp.stage_params(full, cfg.depth, mesh).items()}
    got = pp.pipeline_vit_forward(local, x, cfg, mesh, n_micro=p["n_micro"])
    (got * cot).sum().backward()
    ref_leaves = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    ref = vit_forward_train(ref_leaves, x, cfg, block_impl="xla")
    (ref * cot).sum().backward()
    out["pp"] = {"out": got.detach().cpu().numpy(), "ref": ref.detach().cpu().numpy(),
                 "layers": list(pp.stage_layers(cfg.depth, mesh)),
                 "grads": {k: (v.grad.cpu().numpy(), ref_leaves[k].grad.cpu().numpy())
                           for k, v in local.items()}}
    return out


SCENARIOS = {"dp": dp, "model_parallel": model_parallel, "cuda_hand_off": cuda_hand_off}


# ------------------------------------------------------- the training CLI
def train_cli(argv) -> None:
    """``easy_vitpose_tpu_torch.cli.train.main(argv)`` on a tiny model (D=64,
    depth 2, 4 heads, no drop-path) and without TensorBoard (its import
    takes TensorFlow's seconds): the CLI's flags and files at test size.
    Run as ``python -m torch.distributed.run ... -m
    tests.torch_parallel_workers ARGS`` for one rank of a process group, or
    called in-process."""
    from easy_vitpose_tpu_torch import configs as tc
    from easy_vitpose_tpu_torch.cli import train as cli

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    cfg = tc.ModelConfig("tiny", "coco", tc.BackboneConfig(embed_dim=64, depth=2, num_heads=4),
                         tc.HeadConfig(in_channels=64, num_keypoints=17, deconv_filters=(16, 16)))
    cli.get_model_config = lambda dataset, size: cfg
    cli.main(argv)


if __name__ == "__main__":
    train_cli(sys.argv[1:])
