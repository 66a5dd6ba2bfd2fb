"""PyTorch port: the training loop (``train/loop.py::train_model``), its
checkpoints, resume and fault tolerance, against the JAX package's.

One JAX loop and one port loop run for the module on the synthetic COCO set
of tests/test_torch_train_dataset.py (16 train and 16 val instances): the
tiny config with drop path 0 (the two packages draw from different random
streams), float32, batch 8, 2 epochs, the XLA block on both sides, Adam,
validation with PCK and the in-loop AP, a save every epoch, from the same
weights (the port's random init in JAX's tree, and carried back by
``state_dict_from_jax``) and the
same dataset seed.  JAX runs on its 8 virtual CPU devices, the port on the
CPU; 8 val instances a batch pad nothing on either.
"""
import dataclasses
import json
import os
import signal

import jax
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.train import dataset as jds
from easy_vitpose_tpu.train import loop as jloop
from easy_vitpose_tpu.utils.checkpoint import load_params
from easy_vitpose_tpu_torch.convert.from_jax import state_dict_from_jax, state_dict_to_jax
from easy_vitpose_tpu_torch.train import dataset as pds
from easy_vitpose_tpu_torch.train import loop as ploop
from easy_vitpose_tpu_torch.train import state_ckpt
from easy_vitpose_tpu_torch.train import step as pstep
from easy_vitpose_tpu_torch.train.fused_opt import make_fused_adam
from easy_vitpose_tpu_torch.train.resilient import train_model_resilient
from tests.test_torch_train_dataset import write_coco
from tests.test_torch_train_optim import jax_params, no_drop_path
from tests.test_torch_train_step import CFG, PCFG

torch.set_num_threads(2)
JCFG, TCFG = no_drop_path(CFG), no_drop_path(PCFG)
SETTINGS = dict(lr=1e-3, total_epochs=2, batch_size=8, use_amp=False, save_interval=1,
                ckpt_topk_epoch=0, eval_ap_interval=1, tensorboard=False)


def quiet(_):
    pass


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"))


def datasets(mod, coco_dir, seed=0):
    return (mod.CocoPoseDataset(coco_dir, "train2017", is_train=True, seed=seed),
            mod.CocoPoseDataset(coco_dir, "val2017", is_train=False))


def port_params(seed=0):
    return state_dict_from_jax(jax_params(seed), TCFG)


@pytest.fixture(scope="module")
def runs(coco_dir, tmp_path_factory):
    """The JAX loop's and the port's output and work dirs."""
    work = tmp_path_factory.mktemp("loops")
    j = jloop.train_model(jax_params(), JCFG,
                          *datasets(jds, coco_dir),
                          jloop.TrainSettings(**SETTINGS, work_dir=str(work / "jax")), log=quiet)
    p = ploop.train_model(port_params(), TCFG, *datasets(pds, coco_dir),
                          ploop.TrainSettings(**SETTINGS, save_full_state=True,
                                              work_dir=str(work / "port")),
                          log=quiet, device="cpu")
    return j, p, work


def test_history_matches_jax(runs):
    """Per epoch: the train loss to 1e-4 relative and the val loss to 5e-4
    (float32 sums in another order, JAX's over 8 devices, through 4 Adam
    steps; measured 1.0e-5 and 8.9e-5), the learning rate equal (the
    plateau controller saw the same losses), PCK and AP to 1e-3 (the argmax
    of two near-equal maps; measured 0; the random weights' AP is 0 on
    both, so the AP's own path is held in test_in_loop_ap_matches_jax)."""
    j, p, _ = runs
    assert [h["epoch"] for h in p["history"]] == [h["epoch"] for h in j["history"]] == [0, 1]
    for hj, hp in zip(j["history"], p["history"]):
        for k, tol in (("train_loss", 1e-4), ("val_loss", 5e-4)):
            assert abs(hp[k] - hj[k]) <= tol * hj[k], k
        assert hp["lr"] == hj["lr"]
        for k in ("val_acc", "val_ap"):
            assert hj[k] is not None and abs(hp[k] - hj[k]) <= 1e-3, k
    assert p["preempted"] is j["preempted"] is False


def test_checkpoints_load_in_jax(runs):
    """The port writes JAX's files: epoch000/001, best and last load with
    JAX's ``load_params``; last.npz is the run's final params and the full
    state's weights bit for bit (through the inverse converter).  Against
    JAX's run, from the same start: Adam moves a weight by about lr a step
    whatever its gradient's size, so a gradient near 0 may move it either
    way; at most 1% of each leaf's weights (and BN statistics) end more
    than lr apart (measured 0.01%), and the whole change agrees to 0.05 in
    relative L2 (measured 0.0044)."""
    j, p, work = runs
    names = sorted(os.listdir(work / "port"))
    assert {"epoch000.npz", "epoch001.npz", "best.npz", "last.npz", "loop_state.json",
            "train_state"} <= set(names)
    for f in ("epoch000.npz", "epoch001.npz", "best.npz"):
        tree = load_params(str(work / "port" / f))
        assert jax.tree.structure(tree) == jax.tree.structure(load_params(str(work / "jax" / f)))
    last = load_params(str(work / "port" / "last.npz"))
    jax.tree.map(np.testing.assert_array_equal, last, p["params"])
    st = state_ckpt.restore_train_state(str(work / "port" / "train_state"))
    full = state_dict_to_jax(pstep.merge_bn_state(st["params"], st["bn_state"]), TCFG)
    jax.tree.map(np.testing.assert_array_equal, last, full)
    jlast, init = load_params(str(work / "jax" / "last.npz")), jax_params()
    num = den = 0.0
    for x, y, z in zip(jax.tree.leaves(last), jax.tree.leaves(jlast), jax.tree.leaves(init)):
        assert float((np.abs(x - y) > SETTINGS["lr"]).mean()) <= 0.01
        num, den = num + float(((x - y) ** 2).sum()), den + float(((y - z) ** 2).sum())
    assert (num / den) ** 0.5 <= 0.05


def test_in_loop_ap_matches_jax(coco_dir, tmp_path, monkeypatch):
    """The in-loop AP's own path (the UDP decode of each val batch's
    heatmaps un-cropped by its metas, the results, ``CocoKeypointEval``) on
    heatmaps that score: the eval step patched to return the batch's target
    maps.  JAX's decode and AP on the same maps give the same AP (to 1e-9;
    the decodes agree to float32 rounding)."""
    from easy_vitpose_tpu.eval.cocoeval import CocoKeypointEval
    from easy_vitpose_tpu.ops.decode import keypoints_from_heatmaps_udp

    def targets_as_heatmaps(cfg, **kw):
        return lambda state, batch: (torch.zeros(()), torch.as_tensor(batch["targets"]))

    monkeypatch.setattr(ploop.steplib, "make_eval_step", targets_as_heatmaps)
    tr, va = datasets(pds, coco_dir)
    out = ploop.train_model(port_params(), TCFG, tr, va,
                            ploop.TrainSettings(**{**SETTINGS, "total_epochs": 1,
                                                   "save_interval": 0},
                                                work_dir=str(tmp_path / "ap")),
                            log=quiet, device="cpu")
    results = []
    for batch in jds.batch_iterator(datasets(jds, coco_dir)[1], 8, shuffle=False,
                                    drop_last=False):
        metas = batch["meta"]
        preds, maxv = keypoints_from_heatmaps_udp(
            batch["targets"], np.stack([m["center"] for m in metas]),
            np.stack([m["scale"] for m in metas]) * jds.PIXEL_STD)
        preds, maxv = np.asarray(preds), np.asarray(maxv)
        for i, m in enumerate(metas):
            results.append({"image_id": int(m["imgId"]), "category_id": 1,
                            "keypoints": [float(v) for v in
                                          np.concatenate([preds[i], maxv[i]], -1).ravel()],
                            "score": float(maxv[i].mean())})
    with open(va.ann_file) as f:
        ref = CocoKeypointEval(json.load(f), results).accumulate()["AP"]
    assert ref > 0.5
    assert abs(out["history"][0]["val_ap"] - ref) <= 1e-9


@pytest.mark.parametrize("layout", ["tiny", "vit_b"])
def test_state_dict_to_jax_round_trip(layout):
    """The inverse converter: port -> JAX -> port bit for bit, and the JAX
    tree the JAX package's own converter makes of the same state dict, bit
    for bit; with and without the BN statistics.  ViT-B's layout is its
    widths (D=768, 12 heads, the 256-channel head) at depth 2."""
    from easy_vitpose_tpu.configs import get_model_config as jcfg
    from easy_vitpose_tpu.convert.vitpose_torch import convert_vitpose_state_dict
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    if layout == "tiny":
        pcfg, cfg = PCFG, CFG
    else:
        pcfg, cfg = get_model_config("coco", "b"), jcfg("coco", "b")
        pcfg = dataclasses.replace(pcfg, backbone=dataclasses.replace(pcfg.backbone, depth=2))
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, depth=2))
    sd = init_params(pcfg, 0).state_dict()
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    tree = state_dict_to_jax(sd, pcfg)
    jax.tree.map(np.testing.assert_array_equal, tree,
                 convert_vitpose_state_dict({k: v.numpy() for k, v in sd.items()}, cfg))
    back = state_dict_from_jax(tree, pcfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    trainable, _ = pstep.split_bn_state(sd)
    back = state_dict_from_jax(state_dict_to_jax(trainable, pcfg, bn_state=False), pcfg,
                               bn_state=False)
    assert all(torch.equal(back[k], v) for k, v in trainable.items())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "ema", "adam"])
def test_full_state_round_trip(tmp_path, kind):
    """A state after one step, saved and restored into a fresh template:
    every tensor bit for bit (int8 codes and scales, bf16 moments, the EMA,
    the optax-chain state), on the template's tensors, and the next step
    from it equal to the next step from the original."""
    tx = pstep.make_optimizer(1e-3) if kind == "adam" else \
        make_fused_adam(1e-3, moment_dtype="f32" if kind == "ema" else kind)
    ema = 0.9 if kind == "ema" else 0.0
    step = pstep.make_train_step(TCFG, tx, use_amp=False, ema_decay=ema)
    batch = {"images_u8": np.random.default_rng(0).integers(0, 256, (2, 256, 192, 3), np.uint8),
             "joints": np.full((2, 17, 2), 60.0, np.float32),
             "joints_vis": np.ones((2, 17, 2), np.float32)}
    state, _ = step(pstep.init_train_state(port_params(), tx, ema_decay=ema, device="cpu"), batch)
    state_ckpt.save_train_state(str(tmp_path / "ts"), state)
    tmpl = pstep.init_train_state(port_params(1), tx, ema_decay=ema, device="cpu")
    tmpl_ptr = tmpl["params"]["backbone.pos_embed"].data_ptr()
    back = state_ckpt.restore_train_state(str(tmp_path / "ts"), template=tmpl)
    assert back["params"]["backbone.pos_embed"].data_ptr() == tmpl_ptr
    assert type(back["opt_state"]) is type(state["opt_state"])

    def flat(tree, pre=""):
        if hasattr(tree, "_asdict"):
            tree = tree._asdict()
        if isinstance(tree, dict) or hasattr(tree, "keys"):
            return {n: v for k in tree for n, v in flat(tree[k], f"{pre}/{k}").items()}
        return {pre: tree}

    a, b = flat(state), flat(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    for x, y in zip(flat(step(state, batch)[0]).values(), flat(step(back, batch)[0]).values()):
        assert torch.equal(x, y)


def test_pre_ema_resume_seeds_the_ema(coco_dir, tmp_path):
    """A checkpoint from a run without EMA resumed with ``ema_decay``: the
    template's ``ema_params`` are missing from it (a ValueError naming
    them), so the loop restores without them and seeds the EMA from the
    restored params."""
    base = ploop.TrainSettings(**{**SETTINGS, "total_epochs": 1, "eval_ap_interval": 0},
                               save_full_state=True, work_dir=str(tmp_path / "a"))
    tr, _ = datasets(pds, coco_dir)
    ploop.train_model(port_params(), TCFG, tr, None, base, log=quiet, device="cpu")
    sd = str(tmp_path / "a" / "train_state")
    tx = make_fused_adam(1e-3)
    tmpl = pstep.init_train_state(port_params(), pstep.make_optimizer(1e-3), ema_decay=0.9,
                                  device="cpu")
    with pytest.raises(ValueError, match="ema_params"):
        state_ckpt.restore_train_state(sd, template=tmpl)
    with pytest.raises(ValueError, match="optimizer mismatch"):
        state_ckpt.restore_train_state(sd, template=pstep.init_train_state(port_params(), tx,
                                                                           device="cpu"))
    logs = []
    out = ploop.train_model(port_params(), TCFG, tr, None,
                            dataclasses.replace(base, total_epochs=2, ema_decay=0.9,
                                                resume_state_dir=sd,
                                                work_dir=str(tmp_path / "b")),
                            log=logs.append, device="cpu")
    assert any("pre-EMA checkpoint" in ln for ln in logs)
    assert any("-> epoch 1" in ln for ln in logs)
    assert [h["epoch"] for h in out["history"]] == [1]


def test_loop_controllers_restore_into_fresh_work_dir(coco_dir, tmp_path):
    """The CLI's resume flow makes a new work dir: ``loop_state.json`` is
    read next to the resumed train state, and the plateau rate it holds is
    the resumed epoch's."""
    tr, _ = datasets(pds, coco_dir)
    base = ploop.TrainSettings(**{**SETTINGS, "eval_ap_interval": 0, "ckpt_topk_epoch": 10},
                               save_full_state=True, work_dir=str(tmp_path / "old"))
    ploop.train_model(port_params(), TCFG, tr, None, base, log=quiet, device="cpu")
    path = tmp_path / "old" / "loop_state.json"
    ctl = json.loads(path.read_text())
    assert set(ctl) == {"sched_lr", "sched_best", "sched_bad_epochs", "best_val", "patience",
                        "epoch"} and ctl["epoch"] == 1
    path.write_text(json.dumps({**ctl, "sched_lr": 4.56e-5}))
    logs = []
    out = ploop.train_model(port_params(), TCFG, tr, None,
                            dataclasses.replace(base, total_epochs=3,
                                                work_dir=str(tmp_path / "fresh"),
                                                resume_state_dir=str(tmp_path / "old" /
                                                                     "train_state")),
                            log=logs.append, device="cpu")
    assert any("restored loop controllers (lr 4.56e-05" in ln for ln in logs), logs
    assert [h["epoch"] for h in out["history"]] == [2]
    assert out["history"][0]["lr"] == pytest.approx(4.56e-5, rel=1e-6)


def test_bg_writer_plateau_and_partial_load_match_jax():
    """``_BgWriter``: ordered writes, an idempotent close, the first error
    raised at drain, as JAX's.  ``PlateauScheduler``: the same rates on the
    same metrics.  ``partial_load_for_finetune``: JAX's result on the same
    weights, with a 25-joint checkpoint's final layer replaced and a
    17-joint one's kept."""
    for mod in (ploop, jloop):
        w, hits = mod._BgWriter(), []
        w.submit(lambda: hits.append(1))
        w.submit(lambda: hits.append(2))
        w.close()
        w.close()
        assert hits == [1, 2]
        w2 = mod._BgWriter()
        w2.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            w2.close()
        w2.close()
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.98, 0.89, 0.9, 0.91, 0.92]
    sp, sj = ploop.PlateauScheduler(1e-3, 0.1, 2), jloop.PlateauScheduler(1e-3, 0.1, 2)
    assert [sp.step(m) for m in metrics] == [sj.step(m) for m in metrics]
    assert sp.lr == pytest.approx(1e-5)
    params = jax_params(0)
    cfg25 = dataclasses.replace(CFG, head=dataclasses.replace(CFG.head, num_keypoints=25))
    pcfg25 = dataclasses.replace(PCFG, head=dataclasses.replace(PCFG.head, num_keypoints=25))
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    for ck_j, ck_cfg in ((state_dict_to_jax(init_params(pcfg25, 3).state_dict(), pcfg25), pcfg25),
                         (jax_params(4), PCFG)):
        ref = jloop.partial_load_for_finetune(params, ck_j)
        got = ploop.partial_load_for_finetune(state_dict_from_jax(params, PCFG),
                                              state_dict_from_jax(ck_j, ck_cfg))
        want = state_dict_from_jax(jax.tree.map(np.asarray, ref), PCFG)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_drop_path_draws_follow_the_seed(coco_dir, tmp_path):
    """With drop path 0.2, two runs with one seed are equal and another seed
    differs: the generator is the run's (reseeded per epoch), not global."""
    tr_cfg = PCFG                                     # drop_path_rate 0.2
    hist = []
    for i, seed in enumerate((1, 1, 2)):
        s = ploop.TrainSettings(**{**SETTINGS, "total_epochs": 1, "save_interval": 0,
                                   "eval_ap_interval": 0}, seed=seed,
                                block_impl="pallas_train_interpret",
                                work_dir=str(tmp_path / f"r{i}"))
        out = ploop.train_model(port_params(), tr_cfg, *datasets(pds, coco_dir, seed=0)[:1], None,
                                s, log=quiet, device="cpu")
        hist.append(out["history"][0]["train_loss"])
    assert hist[0] == hist[1] != hist[2]


def test_train_model_runs_on_cuda_unless_asked(coco_dir, tmp_path):
    """Without a device the loop runs on CUDA: with no card it raises
    before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the chip smoke drives the loop there")
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        ploop.train_model(port_params(), TCFG, *datasets(pds, coco_dir),
                          ploop.TrainSettings(**SETTINGS, work_dir=str(tmp_path / "w")),
                          log=quiet)
    assert not (tmp_path / "w").exists()


def test_optimizer_options_are_checked_as_jax():
    """The option checks of ``loop.py:246-281``."""
    for kw, msg in ((dict(lr_policy="step"), "lr_policy='step'"),
                    (dict(optimizer="adamw_layer_decay", freeze_backbone=True), "freeze_backbone"),
                    (dict(optimizer="fused_adam", freeze_backbone=True), "freeze_backbone")):
        with pytest.raises(ValueError, match=msg):
            ploop.build_optimizer(TCFG, ploop.TrainSettings(**kw), 2)


class _Preemptible:
    """Raises once at the Nth cumulative sample access (a failure mid
    epoch), then behaves normally."""

    def __init__(self, ds, fail_at: int):
        self.ds, self.fail_at, self.count, self.tripped = ds, fail_at, 0, False

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.count += 1
        if not self.tripped and self.count == self.fail_at:
            self.tripped = True
            raise RuntimeError("simulated preemption")
        return self.ds[i]


class _KillAt(_Preemptible):
    """Sends this process SIGTERM once, at the Nth sample access."""

    def __getitem__(self, i):
        self.count += 1
        if not self.tripped and self.count == self.fail_at:
            self.tripped = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self.ds[i]


def resilient_settings(work, **kw):
    return ploop.TrainSettings(**{**SETTINGS, "eval_ap_interval": 0, "total_epochs": 3,
                                  "ckpt_topk_epoch": 10, **kw}, work_dir=str(work))


def test_resilient_restarts_after_a_failure(coco_dir, tmp_path):
    """A failure mid epoch 1, after epoch 0's full save: the wrapper
    restores the saved state and finishes, resuming at epoch 1."""
    tr, _ = datasets(pds, coco_dir)
    ds = _Preemptible(tr, fail_at=24)        # 2 steps of 8 an epoch: access 24 is in epoch 1
    logs = []
    out = train_model_resilient(port_params(), TCFG, ds, None, resilient_settings(tmp_path / "r"),
                                log=logs.append, max_restarts=2, device="cpu")
    text = "\n".join(logs)
    assert "transient failure" in text and "-> epoch 1" in text
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    assert (tmp_path / "r" / "last.npz").exists()


@pytest.mark.parametrize("error", [FloatingPointError, RuntimeError])
def test_resilient_retry_rules(coco_dir, tmp_path, monkeypatch, error):
    """NaN (FloatingPointError) is not retried; a failure that makes no
    progress is retried ``max_restarts`` times, then raised."""
    from easy_vitpose_tpu_torch.train import resilient as R
    calls = []

    def explode(*a, **k):
        calls.append(1)
        raise error("boom")

    monkeypatch.setattr(R, "train_model", explode)
    with pytest.raises(error, match="boom"):
        train_model_resilient(port_params(), TCFG, datasets(pds, coco_dir)[0], None,
                              resilient_settings(tmp_path / "r"), log=quiet, max_restarts=2,
                              device="cpu")
    assert len(calls) == (1 if error is FloatingPointError else 3)


def test_sigterm_checkpoints_and_resumes(coco_dir, tmp_path):
    """SIGTERM mid epoch 1 finishes the step in flight, saves the full
    state and last.npz even with periodic saves off, and returns
    ``preempted``; the resume re-enters epoch 1 and completes."""
    tr, _ = datasets(pds, coco_dir)
    ds = _KillAt(tr, fail_at=20)
    work = tmp_path / "sig"
    s = resilient_settings(work, total_epochs=3, save_interval=10 ** 6)
    logs = []
    out = ploop.train_model(port_params(), TCFG, ds, None, s, log=logs.append, device="cpu")
    assert out["preempted"] is True and ds.tripped
    assert "preempted at epoch 1" in "\n".join(logs)
    assert (work / "train_state" / "state.pt").exists() and (work / "last.npz").exists()
    assert [h["epoch"] for h in out["history"]] == [0]
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    out2 = ploop.train_model(port_params(1), TCFG, ds, None,
                             dataclasses.replace(s, resume_state_dir=str(work / "train_state")),
                             log=logs.append, device="cpu")
    assert out2["preempted"] is False
    assert [h["epoch"] for h in out2["history"]] == [1, 2]
