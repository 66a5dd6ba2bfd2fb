"""PyTorch port: ``python -m easy_vitpose_tpu_torch.cli.train`` with
``--device cpu`` on the synthetic COCO set of
tests/test_torch_train_dataset.py.

The CLI builds the model of ``--model-name``; here ``get_model_config`` is
patched to the tiny config (D=96, depth 2) with the dataset's joints, so
each run is a few CPU seconds: the flags, presets, resume paths and files
are what is held.  The loop itself is held against JAX's in
tests/test_torch_train_loop.py.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from easy_vitpose_tpu_torch.cli import train as cli
from easy_vitpose_tpu_torch.train.step import make_step_lr_schedule
from tests.test_torch_train_dataset import write_coco
from tests.test_torch_train_optim import no_drop_path
from tests.test_torch_train_step import PCFG

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"))


@pytest.fixture(autouse=True)
def tiny_model(monkeypatch):
    """The tiny model, and no TensorBoard (its import takes TensorFlow's
    13 s here; the loop then logs that scalars are off)."""
    monkeypatch.setattr(cli, "get_model_config", lambda dataset, size: no_drop_path(PCFG))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def run(coco_dir, work, *flags, config=None):
    argv = ["--data-root", coco_dir, "--model-name", "b", "--batch-size", "8", "--no-amp",
            "--device", "cpu", "--work-dir", str(work), *flags]
    if config:
        path = work.parent / f"{work.name}.yaml"
        path.write_text("".join(f"{k}: {v}\n" for k, v in config.items()))
        argv += ["--config", str(path)]
    cli.main(argv)
    with open(work / "history.json") as f:
        return json.load(f)


def test_finetune_fused_cli(coco_dir, tmp_path, capsys):
    """The finetune preset with ``--fused-block --fused-opt``: the plain
    versions of the training block on the CPU (with the CLI's notice), the
    fused Adam, validation with PCK and AP every epoch, epoch saves from
    the yaml config, history.json and last.npz."""
    work = tmp_path / "ft"
    hist = run(coco_dir, work, "--fused-block", "--fused-opt", "--epochs", "2",
               "--eval-ap-interval", "1", config={"save_interval": 1})
    assert "plain versions" in capsys.readouterr().out
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and h["val_acc"] is not None
               and h["val_ap"] is not None and h["lr"] == 3.75e-4 for h in hist)
    assert {"epoch000.npz", "epoch001.npz", "last.npz"} <= set(os.listdir(work))


def test_from_scratch_cli(coco_dir, tmp_path):
    """The from-scratch preset: AdamW with layer decay under the warmup
    schedule, whose value at the count before each epoch's last update is
    the history's rate (16 instances, batch 8: 2 steps an epoch)."""
    hist = run(coco_dir, tmp_path / "fs", "--preset", "from-scratch", "--epochs", "2")
    sched = make_step_lr_schedule(5e-4, 2, milestones=(170, 200), gamma=0.1,
                                  warmup_iters=500, warmup_ratio=1e-3)
    assert [h["lr"] for h in hist] == [float(sched(1)), float(sched(3))]


def test_int8_resilient_then_resume_state_and_resume_from(coco_dir, tmp_path, capsys):
    """``--opt-moments int8 --resilient`` saves the full state (int8
    moments) every epoch of the yaml's interval; ``--resume-state`` into a
    fresh work dir continues at the next epoch with the controllers read
    next to it; ``--resume-from`` starts from the first run's last.npz."""
    first = tmp_path / "a"
    run(coco_dir, first, "--opt-moments", "int8", "--resilient", "--epochs", "1",
        config={"save_interval": 1})
    assert (first / "train_state" / "state.pt").exists()
    hist = run(coco_dir, tmp_path / "b", "--opt-moments", "int8", "--epochs", "2",
               "--resume-state", str(first / "train_state"))
    assert [h["epoch"] for h in hist] == [1]
    capsys.readouterr()
    hist = run(coco_dir, tmp_path / "c", "--epochs", "1", "--resume-from",
               str(first / "last.npz"))
    assert ">>> resumed from" in capsys.readouterr().out and len(hist) == 1


def test_cli_runs_on_cuda_unless_asked(coco_dir, tmp_path):
    """Without ``--device`` the CLI trains on CUDA, and raises before any
    work without a card; ``--fused-block`` takes the kernels on CUDA."""
    assert cli._fused_train_impl(torch.device("cuda", 0)) == "pallas_train"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="runs on CUDA"):
        cli.main(["--data-root", coco_dir, "--model-name", "b", "--work-dir",
                  str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()


def test_stem_channels_from_yaml_cli(coco_dir, tmp_path):
    """A yaml ``stem_channels`` trains the hybrid-stem model (here 4 stages,
    the 16x12 grid): one epoch with ``--fused-block --fused-opt``, and its
    ``last.npz`` holds JAX's stem leaves, which load back into a stem model.
    The stem's math is held to JAX's in tests/test_torch_stem.py."""
    from easy_vitpose_tpu_torch.configs import with_stem
    from easy_vitpose_tpu_torch.convert.from_jax import state_dict_from_jax
    from easy_vitpose_tpu_torch.models.vitpose import ViTPose
    from easy_vitpose_tpu_torch.utils.checkpoint import load_params

    work = tmp_path / "stem"
    hist = run(coco_dir, work, "--fused-block", "--fused-opt", "--epochs", "1",
               config={"stem_channels": "[8, 8, 16, 16]"})
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    tree = load_params(str(work / "last.npz"))
    stem = tree["backbone"]["stem"]
    assert [c["w"].shape for c in stem["convs"]] == [(3, 3, 3, 8), (3, 3, 8, 8),
                                                     (3, 3, 8, 16), (3, 3, 16, 16)]
    assert stem["proj_w"].shape == (16, 96) and "patch_w" not in tree["backbone"]
    cfg = with_stem(no_drop_path(PCFG), (8, 8, 16, 16))
    ViTPose(cfg).load_state_dict(state_dict_from_jax(tree, cfg))
