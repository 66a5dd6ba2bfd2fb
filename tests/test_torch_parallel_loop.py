"""PyTorch port: the training loop and CLI under a process group
(``train/loop.py``, ``cli/train.py``) against one process.

``python -m torch.distributed.run --standalone --nproc-per-node 2`` runs
``cli/train.py``'s ``main`` with ``--device cpu`` (gloo) on the tiny
model (tests/torch_parallel_workers.py::train_cli) over a synthetic COCO
set of 5 instances a split, a global batch of 4: one step an epoch, two
epochs, and a validation of 4 rows then a tail of 1, which the ranks pad
to 2.  The same CLI in this process is the one-process run.  Both load
with ``--workers 1``, whose samples draw their augmentation from their
own seeds, so each global batch is the same rows augmented alike (with a
thread loader each rank's draws follow its own order).  Per-step losses,
validation losses and PCK agree within 1e-5; only rank 0 logs and writes.
JAX's tail padding is held by its own formula (``loop.py:491-501``).
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from easy_vitpose_tpu_torch.train.loop import pad_to_devices
from tests.test_torch_train_dataset import write_coco
from tests.torch_parallel_workers import train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def argv(coco, work):
    return ["--data-root", coco, "--model-name", "b", "--batch-size", "4", "--no-amp",
            "--device", "cpu", "--epochs", "2", "--workers", "1", "--fused-block",
            "--fused-opt", "--work-dir", str(work)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process history, two-rank history, the ranks' stdout, the
    two-rank work dir)."""
    d = tmp_path_factory.mktemp("loop")
    (d / "coco").mkdir()
    coco = write_coco(d / "coco", n_images=5, per_image=1)
    logs = d / "logs"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--log-dir", str(logs), "--redirects", "3", "-m", "tests.torch_parallel_workers",
         *argv(coco, d / "two")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    train_cli(argv(coco, d / "one"))
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    stdout = {}
    for r in (0, 1):
        (path,) = glob.glob(str(logs / "**" / str(r) / "stdout.log"), recursive=True)
        stdout[r] = open(path).read()
    hist = [json.load(open(d / w / "history.json")) for w in ("one", "two")]
    return hist[0], hist[1], stdout, d / "two"


def test_two_ranks_match_one_process(runs):
    """Each epoch's one step, its validation loss (the tail padded on the
    ranks) and PCK: the two ranks' run against the one-process run."""
    one, two, _, _ = runs
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        for k in ("train_loss", "val_loss", "val_acc"):
            assert abs(a[k] - b[k]) <= 1e-5 * max(abs(a[k]), 1e-3), (k, a[k], b[k])
        assert a["lr"] == b["lr"]


def test_only_rank_zero_logs_and_writes(runs):
    """Rank 0 logs the epochs and writes the checkpoints and history; rank 1
    prints nothing of them."""
    _, _, stdout, work = runs
    assert "[ep 000]" in stdout[0] and ">>> done" in stdout[0]
    assert "[ep" not in stdout[1] and ">>> done" not in stdout[1] and "#== train" not in stdout[1]
    assert "2 device(s)" in stdout[0]
    assert {"last.npz", "history.json"} <= set(os.listdir(work))


def jax_pad(b, n_dev):
    """JAX's tail padding (easy_vitpose_tpu/train/loop.py:491-501)."""
    n_orig = len(b["images"])
    if n_orig % n_dev:
        pad = n_dev - n_orig % n_dev
        reps = -(-pad // n_orig) + 1
        b = {k: np.concatenate([v] * reps)[:len(v) + pad] for k, v in b.items()}
    return b


@pytest.mark.parametrize("n_dev", [2, 3, 8])
def test_tail_padding_is_jaxs(n_dev):
    """The loop's padding of a tail validation batch equals JAX's, rows and
    all, for every tail size."""
    for n in range(1, 10):
        b = {"images": np.arange(n * 2).reshape(n, 2), "targets": np.arange(n) * 10}
        got, want = pad_to_devices({**b, "meta": [{}] * n}, n_dev), jax_pad(b, n_dev)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
