"""The benchmark's own tests: ``python -m pytest h100_bench/tests -q``.

CPU tests run the harness at a tiny size on the port's plain versions; the
tests marked ``cuda`` run on a card and skip without one."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"embed_dim": 64, "depth": 2, "num_heads": 2, "deconv_filters": [16, 16]}


def tiny_copy(dst: Path) -> Path:
    """A copy of the benchmark under ``dst`` (``h100_bench/`` and
    ``BENCHMARK.json``) with each configuration cut to a tiny width and
    depth and each traffic mix to a few small steps, for the CPU."""
    shutil.copytree(BENCH, dst / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for p in (dst / "h100_bench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(TINY)
        if "training" in c:
            c["training"]["batch"] = 4
        p.write_text(json.dumps(c))
    shrink = {"pose_step": dict(frames=3, frame_hw=[540, 960], slots=8, masked=2,
                                warmup_steps=1, enqueue_steps=2, check_steps=2),
              "train_step": dict(batches=4)}
    for p in (dst / "h100_bench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(shrink.get(t["kind"], {}))
        p.write_text(json.dumps(t))
    return dst / "h100_bench"


@pytest.fixture
def tiny_bench(tmp_path):
    return tiny_copy(tmp_path)


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
