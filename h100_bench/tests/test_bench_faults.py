"""A run whose timed path is broken underneath reads ``correct`` false.

Each test drives a whole run of a cell at a tiny size on the CPU (the
look for a card skipped), first sound, then with one fault planted in the
port under the harness.  The limits here are three times the larger of
two sound runs' readings, so that each fault has to stand out from what
rounding gives at this size; exact numbers keep 0, and a number that
reads 0 on both sound runs takes 1.
"""
import json

import pytest

from harness import core

SEED = 2 ** 31 + 11
EXACT = ("not_finite", "masked_nonzero")


def run_once(bench, workload, limits=None, seed=SEED):
    import run as bench_run

    cell = core.Cell(core.load_manifest(bench.parent), workload, bench=bench)
    if limits is not None:
        cell.limits = limits
    return bench_run.run_cell(cell, seed, 0.3, False, "cpu")


def sound_limits(lines):
    worst = {k: max(line["compared"][k]["value"] for line in lines) for k in lines[0]["compared"]}
    return {k: 0.0 if k in EXACT else (3.0 * v if v > 0 else 1.0) for k, v in worst.items()}


@pytest.mark.parametrize("workload,names", [
    ("pose-b-int8-64", ("pose_half", "pose_swap", "pose_shift")),
    ("train-l-q8m-64", ("train_unchanged", "train_half"))])
def test_faults_read_incorrect(tiny_bench, workload, names):
    from tools.faults import FAULTS

    limits = sound_limits([run_once(tiny_bench, workload, seed=SEED + k) for k in (0, 1)])
    assert run_once(tiny_bench, workload, limits)["correct"]
    for name in names:
        with FAULTS[name]():
            line = run_once(tiny_bench, workload, limits)
        assert not line["correct"], (name, json.dumps(line["compared"]))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pose-b-int8-64", "train-l-q8m-64"])
def test_control_fails_at_the_cells_size(cuda_card, workload):
    """The control (the reference one precision down in the program's
    place) fails the cell's limits on three seeds, at the cell's size."""
    import run as bench_run
    from reference import compare

    cell = core.Cell(core.load_manifest(), workload)
    limits = cell.limits
    for seed in (101, 2 ** 31 + 3, 7):
        ctx = bench_run.Context(cell, seed, 0, False, cuda_card)
        got = core.load_driver(cell.traffic["kind"]).control(ctx)
        assert not compare.passes(compare.held({k: got[k] for k in limits}, limits)), (seed, got)
