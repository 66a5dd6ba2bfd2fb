"""The mixed-task ViTPose+ cell's operation and byte counts
(``h100_bench/ops_count_plus.py``) against counts made by hand from the
published ViTPose+-H widths."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "h100_bench") not in sys.path:
    sys.path.insert(0, str(ROOT / "h100_bench"))

import ops_count  # noqa: E402
import ops_count_plus as opp  # noqa: E402

H = json.loads((ROOT / "h100_bench" / "configs" / "vitpose-plus-h-int8.json").read_text())


def test_published_widths_and_the_expert_split():
    assert (H["embed_dim"], H["depth"], H["num_heads"], ops_count.hidden(H)) == (1280, 32, 16, 5120)
    assert ops_count.tokens(H) == 192
    assert (opp.expert_rows(H), opp.shared_rows(H)) == (320, 960)
    cut = {**H, "embed_dim": 64}
    assert (opp.expert_rows(cut), opp.shared_rows(cut)) == (16, 48)


@pytest.mark.parametrize("rows,experts", [(192, 1), (12288, 6), (64 * 192, 4), (0, 0)])
def test_expert_slice_at_stated_rows(rows, experts):
    b, ops = opp.expert_gemm(H, rows, experts)
    assert ops == {"int8": 2.0 * rows * 5120 * 320}
    assert b == rows * 5120 + experts * 320 * 5120 + rows * 320 * 2


def test_expert_slice_of_a_64_crop_step():
    _, ops = opp.expert_gemm(H, 64 * 192, 6)
    assert ops["int8"] == pytest.approx(40.27e9, rel=1e-3)          # 40.3 GOP a block
    assert ops["int8"] / 1979e12 == pytest.approx(20.35e-6, rel=1e-3)


@pytest.mark.parametrize("k", [14, 16, 17, 133])
def test_head_ops_at_each_k(k):
    deconv1 = 2 * 1280 * (16 * 12) * 256 * 16      # each input value meets a 4x4 window
    deconv2 = 2 * 256 * (32 * 24) * 256 * 16
    final = 2 * 256 * (64 * 48) * k
    assert opp.head_ops(H, k) == deconv1 + deconv2 + final


def test_wholebody_head_against_aic():
    assert opp.head_ops(H, 133) - opp.head_ops(H, 14) == 2 * 256 * 64 * 48 * 119


def test_a_crop_counts_its_whole_fc2_minus_nothing():
    """A ViTPose+-H crop: 2 192 12 1280^2 int8 operations a block (qkv 3D^2,
    proj D^2, fc1 4D^2, fc2 4D^2 of which the shared rows give 3D^2 and the
    expert's D^2), over 32 blocks."""
    per_block = 2 * 192 * 12 * 1280 ** 2
    for k in (14, 133):
        ops = opp.crop_ops(H, k)
        assert ops["int8"] == 32 * per_block
        assert ops["bf16"] == (32 * 4 * 192 * 192 * 1280 + 2 * 192 * 1280 * 16 * 16 * 3
                               + opp.head_ops(H, k))
    shared = 2 * 192 * 5120 * opp.shared_rows(H)
    expert = opp.expert_gemm(H, 192, 1)[1]["int8"]
    assert shared + expert == 2 * 192 * 5120 * 1280


def test_a_step_adds_its_crops_at_their_own_k():
    by_k = {17: 40, 14: 6, 16: 6, 133: 12}
    want = sum(n * ops_count.ops_s(opp.crop_ops(H, k)) for k, n in by_k.items())
    assert opp.crops_ops_s(H, by_k) == pytest.approx(want, rel=1e-12)
    assert opp.crops_ops_s(H, {133: 1}) > opp.crops_ops_s(H, {14: 1})
