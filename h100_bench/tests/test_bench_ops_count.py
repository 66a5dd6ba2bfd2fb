"""The frozen counts against hand counts."""
import json

import pytest

import ops_count
from conftest import BENCH


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_vit_b_and_l_linears_per_block():
    b, l_ = config("vitpose-b-int8"), config("vitpose-l-finetune-q8m")
    assert ops_count.tokens(b) == 192
    # 2 * 192 * (4 D^2 + 8 D^2): 2.72 GFLOP at D = 768, 4.83 at 1024
    assert ops_count.block_linear_ops(b) == pytest.approx(2.718e9, rel=1e-3)
    assert ops_count.block_linear_ops(l_) == pytest.approx(4.832e9, rel=1e-3)
    assert ops_count.block_attention_ops(b) == 4.0 * 192 * 192 * 768


def test_whole_forward_and_training_per_crop():
    b, l_ = config("vitpose-b-int8"), config("vitpose-l-finetune-q8m")
    # head: deconv 768->256 on 16x12, 256->256 on 32x24 (4x4 windows), 1x1 to 17
    head = 2 * 768 * 192 * 256 * 16 + 2 * 256 * 768 * 256 * 16 + 2 * 256 * 3072 * 17
    assert ops_count.head_ops(b) == head
    assert ops_count.forward_ops(b) == pytest.approx(37.1e9, rel=5e-3)
    ops = ops_count.serving_ops(b)
    assert ops["int8"] == 12 * ops_count.block_linear_ops(b)
    assert ops_count.train_ops(l_) == pytest.approx(369e9, rel=5e-3)


def test_bounds_and_optimizer_bytes():
    assert ops_count.bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert ops_count.bound_s(0, {"bf16": 989e12, "int8": 1979e12}) == pytest.approx(2.0)
    # the norm reads g (4); K9 reads g, p, m, v (4 + 4 + 1 + 1), writes p, m, v (4 + 1 + 1)
    assert ops_count.adam_q8_bytes(1000) == 1000 * (4 + (4 + 4 + 1 + 1) + (4 + 1 + 1))
    b = config("vitpose-b-int8")
    nbytes, ops = ops_count.k2_block(b, 64)
    assert nbytes == 12 * 768 * 768 + 2 * 64 * 192 * 768 * 2
    assert ops["int8"] == 64 * ops_count.block_linear_ops(b)



def test_training_block_counts_the_mathematics_only():
    """Forward: 4 D^2 + 8 D^2 of linears and two attention products.  The
    MLP's backward: four GEMMs (dx and dW of fc1 and fc2), 2 * 2 * 8 D^2 a
    row.  The attention half's backward: dx and dW of qkv and proj (2 * 2 *
    4 D^2 a row) and four products (dP, dV, dQ, dK).  No recomputation:
    per row 72 D^2 + 12 N D in all."""
    l_ = config("vitpose-l-finetune-q8m")
    B, N, D = 64, 192, 1024
    R = B * N
    k = ops_count.train_block_kernels(l_, B)
    ops = {name: o["bf16"] for name, (_, o) in k.items()}
    assert ops["K5"] == 2 * R * 12 * D * D + 2 * 2 * R * N * D
    assert ops["K6b"] == ops["K6c"] == 2 * 2 * R * D * 4 * D
    assert ops["K7"] == 2 * 2 * R * 4 * D * D + 4 * 2 * R * N * D
    assert sum(ops.values()) == pytest.approx(R * (72 * D * D + 12 * N * D))
    # three times the forward's block operations, the attention products as well
    fwd = ops_count.block_linear_ops(l_) + ops_count.block_attention_ops(l_)
    assert sum(ops.values()) == pytest.approx(3 * B * fwd)
