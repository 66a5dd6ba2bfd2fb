"""PyTorch port: the plain versions of K1 (fused block) and K2 (int8 block)
vs the JAX package's block, its Pallas kernels in interpret mode, and its
int8 weight quantisation.  On the CPU each wrapper takes its plain version,
which these tests hold; the kernels themselves are held to the plain
versions on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easy_vitpose_tpu.models import quant as jquant
from easy_vitpose_tpu.models.fused_block import _gelu_exact, fused_block as jax_fused_block
from easy_vitpose_tpu.models.vit import block as jax_block
from easy_vitpose_tpu.models.vitpose import cast_params as jax_cast_params
from easy_vitpose_tpu_torch.models import fused_block, quant, vit
from easy_vitpose_tpu_torch.models.vitpose import cast_params
from tests.test_model_parity import CASES as JAX_CASES
from tests.test_torch_model import jax_params, port_model

torch.set_num_threads(1)
CFG = JAX_CASES["tiny"].backbone


@pytest.fixture(scope="module")
def setup():
    params = jax_params("tiny", seed=5)
    model = port_model(params, "tiny")
    layer0 = jax.tree.map(lambda a: a[0], params["backbone"]["blocks"])
    x = np.random.default_rng(5).standard_normal((2, 192, CFG.embed_dim)).astype(np.float32)
    return params, model, layer0, x


def test_gelu_matches_jax_kernel_gelu():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    ref = np.asarray(_gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(vit.gelu(torch.from_numpy(x)).numpy(), ref, atol=1e-6)


def test_block_f32_matches_jax_block_and_kernel(setup):
    _, model, layer0, x = setup
    with torch.no_grad():
        got = fused_block.fused_block(torch.from_numpy(x), model.backbone.blocks[0]).numpy()
    ref = np.asarray(jax_block(jnp.asarray(x), layer0, CFG.num_heads, CFG.layer_norm_eps))
    kern = np.asarray(jax_fused_block(jnp.asarray(x), layer0, CFG, interpret=True))
    # the bound of tests/test_fused_block.py: same math, A&S erf vs exact erf
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, kern, atol=1e-5)


def test_block_bf16_close_to_jax_kernel(setup):
    params, model, _, x = setup
    p16 = jax.tree.map(lambda a: a[0], jax_cast_params(params, jnp.bfloat16)["backbone"]["blocks"])
    kern = np.asarray(jax_fused_block(jnp.asarray(x, jnp.bfloat16), p16, CFG, interpret=True),
                      np.float32)
    blk = cast_params(model, torch.bfloat16).backbone.blocks[0]
    with torch.no_grad():
        got = fused_block.fused_block(torch.from_numpy(x).bfloat16(), blk).float().numpy()
    # bf16 roundings at the same points; sums in another order may flip one
    assert np.abs(got - kern).max() < 0.02 * np.ptp(kern)


def test_quantized_weights_bit_equal_to_jax(setup):
    params, model, _, _ = setup
    jq = jquant.quantize_vit_params(params)["backbone"]["blocks"]
    for i, blk in enumerate(model.backbone.blocks):
        qb = quant.QBlock(blk)
        for name, tree in (("qkv", jq), ("proj", jq), ("fc1", jq["mlp"]), ("fc2", jq["mlp"])):
            np.testing.assert_array_equal(getattr(qb, f"{name}_wq").numpy(),
                                          np.asarray(tree[f"{name}_wq"][i]).T)
            np.testing.assert_array_equal(getattr(qb, f"{name}_s").numpy(),
                                          np.asarray(tree[f"{name}_s"][i]))


def test_quant_rows_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((64, 96)) * rng.uniform(0.01, 30, (64, 1))).astype(np.float32)
    h[3] = 0.0                                    # an all-zero row keeps scale 1
    h[5, :4] = [0.5, -0.5, 1.5, 127.0]            # ties round half to even
    q, s = quant.quant_rows(torch.from_numpy(h))
    jq, js = jquant.quant_rows(jnp.asarray(h))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_q8_matches_jax(setup, dtype):
    _, model, _, x = setup
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax_params("tiny", seed=5)
    jq = jax.tree.map(lambda a: a[0], jquant.quantize_vit_params(params)["backbone"]["blocks"])
    xj = jnp.asarray(x, jdt)
    ref = np.asarray(jquant.block_q8(xj, jq, CFG.num_heads, CFG.layer_norm_eps), np.float32)
    kern = np.asarray(jquant.fused_block_q8(xj, jq, CFG, interpret=True), np.float32)
    with torch.no_grad():
        got = quant.fused_block_q8(torch.from_numpy(x).to(tdt),
                                   quant.QBlock(model.backbone.blocks[0])).float().numpy()
    # the bound of tests/test_quant.py: a flipped rint moves one int8 step
    span = np.ptp(ref)
    assert np.abs(got - ref).max() < 0.02 * span
    assert np.abs(got - kern).max() < 0.02 * span


def test_cuda_wrappers_refuse_cpu_only_and_bad_shapes():
    from easy_vitpose_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require_cuda(torch.zeros(2))
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_block.check_gemm_shape(96, 768, 2, True)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_block.check_gemm_shape(768, 96, 1, True)
    with pytest.raises(ValueError, match="shared memory"):
        fused_block.check_attention_shape(1024, 1024, 8)
    fused_block.check_gemm_shape(2304, 768, 2, True)      # ViT-B shapes pass
    fused_block.check_attention_shape(192, 768, 12)
