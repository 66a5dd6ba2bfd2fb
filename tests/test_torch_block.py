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


def port_block(layer, cfg) -> vit.Block:
    """A float32 port Block holding one JAX block's params (linears (in, out))."""
    from easy_vitpose_tpu_torch import configs as tc
    blk = vit.Block(tc.BackboneConfig(embed_dim=cfg.embed_dim, depth=1, num_heads=cfg.num_heads,
                                      layer_norm_eps=cfg.layer_norm_eps))
    m = layer["mlp"]
    sd = {"norm1.weight": layer["ln1_s"], "norm1.bias": layer["ln1_b"],
          "attn.qkv.weight": layer["qkv_w"].T, "attn.qkv.bias": layer["qkv_b"],
          "attn.proj.weight": layer["proj_w"].T, "attn.proj.bias": layer["proj_b"],
          "norm2.weight": layer["ln2_s"], "norm2.bias": layer["ln2_b"],
          "mlp.fc1.weight": m["fc1_w"].T, "mlp.fc1.bias": m["fc1_b"],
          "mlp.fc2.weight": m["fc2_w"].T, "mlp.fc2.bias": m["fc2_b"]}
    blk.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    return blk


def test_block_bf16_head_dim_32_rounds_the_scale():
    """At head_dim 32 the scale 32**-0.5 is not exact in bf16, and JAX rounds
    it to bf16 before q*scale.  A bf16 block at D=64 with 2 heads, its qkv
    weights scaled up so the logits span several units and the MLP branch
    zeroed so the output is the attention residual: the port agrees with the
    Pallas kernel (interpret) to at most one bf16 ulp, in under 0.5% of the
    elements (sums in another order; an ulp of the larger of the output and
    the input it adds to), and with the XLA block (bf16 logits) to two ulps
    of the largest output.  An unrounded scale flips ~7% of the elements."""
    from easy_vitpose_tpu.configs import BackboneConfig
    from easy_vitpose_tpu.models.vit import init_vit_params

    cfg = BackboneConfig(embed_dim=64, depth=1, num_heads=2)
    layer = jax.tree.map(lambda a: a[0], init_vit_params(jax.random.PRNGKey(3), cfg)["blocks"])
    layer["qkv_w"] = layer["qkv_w"] * 12.0
    layer["mlp"]["fc2_w"] = layer["mlp"]["fc2_w"] * 0.0
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), layer)
    x = np.random.default_rng(0).standard_normal((3, 192, 64)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    kern = np.asarray(jax_fused_block(xj, p16, cfg, interpret=True), np.float32)
    xla = np.asarray(jax_block(xj, p16, cfg.num_heads, cfg.layer_norm_eps), np.float32)
    blk = port_block(layer, cfg).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_block.fused_block(torch.from_numpy(x).bfloat16(), blk).float().numpy()

    xb = np.asarray(xj, np.float32)

    def ulp(a, b):     # bf16 keeps 8 significant bits
        mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(xb))
        return 2.0 ** (np.floor(np.log2(mag + 1e-30)) - 7)

    d = np.abs(got - kern)
    assert np.all(d <= ulp(got, kern)) and np.mean(d > 0) < 0.005
    assert np.abs(got - xla).max() <= 2 * ulp(np.abs(xla).max(), 0.0).max()


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


def test_resolve_device_never_falls_back_to_the_cpu():
    """The entry points' device rule: the device asked for, else that of the
    tensor given, else CUDA, which raises where there is none."""
    from easy_vitpose_tpu_torch.kernels import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(None, torch.zeros(2)) == torch.device("cpu")
    assert resolve_device("cpu", np.zeros(2)) == torch.device("cpu")
    if not torch.cuda.is_available():
        for like in (None, np.zeros(2)):
            with pytest.raises(RuntimeError, match="runs on CUDA.*device='cpu'"):
                resolve_device(None, like)
    else:
        assert resolve_device(None, np.zeros(2)).type == "cuda"


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


# The bf16 kernels' shape rules are plain Python (models/fused_block.py,
# models/fused_block_train.py): what a CUDA call checks before it launches.
@pytest.mark.parametrize("size", ["s", "b", "l", "h"])
def test_shape_checks_accept_each_vit_size(size):
    """The token count, head dims (32, 64, 64, 80) and linear widths of
    ViTPose-S/B/L/H pass every check, at bf16, float32 and int8."""
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models import fused_block_train
    bb = get_model_config("coco", size).backbone
    D, N, heads, hidden = bb.embed_dim, bb.num_tokens, bb.num_heads, int(bb.embed_dim * bb.mlp_ratio)
    for dt in (torch.bfloat16, torch.float32):
        fused_block.check_attention_shape(N, D, heads, dt)
        fused_block_train.check_train_shapes(N, D, hidden, heads, dt)
    for n, k in ((3 * D, D), (D, D), (hidden, D), (D, hidden)):
        fused_block.check_gemm_shape(n, k, 2, True)
        fused_block.check_gemm_shape(n, k, 1, True)
        fused_block.check_gemm_shape(n, k, 4, False)


@pytest.mark.parametrize("check,args,match", [
    ("attention", (192, 40, 2), "head dim 20.*multiple of 8"),
    ("attention", (192, 272, 2), "head dim 136.*up to 128"),
    ("attention", (257, 768, 12), "257 tokens.*1 to 256"),
    ("attention", (0, 768, 12), "0 tokens.*1 to 256"),
    ("attention", (192, 770, 12), "does not split"),
    ("train", (300, 768, 3072, 12), "300 tokens.*1 to 256"),
    ("train", (192, 768, 100, 12), "multiples of 8"),
    ("gemm", (96, 768, 2), "width 96 is not a multiple of 64"),
    ("gemm", (768, 96, 2), "depth 96 is not a multiple of 64"),
    ("gemm", (768, 192, 1), "depth 192 is not a multiple of 128"),
])
def test_shape_checks_refuse_bad_shapes(check, args, match):
    """No fallback: a shape the bf16 (or int8) kernels do not take raises
    ValueError before any launch."""
    from easy_vitpose_tpu_torch.models import fused_block_train
    with pytest.raises(ValueError, match=match):
        if check == "attention":
            fused_block.check_attention_shape(*args, torch.bfloat16)
        elif check == "train":
            fused_block_train.check_train_shapes(*args, torch.bfloat16)
        else:
            fused_block.check_gemm_shape(*args, True)
