"""The training block (``models/fused_block_train.py``: K5, K6b, K6c, K7)
against its bound (%): the sum of the four launches' bounds from what the
block's mathematics needs (``ops_count.train_block_kernels``: no
recomputation counted) over every block of every step, over the device
time of the block's hand-written kernels, found by name."""
import ops_count
from harness.readers import roofline_percent

BLOCK_KERNELS = ("gemm_bf16_kernel", "gemm_f32_kernel", "gemm_tn2_bf16_kernel",
                 "scale_colsum_kernel", "colsum_finish_kernel", "ln_backward_kernel",
                 "attn_bwd_q_f32_kernel", "attn_bwd_kv_f32_kernel", "layernorm_kernel",
                 "fwd_kernel", "bwd_q_kernel", "bwd_kv_kernel")


def read(run):
    c = run.config
    per_block = sum(ops_count.bound_s(b, o) for b, o in
                    ops_count.train_block_kernels(c, c["training"]["batch"]).values())
    return roofline_percent(run, per_block * c["depth"] * run.steps, BLOCK_KERNELS)
