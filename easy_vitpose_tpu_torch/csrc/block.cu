// K1, the transformer block for bf16 and fp32 serving, as a sequence of
// launches driven by models/fused_block.py: LayerNorm, GEMM with a fused
// epilogue (bias, GELU, residual, cast) and attention; at fp32 the GEMM and
// the attention run 3xTF32 on the tensor cores (gemm_tf32.cuh,
// attention_tf32.cuh), and a split kernel makes the weights' TF32 halves.
// The int8 block (K2, block_q8.cu) reuses the LayerNorm and the attention.
// Replaces easy_vitpose_tpu/models/fused_block.py::_block_kernel.

#include "attention_tc.cuh"
#include "attention_tf32.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"
#include "gemm_tf32.cuh"

// ------------------------------------------------------------- LayerNorm
// One warp per row, float32 statistics: mean = sum/D, var = mean((x-mean)^2),
// y = (x - mean) * rsqrt(var + eps) * w + b, cast to TO.
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(256)
layernorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                 const TW* __restrict__ b, TO* __restrict__ out, int R, int D, float eps) {
    const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= R) return;
    const TX* xr = x + (size_t)row * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int i = lane; i < D; i += 32) {
        const float d = to_f(xr[i]) - mean;
        v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + eps);
    TO* o = out + (size_t)row * D;
    for (int i = lane; i < D; i += 32)
        o[i] = from_f<TO>((to_f(xr[i]) - mean) * rstd * to_f(w[i]) + to_f(b[i]));
}

template <typename TX, typename TW, typename TO>
static void ln_launch(const void* x, const void* w, const void* b, void* out, int R, int D,
                      float eps, cudaStream_t st) {
    layernorm_kernel<TX, TW, TO><<<(R + 7) / 8, 256, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<const TW*>(b),
        static_cast<TO*>(out), R, D, eps);
}

template <typename TX, typename TW>
static void ln_out(const void* x, const void* w, const void* b, void* out, int R, int D,
                   float eps, int out_bf16, cudaStream_t st) {
    if (out_bf16) ln_launch<TX, TW, bf16>(x, w, b, out, R, D, eps, st);
    else ln_launch<TX, TW, float>(x, w, b, out, R, D, eps, st);
}

template <typename TX>
static void ln_w(const void* x, const void* w, const void* b, void* out, int R, int D,
                 float eps, int w_bf16, int out_bf16, cudaStream_t st) {
    if (w_bf16) ln_out<TX, bf16>(x, w, b, out, R, D, eps, out_bf16, st);
    else ln_out<TX, float>(x, w, b, out, R, D, eps, out_bf16, st);
}

EVT_EXPORT int evt_layernorm(const void* x, const void* w, const void* b, void* out, int R,
                             int D, float eps, int x_bf16, int w_bf16, int out_bf16,
                             void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_bf16) ln_w<bf16>(x, w, b, out, R, D, eps, w_bf16, out_bf16, st);
    else ln_w<float>(x, w, b, out, R, D, eps, w_bf16, out_bf16, st);
    return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- GEMMs
// out = epilogue(a @ w^T + bias) in bf16 on the tensor cores (gemm_mma.cuh).
// The caller guarantees N % 64 == 0 and K % 64 == 0.
EVT_EXPORT int evt_gemm(const void* a, const void* w, const void* bias, const void* res,
                        void* out, int M, int N, int K, int epi, void* stream) {
    return static_cast<int>(mma_gemm::launch<false, bf16, bf16>(
        a, w, nullptr, nullptr, bias, res, out, M, N, K * 2, epi,
        static_cast<cudaStream_t>(stream)));
}

// float32 serving is the parity mode: its GEMM is 3xTF32 on the warpgroup
// tensor cores (gemm_tf32.cuh), from w's split halves, a split in
// registers.  The caller guarantees K % 32 == 0, N % 64 == 0 and the
// alignments.
EVT_EXPORT int evt_gemm_tf32(const void* a, const void* w_hi, const void* w_lo,
                             const void* bias, const void* res, void* out, int M, int N, int K,
                             int epi, void* stream) {
    return static_cast<int>(tf::launch(
        a, w_hi, w_lo, bias, res, out, M, N, K, epi, static_cast<cudaStream_t>(stream)));
}

// x's n floats -> their TF32 halves (the weights' split, once per copy)
EVT_EXPORT int evt_split_tf32(const void* x, void* hi, void* lo, long long n, void* stream) {
    const long long blocks = (n + 255) / 256;
    tf::split_kernel<<<static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo), n);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- attention
// bf16: attention_tc.cuh's kernel; float32 (the parity mode): the 3xTF32
// kernel of attention_tf32.cuh.  The caller passes the scale already
// rounded to the working dtype, as JAX rounds a Python float that meets a
// bf16 array.
static cudaError_t attention_bf16_launch(const void* qkv, void* o, int B, int N, int D,
                                         int heads, float scale, cudaStream_t st) {
    if (N <= 0 || N > attn_tc::MAX_TOKENS) return cudaErrorInvalidValue;
    ATTN_TC_DISPATCH(D / heads, attn_tc::fwd_launch, qkv, o, B, N, D, heads, scale, st);
}

EVT_EXPORT int evt_attention(const void* qkv, void* o, int B, int N, int D, int heads,
                             float scale, int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(is_bf16 ? attention_bf16_launch(qkv, o, B, N, D, heads, scale, st)
                                    : attn_tf32::launch(qkv, o, B, N, D, heads, scale, st));
}
