// K1, the transformer block for bf16 and fp32 serving, as a sequence of
// launches driven by models/fused_block.py: LayerNorm, GEMM with a fused
// epilogue (bias, GELU, residual, cast) and attention.  The int8 block (K2,
// block_q8.cu) reuses the LayerNorm and the attention.
// Replaces easy_vitpose_tpu/models/fused_block.py::_block_kernel.
#include <cfloat>

#include "attention_tc.cuh"
#include "common.cuh"
#include "gemm_mma.cuh"

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

// ------------------------------------------------------------ f32 GEMM
// fp32 serving is the parity mode, so its GEMM runs in float32 FMA, not
// TF32.  64x64 tile, k-tile 16, 256 threads with 4x4 outputs each.
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                const float* __restrict__ bias, const float* res, float* out,
                int M, int N, int K, int epi) {
    __shared__ __align__(16) float As[16][64 + 4];   // [k][m]
    __shared__ __align__(16) float Ws[16][64 + 4];   // [k][n]
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int bm = blockIdx.y * 64, bn = blockIdx.x * 64;
    const int lr = tid >> 2, lk = (tid & 3) * 4;     // loader: row, k offset
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += 16) {
        float4 va = make_float4(0.f, 0.f, 0.f, 0.f);
        if (bm + lr < M) va = *reinterpret_cast<const float4*>(A + (size_t)(bm + lr) * K + k0 + lk);
        const float4 vw = *reinterpret_cast<const float4*>(W + (size_t)(bn + lr) * K + k0 + lk);
        As[lk + 0][lr] = va.x; As[lk + 1][lr] = va.y; As[lk + 2][lr] = va.z; As[lk + 3][lr] = va.w;
        Ws[lk + 0][lr] = vw.x; Ws[lk + 1][lr] = vw.y; Ws[lk + 2][lr] = vw.z; Ws[lk + 3][lr] = vw.w;
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = bm + ty * 4 + i;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = bn + tx * 4 + j;
            epilogue_store<float>(acc[i][j] + bias[col], epi, res, out, (size_t)row * N + col);
        }
    }
}

// out = epilogue(a @ w^T + bias): bf16 on the tensor cores, else float32.
// The caller guarantees N % 64 == 0 and K % 64 (bf16) or K % 16 (f32).
EVT_EXPORT int evt_gemm(const void* a, const void* w, const void* bias, const void* res,
                        void* out, int M, int N, int K, int is_bf16, int epi, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        return static_cast<int>(mma_gemm::launch<false, bf16, bf16>(
            a, w, nullptr, nullptr, bias, res, out, M, N, K * 2, epi, st));
    } else {
        dim3 grid(N / 64, (M + 63) / 64);
        gemm_f32_kernel<<<grid, 256, 0, st>>>(
            static_cast<const float*>(a), static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<const float*>(res),
            static_cast<float*>(out), M, N, K, epi);
    }
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- attention
// bf16: the tensor-core kernel of attention_tc.cuh.  float32 (the parity
// mode) keeps this FMA kernel: one block per (64-query tile, head, crop);
// K and V of the head (rows padded by one float against bank conflicts),
// the q tile and the 64 x N float32 logits sit in shared memory.  Logits,
// softmax and sums are float32.  The caller passes the scale already rounded
// to the working dtype, as JAX rounds a Python float that meets a bf16 array.
__global__ void __launch_bounds__(256)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ o, int N, int D,
                     int heads, float scale) {
    extern __shared__ float smem[];
    const int hd = D / heads, ld = hd + 1;
    const int q0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z;
    const int nq = min(64, N - q0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* Ks = smem;
    float* Vs = Ks + N * ld;
    float* Qs = Vs + N * ld;
    float* P = Qs + 64 * hd;
    const float* base = qkv + (size_t)b * N * 3 * D;

    for (int idx = tid; idx < N * hd; idx += 256) {
        const int j = idx / hd, d = idx - j * hd;
        const float* r = base + (size_t)j * 3 * D + h * hd + d;
        Ks[j * ld + d] = r[D];
        Vs[j * ld + d] = r[2 * D];
    }
    for (int idx = tid; idx < nq * hd; idx += 256) {
        const int i = idx / hd, d = idx - i * hd;
        Qs[idx] = base[(size_t)(q0 + i) * 3 * D + h * hd + d] * scale;
    }
    __syncthreads();

    for (int idx = tid; idx < nq * N; idx += 256) {
        const int i = idx / N, j = idx - i * N;
        const float* q = Qs + i * hd;
        const float* k = Ks + j * ld;
        float acc = 0.f;
        for (int d = 0; d < hd; ++d) acc = fmaf(q[d], k[d], acc);
        P[idx] = acc;
    }
    __syncthreads();

    for (int i = warp; i < nq; i += 8) {          // softmax, one warp per row
        float* p = P + i * N;
        float m = -FLT_MAX;
        for (int j = lane; j < N; j += 32) m = fmaxf(m, p[j]);
        m = warp_max(m);
        float s = 0.f;
        for (int j = lane; j < N; j += 32) {
            const float e = expf(p[j] - m);
            p[j] = e;
            s += e;
        }
        s = warp_sum(s);
        for (int j = lane; j < N; j += 32) p[j] = p[j] / s;
    }
    __syncthreads();

    for (int idx = tid; idx < nq * hd; idx += 256) {
        const int i = idx / hd, d = idx - i * hd;
        const float* p = P + i * N;
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc = fmaf(p[j], Vs[j * ld + d], acc);
        o[(size_t)(b * N + q0 + i) * D + h * hd + d] = acc;
    }
}

static cudaError_t attention_f32_launch(const void* qkv, void* o, int B, int N, int D,
                                        int heads, float scale, cudaStream_t st) {
    const int hd = D / heads;
    const size_t smem = sizeof(float) * (2 * (size_t)N * (hd + 1) + 64 * hd + 64 * (size_t)N);
    cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid((N + 63) / 64, heads, B);
    attention_f32_kernel<<<grid, 256, smem, st>>>(static_cast<const float*>(qkv),
                                                  static_cast<float*>(o), N, D, heads, scale);
    return cudaGetLastError();
}

static cudaError_t attention_bf16_launch(const void* qkv, void* o, int B, int N, int D,
                                         int heads, float scale, cudaStream_t st) {
    if (N <= 0 || N > attn_tc::MAX_TOKENS) return cudaErrorInvalidValue;
    ATTN_TC_DISPATCH(D / heads, attn_tc::fwd_launch, qkv, o, B, N, D, heads, scale, st);
}

EVT_EXPORT int evt_attention(const void* qkv, void* o, int B, int N, int D, int heads,
                             float scale, int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(is_bf16 ? attention_bf16_launch(qkv, o, B, N, D, heads, scale, st)
                                    : attention_f32_launch(qkv, o, B, N, D, heads, scale, st));
}
