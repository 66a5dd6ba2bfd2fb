// K5, K6a-K6e and K7: the training block's forward and its backward, in
// every flavor of the JAX package, as sequences of launches driven by
// models/fused_block_train.py.  LayerNorm and the forward attention come
// from block.cu (K1); this file adds
//
//   * a GEMM for the three layouts a backward needs, C = A . B^T over K with
//     A (M, K) and B (N, K) each stored K-contiguous or not: NT (the forward
//     and recompute products, x W^T), NN (activation grads, dY W) and TN
//     (weight grads, dY^T X, contracted over all rows).  bf16 on wgmma
//     (gemm_wgmma.cuh, each operand read as stored) or float32 FMA.  One
//     block owns one output tile for the whole K loop, so a weight grad is
//     one deterministic sum with no atomics.  The TN products come in
//     pairs, a backward's two weight grads in one launch whose grid covers
//     the tiles of both (K6c, and the weight grads of K6a, K6e, K7);
//   * epilogues: bias, GELU, the drop-path residual round(x + dp * (acc + b))
//     with the branch kept in float32, GELU saving the pre-activation (in
//     float32 for the recompute flavors, rounded to the working dtype for
//     the saved-m flavor's forward), and the GELU derivative of a float32
//     pre-activation or of a saved one (which also gives the saved flavor's
//     GELU output, so saved m costs no launch of its own);
//   * a row kernel for the LayerNorm backward and a two-stage column sum for
//     the bias and LayerNorm grads (partials per row chunk, then one fixed-
//     order sum per column);
//   * the attention backward for one (crop, head) split over two kernels by
//     query tiles (o, dq, softmax statistics) and key tiles (dk, dv), each
//     recomputing the logits, so that K, V, Q and dO fit shared memory: at
//     bf16 on the tensor cores (attention_tc.cuh), at float32 in FMA here;
//   * the flavors are launch sequences driven from Python: K6b is K6a's
//     sequence up to dx1, K6c the pair launch of its two weight grads; K6d
//     and K6e split K6a's sequence at dx1 with the recompute repeated; the
//     saved flavors skip a recompute GEMM.
// Replaces easy_vitpose_tpu/models/fused_block_train.py::_fwd_kernel,
// _bwd_mlp_kernel, _bwd_mlp_kernel_ms, _bwd_mlp_dx_kernel,
// _bwd_mlp_dx_save_kernel, _bwd_mlp_dx_save_kernel_ms,
// _bwd_mlp_dw_saved_kernel, _bwd_mlp_dw_kernel, _bwd_attn_kernel and
// _bwd_attn_saved_kernel.
#include <cfloat>

#include "attention_tc.cuh"
#include "common.cuh"
#include "gemm_wgmma.cuh"

enum {
    TE_NONE = 0,          // out = round(acc + bias)
    TE_GELU = 1,          // out = round(gelu(acc + bias))
    TE_DP_RES = 2,        // out = round(res + dp[row / tokens] * (acc + bias))
    TE_GELU_SAVE = 3,     // out2 (float32) = acc + bias; out = round(gelu(out2))
    TE_GELU_GRAD = 4,     // out2 (float32) = acc * gelu'(aux), aux float32
    TE_F32 = 5,           // out2 (float32) = acc + bias
    TE_GELU_SAVE_T = 6,   // out = round(gelu(acc + bias)); out2 (T) = round(acc + bias)
    TE_GELU_GRAD_T = 7,   // out = round(acc * gelu'(aux)), aux float32
    TE_GELU_GRAD_MS = 8,  // aux T: out2 (float32) = acc * gelu'(aux); out = round(gelu(aux))
};

struct Epi {
    int mode, tokens, ldo;
    const void* bias;   // T per column, or null
    const void* res;    // T (M, ldo)
    const float* dp;    // per crop
    const void* aux;    // (M, ldo): float32, or T for TE_GELU_GRAD_MS
    void* out;          // T
    void* out2;         // float32, or T for TE_GELU_SAVE_T
};

__device__ __forceinline__ float gelu_grad(float x) {
    const float cdf = 0.5f * (1.0f + erf_as(x * 0.7071067811865476f));
    const float pdf = expf(-0.5f * x * x) * 0.3989422804014327f;
    return cdf + x * pdf;
}

// The float32 GEMM's epilogues come in two families, each compiled into
// kernels of its own: the default path's (TE_NONE .. TE_F32) and the
// flavors' (TE_GELU_SAVE_T .. TE_GELU_GRAD_MS).  One kernel holding all nine
// made the default path's GELU epilogues 6-10% slower (PERF.md).  The bf16
// GEMM goes further: one kernel per mode (see its note).
constexpr int FLAVOR_EPI = TE_GELU_SAVE_T;

template <typename T, int FAM>
__device__ __forceinline__ void epi_store(const Epi& e, int row, int col, float acc) {
    const size_t idx = (size_t)row * e.ldo + col;
    float v = acc;
    if (e.bias) v = __fadd_rn(v, to_f(static_cast<const T*>(e.bias)[col]));
    T* out = static_cast<T*>(e.out);
    float* out_f = static_cast<float*>(e.out2);
    if constexpr (FAM == 0) {
        switch (e.mode) {
            case TE_NONE: out[idx] = from_f<T>(v); break;
            case TE_GELU: out[idx] = from_f<T>(gelu_as(v)); break;
            case TE_DP_RES:
                out[idx] = from_f<T>(__fadd_rn(to_f(static_cast<const T*>(e.res)[idx]),
                                               __fmul_rn(v, e.dp[row / e.tokens])));
                break;
            case TE_GELU_SAVE: out_f[idx] = v; out[idx] = from_f<T>(gelu_as(v)); break;
            case TE_GELU_GRAD:
                out_f[idx] = __fmul_rn(v, gelu_grad(static_cast<const float*>(e.aux)[idx]));
                break;
            default: out_f[idx] = v; break;
        }
    } else {
        switch (e.mode) {
            case TE_GELU_SAVE_T:
                static_cast<T*>(e.out2)[idx] = from_f<T>(v);
                out[idx] = from_f<T>(gelu_as(v));
                break;
            case TE_GELU_GRAD_T:
                // the float32 value TE_GELU_GRAD stores, rounded: K6d's dm1c
                // is bit for bit the rounding of K6b's dm1
                out[idx] = from_f<T>(__fmul_rn(v, gelu_grad(static_cast<const float*>(e.aux)[idx])));
                break;
            default: {   // TE_GELU_GRAD_MS
                const float m = to_f(static_cast<const T*>(e.aux)[idx]);
                out_f[idx] = __fmul_rn(v, gelu_grad(m));
                out[idx] = from_f<T>(gelu_as(m));
                break;
            }
        }
    }
}

// ------------------------------------------------------------ bf16 GEMM
// The products of the TPU bodies _fwd_kernel (K5: qkv, proj, fc1, fc2),
// _bwd_mlp_* (K6a-K6e: the fc1 recompute, the grads through fc2 and fc1,
// the pair dW1, dW2) and _bwd_attn* (K7: the qkv recompute, the grads
// through proj and qkv, the pair dWqkv, dWp).  At 64 crops (12288 rows)
// each is 14-206 GFLOP at 370-770 FLOP per byte moved, above the H100's
// 295, so operations bound them (989 TFLOP/s bf16; the earlier 64 x 64
// mma.sync tile reached 120).  The one near the line is the NN product
// through fc2, whose GELU-gradient epilogue reads and writes float32 rows
// of the hidden width (240 FLOP per byte).
//
// Design (gemm_wgmma.cuh): 128 x 128 block tiles of two wgmma warpgroups,
// a 3-stage TMA ring of 64-wide k-tiles (32 KB a stage, 97 KB a block),
// two blocks per SM, so that one block's epilogue and ring fill overlap
// the other's products; that leaves a thread at most 128 registers, for
// the 64 float32 accumulators and the rest (4 stages at one block per SM
// measured 17-35% slower, but within 4% on the MLP weight-grad pairs).
// Every shape takes that one tile: at 12288 rows the NT and NN products
// have 576-3072 tiles (2.2-11.6 waves of 264 blocks), the weight-grad
// pairs 144 (ViT-B attention: 12 SMs take two tiles), 288 (ViT-B MLP),
// 256 (ViT-L attention) and 512 (ViT-L MLP).  No shape is split over K,
// so every epilogue and every flavor sum each output in the same order
// (K6d + K6e = K6b + K6c, K7 _saved = K7, bit for bit).  The epilogue
// stages the tile in the freed ring: the mode's input (a float32 or T
// aux, or the residual) comes in by TMA, brought into L2 by a prefetch
// when the block starts; the outputs go out by TMA stores of whole
// 128-byte rows.  Each mode is a kernel of its own, holding only its
// epilogue's code: with the modes behind a switch in one kernel, stored
// from registers or staged, the GELU-saving and GELU-gradient epilogues
// took 2.9-3.7x the plain store's time, against 1.8-2.0x as kernels of
// their own (PERF.md).
namespace tg {
constexpr int BM = 64;     // the float32 GEMM's tile

// The staged tiles of a mode in the freed ring: out2 (float32 or T) and a
// float32 aux at OUT2_AT (64 KB), out (T) and a T aux or res at OUT_AT (32
// KB), so that an input and the output written at the same elements share
// bytes.  in_bytes: the element size of the tile a mode reads (0: none).
constexpr uint32_t OUT2_AT = 0, OUT_AT = 4 * wg::BM * 128;

__host__ __device__ constexpr int in_bytes(int mode) {
    return mode == TE_GELU_GRAD || mode == TE_GELU_GRAD_T ? 4
         : mode == TE_DP_RES || mode == TE_GELU_GRAD_MS ? 2 : 0;
}
__host__ __device__ constexpr int out2_bytes(int mode) {
    return mode == TE_GELU_SAVE || mode == TE_GELU_GRAD || mode == TE_F32 ||
           mode == TE_GELU_GRAD_MS ? 4 : mode == TE_GELU_SAVE_T ? 2 : 0;
}
__host__ __device__ constexpr bool has_out(int mode) {
    return mode != TE_GELU_GRAD && mode != TE_F32;
}

__device__ __forceinline__ float2* f32_at(uint8_t* t, int r, int c) {
    return reinterpret_cast<float2*>(t + wg::tile_offset<4>(r, c));
}
__device__ __forceinline__ __nv_bfloat162* t_at(uint8_t* t, int r, int c) {
    return reinterpret_cast<__nv_bfloat162*>(t + wg::tile_offset<2>(r, c));
}

// epi_store of mode MODE for the values v0, v1 (acc + bias) of columns c
// and c + 1 of tile row r (output row `row`), on the staged tiles: t1 holds
// out and a T input, t2 out2 and a float32 input
template <int MODE>
__device__ __forceinline__ void epi_pair(const Epi& e, uint8_t* t1, uint8_t* t2, int r, int c,
                                         int row, float v0, float v1) {
    if constexpr (MODE == TE_NONE) {
        *t_at(t1, r, c) = __floats2bfloat162_rn(v0, v1);
    } else if constexpr (MODE == TE_GELU) {
        *t_at(t1, r, c) = __floats2bfloat162_rn(gelu_as(v0), gelu_as(v1));
    } else if constexpr (MODE == TE_DP_RES) {
        const float dp = e.dp[row / e.tokens];
        const float2 x = __bfloat1622float2(*t_at(t1, r, c));
        *t_at(t1, r, c) = __floats2bfloat162_rn(__fadd_rn(x.x, __fmul_rn(v0, dp)),
                                                __fadd_rn(x.y, __fmul_rn(v1, dp)));
    } else if constexpr (MODE == TE_GELU_SAVE) {
        *f32_at(t2, r, c) = make_float2(v0, v1);
        *t_at(t1, r, c) = __floats2bfloat162_rn(gelu_as(v0), gelu_as(v1));
    } else if constexpr (MODE == TE_GELU_GRAD) {
        const float2 m = *f32_at(t2, r, c);
        *f32_at(t2, r, c) = make_float2(__fmul_rn(v0, gelu_grad(m.x)),
                                        __fmul_rn(v1, gelu_grad(m.y)));
    } else if constexpr (MODE == TE_F32) {
        *f32_at(t2, r, c) = make_float2(v0, v1);
    } else if constexpr (MODE == TE_GELU_SAVE_T) {
        *t_at(t2, r, c) = __floats2bfloat162_rn(v0, v1);
        *t_at(t1, r, c) = __floats2bfloat162_rn(gelu_as(v0), gelu_as(v1));
    } else if constexpr (MODE == TE_GELU_GRAD_T) {
        // the float32 value TE_GELU_GRAD stores, rounded: K6d's dm1c is bit
        // for bit the rounding of K6b's dm1
        const float2 m = *f32_at(t2, r, c);
        *t_at(t1, r, c) = __floats2bfloat162_rn(__fmul_rn(v0, gelu_grad(m.x)),
                                                __fmul_rn(v1, gelu_grad(m.y)));
    } else {   // TE_GELU_GRAD_MS
        const float2 m = __bfloat1622float2(*t_at(t1, r, c));
        *f32_at(t2, r, c) = make_float2(__fmul_rn(v0, gelu_grad(m.x)),
                                        __fmul_rn(v1, gelu_grad(m.y)));
        *t_at(t1, r, c) = __floats2bfloat162_rn(gelu_as(m.x), gelu_as(m.y));
    }
}

// The block's accumulators (wg::mainloop's layout) through the epilogue:
// the input tile, if the mode has one, comes into the ring by TMA; each
// thread turns its pairs of columns into the mode's outputs, in place in
// the ring; then thread 0 writes the staged tiles out by TMA, which drops
// what lies beyond M and N.  The float32 math and its rounding points are
// epi_store's.
template <int MODE>
__device__ __forceinline__ void epilogue(const float (&acc)[wg::ACC], const Epi& e,
                                         const CUtensorMap* out_map, const CUtensorMap* out2_map,
                                         const CUtensorMap* in_map, uint32_t ring, uint32_t in_bar,
                                         int M, int N, int m0, int n0) {
    extern __shared__ uint8_t smem_raw[];
    constexpr int ib = in_bytes(MODE), o2 = out2_bytes(MODE);
    __syncthreads();                                  // every warp is done with the ring
    if constexpr (ib != 0) {
        if (threadIdx.x == 0) {
            const uint32_t at = ring + (ib == 4 ? OUT2_AT : OUT_AT);
            wg::mbar_expect(in_bar, ib * wg::BM * wg::BN);
            for (int c = 0; c < wg::BN; c += 128 / ib)
                wg::tma_load(at + c * ib * wg::BM, in_map, n0 + c, m0, in_bar);
        }
        wg::mbar_wait(in_bar, 0);
    }
    uint8_t* const tile = smem_raw + (ring - wg::smem_u32(smem_raw));
    const int lane = threadIdx.x & 31;
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < wg::ACC / 4; ++j) {
        const int c = c0 + 8 * j;
        float b0 = 0.f, b1 = 0.f;
        const bool bias = e.bias && n0 + c < N;       // N % 8 == 0: both columns or neither
        if (bias) {
            const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                static_cast<const bf16*>(e.bias) + n0 + c));
            b0 = bv.x;
            b1 = bv.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (bias) {
                v0 = __fadd_rn(v0, b0);
                v1 = __fadd_rn(v1, b1);
            }
            epi_pair<MODE>(e, tile + OUT_AT, tile + OUT2_AT, r, c, min(m0 + r, M - 1), v0, v1);
        }
    }
    wg::fence_to_tma();
    __syncthreads();
    if (threadIdx.x == 0) {
        if constexpr (has_out(MODE))
            for (int c = 0; c < wg::BN && n0 + c < N; c += 64)
                wg::tma_store(out_map, ring + OUT_AT + c * 2 * wg::BM, n0 + c, m0);
        if constexpr (o2 != 0)
            for (int c = 0; c < wg::BN && n0 + c < N; c += 128 / o2)
                wg::tma_store(out2_map, ring + OUT2_AT + c * o2 * wg::BM, n0 + c, m0);
        wg::tma_store_commit_and_wait();
    }
}

// the maps of a launch's output, second output and epilogue input
struct EpiMaps {
    CUtensorMap out, out2, in;
};

// C (M, N) = epilogue(A . B^T): A (M, K) K-major; B (N, K) K-major (NT) or
// stored (K, N) (NN)
template <bool BKM, int MODE>
__global__ void __launch_bounds__(wg::THREADS, wg::MIN_BLOCKS)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                 const __grid_constant__ EpiMaps em, int M, int N, int K, Epi ep) {
    __shared__ __align__(8) uint64_t in_bar;
    constexpr int ib = in_bytes(MODE);
    const int m0 = blockIdx.y * wg::BM, n0 = blockIdx.x * wg::BN;
    if (threadIdx.x == 0) {
        wg::mbar_init(wg::smem_u32(&in_bar), 1);
        if constexpr (ib != 0)
            for (int c = 0; c < wg::BN; c += 128 / ib) wg::tma_prefetch(&em.in, n0 + c, m0);
    }
    float acc[wg::ACC];
    const uint32_t ring = wg::mainloop<true, BKM>(acc, &ma, &mb, m0, n0, K);
    epilogue<MODE>(acc, ep, &em.out, &em.out2, &em.in, ring, wg::smem_u32(&in_bar), M, N, m0, n0);
}

template <bool BKM, int MODE>
cudaError_t launch_bf16(const void* a, const void* b, int M, int N, int K, int lda, int ldb,
                        const Epi& ep, cudaStream_t st) {
    CUtensorMap ma, mb;
    EpiMaps em = {};
    constexpr int ib = in_bytes(MODE), o2 = out2_bytes(MODE);
    const bool ok = wg::operand_map(&ma, a, M, K, lda, true) &&
                    wg::operand_map(&mb, b, N, K, ldb, BKM) &&
                    (!has_out(MODE) || wg::tile_map(&em.out, ep.out, M, N, ep.ldo, 2)) &&
                    (!o2 || wg::tile_map(&em.out2, ep.out2, M, N, ep.ldo, o2)) &&
                    (!ib || wg::tile_map(&em.in, MODE == TE_DP_RES ? ep.res : ep.aux, M, N,
                                         ep.ldo, ib));
    if (!ok) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel<BKM, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + wg::BN - 1) / wg::BN, (M + wg::BM - 1) / wg::BM);
    gemm_bf16_kernel<BKM, MODE><<<grid, wg::THREADS, wg::SMEM, st>>>(ma, mb, em, M, N, K, ep);
    return cudaGetLastError();
}

// one bf16 kernel per epilogue mode: each holds only its own epilogue's code
template <bool BKM>
cudaError_t launch_bf16_mode(const void* a, const void* b, int M, int N, int K, int lda, int ldb,
                             const Epi& ep, cudaStream_t st) {
    switch (ep.mode) {
        case TE_NONE: return launch_bf16<BKM, TE_NONE>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU: return launch_bf16<BKM, TE_GELU>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_DP_RES: return launch_bf16<BKM, TE_DP_RES>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU_SAVE: return launch_bf16<BKM, TE_GELU_SAVE>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU_GRAD: return launch_bf16<BKM, TE_GELU_GRAD>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_F32: return launch_bf16<BKM, TE_F32>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU_SAVE_T:
            return launch_bf16<BKM, TE_GELU_SAVE_T>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU_GRAD_T:
            return launch_bf16<BKM, TE_GELU_GRAD_T>(a, b, M, N, K, lda, ldb, ep, st);
        case TE_GELU_GRAD_MS:
            return launch_bf16<BKM, TE_GELU_GRAD_MS>(a, b, M, N, K, lda, ldb, ep, st);
        default: return cudaErrorInvalidValue;
    }
}

// ------------------------------------------------------------ f32 GEMM
// float32 training is the parity mode: FMA, no TF32.  64x64 tile, k-tile 16,
// 256 threads with 4x4 outputs each; shared tiles are [k][row].
constexpr int FK = 16, FPITCH = 68;

template <bool KMAJ>
__device__ __forceinline__ void load_f32(float (*dst)[FPITCH], const float* src, int r0, int rows,
                                         int k0, int K, int ld) {
    const int tid = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (KMAJ) {
        const int r = tid >> 2, kc = (tid & 3) * 4;
        if (r0 + r < rows && k0 + kc < K)
            v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld + k0 + kc);
        dst[kc + 0][r] = v.x; dst[kc + 1][r] = v.y; dst[kc + 2][r] = v.z; dst[kc + 3][r] = v.w;
    } else {
        const int k = tid >> 4, rc = (tid & 15) * 4;
        if (k0 + k < K && r0 + rc < rows)
            v = *reinterpret_cast<const float4*>(src + (size_t)(k0 + k) * ld + r0 + rc);
        *reinterpret_cast<float4*>(&dst[k][rc]) = v;
    }
}

template <bool AK, bool BKM, int FAM>
__device__ __forceinline__ void gemm_f32_tile(const float* __restrict__ A,
                                              const float* __restrict__ B, int M, int N, int K,
                                              int lda, int ldb, const Epi& ep, int bm, int bn) {
    __shared__ __align__(16) float As[FK][FPITCH];
    __shared__ __align__(16) float Bs[FK][FPITCH];
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += FK) {
        load_f32<AK>(As, A, bm, M, k0, K, lda);
        load_f32<BKM>(Bs, B, bn, N, k0, K, ldb);
        __syncthreads();
#pragma unroll
        for (int k = 0; k < FK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int row = bm + ty * 4 + i, col = bn + tx * 4 + j;
            if (row < M && col < N) epi_store<float, FAM>(ep, row, col, acc[i][j]);
        }
}

template <bool AK, bool BKM, int FAM>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K,
                int lda, int ldb, Epi ep) {
    gemm_f32_tile<AK, BKM, FAM>(A, B, M, N, K, lda, ldb, ep, blockIdx.y * BM, blockIdx.x * BM);
}

// Two TN products over the same K rows, C_i (M_i, N_i) = A_i^T B_i
// with A_i (K, M_i) and B_i (K, N_i) row-major, in one launch.  Block t
// takes tile t of product 0 while t < tiles0, else tile t - tiles0 of
// product 1; tiles run along N first.
struct TnPair {
    const void* a[2];
    const void* b[2];
    void* out[2];
    int M[2], N[2];
    int tiles0, K;
};

// The product's operands are picked with selects, not by indexing the
// parameter arrays with a runtime index, which would copy them to the stack.
struct TnTile {
    const void *a, *b;
    int M, N, bm, bn;
    Epi ep;
};

__device__ __forceinline__ TnTile tn_pair_tile(const TnPair& pr) {
    const bool second = static_cast<int>(blockIdx.x) >= pr.tiles0;
    const int t = second ? blockIdx.x - pr.tiles0 : blockIdx.x;
    TnTile tl;
    tl.a = second ? pr.a[1] : pr.a[0];
    tl.b = second ? pr.b[1] : pr.b[0];
    tl.M = second ? pr.M[1] : pr.M[0];
    tl.N = second ? pr.N[1] : pr.N[0];
    const int tiles_n = (tl.N + BM - 1) / BM;
    tl.bm = (t / tiles_n) * BM;
    tl.bn = (t % tiles_n) * BM;
    tl.ep = Epi{TE_NONE, 1, tl.N, nullptr, nullptr, nullptr, nullptr,
                second ? pr.out[1] : pr.out[0], nullptr};
    return tl;
}

__global__ void __launch_bounds__(256) gemm_tn2_f32_kernel(TnPair pr) {
    const TnTile tl = tn_pair_tile(pr);
    gemm_f32_tile<false, false, 0>(static_cast<const float*>(tl.a), static_cast<const float*>(tl.b),
                                tl.M, tl.N, pr.K, tl.M, tl.N, tl.ep, tl.bm, tl.bn);
}

// The bf16 pair: every operand MN-major, read by tensor map.  Block t takes
// 128 x 128 tile t of product 0 while t < tiles0, else tile t - tiles0 of
// product 1, along N first; its maps are picked by address, one parameter
// or the other, never by a runtime index.
struct TnMaps {
    CUtensorMap a0, b0, o0, a1, b1, o1;
    int M[2], N[2];
    int tiles0, K;
};

__global__ void __launch_bounds__(wg::THREADS, wg::MIN_BLOCKS)
gemm_tn2_bf16_kernel(const __grid_constant__ TnMaps p) {
    const bool second = static_cast<int>(blockIdx.x) >= p.tiles0;
    const int t = second ? blockIdx.x - p.tiles0 : blockIdx.x;
    const int M = second ? p.M[1] : p.M[0], N = second ? p.N[1] : p.N[0];
    const int tiles_n = (N + wg::BN - 1) / wg::BN;
    const int m0 = (t / tiles_n) * wg::BM, n0 = (t % tiles_n) * wg::BN;
    float acc[wg::ACC];
    const uint32_t ring = wg::mainloop<false, false>(acc, second ? &p.a1 : &p.a0,
                                                     second ? &p.b1 : &p.b0, m0, n0, p.K);
    const Epi ep{TE_NONE, 1, N, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    epilogue<TE_NONE>(acc, ep, second ? &p.o1 : &p.o0, nullptr, nullptr, ring, 0, M, N, m0, n0);
}

inline int bf16_tiles(int M, int N) {
    return ((M + wg::BM - 1) / wg::BM) * ((N + wg::BN - 1) / wg::BN);
}

cudaError_t tn2_bf16(const void* a0, const void* b0, int M0, int N0, void* out0, const void* a1,
                     const void* b1, int M1, int N1, void* out1, int K, cudaStream_t st) {
    TnMaps p = {};
    p.M[0] = M0; p.M[1] = M1; p.N[0] = N0; p.N[1] = N1;
    p.tiles0 = bf16_tiles(M0, N0);
    p.K = K;
    const int tiles1 = bf16_tiles(M1, N1);
    // a product without outputs gets no maps and no blocks
    if (p.tiles0 && (!wg::operand_map(&p.a0, a0, M0, K, M0, false) ||
                     !wg::operand_map(&p.b0, b0, N0, K, N0, false) ||
                     !wg::tile_map(&p.o0, out0, M0, N0, N0, 2)))
        return cudaErrorInvalidValue;
    if (tiles1 && (!wg::operand_map(&p.a1, a1, M1, K, M1, false) ||
                   !wg::operand_map(&p.b1, b1, N1, K, N1, false) ||
                   !wg::tile_map(&p.o1, out1, M1, N1, N1, 2)))
        return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tn2_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
    if (err != cudaSuccess || p.tiles0 + tiles1 == 0) return err;
    gemm_tn2_bf16_kernel<<<p.tiles0 + tiles1, wg::THREADS, wg::SMEM, st>>>(p);
    return cudaGetLastError();
}

template <int FAM>
cudaError_t launch_f32(const void* a, const void* b, int M, int N, int K, int lda, int ldb,
                       int b_kmaj, const Epi& ep, cudaStream_t st) {
    const dim3 grid((N + BM - 1) / BM, (M + BM - 1) / BM);
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    if (b_kmaj)
        gemm_f32_kernel<true, true, FAM><<<grid, 256, 0, st>>>(af, bf, M, N, K, lda, ldb, ep);
    else
        gemm_f32_kernel<true, false, FAM><<<grid, 256, 0, st>>>(af, bf, M, N, K, lda, ldb, ep);
    return cudaGetLastError();
}
}  // namespace tg

// The NT and NN products: C (M, N) = epilogue(sum_k A[m, k] B[n, k]).
// A[m, k] sits at a[m*lda + k]; B[n, k] at b[n*ldb + k] (b_kmaj) or
// b[k*ldb + n].  The caller guarantees that each operand's contiguous dim
// (K, or N) and the leading dims are multiples of 8 and the pointers
// multiples of 16 bytes; the other dims are ragged.  TN products go
// through evt_train_gemm_tn2.
EVT_EXPORT int evt_train_gemm(const void* a, const void* b, int M, int N, int K, int lda, int ldb,
                              int b_kmaj, int is_bf16, int mode, const void* bias,
                              const void* res, const void* dp, int tokens, const void* aux,
                              void* out, void* out2, int ldo, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Epi ep;
    ep.mode = mode; ep.tokens = tokens; ep.ldo = ldo; ep.bias = bias; ep.res = res;
    ep.dp = static_cast<const float*>(dp); ep.aux = aux;
    ep.out = out; ep.out2 = out2;
    if (is_bf16)
        return static_cast<int>(
            b_kmaj ? tg::launch_bf16_mode<true>(a, b, M, N, K, lda, ldb, ep, st)
                   : tg::launch_bf16_mode<false>(a, b, M, N, K, lda, ldb, ep, st));
    return static_cast<int>(mode >= FLAVOR_EPI
                                ? tg::launch_f32<1>(a, b, M, N, K, lda, ldb, b_kmaj, ep, st)
                                : tg::launch_f32<0>(a, b, M, N, K, lda, ldb, b_kmaj, ep, st));
}

// A backward's two weight grads: out0 (M0, N0) = a0^T b0 and out1 (M1,
// N1) = a1^T b1, a_i (K, M_i) and b_i (K, N_i) row-major, M_i and N_i
// multiples of 8; out_i in the operands' type.
EVT_EXPORT int evt_train_gemm_tn2(const void* a0, const void* b0, int M0, int N0, void* out0,
                                  const void* a1, const void* b1, int M1, int N1, void* out1,
                                  int K, int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return static_cast<int>(tg::tn2_bf16(a0, b0, M0, N0, out0, a1, b1, M1, N1, out1, K, st));
    const auto tiles = [](int M, int N) {
        return ((M + tg::BM - 1) / tg::BM) * ((N + tg::BM - 1) / tg::BM);
    };
    tg::TnPair pr{{a0, a1}, {b0, b1}, {out0, out1}, {M0, M1}, {N0, N1}, tiles(M0, N0), K};
    tg::gemm_tn2_f32_kernel<<<pr.tiles0 + tiles(M1, N1), 256, 0, st>>>(pr);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ mma.sync probe
// out (R, C) = x (R, hd) . y (C, hd)^T in float32 by mma.sync m16n8k16
// summed from zero in k order, one warp per 16 x 8 tile, fragments read
// straight from memory: the steps by which attention_tc.cuh forms its
// logits.  chip_smoke.py forms x y^T and y x^T with it to show that the
// product with its operands swapped is the same bits, on which K7's key
// kernel relies.  R % 16, C % 8 and hd % 16 are 0.
__global__ void __launch_bounds__(32) mma_probe_kernel(const bf16* __restrict__ x,
                                                       const bf16* __restrict__ y,
                                                       float* __restrict__ out, int C, int hd) {
    const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
    const int r0 = blockIdx.y * 16, c0 = blockIdx.x * 8;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < hd; k += 16) {
        const bf16* xa = x + (size_t)(r0 + g) * hd + k + 2 * t;
        const bf16* yb = y + (size_t)(c0 + g) * hd + k + 2 * t;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(xa),
                               *reinterpret_cast<const uint32_t*>(xa + 8 * hd),
                               *reinterpret_cast<const uint32_t*>(xa + 8),
                               *reinterpret_cast<const uint32_t*>(xa + 8 * hd + 8)};
        tc::mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(yb),
                     *reinterpret_cast<const uint32_t*>(yb + 8));
    }
    float* o = out + (size_t)(r0 + g) * C + c0 + 2 * t;
    o[0] = c[0]; o[1] = c[1];
    o[8 * C] = c[2]; o[8 * C + 1] = c[3];
}

EVT_EXPORT int evt_mma_probe(const void* x, const void* y, void* out, int R, int C, int hd,
                             void* stream) {
    if (R % 16 || C % 8 || hd % 16) return static_cast<int>(cudaErrorInvalidValue);
    mma_probe_kernel<<<dim3(C / 8, R / 16), 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y), static_cast<float*>(out), C, hd);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ column sums
// Stage 1: v = src * dp[row / tokens] (dp optional) in float32, written
// rounded to TD, and summed per column over a chunk of rows.  Stage 2 sums
// the chunks of each column in order.
template <typename TS, typename TD>
__global__ void __launch_bounds__(256)
scale_colsum_kernel(const TS* __restrict__ src, const float* __restrict__ dp, int tokens,
                    TD* __restrict__ dst, float* __restrict__ partial, int R, int C, int chunk) {
    const int c = blockIdx.x * 256 + threadIdx.x;
    if (c >= C) return;
    const int r0 = blockIdx.y * chunk, r1 = min(R, r0 + chunk);
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
        float v = to_f(src[(size_t)r * C + c]);
        if (dp) v = __fmul_rn(v, dp[r / tokens]);
        dst[(size_t)r * C + c] = from_f<TD>(v);
        s = __fadd_rn(s, v);
    }
    partial[(size_t)blockIdx.y * C + c] = s;
}

template <typename TO>
__global__ void __launch_bounds__(256)
colsum_finish_kernel(const float* __restrict__ partial, int n, int C, TO* __restrict__ out) {
    const int c = blockIdx.x * 256 + threadIdx.x;
    if (c >= C) return;
    float s = 0.f;
    for (int i = 0; i < n; ++i) s = __fadd_rn(s, partial[(size_t)i * C + c]);
    out[c] = from_f<TO>(s);
}

template <typename TS, typename TD>
static void scale_colsum(const void* src, const void* dp, int tokens, void* dst, void* partial,
                         int R, int C, int chunk, cudaStream_t st) {
    const dim3 grid((C + 255) / 256, (R + chunk - 1) / chunk);
    scale_colsum_kernel<TS, TD><<<grid, 256, 0, st>>>(
        static_cast<const TS*>(src), static_cast<const float*>(dp), tokens, static_cast<TD*>(dst),
        static_cast<float*>(partial), R, C, chunk);
}

// partial gets ceil(R / chunk) rows of C floats
EVT_EXPORT int evt_scale_colsum(const void* src, int src_bf16, const void* dp, int tokens,
                                void* dst, int dst_bf16, void* partial, int R, int C, int chunk,
                                void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (src_bf16 && dst_bf16) scale_colsum<bf16, bf16>(src, dp, tokens, dst, partial, R, C, chunk, st);
    else if (src_bf16) scale_colsum<bf16, float>(src, dp, tokens, dst, partial, R, C, chunk, st);
    else if (dst_bf16) scale_colsum<float, bf16>(src, dp, tokens, dst, partial, R, C, chunk, st);
    else scale_colsum<float, float>(src, dp, tokens, dst, partial, R, C, chunk, st);
    return static_cast<int>(cudaGetLastError());
}

EVT_EXPORT int evt_colsum_finish(const void* partial, int n, int C, void* out, int out_bf16,
                                 void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (C + 255) / 256;
    if (out_bf16)
        colsum_finish_kernel<bf16><<<blocks, 256, 0, st>>>(static_cast<const float*>(partial), n,
                                                          C, static_cast<bf16*>(out));
    else
        colsum_finish_kernel<float><<<blocks, 256, 0, st>>>(static_cast<const float*>(partial), n,
                                                           C, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ LayerNorm backward
// One warp per row, 8 warps per block, LN_ROWS rows per block.  It
// recomputes mean, 1/sigma and xhat of the forward from x, then
//   dxhat = dh * w,  dx = (1/sigma) (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
//   out = round(res + dx),
// and each warp writes its partial sums of dh * xhat (dw) and dh (db) over
// its rows: partial row (block * 8 + warp).  A lane holds columns
// lane + 32 j, j < LN_MAXJ, so D <= 32 * LN_MAXJ.
constexpr int LN_ROWS = 64, LN_MAXJ = 48;

template <typename T>
__global__ void __launch_bounds__(256)
ln_backward_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ dh,
                   const T* __restrict__ res, T* __restrict__ out, float* __restrict__ pdw,
                   float* __restrict__ pdb, int R, int D, float eps) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float dw[LN_MAXJ], db[LN_MAXJ];
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j) dw[j] = db[j] = 0.f;
    const int r_end = min(R, (blockIdx.x + 1) * LN_ROWS);
    for (int r = blockIdx.x * LN_ROWS + warp; r < r_end; r += 8) {
        const T* xr = x + (size_t)r * D;
        const float* g = dh + (size_t)r * D;
        float s = 0.f;
        for (int i = lane; i < D; i += 32) s += to_f(xr[i]);
        const float mean = warp_sum(s) / D;
        float v = 0.f;
        for (int i = lane; i < D; i += 32) {
            const float d = to_f(xr[i]) - mean;
            v += d * d;
        }
        const float inv = rsqrtf(warp_sum(v) / D + eps);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < LN_MAXJ; ++j) {
            const int i = lane + 32 * j;
            if (i < D) {
                const float xhat = (to_f(xr[i]) - mean) * inv;
                const float dxhat = g[i] * to_f(w[i]);
                s1 += dxhat;
                s2 += dxhat * xhat;
                dw[j] += g[i] * xhat;
                db[j] += g[i];
            }
        }
        const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
        for (int j = 0; j < LN_MAXJ; ++j) {
            const int i = lane + 32 * j;
            if (i < D) {
                const float xhat = (to_f(xr[i]) - mean) * inv;
                const float dxhat = g[i] * to_f(w[i]);
                const float dx = inv * (dxhat - m1 - xhat * m2);
                out[(size_t)r * D + i] = from_f<T>(to_f(res[(size_t)r * D + i]) + dx);
            }
        }
    }
    const size_t prow = (size_t)(blockIdx.x * 8 + warp) * D;
#pragma unroll
    for (int j = 0; j < LN_MAXJ; ++j) {
        const int i = lane + 32 * j;
        if (i < D) {
            pdw[prow + i] = dw[j];
            pdb[prow + i] = db[j];
        }
    }
}

// pdw and pdb get 8 * ceil(R / LN_ROWS) rows of D floats
EVT_EXPORT int evt_ln_backward(const void* x, const void* w, const void* dh, const void* res,
                               void* out, void* pdw, void* pdb, int R, int D, float eps,
                               int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = (R + LN_ROWS - 1) / LN_ROWS;
    if (is_bf16)
        ln_backward_kernel<bf16><<<blocks, 256, 0, st>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(w),
            static_cast<const float*>(dh), static_cast<const bf16*>(res), static_cast<bf16*>(out),
            static_cast<float*>(pdw), static_cast<float*>(pdb), R, D, eps);
    else
        ln_backward_kernel<float><<<blocks, 256, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<const float*>(dh), static_cast<const float*>(res),
            static_cast<float*>(out), static_cast<float*>(pdw), static_cast<float*>(pdb), R, D,
            eps);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ attention backward
// bf16: the tensor-core kernels of attention_tc.cuh.  float32 (the parity
// mode) keeps these FMA kernels.  Per (crop b, head h), with q, k, v the
// head's columns of qkv, do the head's columns of the output grad,
// qs = q * qscale:
//   P = softmax(qs k^T),  o = P v,  dP = do v^T,  dlog = P (dP - rowsum(dP P)),
//   dv = P^T do,  dq = dlog k * scale,  dk = dlog^T q * scale.
// Kernel A takes a tile of TQ queries: it holds K and V of all tokens, the
// tile's qs and do, and the tile's logits and dP; it writes o, dq and each
// query's softmax max, sum and rowsum(dP P).  Kernel B takes a tile of TK
// keys: it holds q and do of all tokens, the tile's k and v, and the tile's
// transposed logits; it recomputes them in the same order (so bitwise the
// same P and dP as kernel A) from A's statistics and writes dk and dv.
// Shared rows are padded by one float against bank conflicts.
constexpr int TQ = 32, TK = 32;

__global__ void __launch_bounds__(256)
attn_bwd_q_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                      float* __restrict__ o, float* __restrict__ dqkv, float* __restrict__ stats,
                      int N, int D, int heads, float qscale, float scale) {
    extern __shared__ float smem[];
    const int hd = D / heads, ld = hd + 1;
    const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    const int nq = min(TQ, N - q0);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* Ks = smem;
    float* Vs = Ks + N * ld;
    float* Qs = Vs + N * ld;
    float* Ds = Qs + TQ * ld;
    float* P = Ds + TQ * ld;
    float* dP = P + TQ * N;
    const float* base = qkv + (size_t)b * N * 3 * D + h * hd;
    float* st = stats + ((size_t)b * heads + h) * 3 * N;   // [max | sum | rowsum(dP P)]

    for (int idx = tid; idx < N * hd; idx += 256) {
        const int j = idx / hd, d = idx - j * hd;
        const float* r = base + (size_t)j * 3 * D + d;
        Ks[j * ld + d] = r[D];
        Vs[j * ld + d] = r[2 * D];
    }
    for (int idx = tid; idx < nq * hd; idx += 256) {
        const int i = idx / hd, d = idx - i * hd;
        Qs[i * ld + d] = base[(size_t)(q0 + i) * 3 * D + d] * qscale;
        Ds[i * ld + d] = dO[(size_t)(b * N + q0 + i) * D + h * hd + d];
    }
    __syncthreads();
    for (int idx = tid; idx < nq * N; idx += 256) {
        const int i = idx / N, j = idx - i * N;
        float acc = 0.f, dacc = 0.f;
        for (int d = 0; d < hd; ++d) {
            acc = fmaf(Qs[i * ld + d], Ks[j * ld + d], acc);
            dacc = fmaf(Ds[i * ld + d], Vs[j * ld + d], dacc);
        }
        P[idx] = acc;
        dP[idx] = dacc;
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
        float ds = 0.f;
        for (int j = lane; j < N; j += 32) {
            p[j] = p[j] / s;
            ds += dP[i * N + j] * p[j];
        }
        ds = warp_sum(ds);
        for (int j = lane; j < N; j += 32) dP[i * N + j] = p[j] * (dP[i * N + j] - ds);
        if (lane == 0) {
            st[q0 + i] = m;
            st[N + q0 + i] = s;
            st[2 * N + q0 + i] = ds;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < nq * hd; idx += 256) {
        const int i = idx / hd, d = idx - i * hd;
        const float* p = P + i * N;
        const float* g = dP + i * N;
        float acc = 0.f, dq = 0.f;
        for (int j = 0; j < N; ++j) {
            acc = fmaf(p[j], Vs[j * ld + d], acc);
            dq = fmaf(g[j], Ks[j * ld + d], dq);
        }
        const size_t row = (size_t)b * N + q0 + i;
        o[row * D + h * hd + d] = acc;
        dqkv[row * 3 * D + h * hd + d] = dq * scale;
    }
}

__global__ void __launch_bounds__(256)
attn_bwd_kv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                       const float* __restrict__ stats, float* __restrict__ dqkv, int N, int D,
                       int heads, float qscale, float scale) {
    extern __shared__ float smem[];
    const int hd = D / heads, ld = hd + 1;
    const int k0 = blockIdx.x * TK, h = blockIdx.y, b = blockIdx.z;
    const int nk = min(TK, N - k0);
    const int tid = threadIdx.x;
    float* Qr = smem;
    float* Dd = Qr + N * ld;
    float* Kt = Dd + N * ld;
    float* Vt = Kt + TK * ld;
    float* Pt = Vt + TK * ld;        // P, then dlog: [key][query] each
    const float* base = qkv + (size_t)b * N * 3 * D + h * hd;
    const float* st = stats + ((size_t)b * heads + h) * 3 * N;

    for (int idx = tid; idx < N * hd; idx += 256) {
        const int i = idx / hd, d = idx - i * hd;
        Qr[i * ld + d] = base[(size_t)i * 3 * D + d];
        Dd[i * ld + d] = dO[(size_t)(b * N + i) * D + h * hd + d];
    }
    for (int idx = tid; idx < nk * hd; idx += 256) {
        const int j = idx / hd, d = idx - j * hd;
        const float* r = base + (size_t)(k0 + j) * 3 * D + d;
        Kt[j * ld + d] = r[D];
        Vt[j * ld + d] = r[2 * D];
    }
    __syncthreads();
    for (int idx = tid; idx < nk * N; idx += 256) {
        const int j = idx / N, i = idx - j * N;
        float acc = 0.f, dacc = 0.f;
        for (int d = 0; d < hd; ++d) {
            acc = fmaf(Qr[i * ld + d] * qscale, Kt[j * ld + d], acc);
            dacc = fmaf(Dd[i * ld + d], Vt[j * ld + d], dacc);
        }
        const float p = expf(acc - st[i]) / st[N + i];
        Pt[idx] = p;
        Pt[nk * N + idx] = p * (dacc - st[2 * N + i]);                 // dlog
    }
    __syncthreads();
    for (int idx = tid; idx < nk * hd; idx += 256) {
        const int j = idx / hd, d = idx - j * hd;
        const float* p = Pt + j * N;
        const float* g = Pt + nk * N + j * N;
        float dv = 0.f, dk = 0.f;
        for (int i = 0; i < N; ++i) {
            dv = fmaf(p[i], Dd[i * ld + d], dv);
            dk = fmaf(g[i], Qr[i * ld + d], dk);
        }
        const size_t row = ((size_t)b * N + k0 + j) * 3 * D + h * hd + d;
        dqkv[row + D] = dk * scale;
        dqkv[row + 2 * D] = dv;
    }
}

static cudaError_t attn_bwd_f32_launch(const void* qkv, const void* dO, void* o, void* dqkv,
                                       void* stats, int B, int N, int D, int heads, float qscale,
                                       float scale, cudaStream_t st) {
    const int hd = D / heads;
    const size_t smem_q = sizeof(float) * (2 * (size_t)N * (hd + 1) + 2 * TQ * (hd + 1) +
                                           2 * (size_t)TQ * N);
    const size_t smem_kv = sizeof(float) * (2 * (size_t)N * (hd + 1) + 2 * TK * (hd + 1) +
                                            2 * (size_t)TK * N);
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_q_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_q));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_kv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    const dim3 gq((N + TQ - 1) / TQ, heads, B), gk((N + TK - 1) / TK, heads, B);
    attn_bwd_q_f32_kernel<<<gq, 256, smem_q, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dO), static_cast<float*>(o),
        static_cast<float*>(dqkv), static_cast<float*>(stats), N, D, heads, qscale, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attn_bwd_kv_f32_kernel<<<gk, 256, smem_kv, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dO),
        static_cast<const float*>(stats), static_cast<float*>(dqkv), N, D, heads, qscale, scale);
    return cudaGetLastError();
}

static cudaError_t attn_bwd_bf16_launch(const void* qkv, const void* dO, void* o, void* dqkv,
                                        void* stats, int B, int N, int D, int heads,
                                        float qscale, float scale, cudaStream_t st) {
    if (N <= 0 || N > attn_tc::MAX_TOKENS) return cudaErrorInvalidValue;
    ATTN_TC_DISPATCH(D / heads, attn_tc::bwd_launch, qkv, dO, o, dqkv, stats, B, N, D, heads,
                     qscale, scale, st);
}

// qkv (B*N, 3D) T, dO (B*N, D) T -> o (B*N, D) T, dqkv (B*N, 3D) float32;
// stats is scratch of B * heads * 3 * N floats
EVT_EXPORT int evt_attn_backward(const void* qkv, const void* dO, void* o, void* dqkv,
                                 void* stats, int B, int N, int D, int heads, float qscale,
                                 float scale, int is_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        is_bf16 ? attn_bwd_bf16_launch(qkv, dO, o, dqkv, stats, B, N, D, heads, qscale, scale, st)
                : attn_bwd_f32_launch(qkv, dO, o, dqkv, stats, B, N, D, heads, qscale, scale,
                                      st));
}
