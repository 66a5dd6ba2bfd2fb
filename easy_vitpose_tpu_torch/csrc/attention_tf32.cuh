// float32 attention on the tensor cores with float32 accuracy (3xTF32):
// the forward of the fp32 serving block (K1, block.cu's evt_attention) and
// of the fp32 training block (K5).
//
// What bounds it on the H100: at ViT-B and 64 crops of 192 tokens the
// forward is 7.2 GFLOP on 57 MB of float32 qkv: three TF32 passes take 44
// us at the TF32 peak, the bytes 17 us; so, as for the bf16 kernel
// (attention_tc.cuh), latency holds it: loads, the splits and the exp of
// every logit.  The float32 FMA kernel before it held a 64 x N logit tile
// in shared memory (one block per SM) and took 1.5 ms.
//
//   * one block of 4 warps per (64-query tile, head, crop), each warp
//     owning 16 rows; the head's K and V sit in shared memory as float32
//     (rows padded by 4 floats, so each fragment load hits 32 banks), by
//     16-byte cp.async from qkv; at hd 64 and N 192 that is 104 KB, two
//     blocks an SM.  The warp's q, times the scale, stays in registers;
//   * products are mma.sync m16n8k8 TF32 with float32 sums, each operand
//     split into TF32 halves (x = hi + lo, tc.cuh) and each product the
//     three passes lo.hi + hi.lo + hi.hi.  S = qs K^T reads K's rows as B;
//     P V takes P from S's accumulators: with key 2t of an 8-key tile as
//     the product's k index t and key 2t + 1 as t + 4, thread (g, t)'s C
//     fragment is its A fragment, and V's B fragment is rows 2t and 2t + 1;
//   * the softmax is online over chunks of 64 keys (8 n8 tiles in
//     registers; 32 keys above hd 80): the running row max and sum rescale
//     the output, which is divided by the sum at the end; float32
//     throughout (the plain version's float32 P and o round nowhere else);
//   * ragged shapes: rows >= N are zero in shared memory and not stored,
//     keys >= N are -inf before the max; a head dim padded to a multiple of
//     16 adds zero products.  The callers refuse shapes whose K and V do not
//     fit in shared memory (models/fused_block.py::check_attention_shape).
#pragma once

#include <math.h>

#include "tc.cuh"

namespace attn_tf32 {

constexpr int WARPS = 4, THREADS = 32 * WARPS, TILE = 16 * WARPS;   // 64 query rows a block
constexpr int MAX_HD16 = 8;

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

template <int HD16>
struct Cfg {
    static constexpr int HDP = 16 * HD16, LD = HDP + 4, KS = 2 * HD16;   // k-steps of 8
    static constexpr int CHUNK8 = HD16 <= 5 ? 8 : 4;   // 8-key tiles of a chunk, in registers
};

template <int HD16>
inline size_t smem_bytes(int N) { return 2 * sizeof(float) * (size_t)pad8(N) * Cfg<HD16>::LD; }

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in three TF32 passes, small ones first: a (16 x 8) given by
// its halves, b (8 x 8) as the two raw floats of this thread's fragment
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah, const uint32_t* al, float b0,
                                     float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    tc::tf32_halves(b0, bh0, bl0);
    tc::tf32_halves(b1, bh1, bl1);
    mma_tf32(c, al, bh0, bh1);
    mma_tf32(c, ah, bl0, bl1);
    mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (ceil(N / 64), heads, crops); qkv (B*N, 3D), o (B*N, D), float32
template <int HD16>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const float* __restrict__ qkv, float* __restrict__ o, int N, int D, int heads,
           float scale) {
    constexpr int LD = Cfg<HD16>::LD, KS = Cfg<HD16>::KS, CHUNK8 = Cfg<HD16>::CHUNK8;
    extern __shared__ __align__(16) float smem[];
    const int NP = pad8(N), nkt = NP / 8;
    float* Ks = smem;
    float* Vs = Ks + NP * LD;
    const int hd = D / heads, q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const size_t pitch = 3 * (size_t)D;
    const float* base = qkv + (size_t)b * N * pitch + h * hd;

    constexpr int CH = Cfg<HD16>::HDP / 4;          // 16-byte chunks of a padded row
    for (int i = threadIdx.x; i < NP * CH; i += THREADS) {
        const int r = i / CH, c = i - r * CH;
        const bool ok = r < N && 4 * c < hd;
        const float* src = base + (ok ? r * pitch + 4 * c : 0);
        tc::cp_async16(Ks + r * LD + 4 * c, src + D, ok ? 16 : 0);
        tc::cp_async16(Vs + r * LD + 4 * c, src + 2 * D, ok ? 16 : 0);
    }
    tc::cp_async_commit();

    // this warp's q (rows r0 + g and r0 + g + 8) times the scale: the A
    // fragments of its KS k-steps, element i at row g + 8 (i & 1), column
    // 8 ks + t + 4 (i >> 1)
    const int r0 = q0 + 16 * warp;
    float q[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + g + 8 * (i & 1), c = 8 * ks + t + 4 * (i >> 1);
            q[ks][i] = r < N && c < hd ? base[(size_t)r * pitch + c] * scale : 0.f;
        }
    tc::cp_async_wait<0>();
    __syncthreads();

    float acc[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int c0 = 0; c0 < nkt; c0 += CHUNK8) {
        const int nt = min(CHUNK8, nkt - c0);
        float s[CHUNK8][4];
#pragma unroll
        for (int j = 0; j < CHUNK8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        // S = qs K^T over the chunk's keys
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) tc::tf32_halves(q[ks][i], ah[i], al[i]);
            const float* kp = Ks + (8 * c0 + g) * LD + 8 * ks + t;
#pragma unroll
            for (int j = 0; j < CHUNK8; ++j)
                if (j < nt) mma3(s[j], ah, al, kp[8 * j * LD], kp[8 * j * LD + 4]);
        }
        // keys >= N at -inf; the chunk's row max; rescale what came before
        float mc[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < CHUNK8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (j >= nt || 8 * (c0 + j) + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
                mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
            }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const float mn = fmaxf(m[hh], quad_max(mc[hh]));
            corr[hh] = expf(m[hh] - mn);             // 0 on the first chunk
            m[hh] = mn;
            l[hh] *= corr[hh];
        }
#pragma unroll
        for (int n = 0; n < KS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
        // P = exp(s - max); o += P V
#pragma unroll
        for (int j = 0; j < CHUNK8; ++j) {
            if (j >= nt) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[j][e] = expf(s[j][e] - m[e >> 1]);
                l[e >> 1] += s[j][e];
            }
            // A of keys (2t, 2t + 1) as k (t, t + 4): a0 (g, 2t), a1 (g + 8,
            // 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
            uint32_t ah[4], al[4];
            tc::tf32_halves(s[j][0], ah[0], al[0]);
            tc::tf32_halves(s[j][2], ah[1], al[1]);
            tc::tf32_halves(s[j][1], ah[2], al[2]);
            tc::tf32_halves(s[j][3], ah[3], al[3]);
            const float* vp = Vs + (8 * (c0 + j) + 2 * t) * LD + g;
#pragma unroll
            for (int n = 0; n < KS; ++n) mma3(acc[n], ah, al, vp[8 * n], vp[LD + 8 * n]);
        }
    }

    // o = acc / sum, rows < N, columns < hd
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
        const int c = 8 * n + 2 * t;
        if (c >= hd) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + g + 8 * hh;
            if (r >= N) continue;
            *reinterpret_cast<float2*>(o + (size_t)(b * N + r) * D + h * hd + c) =
                make_float2(acc[n][2 * hh] / l[hh], acc[n][2 * hh + 1] / l[hh]);
        }
    }
}

template <int HD16>
cudaError_t fwd_launch(const void* qkv, void* o, int B, int N, int D, int heads, float scale,
                       cudaStream_t st) {
    const size_t smem = smem_bytes<HD16>(N);
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel<HD16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fwd_kernel<HD16><<<dim3((N + TILE - 1) / TILE, heads, B), THREADS, smem, st>>>(
        static_cast<const float*>(qkv), static_cast<float*>(o), N, D, heads, scale);
    return cudaGetLastError();
}

// fwd_launch<ceil(hd / 16)>; refuses a head dim that is not a multiple of
// 8 or above 128
inline cudaError_t launch(const void* qkv, void* o, int B, int N, int D, int heads, float scale,
                          cudaStream_t st) {
    const int hd = D / heads;
    if (hd % 8 || hd <= 0 || hd > 16 * MAX_HD16 || N <= 0) return cudaErrorInvalidValue;
    switch ((hd + 15) / 16) {
        case 1: return fwd_launch<1>(qkv, o, B, N, D, heads, scale, st);
        case 2: return fwd_launch<2>(qkv, o, B, N, D, heads, scale, st);
        case 3: return fwd_launch<3>(qkv, o, B, N, D, heads, scale, st);
        case 4: return fwd_launch<4>(qkv, o, B, N, D, heads, scale, st);
        case 5: return fwd_launch<5>(qkv, o, B, N, D, heads, scale, st);
        case 6: return fwd_launch<6>(qkv, o, B, N, D, heads, scale, st);
        case 7: return fwd_launch<7>(qkv, o, B, N, D, heads, scale, st);
        default: return fwd_launch<8>(qkv, o, B, N, D, heads, scale, st);
    }
}

}  // namespace attn_tf32
