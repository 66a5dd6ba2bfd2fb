// bf16 attention on the tensor cores: the forward of the serving and
// training blocks (K1, K2, K5; block.cu's evt_attention) and the attention
// backward of the training block (K7, K7 _saved; train_block.cu's
// evt_attn_backward).  float32 keeps the FMA kernels of those files: it is
// the parity mode.
//
// What bounds these on the H100: at ViT-B and 64 crops of 192 tokens the
// forward is 7.2 GFLOP of bf16 products on 57 MB of qkv (17 us of memory,
// 7 us of tensor peak), the backward 29 GFLOP (with its recomputes).  So
// the work is small and the kernels are held by latency: the loads of K and
// V, the exp of every logit and the short products of ViTPose's head dims
// (32, 64, 80).  The design keeps everything between the loads and the
// stores in shared memory and registers:
//
//   * one block of 4 warps per (64-row tile, head, crop), each warp owning
//     16 rows.  The head's K and V (or, in the backward's key kernel, all
//     tokens' q and dO) sit in shared memory as bf16, copied by 16-byte
//     cp.async straight from qkv, rows padded by 16 bytes so that ldmatrix
//     reads 8 rows on 8 different 16-byte bank groups.  At hd 64 and N 192
//     that is 63 KB for the forward and 74 and 76 KB for the backward's two
//     kernels; their registers (190, 213 and 165 a thread) allow 2, 2 and 3
//     blocks per SM.  The kernels are built with __launch_bounds__(128, 1):
//     with the block size alone ptxas capped some head dims at 168 or 128
//     registers and spilled.  One block per (crop, head) that loads K and V
//     once would need 12 warps for 192 queries and more registers than an
//     SM has (12 x 32 x ~180); the three query tiles of a head run side by
//     side and read the head's K and V from L2;
//   * products are mma.sync m16n8k16 bf16 with float32 sums: QK^T reads K
//     with ldmatrix, PV reads V with ldmatrix.trans, and the float32 logits
//     stay in registers, their C fragments packed into the A fragments of
//     PV (tc.cuh);
//   * the softmax is over the whole row, not online, because the JAX
//     kernels normalise P before rounding it: a warp holds the logits of up
//     to CK16 16-key tiles (12 at hd <= 80: N 192 in one pass; 8 in the
//     forward and 2 in the backward at larger hd).  Longer rows
//     take the row max, then the sum, then P in passes over key chunks,
//     recomputing the chunk's logits each pass: the same products in the
//     same order, so exp(s - m) and P are the same bits as in one pass;
//   * rounding as the JAX kernels (models/fused_block.py:75-84,
//     fused_block_train.py:440-470): qs = round(q * round(scale)), logits,
//     softmax (expf, IEEE division) and dP in float32, P rounded before PV,
//     o rounded, dlog = P (dP - rowsum(dP P)) rounded before dq and dk, dk
//     from the unscaled q, dq and dk times scale in float32.  Every product
//     operand is already bf16, so the tensor cores form the same products
//     as the plain version; only the float32 summation order differs;
//   * ragged shapes: token rows >= N are zero-filled (keys beyond N are
//     set to -inf before the max); a head dim that is a multiple of 8 but
//     not of 16 is zero-padded to 16 in shared memory, adding zero products.
//     The callers refuse hd % 8 != 0, hd > 128 and N > 256
//     (models/fused_block.py::check_attention_shape).
//
// The backward keeps two kernels and no atomics.  Kernel A (query tiles)
// holds all tokens' K and V and the tile's q and dO; it forms S = qs K^T,
// the softmax statistics, o = round(P) V, rowsum(dP P) from dP = dO V^T in
// 16-key steps, then dlog and dq = round(dlog) K scale (recomputing dP),
// and writes o, dq and each row's max, sum and rowsum(dP P).  Kernel B (key
// tiles) holds all tokens' q and dO and the tile's K and V; per 16-query
// step it forms S^T = K qs^T and dP^T = V dO^T, P^T from A's statistics,
// dlog^T, and adds dv += round(P)^T dO and dk += round(dlog)^T q; it writes
// dk scale and dv.  S^T and dP^T are the products of A's S and dP with the
// operands swapped.
#pragma once

#include <math.h>

#include "tc.cuh"

namespace attn_tc {

constexpr int WARPS = 4, THREADS = 32 * WARPS, TILE = 16 * WARPS;   // 64 rows per block
constexpr int MAX_TOKENS = 256, MAX_HD16 = 8;

template <int HD16>
struct Cfg {
    static constexpr int HDP = 16 * HD16;           // head dim padded to the mma depth
    static constexpr int LD = HDP + 8;              // shared row in bf16: 16 bytes of pad
    // 16-key tiles of logits a warp holds in registers at once
    static constexpr int FWD_CK16 = HD16 <= 5 ? 12 : 8;
    static constexpr int BWD_CK16 = HD16 <= 5 ? 12 : 2;
    // kernel B keeps its K and V fragments in registers up to hd 64
    static constexpr bool HOLD = HD16 <= 4;
};

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

template <int HD16>
inline size_t fwd_smem(int N) { return 2 * (size_t)Cfg<HD16>::LD * (TILE + 2 * pad16(N)); }

template <int HD16>
inline size_t bwd_q_smem(int N) { return 2 * (size_t)Cfg<HD16>::LD * (2 * TILE + 2 * pad16(N)); }

template <int HD16>
inline size_t bwd_kv_smem(int N) { return bwd_q_smem<HD16>(N) + 3 * sizeof(float) * pad16(N); }

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [0, nrows) of a head's (rows, hd) slice at src (row pitch `pitch`
// elements) into dst with shared row stride LD, asynchronously; rows >= valid
// and columns >= hd are zero.
template <int HD16>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t pitch, int nrows,
                                          int valid, int hd) {
    constexpr int CH = 2 * HD16;                    // 16-byte chunks per padded row
    for (int i = threadIdx.x; i < nrows * CH; i += THREADS) {
        const int r = i / CH, c = i - r * CH;
        const bool ok = r < valid && 8 * c < hd;
        tc::cp_async16(dst + r * Cfg<HD16>::LD + 8 * c, ok ? src + r * pitch + 8 * c : src,
                       ok ? 16 : 0);
    }
}

// The A fragments of a warp's 16 rows starting at `rows` (shared), one per
// 16 columns; SCALE rounds each element times `scale` to bf16.
template <int HD16, bool SCALE>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD16][4], const bf16* rows, int lane,
                                       float scale) {
    const bf16* p = rows + (lane & 15) * Cfg<HD16>::LD + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < HD16; ++kk) {
        tc::ldsm_x4(a[kk], p + 16 * kk);
        if constexpr (SCALE)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[kk][i] = tc::scale_bf16x2(a[kk][i], scale);
    }
}

// c0, c1 (the two n8 tiles of 16 columns) = A . Y[row0, row0 + 16)^T, the
// contraction over the head dim.  A is the warp's held fragments, or (HELD
// false) loaded from its 16 shared rows at `arows`; SCALE rounds Y's
// elements times `scale` to bf16 on the way.
template <int HD16, bool HELD, bool SCALE, typename AF>
__device__ __forceinline__ void mma_nt(float* c0, float* c1, const AF& af, const bf16* arows,
                                       const bf16* Y, int row0, int lane, float scale) {
    constexpr int LD = Cfg<HD16>::LD;
    const bf16* yp = Y + (row0 + (lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
    const bf16* ap = arows + (lane & 15) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int e = 0; e < 4; ++e) c0[e] = c1[e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD16; ++kk) {
        uint32_t a[4], b[4];
        if constexpr (HELD) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = af[kk][i];
        } else {
            tc::ldsm_x4(a, ap + 16 * kk);
        }
        tc::ldsm_x4(b, yp + 16 * kk);
        if constexpr (SCALE)
#pragma unroll
            for (int i = 0; i < 4; ++i) b[i] = tc::scale_bf16x2(b[i], scale);
        tc::mma_bf16(c0, a, b[0], b[1]);
        tc::mma_bf16(c1, a, b[2], b[3]);
    }
}

// acc (16 x HDP) += A (16 x 16, bf16 fragment) . Y[row0, row0 + 16): the
// contraction over 16 rows of Y, read with ldmatrix.trans.
template <int HD16>
__device__ __forceinline__ void mma_nn(float (&acc)[2 * HD16][4], const uint32_t (&a)[4],
                                       const bf16* Y, int row0, int lane) {
    constexpr int LD = Cfg<HD16>::LD;
    const bf16* yp = Y + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int d = 0; d < HD16; ++d) {
        uint32_t b[4];
        tc::ldsm_x4_t(b, yp + 16 * d);
        tc::mma_bf16(acc[2 * d], a, b[0], b[1]);
        tc::mma_bf16(acc[2 * d + 1], a, b[2], b[3]);
    }
}

// The bf16 A fragment of 16 columns from the C fragments of their two n8 tiles
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float* c0, const float* c1) {
    a[0] = tc::pack_bf16(c0[0], c0[1]);
    a[1] = tc::pack_bf16(c0[2], c0[3]);
    a[2] = tc::pack_bf16(c1[0], c1[1]);
    a[3] = tc::pack_bf16(c1[2], c1[3]);
}

// A warp's 16 rows against the keys of one chunk, in registers: the logits
// s = qs K^T of the chunk's nt 16-key tiles, keys >= N at -inf.
template <int HD16, int CK16>
__device__ __forceinline__ void logits(float (&s)[2 * CK16][4], const uint32_t (&qf)[HD16][4],
                                       const bf16* Ks, int key0, int nt, int N, int lane) {
#pragma unroll
    for (int j = 0; j < CK16; ++j)
        if (j < nt)
            mma_nt<HD16, true, false>(s[2 * j], s[2 * j + 1], qf, Ks, Ks, key0 + 16 * j,
                                      lane, 0.f);
    if (key0 + 16 * nt > N) {
#pragma unroll
        for (int n = 0; n < 2 * CK16; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (key0 + 8 * n + 2 * (lane & 3) + (e & 1) >= N) s[n][e] = -INFINITY;
    }
}

// Row state of a warp's softmax: rows g (index 0) and g + 8 (index 1)
struct RowStats {
    float m[2], l[2];
};

// The max and the sum of exp(s - max) of each row over all N keys.  With
// the keys in one chunk, s is left holding exp(s - max).
template <int HD16, int CK16>
__device__ __forceinline__ RowStats softmax_stats(float (&s)[2 * CK16][4],
                                                  const uint32_t (&qf)[HD16][4], const bf16* Ks,
                                                  int N, int lane) {
    const int nkt = (N + 15) >> 4, nch = (nkt + CK16 - 1) / CK16;
    RowStats r = {{-INFINITY, -INFINITY}, {0.f, 0.f}};
    for (int c = 0; c < nch; ++c) {
        const int nt = min(CK16, nkt - c * CK16);
        logits<HD16, CK16>(s, qf, Ks, 16 * CK16 * c, nt, N, lane);
#pragma unroll
        for (int n = 0; n < 2 * CK16; ++n)
            if (n < 2 * nt) {
                r.m[0] = fmaxf(r.m[0], fmaxf(s[n][0], s[n][1]));
                r.m[1] = fmaxf(r.m[1], fmaxf(s[n][2], s[n][3]));
            }
    }
    r.m[0] = quad_max(r.m[0]);
    r.m[1] = quad_max(r.m[1]);
    for (int c = 0; c < nch; ++c) {
        const int nt = min(CK16, nkt - c * CK16);
        if (nch > 1) logits<HD16, CK16>(s, qf, Ks, 16 * CK16 * c, nt, N, lane);
#pragma unroll
        for (int n = 0; n < 2 * CK16; ++n)
            if (n < 2 * nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    s[n][e] = expf(s[n][e] - r.m[e >> 1]);
                    r.l[e >> 1] += s[n][e];
                }
    }
    r.l[0] = quad_sum(r.l[0]);
    r.l[1] = quad_sum(r.l[1]);
    return r;
}

// s := P = exp(s - max) / sum of chunk c, float32.  With more than one
// chunk the chunk's logits are formed again (the same bits as in
// softmax_stats); with one, s already holds exp(s - max) and is divided in
// place when `first`, and holds P already otherwise.
template <int HD16, int CK16>
__device__ __forceinline__ void probs(float (&s)[2 * CK16][4], const uint32_t (&qf)[HD16][4],
                                      const bf16* Ks, int N, int c, const RowStats& r,
                                      bool first, int lane) {
    const int nkt = (N + 15) >> 4, nch = (nkt + CK16 - 1) / CK16;
    const int nt = min(CK16, nkt - c * CK16);
    if (nch > 1) {
        logits<HD16, CK16>(s, qf, Ks, 16 * CK16 * c, nt, N, lane);
#pragma unroll
        for (int n = 0; n < 2 * CK16; ++n)
            if (n < 2 * nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - r.m[e >> 1]);
    } else if (!first) {
        return;
    }
#pragma unroll
    for (int n = 0; n < 2 * CK16; ++n)
        if (n < 2 * nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] / r.l[e >> 1];
}

// Store a warp's 16 x hd accumulator rows [row0, row0 + 16) (those < N) at
// out + row * ld + col, rounded to bf16 or as float32 times `mul`.
template <int HD16, typename TO>
__device__ __forceinline__ void store_rows(TO* out, size_t ld, const float (&acc)[2 * HD16][4],
                                           int row0, int N, int hd, float mul, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2 * HD16; ++n) {
        if (8 * n >= hd) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + g + 8 * half;
            if (row >= N) continue;
            TO* p = out + (size_t)row * ld + 8 * n + 2 * t;
            const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
            if constexpr (sizeof(TO) == 2)
                *reinterpret_cast<uint32_t*>(p) = tc::pack_bf16(v0, v1);
            else
                *reinterpret_cast<float2*>(p) = make_float2(v0 * mul, v1 * mul);
        }
    }
}

// ------------------------------------------------------------- forward
// grid (ceil(N / 64), heads, crops); qkv (B*N, 3D), o (B*N, D)
template <int HD16>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int N, int D, int heads,
           float scale) {
    constexpr int LD = Cfg<HD16>::LD, CK16 = Cfg<HD16>::FWD_CK16;
    extern __shared__ __align__(16) unsigned char smem[];
    const int NKP = pad16(N);
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + TILE * LD;
    bf16* Vs = Ks + NKP * LD;
    const int hd = D / heads, q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t pitch = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * N * pitch + h * hd;

    load_rows<HD16>(Qs, base + q0 * pitch, pitch, TILE, N - q0, hd);
    load_rows<HD16>(Ks, base + D, pitch, NKP, N, hd);
    tc::cp_async_commit();
    load_rows<HD16>(Vs, base + 2 * D, pitch, NKP, N, hd);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                         // q and K; V still in flight
    __syncthreads();

    uint32_t qf[HD16][4];
    load_a<HD16, true>(qf, Qs + 16 * warp * LD, lane, scale);
    float s[2 * CK16][4];
    const RowStats r = softmax_stats<HD16, CK16>(s, qf, Ks, N, lane);
    tc::cp_async_wait<0>();
    __syncthreads();

    float acc[2 * HD16][4] = {};
    const int nkt = (N + 15) >> 4, nch = (nkt + CK16 - 1) / CK16;
    for (int c = 0; c < nch; ++c) {
        probs<HD16, CK16>(s, qf, Ks, N, c, r, true, lane);
        const int nt = min(CK16, nkt - c * CK16);
#pragma unroll
        for (int j = 0; j < CK16; ++j)
            if (j < nt) {
                uint32_t a[4];
                c_to_a(a, s[2 * j], s[2 * j + 1]);
                mma_nn<HD16>(acc, a, Vs, 16 * (CK16 * c + j), lane);
            }
    }
    store_rows<HD16>(o + (size_t)b * N * D + h * hd, D, acc, q0 + 16 * warp, N, hd, 1.f, lane);
}

// ------------------------------------------------------------- backward
// Kernel A, grid (ceil(N / 64), heads, crops): o (B*N, D) bf16, the dq
// columns of dqkv (B*N, 3D) float32, stats [max | sum | rowsum(dP P)] of N
// floats each per (crop, head).
template <int HD16>
__global__ void __launch_bounds__(THREADS, 1)
bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO, bf16* __restrict__ o,
             float* __restrict__ dqkv, float* __restrict__ stats, int N, int D, int heads,
             float qscale, float scale) {
    constexpr int LD = Cfg<HD16>::LD, CK16 = Cfg<HD16>::BWD_CK16;
    extern __shared__ __align__(16) unsigned char smem[];
    const int NKP = pad16(N);
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ds = Qs + TILE * LD;
    bf16* Ks = Ds + TILE * LD;
    bf16* Vs = Ks + NKP * LD;
    const int hd = D / heads, q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t pitch = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * N * pitch + h * hd;

    load_rows<HD16>(Qs, base + q0 * pitch, pitch, TILE, N - q0, hd);
    load_rows<HD16>(Ks, base + D, pitch, NKP, N, hd);
    tc::cp_async_commit();
    load_rows<HD16>(Ds, dO + ((size_t)b * N + q0) * D + h * hd, D, TILE, N - q0, hd);
    load_rows<HD16>(Vs, base + 2 * D, pitch, NKP, N, hd);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();

    uint32_t qf[HD16][4];
    load_a<HD16, true>(qf, Qs + 16 * warp * LD, lane, qscale);
    float s[2 * CK16][4];
    const RowStats r = softmax_stats<HD16, CK16>(s, qf, Ks, N, lane);
    tc::cp_async_wait<0>();
    __syncthreads();
    uint32_t df[HD16][4];
    load_a<HD16, false>(df, Ds + 16 * warp * LD, lane, 0.f);

    const int nkt = (N + 15) >> 4, nch = (nkt + CK16 - 1) / CK16;
    const int row0 = q0 + 16 * warp;
    float acc[2 * HD16][4] = {};
    for (int c = 0; c < nch; ++c) {                 // o = round(P) V
        probs<HD16, CK16>(s, qf, Ks, N, c, r, true, lane);
        const int nt = min(CK16, nkt - c * CK16);
#pragma unroll
        for (int j = 0; j < CK16; ++j)
            if (j < nt) {
                uint32_t a[4];
                c_to_a(a, s[2 * j], s[2 * j + 1]);
                mma_nn<HD16>(acc, a, Vs, 16 * (CK16 * c + j), lane);
            }
    }
    store_rows<HD16>(o + (size_t)b * N * D + h * hd, D, acc, row0, N, hd, 1.f, lane);

    float ds[2] = {0.f, 0.f};                       // rowsum(dP P), dP = dO V^T
    for (int c = 0; c < nch; ++c) {
        probs<HD16, CK16>(s, qf, Ks, N, c, r, false, lane);
        const int nt = min(CK16, nkt - c * CK16);
#pragma unroll
        for (int j = 0; j < CK16; ++j)
            if (j < nt) {
                float dp[2][4];
                mma_nt<HD16, true, false>(dp[0], dp[1], df, Vs, Vs, 16 * (CK16 * c + j),
                                          lane, 0.f);
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) ds[e >> 1] += dp[n][e] * s[2 * j + n][e];
            }
    }
    ds[0] = quad_sum(ds[0]);
    ds[1] = quad_sum(ds[1]);

#pragma unroll
    for (int n = 0; n < 2 * HD16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int c = 0; c < nch; ++c) {                 // dq = round(dlog) K
        probs<HD16, CK16>(s, qf, Ks, N, c, r, false, lane);
        const int nt = min(CK16, nkt - c * CK16);
#pragma unroll
        for (int j = 0; j < CK16; ++j)
            if (j < nt) {
                float dp[2][4], g[2][4];
                mma_nt<HD16, true, false>(dp[0], dp[1], df, Vs, Vs, 16 * (CK16 * c + j),
                                          lane, 0.f);
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        g[n][e] = s[2 * j + n][e] * (dp[n][e] - ds[e >> 1]);
                uint32_t a[4];
                c_to_a(a, g[0], g[1]);
                mma_nn<HD16>(acc, a, Ks, 16 * (CK16 * c + j), lane);
            }
    }
    store_rows<HD16>(dqkv + (size_t)b * N * 3 * D + h * hd, 3 * (size_t)D, acc, row0, N, hd,
                     scale, lane);
    if ((lane & 3) == 0) {
        float* st = stats + ((size_t)b * heads + h) * 3 * N;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + (lane >> 2) + 8 * half;
            if (row < N) {
                st[row] = r.m[half];
                st[N + row] = r.l[half];
                st[2 * N + row] = ds[half];
            }
        }
    }
}

// Kernel B, grid (ceil(N / 64), heads, crops): the dk and dv columns of dqkv.
template <int HD16>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dO,
              const float* __restrict__ stats, float* __restrict__ dqkv, int N, int D, int heads,
              float qscale, float scale) {
    constexpr int LD = Cfg<HD16>::LD;
    constexpr bool HOLD = Cfg<HD16>::HOLD;
    extern __shared__ __align__(16) unsigned char smem[];
    const int NKP = pad16(N);
    bf16* Kt = reinterpret_cast<bf16*>(smem);
    bf16* Vt = Kt + TILE * LD;
    bf16* Qs = Vt + TILE * LD;
    bf16* Ds = Qs + NKP * LD;
    float* St = reinterpret_cast<float*>(Ds + NKP * LD);   // max | sum | rowsum(dP P)
    const int hd = D / heads, k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t pitch = 3 * (size_t)D;
    const bf16* base = qkv + (size_t)b * N * pitch + h * hd;

    load_rows<HD16>(Kt, base + k0 * pitch + D, pitch, TILE, N - k0, hd);
    load_rows<HD16>(Vt, base + k0 * pitch + 2 * D, pitch, TILE, N - k0, hd);
    load_rows<HD16>(Qs, base, pitch, NKP, N, hd);
    load_rows<HD16>(Ds, dO + (size_t)b * N * D + h * hd, D, NKP, N, hd);
    tc::cp_async_commit();
    const float* st = stats + ((size_t)b * heads + h) * 3 * N;
    for (int i = threadIdx.x; i < NKP; i += THREADS) {
        // padded queries: q = dO = 0 gives S^T = 0, P^T = 1, dlog^T = 0 and
        // no term in dv or dk
        const bool ok = i < N;
        St[i] = ok ? st[i] : 0.f;
        St[NKP + i] = ok ? st[N + i] : 1.f;
        St[2 * NKP + i] = ok ? st[2 * N + i] : 0.f;
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    const bf16* krows = Kt + 16 * warp * LD;
    const bf16* vrows = Vt + 16 * warp * LD;
    uint32_t kf[HOLD ? HD16 : 1][4], vf[HOLD ? HD16 : 1][4];
    if constexpr (HOLD) {
        load_a<HD16, false>(kf, krows, lane, 0.f);
        load_a<HD16, false>(vf, vrows, lane, 0.f);
    }
    float dv[2 * HD16][4] = {}, dk[2 * HD16][4] = {};
    const int t = lane & 3;
    for (int q = 0; q < NKP; q += 16) {
        float sT[2][4], dpT[2][4];
        mma_nt<HD16, HOLD, true>(sT[0], sT[1], kf, krows, Qs, q, lane, qscale);
        mma_nt<HD16, HOLD, false>(dpT[0], dpT[1], vf, vrows, Ds, q, lane, 0.f);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int i = q + 8 * n + 2 * t + (e & 1);       // the query of this element
                sT[n][e] = expf(sT[n][e] - St[i]) / St[NKP + i];                  // P^T
                dpT[n][e] = sT[n][e] * (dpT[n][e] - St[2 * NKP + i]);             // dlog^T
            }
        uint32_t a[4];
        c_to_a(a, sT[0], sT[1]);
        mma_nn<HD16>(dv, a, Ds, q, lane);
        c_to_a(a, dpT[0], dpT[1]);
        mma_nn<HD16>(dk, a, Qs, q, lane);
    }
    float* out = dqkv + (size_t)b * N * 3 * D + h * hd;
    store_rows<HD16>(out + D, 3 * (size_t)D, dk, k0 + 16 * warp, N, hd, scale, lane);
    store_rows<HD16>(out + 2 * D, 3 * (size_t)D, dv, k0 + 16 * warp, N, hd, 1.f, lane);
}

// ------------------------------------------------------------- launches
template <int HD16>
cudaError_t fwd_launch(const void* qkv, void* o, int B, int N, int D, int heads, float scale,
                       cudaStream_t st) {
    const size_t smem = fwd_smem<HD16>(N);
    cudaError_t err = cudaFuncSetAttribute(fwd_kernel<HD16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fwd_kernel<HD16><<<dim3((N + TILE - 1) / TILE, heads, B), THREADS, smem, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(o), N, D, heads, scale);
    return cudaGetLastError();
}

template <int HD16>
cudaError_t bwd_launch(const void* qkv, const void* dO, void* o, void* dqkv, void* stats, int B,
                       int N, int D, int heads, float qscale, float scale, cudaStream_t st) {
    const size_t smem_q = bwd_q_smem<HD16>(N), smem_kv = bwd_kv_smem<HD16>(N);
    cudaError_t err = cudaFuncSetAttribute(bwd_q_kernel<HD16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_q));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(bwd_kv_kernel<HD16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_kv));
    if (err != cudaSuccess) return err;
    const dim3 grid((N + TILE - 1) / TILE, heads, B);
    bwd_q_kernel<HD16><<<grid, THREADS, smem_q, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dO), static_cast<bf16*>(o),
        static_cast<float*>(dqkv), static_cast<float*>(stats), N, D, heads, qscale, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_kv_kernel<HD16><<<grid, THREADS, smem_kv, st>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dO),
        static_cast<const float*>(stats), static_cast<float*>(dqkv), N, D, heads, qscale, scale);
    return cudaGetLastError();
}

// F<hd16>(args...) for the padded head dim of a head dim hd (a multiple of
// 8, at most 128; the caller's shape check refuses others)
#define ATTN_TC_DISPATCH(hd, F, ...)                                          \
    do {                                                                      \
        if ((hd) % 8 || (hd) > 16 * attn_tc::MAX_HD16 || (hd) <= 0)           \
            return cudaErrorInvalidValue;                                     \
        switch (((hd) + 15) / 16) {                                           \
            case 1: return F<1>(__VA_ARGS__);                                 \
            case 2: return F<2>(__VA_ARGS__);                                 \
            case 3: return F<3>(__VA_ARGS__);                                 \
            case 4: return F<4>(__VA_ARGS__);                                 \
            case 5: return F<5>(__VA_ARGS__);                                 \
            case 6: return F<6>(__VA_ARGS__);                                 \
            case 7: return F<7>(__VA_ARGS__);                                 \
            default: return F<8>(__VA_ARGS__);                                \
        }                                                                     \
    } while (0)

}  // namespace attn_tc
