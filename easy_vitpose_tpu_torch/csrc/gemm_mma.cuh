// Tensor-core GEMM of the serving blocks (K1 bf16, K2 int8) with mma.sync:
// out = epilogue(A @ W^T), A (M, K) and W (N, K) both K-contiguous (W in
// torch's Linear layout).
//
// bf16: mma.m16n8k16, float32 accumulation.  int8: mma.m16n8k32, int32
// accumulation.  Both read the same bytes per thread: a k-step is 32 bytes
// of a row (16 bf16 or 32 int8), and a thread's A register r holds the
// 4 bytes at row (g + 8*(r&1)), byte 4*t + 16*(r>>1) of the step; its B
// register r the 4 bytes at column g, byte 4*t + 16*r (g = lane/4,
// t = lane%4).  ldmatrix hands out exactly those bytes (it moves 16-bit
// pairs, which for int8 are byte pairs), so one loader and one fragment
// path serve both.
//
// What bounds it on the H100 is operations: a ViT-B block's four products
// at 64 crops are 174 GFLOP (0.18 ms at the bf16 peak).  Design:
//   * block tile 128 x BN (BN 128 or 64), 8 warps with 64x32 or 32x32 warp
//     tiles; k-tile of 128 bytes of each row;
//   * a ring of STAGES = 3 k-tiles in dynamic shared memory, filled by
//     16-byte cp.async.cg copies (commit_group / wait_group): while the
//     warps multiply k-tile i, the copies of i+1 and i+2 are in flight;
//   * shared rows of 128 bytes with the 16-byte chunk c of row r stored at
//     chunk c ^ (r & 7), so that the 8 rows an ldmatrix reads at one chunk,
//     and the 8 chunks the copies write to one row, fall on 8 different
//     16-byte bank groups;
//   * fragments by ldmatrix.x4 (four 8x8 b16 matrices per instruction);
//   * the launch takes BN = 128 where N allows it and the grid fills its
//     last wave to at least 90% (by the occupancy the runtime reports), else
//     BN = 64: at M = 12288 (64 crops of 192 tokens) a ViT-B qkv or fc1
//     product takes 128-wide tiles, proj and fc2 (576 such tiles on 132 SMs
//     at 2 blocks each: 2.2 waves) 64-wide ones;
//   * the epilogue (bias, A&S-erf GELU, residual, cast; int8's
//     acc * sx * sw + b) is unchanged in meaning, two columns per store.
// On the H100 these two tiles measured best, by the products of a ViT-B
// block, against 64x64 warp tiles (128x128, 256x128 and 128x256 blocks)
// and a 4-stage ring (scripts/bench_kernel_variants.py; PERF.md).
// wgmma fed by TMA is the next step (ROADMAP).
#pragma once

#include "common.cuh"
#include "tc.cuh"

namespace mma_gemm {

constexpr int STAGES = 3;
constexpr int KT_BYTES = 128;               // bytes of one row per k-tile

template <bool INT8> struct Acc { typedef float type; };
template <> struct Acc<true> { typedef int type; };

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    tc::mma_bf16(c, a, b0, b1);
}
__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    tc::mma_s8(c, a, b0, b1);
}

// Block tile BM_ x BN_ of warps with WM_ x WN_ warp tiles; MIN_BLOCKS_
// blocks per SM for the register budget.
template <int BM_, int BN_, int WM_, int WN_, int MIN_BLOCKS_>
struct Tile {
    static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
    static constexpr int WARPS_N = BN / WN;
    static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
    static constexpr int MT = WM / 16, NT = WN / 8;           // m16 and n8 tiles of a warp
    static constexpr int STAGE = (BM + BN) * KT_BYTES;        // bytes of one ring slot
    static constexpr int SMEM = STAGES * STAGE;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
};

// byte offset of chunk c (16 bytes) of row r in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * KT_BYTES + ((c ^ (r & 7)) << 4); }

// Copy the k-tile at byte kbyte of `nrows` rows from row0 into a swizzled
// shared tile, asynchronously; rows >= valid are zero.
template <int NROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, int row0, int valid,
                                          int pitch, int kbyte) {
#pragma unroll
    for (int i = 0; i < NROWS * 8 / THREADS; ++i) {
        const int c = threadIdx.x + i * THREADS;
        const int r = c >> 3, ch = c & 7;
        const bool ok = row0 + r < valid;
        const uint8_t* s = src + (size_t)(ok ? row0 + r : 0) * pitch + kbyte + ch * 16;
        tc::cp_async16(dst + swz(r, ch), s, ok ? 16 : 0);
    }
}

// Value of one output before the epilogue: acc + bias (float accumulation),
// or acc * sx * sw + bias (int8), in the JAX kernels' order.
template <typename TB>
__device__ __forceinline__ float dequant(float acc, int, int col, const float*, const float*,
                                         const TB* bias) {
    return acc + to_f(bias[col]);
}
template <typename TB>
__device__ __forceinline__ float dequant(int acc, int row, int col, const float* sx,
                                         const float* sw, const TB* bias) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx[row]), sw[col]),
                     to_f(bias[col]));
}

// epilogue_store's value for two neighbouring columns, stored together
template <typename TO>
__device__ __forceinline__ void epilogue_store2(float v0, float v1, int epi, const TO* res,
                                                TO* out, size_t idx) {
    if (epi == EPI_GELU) {
        v0 = gelu_as(v0);
        v1 = gelu_as(v1);
    }
    if (epi == EPI_RESIDUAL) {
        v0 = to_f(res[idx]) + round_to<TO>(v0);
        v1 = to_f(res[idx + 1]) + round_to<TO>(v1);
    }
    if constexpr (sizeof(TO) == 2)
        *reinterpret_cast<uint32_t*>(out + idx) = tc::pack_bf16(v0, v1);
    else
        *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
}

// grid (N / T::BN, ceil(M / T::BM)), T::THREADS threads, T::SMEM bytes of
// dynamic shared memory; K_bytes = K * sizeof(element), a multiple of KT_BYTES.
template <bool INT8, typename TB, typename TO, typename T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
gemm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ W,
            const float* __restrict__ sx, const float* __restrict__ sw,
            const TB* __restrict__ bias, const TO* res, TO* out,
            int M, int N, int K_bytes, int epi) {
    typedef typename Acc<INT8>::type acc_t;
    constexpr int BM = T::BM, BN = T::BN;
    extern __shared__ __align__(128) uint8_t smem[];

    const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
    const int nk = K_bytes / KT_BYTES;

    auto load_stage = [&](int kt) {
        uint8_t* st = smem + (kt % STAGES) * T::STAGE;
        load_tile<BM, T::THREADS>(st, A, bm, M, K_bytes, kt * KT_BYTES);
        load_tile<BN, T::THREADS>(st + BM * KT_BYTES, W, bn, N, K_bytes, kt * KT_BYTES);
    };

    acc_t acc[T::MT][T::NT][4];
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(s);
        tc::cp_async_commit();
    }
    // ldmatrix row and chunk of this lane: A matrices (rows 0-7 | 8-15) x
    // (chunk 0 | 1) of a k-step; B matrices (n 0-7 chunk 0 | 1, n 8-15 ...)
    const int a_row = lane & 15, a_ch = lane >> 4;
    const int b_row = (lane & 7) + 8 * (lane >> 4), b_ch = (lane >> 3) & 1;

    for (int kt = 0; kt < nk; ++kt) {
        tc::cp_async_wait<STAGES - 2>();       // k-tile kt has landed (this thread's copies)
        __syncthreads();                       // ... everyone's; slot kt-1 is free
        if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1);
        tc::cp_async_commit();
        const uint8_t* As = smem + (kt % STAGES) * T::STAGE;
        const uint8_t* Ws = As + BM * KT_BYTES;
#pragma unroll
        for (int ks = 0; ks < KT_BYTES / 32; ++ks) {
            uint32_t a[T::MT][4], b[T::NT][2];
#pragma unroll
            for (int mi = 0; mi < T::MT; ++mi) {
                const int r = wm + mi * 16 + a_row;
                tc::ldsm_x4(a[mi], As + swz(r, 2 * ks + a_ch));
            }
#pragma unroll
            for (int np = 0; np < T::NT / 2; ++np) {
                const int r = wn + np * 16 + b_row;
                uint32_t v[4];
                tc::ldsm_x4(v, Ws + swz(r, 2 * ks + b_ch));
                b[2 * np][0] = v[0];
                b[2 * np][1] = v[1];
                b[2 * np + 1][0] = v[2];
                b[2 * np + 1][1] = v[3];
            }
#pragma unroll
            for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
                for (int ni = 0; ni < T::NT; ++ni) mma(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
    }
    tc::cp_async_wait<0>();

    // accumulator e of an m16n8 tile: row g + 8*(e>>1), column 2*t + (e&1)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = bm + wm + mi * 16 + g + 8 * half;
                const int col = bn + wn + ni * 8 + 2 * t;
                if (row < M) {
                    const float v0 = dequant<TB>(acc[mi][ni][2 * half], row, col, sx, sw, bias);
                    const float v1 = dequant<TB>(acc[mi][ni][2 * half + 1], row, col + 1, sx,
                                                 sw, bias);
                    epilogue_store2<TO>(v0, v1, epi, res, out, (size_t)row * N + col);
                }
            }
}

// The two tiles the launch picks from
typedef Tile<128, 128, 64, 32, 2> Wide;     // 8 warps, 96 KB: 2 blocks per SM
typedef Tile<128, 64, 32, 32, 3> Narrow;    // 8 warps, 72 KB: 3 blocks per SM

// Blocks of gemm_kernel<..., T> that fit one SM, from the runtime's
// occupancy calculator (registers and shared memory), once per process.
template <bool INT8, typename TB, typename TO, typename T>
inline int blocks_per_sm() {
    static int n = [] {
        int v = 0;
        cudaFuncSetAttribute(gemm_kernel<INT8, TB, TO, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v, gemm_kernel<INT8, TB, TO, T>,
                                                      T::THREADS, T::SMEM);
        return v > 0 ? v : 1;
    }();
    return n;
}

inline int sm_count() {
    static int n = [] {
        int dev = 0, v = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
        return v > 0 ? v : 1;
    }();
    return n;
}

// Share of the block slots of the grid's waves that hold a tile.
inline double wave_fill(long tiles, long slots) {
    const long waves = (tiles + slots - 1) / slots;
    return static_cast<double>(tiles) / static_cast<double>(waves * slots);
}

// The caller guarantees N % T::BN == 0 and K_bytes % KT_BYTES == 0.
template <bool INT8, typename TB, typename TO, typename T>
inline cudaError_t launch_tile(const void* A, const void* W, const float* sx, const float* sw,
                               const void* bias, const void* res, void* out, int M, int N,
                               int K_bytes, int epi, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(gemm_kernel<INT8, TB, TO, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(N / T::BN, (M + T::BM - 1) / T::BM);
    gemm_kernel<INT8, TB, TO, T><<<grid, T::THREADS, T::SMEM, stream>>>(
        static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(W), sx, sw,
        static_cast<const TB*>(bias), static_cast<const TO*>(res), static_cast<TO*>(out),
        M, N, K_bytes, epi);
    return cudaGetLastError();
}

// The caller guarantees N % 64 == 0 and K_bytes % KT_BYTES == 0.
template <bool INT8, typename TB, typename TO>
inline cudaError_t launch(const void* A, const void* W, const float* sx, const float* sw,
                          const void* bias, const void* res, void* out, int M, int N,
                          int K_bytes, int epi, cudaStream_t stream) {
    if (N % Narrow::BN || K_bytes % KT_BYTES || M <= 0) return cudaErrorInvalidValue;
    const long wide_tiles = (long)(M + Wide::BM - 1) / Wide::BM * (N / Wide::BN);
    if (N % Wide::BN == 0 &&
        wave_fill(wide_tiles, (long)sm_count() * blocks_per_sm<INT8, TB, TO, Wide>()) >= 0.9)
        return launch_tile<INT8, TB, TO, Wide>(A, W, sx, sw, bias, res, out, M, N, K_bytes, epi,
                                               stream);
    return launch_tile<INT8, TB, TO, Narrow>(A, W, sx, sw, bias, res, out, M, N, K_bytes, epi,
                                             stream);
}

}  // namespace mma_gemm
