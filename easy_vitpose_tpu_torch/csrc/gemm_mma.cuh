// Tensor-core GEMM with mma.sync: out = epilogue(A @ W^T), A (M, K) and
// W (N, K) both K-contiguous (W in torch's Linear layout).
//
// bf16: mma.m16n8k16, float32 accumulation.  int8: mma.m16n8k32, int32
// accumulation.  Both read the same bytes per thread: a k-step is 32 bytes
// of a row (16 bf16 or 32 int8), and a thread's A register r holds the
// 4 bytes at row (g + 8*(r&1)), byte 4*t + 16*(r>>1) of the step; its B
// register r the 4 bytes at column g, byte 4*t + 16*r (g = lane/4,
// t = lane%4).  So one loader and one fragment layout serve both.
//
// Block tile 64x64, 4 warps in 2x2, warp tile 32x32 (2 x 4 mma tiles),
// k-tile 128 bytes.  Shared rows are padded to 144 bytes, which puts the 32
// lanes' 4-byte reads on 32 different banks.  No pipelining: this is the
// simple first version (PERF.md has its time).
#pragma once

#include "common.cuh"

namespace mma_gemm {

constexpr int BM = 64, BN = 64, THREADS = 128;
constexpr int KT_BYTES = 128;               // bytes of one row per k-tile
constexpr int ROW = KT_BYTES + 16;          // padded shared row, bytes

template <bool INT8> struct Acc { typedef float type; };
template <> struct Acc<true> { typedef int type; };

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy a 64-row x 128-byte tile into shared memory, zero-filling rows >= rows.
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src, int row0, int rows,
                                          int pitch, int kbyte) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int c = threadIdx.x + i * THREADS;    // 512 16-byte chunks
        const int r = c >> 3, col = (c & 7) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < rows)
            v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * pitch + kbyte + col);
        *reinterpret_cast<uint4*>(dst + r * ROW + col) = v;
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

// grid (N / 64, ceil(M / 64)), 128 threads; K_bytes = K * sizeof(element).
template <bool INT8, typename TB, typename TO>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ W,
            const float* __restrict__ sx, const float* __restrict__ sw,
            const TB* __restrict__ bias, const TO* res, TO* out,
            int M, int N, int K_bytes, int epi) {
    typedef typename Acc<INT8>::type acc_t;
    __shared__ __align__(16) uint8_t As[BM * ROW];
    __shared__ __align__(16) uint8_t Ws[BN * ROW];

    const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;

    acc_t acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    for (int kb = 0; kb < K_bytes; kb += KT_BYTES) {
        load_tile(As, A, bm, M, K_bytes, kb);
        load_tile(Ws, W, bn, N, K_bytes, kb);
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < KT_BYTES; ks += 32) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const uint8_t* p = As + (wm + mi * 16 + g) * ROW + ks + 4 * t;
                a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
                a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
                a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const uint8_t* p = Ws + (wn + ni * 8 + g) * ROW + ks + 4 * t;
                b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
                b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
        }
        __syncthreads();
    }

    // accumulator e of an m16n8 tile: row g + 8*(e>>1), column 2*t + (e&1)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = bm + wm + mi * 16 + g + 8 * (e >> 1);
                const int col = bn + wn + ni * 8 + 2 * t + (e & 1);
                if (row < M) {
                    const float v = dequant<TB>(acc[mi][ni][e], row, col, sx, sw, bias);
                    epilogue_store<TO>(v, epi, res, out, (size_t)row * N + col);
                }
            }
}

template <bool INT8, typename TB, typename TO>
inline void launch(const void* A, const void* W, const float* sx, const float* sw,
                   const void* bias, const void* res, void* out, int M, int N, int K_bytes,
                   int epi, cudaStream_t stream) {
    dim3 grid(N / BN, (M + BM - 1) / BM);
    gemm_kernel<INT8, TB, TO><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(W), sx, sw,
        static_cast<const TB*>(bias), static_cast<const TO*>(res), static_cast<TO*>(out),
        M, N, K_bytes, epi);
}

}  // namespace mma_gemm
