// K1's float32 GEMM on Hopper's warpgroup tensor cores with float32
// accuracy ("3xTF32", sm_90a): C = epilogue(A . W^T + bias) with A (M, K)
// and W (N, K) float32, both K-major.
//
// What bounds it: operations.  At ViT-B and 64 crops a block's four
// products are 174 GFLOP; the float32 FMA units' 67 TFLOP/s make that 2.6
// ms, while the TF32 tensor cores run 495 TFLOP/s but keep only 11
// significant bits of each operand.  So each operand is split into two
// TF32 numbers, x = hi + lo + O(2^-22 |x|), with hi = rna(x) and
// lo = rna(x - hi) (cvt.rna.tf32.f32's rounding, the low 13 bits zero),
// and every product is the float32 sum of three TF32 products,
//     a.w ~= a_lo.w_hi + a_hi.w_lo + a_hi.w_hi,
// the small ones first (CUTLASS's "fast float32" order); the dropped
// a_lo.w_lo is O(2^-22) of a.w.  Three products at the TF32 peak bound
// the GEMMs at 1.05 ms a ViT-B block.
//
// The design is gemm_wgmma.cuh's ring at 128 bytes a k-tile (32 floats):
// one block of 256 threads computes a 128 x 128 tile, two warpgroups of 64
// rows each issuing wgmma.mma_async m64n128k8 (f32 += tf32 . tf32), the
// operands' k-tiles TMA-loaded into a ring of shared memory with the
// 128-byte swizzle.  W comes split once per serving copy
// (models/fused_block.py keeps W_hi and W_lo beside the weights) and is
// read by descriptor.  A comes raw and is split in registers: a slot holds
// A's, W_hi's and W_lo's k-tiles (four slots), each thread reads its wgmma
// fragment of A's (the m16n8k8 A layout: a0 (row g, k t), a1 (row g + 8,
// k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4), g = lane / 4,
// t = lane % 4), splits it, and issues the register-A form of wgmma.  A
// wgmma reads its A registers until its group completes, so a k-tile's
// fragments go to the other of two buffers, read and split while the
// k-tile before runs.  (scripts/bench_kernel_variants.py --tf32-gemm
// times this against A split by the launch that produces it and read by
// descriptor; PERF.md has the numbers.)
//
// The tensor cores add a wgmma's products to its accumulator with
// truncation (round toward zero), an error of up to an ulp of the running
// sum each time, which over K = 3072 reached 2.5e-5 of the largest output
// when one accumulator took all of K.  So a k-tile's twelve products go to
// a fresh accumulator, which the threads then add to the tile's float32
// sums (round to nearest).  A warpgroup waits for its k-tile's products
// (wait_group 0) before it adds them and releases the slot; the other
// warpgroup's products keep the tensor cores busy meanwhile.
//
// Reads outside the matrices are zeros (TMA), so any M and N work.  The
// epilogue (bias, the A&S-erf GELU or the residual, common.cuh's math)
// runs on the accumulators and stages the tile in the ring, from where TMA
// stores whole 128-byte rows and drops rows >= M and columns >= N; the
// residual comes in by TMA too.  With one block an SM nothing hides an
// epilogue.  The k order is fixed: the same inputs give the same bits.
#pragma once

#include <type_traits>

#include "gemm_wgmma.cuh"
#include "tc.cuh"

namespace tf {

constexpr int BM = 128, BN = 128, BK = 32;         // k-tile: 32 floats = 128 bytes
constexpr int THREADS = 256, ACC = BN / 2;
constexpr int TILE_BYTES = 128 * BK * 4;           // one operand's k-tile, 16 KB
constexpr int STAGES = 4;                          // ring slots
constexpr int STAGE_BYTES = 3 * TILE_BYTES;        // a slot: A's, W_hi's and W_lo's k-tiles
constexpr uint32_t W_AT = TILE_BYTES;              // W_hi's k-tile in a slot, W_lo's after
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;

// x rounded to TF32 by tc.cuh's rule (cvt.rna.tf32.f32's bits; the
// instruction itself made the split of A the slower,
// scripts/bench_kernel_variants.py --tf32-gemm); infinities stay and a NaN
// becomes 0x7FC00000
__device__ __forceinline__ uint32_t tf32_round(float x) {
    return isnan(x) ? 0x7FC00000u : tc::tf32_rna(x);
}

// x = hi + lo + O(2^-22 |x|); a non-finite x has lo = 0
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_round(x);
    lo = isfinite(x) ? tc::tf32_rna(x - __uint_as_float(hi)) : 0u;
}

// d (64 x 128, float32) = A (64 x 8, this thread's fragment a) . B^T
// (+ d unless scale_d is 0), B (128 x 8) read by descriptor
__device__ __forceinline__ void wgmma_ra(float (&d)[ACC], const uint32_t* a, uint64_t db,
                                         int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// byte offset of float (r, k) in a swizzled k-tile of 128-byte rows
__device__ __forceinline__ uint32_t swz(int r, int k) {
    return r * 128 + ((((k >> 2) ^ (r & 7))) << 4) + ((k & 3) << 2);
}

// Thread 0's loads of k-tile kt into its slot: A's, W_hi's and W_lo's
// boxes of 32 floats x 128 rows
__device__ __forceinline__ void load_tile(const CUtensorMap* ma, const CUtensorMap* mwh,
                                          const CUtensorMap* mwl, uint32_t ring, uint32_t full,
                                          int kt, int m0, int n0) {
    const int s = kt % STAGES, k0 = kt * BK;
    const uint32_t slot = ring + s * STAGE_BYTES, bar = full + 8 * s;
    wg::mbar_expect(bar, STAGE_BYTES);
    wg::tma_load(slot, ma, k0, m0, bar);
    wg::tma_load(slot + W_AT, mwh, k0, n0, bar);
    wg::tma_load(slot + W_AT + TILE_BYTES, mwl, k0, n0, bar);
}

// This thread's A fragments of the k-tile at `a` (shared), split: for
// k-step ks, hi in frag[ks][0-3] and lo in frag[ks][4-7]
__device__ __forceinline__ void load_frags(uint32_t (&frag)[4][8], const uint8_t* a, int row) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row + 8 * (i & 1), k = 8 * ks + t + 4 * (i >> 1);
            tf32_split(*reinterpret_cast<const float*>(a + swz(r, k)), frag[ks][i],
                       frag[ks][4 + i]);
        }
}

// One k-tile's twelve products (four k-steps of three) for this thread's
// warpgroup into acc (the first overwrites it), issued as one group; frag
// holds the k-tile's A fragments until the group completes.
__device__ __forceinline__ void issue_tile(float (&acc)[ACC], const uint32_t (&frag)[4][8],
                                           uint32_t slot) {
    const uint32_t wh = slot + W_AT, wl = wh + TILE_BYTES;
    wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
        const uint64_t dh = wg::desc(wh + 32 * ks, 16, 1024), dl = wg::desc(wl + 32 * ks, 16, 1024);
        wgmma_ra(acc, frag[ks] + 4, dh, ks);  // a_lo . w_hi
        wgmma_ra(acc, frag[ks], dl, 1);       // a_hi . w_lo
        wgmma_ra(acc, frag[ks], dh, 1);       // a_hi . w_hi
    }
    wg::wgmma_commit();
}

// the maps of a launch's output and of its residual, in gemm_wgmma.cuh's
// 128-byte x 128-row boxes
struct EpiMaps {
    CUtensorMap out, res;
};

// The epilogue's tiles, staged in the ring once the main loop is done:
// the output, then the residual; 64 KB each
constexpr uint32_t OUT_AT = 0, RES_AT = 64 * 1024;

__global__ void __launch_bounds__(THREADS, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mwh,
                 const __grid_constant__ CUtensorMap mwl, const __grid_constant__ EpiMaps em,
                 const float* __restrict__ bias, int N, int K, int epi) {
    static_assert(STAGES * STAGE_BYTES >= RES_AT + 64 * 1024, "the epilogue's tiles");
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full[s], then empty[s]
    __shared__ __align__(8) uint64_t res_bar;
    const uint32_t ring = (wg::smem_u32(smem_raw) + 1023) & ~1023u;
    const uint8_t* const ring_ptr = smem_raw + (ring - wg::smem_u32(smem_raw));
    const uint32_t full = wg::smem_u32(bars), empty = full + 8 * STAGES;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int nk = K / BK, wgi = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int row = 64 * wgi + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);   // of the tile

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            wg::mbar_init(full + 8 * s, 1);
            wg::mbar_init(empty + 8 * s, THREADS / 32);
        }
        wg::mbar_init(wg::smem_u32(&res_bar), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
        for (int kt = 0; kt < STAGES && kt < (nk + 1) / 2 * 2; ++kt)
            load_tile(&ma, &mwh, &mwl, ring, full, kt, m0, n0);

    // Each k-tile's products go to part, then into acc in float32.  The
    // fragments of k-tile kt + 1 are read and split while kt's products
    // run, into the other of two buffers (whose products completed before).
    // A slot is refilled one k-tile after its release, so that a warpgroup
    // need not wait for the other to finish the same k-tile.  The count of
    // k-tiles is rounded up to even (a k-tile past K reads zeros), so that
    // the buffers alternate without a branch around the products.
    float acc[ACC], part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
    uint32_t frag[2][4][8];
    const int nk2 = (nk + 1) & ~1;
    auto slot_of = [&](int kt) { return (kt % STAGES) * STAGE_BYTES; };
    auto step = [&](int kt, auto buf) {
        constexpr int B = decltype(buf)::value;
        issue_tile(part, frag[B], ring + slot_of(kt));
        if (kt + 1 < nk2) {
            const int s1 = (kt + 1) % STAGES;
            wg::mbar_wait(full + 8 * s1, ((kt + 1) / STAGES) & 1);
            load_frags(frag[1 - B], ring_ptr + slot_of(kt + 1), row);
        }
        wg::wgmma_wait<0>();
        const int s = kt % STAGES;
        if (lane == 0) wg::mbar_arrive(empty + 8 * s);
        if (threadIdx.x == 0 && kt > 0 && kt - 1 + STAGES < nk2) {
            const int p = (kt - 1) % STAGES;
            wg::mbar_wait(empty + 8 * p, ((kt - 1) / STAGES) & 1);
            load_tile(&ma, &mwh, &mwl, ring, full, kt - 1 + STAGES, m0, n0);
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    };
    wg::mbar_wait(full, 0);
    load_frags(frag[0], ring_ptr, row);
    for (int kt = 0; kt < nk2; kt += 2) {
        step(kt, std::integral_constant<int, 0>());
        step(kt + 1, std::integral_constant<int, 1>());
    }

    // Epilogue, staged in the ring (free once every warp is done with it):
    // the residual tile comes in by TMA; each thread turns its pairs of
    // columns into the output; thread 0 writes the tile out by TMA, which
    // drops rows >= M and columns >= N.  Accumulator 4j + 2h + e is at row
    // `row` + 8h, column 8j + 2t + e of the tile.
    __syncthreads();
    uint8_t* const tile = const_cast<uint8_t*>(ring_ptr);
    if (epi == EPI_RESIDUAL) {
        const uint32_t bar = wg::smem_u32(&res_bar);
        if (threadIdx.x == 0) {
            wg::mbar_expect(bar, 64 * 1024);
            for (int c = 0; c < BN; c += 32) wg::tma_load(ring + RES_AT + c * 4 * BM, &em.res, n0 + c,
                                                          m0, bar);
        }
        wg::mbar_wait(bar, 0);
    }
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
        const int c = 8 * j + c0;
        if (n0 + c >= N) continue;               // N is even: both columns or neither
        const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row + 8 * h;
            const uint32_t at = wg::tile_offset<4>(r, c);
            float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
            if (epi == EPI_GELU) {
                v0 = gelu_as(v0);
                v1 = gelu_as(v1);
            } else if (epi == EPI_RESIDUAL) {
                const float2 x = *reinterpret_cast<const float2*>(tile + RES_AT + at);
                v0 += x.x;
                v1 += x.y;
            }
            *reinterpret_cast<float2*>(tile + OUT_AT + at) = make_float2(v0, v1);
        }
    }
    wg::fence_to_tma();
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int c = 0; c < BN && n0 + c < N; c += 32)
            wg::tma_store(&em.out, ring + OUT_AT + c * 4 * BM, n0 + c, m0);
        wg::tma_store_commit_and_wait();
    }
}

// out (M, N) = epilogue(a . w^T + bias) from a (M, K) and w's split halves
// (N, K) each.  Needs K % 32 == 0, N % 4 == 0 and a, w_hi, w_lo, res and
// out 16-byte aligned (the wrapper checks).
cudaError_t launch(const void* a, const void* w_hi, const void* w_lo, const void* bias,
                   const void* res, void* out, int M, int N, int K, int epi, cudaStream_t st) {
    CUtensorMap ma, mwh, mwl;
    EpiMaps em = {};
    if (!wg::make_map(&ma, a, K, M, K, BK, BM, 4) ||
        !wg::make_map(&mwh, w_hi, K, N, K, BK, BN, 4) ||
        !wg::make_map(&mwl, w_lo, K, N, K, BK, BN, 4) ||
        !wg::tile_map(&em.out, out, M, N, N, 4) ||
        (epi == EPI_RESIDUAL && !wg::tile_map(&em.res, res, M, N, N, 4)))
        return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_tf32_kernel<<<grid, THREADS, SMEM, st>>>(
        ma, mwh, mwl, em, static_cast<const float*>(bias), N, K, epi);
    return cudaGetLastError();
}

// hi and lo of n floats (W's split, made once per serving copy)
__global__ void __launch_bounds__(256)
split_kernel(const float* __restrict__ x, uint32_t* __restrict__ hi, uint32_t* __restrict__ lo,
             long long n) {
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256)
        tf32_split(x[i], hi[i], lo[i]);
}

}  // namespace tf
