// Building blocks of a bf16 GEMM on Hopper's warpgroup tensor-core
// instruction (sm_90a): TMA tensor maps, mbarriers, wgmma.mma_async and the
// block's main loop.  The training GEMM (train_block.cu) is built from them;
// they hold none of its epilogues' math, so another GEMM can share them.
//
// One block computes a BM x BN = 128 x 128 float32 tile of C = A . B^T over
// all of K, with 256 threads: two warpgroups of 64 rows each, both issuing
// wgmma.mma_async m64n128k16 (f32 += bf16 . bf16) with both operands read
// from shared memory by descriptor.  Each operand is read as it is stored:
//   * K-major (K contiguous; A of NT and NN, B of NT): a k-tile is 64 k (128
//     bytes) of each of the tile's 128 rows, one TMA box {64, 128};
//   * MN-major (the rows contiguous; A of TN, B of NN and TN): a k-tile is
//     64 k-rows of 128 bytes for each 64-wide half of the tile's rows, two
//     TMA boxes {64, 64}; the instruction's transpose bit takes them.
// TMA writes both with the 128-byte swizzle (16-byte chunk c of a 128-byte
// row r stored at chunk c ^ (r & 7), on 1024-byte aligned atoms of 8 rows),
// the layout the descriptors name; reads outside the matrix are zeros, so
// ragged M, N and K need no masks in the main loop.
//
// The k-tiles go through a ring of STAGES slots in dynamic shared memory.
// Thread 0 is also the producer: it fills every slot ahead, and once all
// eight warps have released a slot (an mbarrier of 8 arrivals, after the
// wgmma that read it has completed) it loads the k-tile STAGES ahead into
// it; a slot's arrival is an mbarrier with the TMA's transaction bytes.
// wgmma runs one k-tile behind its issue (wait_group 1), so a k-tile's
// products overlap the next one's issue and the copies of the two after.
// The k order is fixed and no tile is split, so every output is one
// fixed-order float32 sum: the same inputs give the same bits.
//
// Once the main loop returns, an epilogue may stage its 128 x 128 tiles in
// the ring (tile_map's boxes at tile_offset's bytes): inputs come in by
// TMA, outputs go out by TMA stores of whole 128-byte rows.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes through the runtime

#include "common.cuh"

namespace wg {

constexpr int BM = 128, BN = 128, BK = 64;         // block tile; k-tile of 64 bf16 = 128 bytes
constexpr int THREADS = 256, STAGES = 3, MIN_BLOCKS = 2;
constexpr int OPERAND_BYTES = 128 * BK * 2;        // one operand's k-tile, 16 KB
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // the slack aligns the ring to 1024 bytes
constexpr int ACC = BN / 2;                        // float32 accumulators per thread

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found once through the CUDA runtime,
// so the library does not link libcuda itself.
inline EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                                 12000, cudaEnableDefault, &q);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                        cudaEnableDefault, &q);
#endif
        return err == cudaSuccess && q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// The map of a bf16 (es 2) or float32 (es 4) matrix with `outer` rows of
// `inner` contiguous elements, row r at base + r * ld, read or written in
// boxes of box_inner x box_outer with the 128-byte swizzle; reads outside
// are zeros, writes outside are dropped.  False if the encoder refuses it
// (the base and ld * es must be multiples of 16 bytes).
inline bool make_map(CUtensorMap* map, const void* base, int inner, int outer, int ld,
                     int box_inner, int box_outer, int es = 2) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * es};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                               static_cast<cuuint32_t>(box_outer)};
    const cuuint32_t step[2] = {1, 1};
    const EncodeTiled enc = encoder();
    return enc != nullptr &&
           enc(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
               const_cast<void*>(base), dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of one operand: (rows, K) stored K-major with leading dim ld, or
// MN-major as (K, rows).
inline bool operand_map(CUtensorMap* map, const void* base, int rows, int K, int ld, bool kmaj) {
    return kmaj ? make_map(map, base, K, rows, ld, BK, 128)
                : make_map(map, base, rows, K, ld, 64, BK);
}

// The map of an (M, N) output or epilogue input with leading dim ld, in
// boxes of 128 bytes x 128 rows: a block's 128 x 128 tile is 128 / (128 /
// es) such boxes side by side (tile_offset's layout).
inline bool tile_map(CUtensorMap* map, const void* base, int M, int N, int ld, int es) {
    return make_map(map, base, N, M, ld, 128 / es, BM, es);
}

// ---------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// arrive and expect `bytes` of TMA transactions on the current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// box at (c0 along the contiguous dim, c1) of `map` into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.  K-major: the stride is
// 1024 bytes from one 8-row atom to the next, the leading offset unused (1).
// MN-major: the stride is 1024 bytes from 8 k-rows to the next 8, the
// leading offset the bytes from one 64-wide half of the rows to the next.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead, uint32_t stride) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           static_cast<uint64_t>(lead >> 4) << 16 |
           static_cast<uint64_t>(stride >> 4) << 32 |
           static_cast<uint64_t>(1) << 62;
}

// box at (c0, c1) of `map` from shared memory at src, as one bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ask for box (c0, c1) of `map` to be brought into L2, with no completion
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0, int c1) {
    asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1) : "memory");
}

// make this thread's shared-memory writes visible to TMA
__device__ __forceinline__ void fence_to_tma() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of element (r, c) of a 128 x 128 tile of es-byte elements
// held as tile_map's boxes (128 rows of 128 bytes, 16 KB each, with the
// 128-byte swizzle).  A thread's accumulator pair (r, c), (r, c + 1), c
// even, lies in one 16-byte chunk, and a warp's pairs at one (j, half)
// fall on distinct chunks of each 128 bytes: no bank conflicts.
template <int ES>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
    constexpr int E = 128 / ES;                   // elements per box row
    const int byte = (c % E) * ES;
    return (c / E) * (BM * 128) + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d (64 x 128, float32) += A (64 x 16) . B (128 x 16)^T; TA / TB: the
// operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_128(float (&d)[ACC], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
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
        : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The block's tile at rows m0 and columns n0, summed over all of K into
// acc (zeroed here): thread x holds warpgroup x / 128's rows.  Accumulator
// 4j + e of a thread (lane g = lane / 4, t = lane % 4, warp w of its
// warpgroup) is at row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1).
// Returns the ring's shared address: STAGES * STAGE_BYTES, free for the
// epilogue once every thread has returned.  Barriers the caller set up
// before the call (thread 0) are initialized when any thread returns.
template <bool AK, bool BKM>
__device__ __forceinline__ uint32_t mainloop(float (&acc)[ACC], const CUtensorMap* ma,
                                             const CUtensorMap* mb, int m0, int n0, int K) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full[s], then empty[s]
    const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
    const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
    const int nk = (K + BK - 1) / BK;
    const int wgi = threadIdx.x >> 7;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, THREADS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    auto load = [&](int kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        const uint32_t a = ring + s * STAGE_BYTES, b = a + OPERAND_BYTES, bar = full + 8 * s;
        mbar_expect(bar, STAGE_BYTES);
        if (AK) {
            tma_load(a, ma, k0, m0, bar);
        } else {
            tma_load(a, ma, m0, k0, bar);
            tma_load(a + OPERAND_BYTES / 2, ma, m0 + 64, k0, bar);
        }
        if (BKM) {
            tma_load(b, mb, k0, n0, bar);
        } else {
            tma_load(b, mb, n0, k0, bar);
            tma_load(b + OPERAND_BYTES / 2, mb, n0 + 64, k0, bar);
        }
    };
    if (threadIdx.x == 0)
        for (int kt = 0; kt < STAGES && kt < nk; ++kt) load(kt);

#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    // this warpgroup's 64 rows of A: 64 rows of 128 bytes (K-major) or the
    // half of each k-row block (MN-major), 8 KB in
    constexpr uint32_t A_LEAD = AK ? 16 : OPERAND_BYTES / 2, B_LEAD = BKM ? 16 : OPERAND_BYTES / 2;
    constexpr uint32_t A_STEP = AK ? 32 : 16 * 128, B_STEP = BKM ? 32 : 16 * 128;   // per k16
    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(full + 8 * s, (kt / STAGES) & 1);
        const uint32_t a = ring + s * STAGE_BYTES + wgi * (OPERAND_BYTES / 2);
        const uint32_t b = ring + s * STAGE_BYTES + OPERAND_BYTES;
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
            wgmma_128<AK ? 0 : 1, BKM ? 0 : 1>(acc, desc(a + ks * A_STEP, A_LEAD, 1024),
                                               desc(b + ks * B_STEP, B_LEAD, 1024));
        wgmma_commit();
        wgmma_wait<1>();               // k-tile kt - 1's products are done: release its slot
        if (kt > 0) {
            const uint32_t prev = empty + 8 * ((kt - 1) % STAGES);
            if ((threadIdx.x & 31) == 0) mbar_arrive(prev);
            if (threadIdx.x == 0 && kt - 1 + STAGES < nk) {
                mbar_wait(prev, ((kt - 1) / STAGES) & 1);
                load(kt - 1 + STAGES);
            }
            __syncwarp();
        }
    }
    wgmma_wait<0>();
    return ring;
}

}  // namespace wg
