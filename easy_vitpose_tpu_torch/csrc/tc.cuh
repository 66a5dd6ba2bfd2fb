// Tensor-core building blocks of the redesigned kernels (sm_90a, the
// mma.sync generation): 16-byte cp.async copies into shared memory, ldmatrix
// fragment loads and the bf16 m16n8k16 product with float32 accumulation.
//
// Fragment layouts (g = lane / 4, t = lane % 4), as PTX defines them:
//   A (16x16, row-major):  a0 (row g, cols 2t, 2t+1), a1 (row g+8, same),
//                          a2 (row g, cols 8+2t, 9+2t), a3 (row g+8, same)
//   B (16x8, "col"):        b0 (k 2t, 2t+1, col g), b1 (k 8+2t, 9+2t, col g)
//   C (16x8, float32):     c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8)
// so the C fragments of two neighbouring n8 tiles, packed to bf16 pairs, are
// the A fragment of a product over those 16 columns.
#pragma once

#include "common.cuh"

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes 16 zeros
// (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// round(x * scale) to bf16 for both halves of a packed pair
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float scale) {
    __nv_bfloat162 p = *reinterpret_cast<__nv_bfloat162*>(&v);
    return pack_bf16(__bfloat162float(p.x) * scale, __bfloat162float(p.y) * scale);
}

}  // namespace tc
