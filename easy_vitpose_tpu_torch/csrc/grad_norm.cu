// The global gradient norm and the clip scale of a step, over the optimizer's
// table of leaves (leaf_table.cuh), in one launch: the sum of squares of
// every gradient element, gnorm = sqrt(sum), s = min(1, max_norm / (gnorm +
// 1e-16)).  Takes the place of the per-leaf torch sums of
// train/fused_opt.py::global_norm (its plain version) on the card; in JAX
// the norm is XLA's (optax.clip_by_global_norm), not a Pallas kernel.
//
// Bound by bytes: 4 bytes per element.  A fixed grid of at most 1024 blocks
// walks the work units (the grid does not depend on the card, so neither
// does the sum's order); each thread sums the squares of its elements in a
// float32 FMA chain, each block reduces its threads in a fixed tree and
// writes one partial.  The last block to finish (a ticket counter in the
// table, taken after a threadfence) sums the partials in a fixed order and
// writes (s, gnorm).  No atomics touch the float sums, so the result is the
// same on every run.  It sums in another order than the plain version:
// equal where every partial sum is exact, within float32 rounding otherwise.
#include "leaf_table.cuh"

namespace {
using namespace leaf_table;

constexpr int MAX_BLOCKS = 1024;

__device__ __forceinline__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = red[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) s = __fadd_rn(s, red[w]);
    return s;
}

__global__ void __launch_bounds__(THREADS)
grad_norm_kernel(Table tb, float* __restrict__ partial, float* __restrict__ out, float max_norm) {
    __shared__ float red[2][THREADS / 32];
    __shared__ bool last;
    float acc = 0.f;
    for (long long u = blockIdx.x; u < tb.units; u += gridDim.x) {
        const Unit w = locate(tb, u);
        const float* g = col<const float>(w.row, 1);
        const bool vec = aligned(g, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const long long e = w.base + j * HALF + 4 * threadIdx.x;
            if (vec && e + 4 <= w.n) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(g + e));
                acc = __fmaf_rn(v.x, v.x, acc);
                acc = __fmaf_rn(v.y, v.y, acc);
                acc = __fmaf_rn(v.z, v.z, acc);
                acc = __fmaf_rn(v.w, v.w, acc);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (e + k < w.n) acc = __fmaf_rn(g[e + k], g[e + k], acc);
            }
        }
    }
    const float sum = block_sum(acc, red[0]);
    if (threadIdx.x == 0) {
        partial[blockIdx.x] = sum;
        __threadfence();
        const unsigned long long ticket =
            atomicAdd(reinterpret_cast<unsigned long long*>(tb.t), 1ull);
        last = ticket == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    float tot = 0.f;
    for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += THREADS)
        tot = __fadd_rn(tot, __ldcg(partial + i));
    tot = block_sum(tot, red[1]);
    if (threadIdx.x == 0) {
        const float gnorm = __fsqrt_rn(tot);
        const float r = __fdiv_rn(max_norm, __fadd_rn(gnorm, 1e-16f));
        out[0] = isnan(r) ? r : fminf(1.f, r);       // torch.minimum keeps a NaN
        out[1] = gnorm;
    }
}
}  // namespace

// table: the leaf table on the card (leaf_table.cuh), rows of `width`
// columns with the gradient in column 1; partial: MAX_BLOCKS float32 of
// scratch; out: 2 float32, (clip scale, global norm).
EVT_EXPORT int evt_grad_norm(void* table, int leaves, int width, long long units, void* partial,
                             void* out, float max_norm, void* stream) {
    if (leaves < 0 || width < 2) return static_cast<int>(cudaErrorInvalidValue);
    const Table tb{static_cast<long long*>(table), leaves, width, units};
    const int grid = static_cast<int>(units < MAX_BLOCKS ? (units > 0 ? units : 1) : MAX_BLOCKS);
    grad_norm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<float*>(partial), static_cast<float*>(out), max_norm);
    return static_cast<int>(cudaGetLastError());
}
