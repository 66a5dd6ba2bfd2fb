// D2: greedy NMS of the detector's score-sorted candidates, compaction and
// the un-letterbox, in one launch.  Replaces the XLA code of
// easy_vitpose_tpu/detect/yolo.py::nms_fixed (an O(k^2) IoU matrix and greedy
// NMS solved as a Jacobi fixpoint in a lax.while_loop, the TPU's workaround
// for sequential loops; in eager PyTorch its exit test would make the host
// wait every round) and the un-letterbox and packing of detect_frame_core.
//
// One block of 1024 threads per frame (the grid takes a stack of S frames'
// candidates, replacing JAX's vmap of nms_fixed in detect_batch_core; each
// block counts its own frame's valid prefix), the form of the reference's
// bitmask NMS (nms_kernel.cu): the IoU of every pair among the n valid candidates
// (score > 0, a prefix of the score order) goes into a bitmask in shared
// memory, row i holding the later candidates j > i that i suppresses (k x
// ceil(k/32) words: 12 KB at k = 300); then one warp sweeps the rows in
// score order, 32 at a time in registers, keeping the removed mask in
// registers, and the block writes the kept rows first and the rest
// after, each in score order (JAX's argsort(~keep, stable=True)), zero
// padding to max_det, every row un-letterboxed ((b - [left, top, left,
// top]) / r).  The sweep's result is JAX's: its fixpoint converges to
// exact greedy.  The IoU is JAX's float32 arithmetic op for op (the class
// offset cls * 7680 added to the coordinates, areas, intersection, inter /
// max(a_i + a_j - inter, 1e-9) > iou_t), every rounding explicit.
//
// Bound on the H100 by neither bytes (~15 KB) nor operations (~14 per
// pair): one SM does all of it.  On an NVIDIA H100 80GB HBM3 at 700 W, at
// k = 300 with 193 valid (scripts/bench_kernel_variants.py --nms): the
// first version (256 threads, one shared-memory step of the sweep per
// candidate) took 0.074 ms; 1024 threads and the word-at-a-time sweep take
// 0.032, the same bits: the bitmask alone 0.025 (the IoU's IEEE division
// 0.008 of it), the sweep alone 0.015.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_WORDS = 64;   // removed-mask words a warp holds: k <= 2048
// dynamic shared memory: 227 KB less room for the kernel's own counters
constexpr size_t MAX_SMEM = 232448 - 64;

size_t smem_bytes(int k) {
    return static_cast<size_t>(k) * (16 + 4 + 4 + 1) +
           4 * static_cast<size_t>(k) * ((k + 31) / 32);
}

__device__ __forceinline__ float iou(float4 a, float area_a, float4 b, float area_b) {
    const float xx1 = fmaxf(a.x, b.x), yy1 = fmaxf(a.y, b.y);
    const float xx2 = fminf(a.z, b.z), yy2 = fminf(a.w, b.w);
    const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.f),
                                  fmaxf(__fsub_rn(yy2, yy1), 0.f));
    const float den = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
    return __fdiv_rn(inter, den);
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ all_boxes, const float* __restrict__ all_scores,
           const int* __restrict__ all_cls, float* __restrict__ all_out, int k, int max_det,
           float iou_t, int class_aware, float left, float top, float r) {
    extern __shared__ __align__(16) unsigned char smem[];
    const size_t f = blockIdx.x;        // this block's frame
    const float* __restrict__ boxes = all_boxes + f * k * 4;
    const float* __restrict__ scores = all_scores + f * k;
    const int* __restrict__ cls = all_cls + f * k;
    float* __restrict__ out = all_out + f * max_det * 7;
    const int words = (k + 31) / 32;
    float4* nb = reinterpret_cast<float4*>(smem);                  // offset boxes
    float* area = reinterpret_cast<float*>(nb + k);
    unsigned* mask = reinterpret_cast<unsigned*>(area + k);        // k x words
    int* before = reinterpret_cast<int*>(mask + static_cast<size_t>(k) * words);
    unsigned char* keep = reinterpret_cast<unsigned char*>(before + k);
    __shared__ int n_valid, n_kept;

    if (threadIdx.x == 0) n_valid = 0;
    __syncthreads();
    int valid = 0;
    for (int i = threadIdx.x; i < k; i += THREADS) {
        float4 b = make_float4(boxes[4 * i], boxes[4 * i + 1], boxes[4 * i + 2], boxes[4 * i + 3]);
        if (class_aware) {
            const float off = __fmul_rn(static_cast<float>(cls[i]), 7680.f);
            b = make_float4(__fadd_rn(b.x, off), __fadd_rn(b.y, off), __fadd_rn(b.z, off),
                            __fadd_rn(b.w, off));
        }
        nb[i] = b;
        area[i] = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
        valid += scores[i] > 0.f;
        keep[i] = 0;
        before[i] = 0;
    }
    if (valid) atomicAdd(&n_valid, valid);
    __syncthreads();
    const int n = n_valid;

    // the bitmask: row i, word w holds bit b for j = 32 w + b, i < j < n
    for (int t = threadIdx.x; t < n * words; t += THREADS) {
        const int i = t / words, w = t - i * words;
        const int j0 = 32 * w;
        unsigned bits = 0u;
        if (j0 + 31 > i && j0 < n) {
            const float4 bi = nb[i];
            const float ai = area[i];
            const int jend = min(j0 + 32, n);
            for (int j = max(j0, i + 1); j < jend; ++j)
                if (iou(bi, ai, nb[j], area[j]) > iou_t) bits |= 1u << (j - j0);
        }
        mask[static_cast<size_t>(i) * words + w] = bits;
    }
    __syncthreads();

    // the greedy sweep, one warp, a word of 32 candidates at a time: lane l
    // holds removed words l and l + 32; the word's 32 dependent steps run in
    // registers on the rows' words shuffled from the lanes that loaded them
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        unsigned rem[MAX_WORDS / 32] = {0u, 0u};
        int kept = 0;
        for (int w = 0; w * 32 < n; ++w) {
            unsigned cur = __shfl_sync(0xffffffffu, (w >> 5) ? rem[1] : rem[0], w & 31);
            const int i0 = 32 * w, cnt = min(32, n - i0);
            // lane b holds word w of row i0 + b; the 32 steps run in registers
            const unsigned rw = lane < cnt ? mask[static_cast<size_t>(i0 + lane) * words + w] : 0u;
            unsigned kb = 0u;
#pragma unroll
            for (int b = 0; b < 32; ++b) {
                const unsigned rb = __shfl_sync(0xffffffffu, rw, b);
                if (b < cnt && !((cur >> b) & 1u)) {
                    kb |= 1u << b;
                    cur |= rb;
                }
            }
            if (lane < cnt) {
                keep[i0 + lane] = (kb >> lane) & 1u;
                before[i0 + lane] = kept + __popc(kb & ((1u << lane) - 1u));
            }
            kept += __popc(kb);
            for (unsigned m = kb; m; m &= m - 1) {         // the kept rows' later words
                const unsigned* row = mask + static_cast<size_t>(i0 + __ffs(m) - 1) * words;
#pragma unroll
                for (int s = 0; s < MAX_WORDS / 32; ++s) {
                    const int ww = lane + 32 * s;
                    if (ww > w && ww < words) rem[s] |= row[ww];
                }
            }
        }
        if (lane == 0) n_kept = kept;
    }
    __syncthreads();

    // kept rows first, then the rest, each in score order; padding after k
    const int nk = n_kept;
    for (int i = threadIdx.x; i < max_det; i += THREADS) {
        float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
        float s = 0.f, c = 0.f, v = 0.f;
        int pos = i;
        if (i < k) {
            b = make_float4(boxes[4 * i], boxes[4 * i + 1], boxes[4 * i + 2], boxes[4 * i + 3]);
            c = static_cast<float>(cls[i]);
            if (i < n) {
                if (keep[i]) {
                    pos = before[i];
                    s = scores[i];
                    v = 1.f;
                } else {
                    pos = nk + i - before[i];
                }
            }
        }
        float* o = out + static_cast<size_t>(pos) * 7;
        o[0] = __fdiv_rn(__fsub_rn(b.x, left), r);
        o[1] = __fdiv_rn(__fsub_rn(b.y, top), r);
        o[2] = __fdiv_rn(__fsub_rn(b.z, left), r);
        o[3] = __fdiv_rn(__fsub_rn(b.w, top), r);
        o[4] = s;
        o[5] = c;
        o[6] = v;
    }
}

}  // namespace

// boxes (S, k, 4), scores (S, k) float32 and cls (S, k) int32: each frame's
// score-sorted candidates; out: (S, max_det, 7) float32 packed rows;
// k <= max_det.  The kernel's shared-memory limit is raised once, at the
// first call (made before any CUDA graph capture), to the most any k takes.
EVT_EXPORT int evt_nms(const void* boxes, const void* scores, const void* cls, void* out, int S,
                       int k, int max_det, float iou_t, int class_aware, float left, float top,
                       float r, void* stream) {
    const size_t smem = smem_bytes(k);
    if (S <= 0 || k <= 0 || k > max_det || k > 32 * MAX_WORDS || smem > MAX_SMEM)
        return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(MAX_SMEM));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    nms_kernel<<<S, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const int*>(cls), static_cast<float*>(out), k, max_det, iou_t, class_aware,
        left, top, r);
    return static_cast<int>(cudaGetLastError());
}
