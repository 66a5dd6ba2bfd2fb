// The fused UDP decode of the pose step: (M, K, H, W) heatmaps, the packed
// (M, 8) crop geometry and the (M,) slot mask -> (M, K, 3) keypoints
// (y, x, score) in frame coordinates, masked slots zero.
// Replaces the decode around easy_vitpose_tpu/ops/pallas_kernels.py::
// _modulate_kernel_body (K4): ops/decode.py::keypoints_from_heatmaps_udp
// and the un-crop of pipeline/pose_step.py, about 80 launches and a
// full-map K4 in the eager composition.
//
// One block per map, which reads the map once:
// 1. the argmax and maximum of the raw map, as torch.argmax breaks ties (the
//    lowest flat index; NaN above every number); the coordinate is -1 where
//    the maximum is <= 0;
// 2. the log-modulated map at the seven points of the edge-padded,
//    batch-flattened maps that the Newton step reads (flat offsets 0, 1,
//    W+2, W+3, -(W+3), -1, -(W+2), wrapped modulo the batch as the flat
//    take of ops/decode.py::post_dark_udp does; a -1 coordinate reads the
//    previous map, map 0 the last one).  Each point is the full-map pass of
//    modulate.cu at one position: for each vertical tap the horizontal sum
//    of its reflect-101 row, then the vertical sum, both in tap order with
//    round-to-nearest intrinsics, then clip and log: the same bits;
// 3. the DARK/UDP Newton step, each operation rounded as the eager ops round
//    it (no FMA contraction, IEEE division for 1/det), and no step where the
//    Hessian is singular;
// 4. transform_preds with UDP (center (wp//2, hp//2), scale (wp, hp)), the
//    un-crop offsets (x1 - left, y1 - top) and the mask.
//
// What bounds it on the H100 is bytes: the maps are read once (13.4 MB at
// ViT-B/64 in float32, 4.0 us at 3.35 TB/s); the seven points cost about
// 1,700 flops a map, out of L1/L2.  A masked slot's maps are not read.
#include "common.cuh"
#include "blur.cuh"

#include <cfloat>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int THREADS = 128;
constexpr int POINTS = 7;

// one 16-byte load as 4 float32 or 8 bf16 values (a bf16 is the top half of
// its float32)
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

// torch.argmax's order: NaN above every number, then the larger value, then
// the lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    if (isnan(v)) return !isnan(bv) || i < bi;
    if (isnan(bv)) return false;
    return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take_if_better(float v, int i, float& bv, int& bi) {
    if (better(v, i, bv, bi)) { bv = v; bi = i; }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ heat, const int* __restrict__ geo,
              const bool* __restrict__ mask, evt_taps taps, float* __restrict__ out,
              float* __restrict__ points, int n_maps, int K, int H, int W, int r) {
    const int map = blockIdx.x, slot = map / K, t = threadIdx.x;
    float* o = out + (size_t)map * 3;
    if (!mask[slot]) {
        if (t < 3) o[t] = 0.f;
        return;
    }
    const int n = H * W;
    // the taps to shared memory, each by a constant index (a dynamic index
    // into the by-value parameter would copy it to local memory)
    __shared__ float s_taps[EVT_MAX_TAPS];
    if (t == 0) {
#pragma unroll
        for (int k = 0; k < EVT_MAX_TAPS; ++k) s_taps[k] = taps.v[k];
    }

    // 1. argmax and maximum: each thread walks its chunks in index order
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    const T* m = heat + (size_t)map * n;
    if constexpr (VEC > 1) {
        const uint4* src = reinterpret_cast<const uint4*>(m);
        for (int c = t; c < n / VEC; c += THREADS) {
            float v[VEC];
            unpack(src[c], v);
#pragma unroll
            for (int j = 0; j < VEC; ++j) take_if_better(v[j], c * VEC + j, bv, bi);
        }
    } else {
        for (int i = t; i < n; i += THREADS) take_if_better(to_f(m[i]), i, bv, bi);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        take_if_better(__shfl_xor_sync(0xffffffffu, bv, s), __shfl_xor_sync(0xffffffffu, bi, s),
                       bv, bi);
    __shared__ float s_bv[THREADS / 32];
    __shared__ int s_bi[THREADS / 32];
    __shared__ float s_h[POINTS][EVT_MAX_TAPS];
    __shared__ float s_mod[POINTS];
    if ((t & 31) == 0) { s_bv[t >> 5] = bv; s_bi[t >> 5] = bi; }
    __syncthreads();
    bv = s_bv[0];
    bi = s_bi[0];
    for (int w = 1; w < THREADS / 32; ++w) take_if_better(s_bv[w], s_bi[w], bv, bi);
    const bool peak = bv > 0.f;
    const int px = peak ? bi % W : -1, py = peak ? bi / W : -1;

    // 2. the modulated map at the seven points: one thread per (point,
    // vertical tap) sums that tap's row, then one thread per point the taps
    const int taps_n = 2 * r + 1, Wp = W + 2;
    const long long per_map = (long long)(H + 2) * Wp, total = per_map * n_maps;
    const long long base = (px + 1) + (long long)(py + 1) * Wp + per_map * map;
    for (int job = t; job < POINTS * taps_n; job += THREADS) {
        const int p = job / taps_n, kv = job - p * taps_n;
        const int off = p == 0 ? 0 : p == 1 ? 1 : p == 2 ? Wp : p == 3 ? Wp + 1
                      : p == 4 ? -(Wp + 1) : p == 5 ? -1 : -Wp;
        long long f = (base + off) % total;
        if (f < 0) f += total;
        const long long pm = f / per_map;
        const int rem = static_cast<int>(f - pm * per_map);
        const int yp = rem / Wp, xp = rem - yp * Wp;
        const int y = min(max(yp - 1, 0), H - 1), x = min(max(xp - 1, 0), W - 1);
        const T* row = heat + (size_t)pm * n + (size_t)reflect101(y + kv - r, H) * W;
        float acc = 0.f;
        for (int k = 0; k < taps_n; ++k)
            acc = __fadd_rn(acc, __fmul_rn(to_f(row[reflect101(x + k - r, W)]), s_taps[k]));
        s_h[p][kv] = acc;
    }
    __syncthreads();
    if (t < POINTS) {
        float acc = 0.f;
        for (int k = 0; k < taps_n; ++k) acc = __fadd_rn(acc, __fmul_rn(s_h[t][k], s_taps[k]));
        s_mod[t] = clip_log(acc);
        if (points) points[(size_t)map * POINTS + t] = s_mod[t];
    }
    __syncthreads();
    if (t != 0) return;

    // 3. the Newton step, rounded op by op as ops/decode.py::post_dark_udp
    const float i0 = s_mod[0], ix1 = s_mod[1], iy1 = s_mod[2], ix1y1 = s_mod[3],
                ix1_y1_ = s_mod[4], ix1_ = s_mod[5], iy1_ = s_mod[6];
    const float two_i0 = __fmul_rn(2.f, i0);
    const float dx = __fmul_rn(0.5f, __fsub_rn(ix1, ix1_));
    const float dy = __fmul_rn(0.5f, __fsub_rn(iy1, iy1_));
    const float dxx = __fadd_rn(__fsub_rn(ix1, two_i0), ix1_);
    const float dyy = __fadd_rn(__fsub_rn(iy1, two_i0), iy1_);
    float s = __fsub_rn(__fsub_rn(ix1y1, ix1), iy1);
    s = __fsub_rn(__fsub_rn(__fadd_rn(s, two_i0), ix1_), iy1_);
    const float dxy = __fmul_rn(0.5f, __fadd_rn(s, ix1_y1_));
    const float a = __fadd_rn(dxx, FLT_EPSILON), d = __fadd_rn(dyy, FLT_EPSILON);
    const float inv_det = __fdiv_rn(1.f, __fsub_rn(__fmul_rn(a, d), __fmul_rn(dxy, dxy)));
    const float off_x = __fmul_rn(__fsub_rn(__fmul_rn(d, dx), __fmul_rn(dxy, dy)), inv_det);
    const float off_y = __fmul_rn(__fsub_rn(__fmul_rn(a, dy), __fmul_rn(dxy, dx)), inv_det);
    // a singular Hessian takes no step (ops/decode.py::post_dark_udp)
    const bool step = isfinite(off_x) && isfinite(off_y);
    const float cx = step ? __fsub_rn(static_cast<float>(px), off_x) : static_cast<float>(px);
    const float cy = step ? __fsub_rn(static_cast<float>(py), off_y) : static_cast<float>(py);

    // 4. UDP transform to the padded crop, then the un-crop to the frame;
    // geo rows are [x1, y1, wc, hc, wp, hp, left, top]
    const int* g = geo + slot * 8;
    const float sx = static_cast<float>(g[4]), sy = static_cast<float>(g[5]);
    const float fx = __fadd_rn(__fmul_rn(cx, __fdiv_rn(sx, static_cast<float>(W - 1))),
                               __fsub_rn(static_cast<float>(g[4] / 2), __fmul_rn(sx, 0.5f)));
    const float fy = __fadd_rn(__fmul_rn(cy, __fdiv_rn(sy, static_cast<float>(H - 1))),
                               __fsub_rn(static_cast<float>(g[5] / 2), __fmul_rn(sy, 0.5f)));
    o[0] = __fadd_rn(fy, static_cast<float>(g[1] - g[7]));
    o[1] = __fadd_rn(fx, static_cast<float>(g[0] - g[6]));
    o[2] = bv;
}

template <typename T>
int launch(const void* heat, const int* geo, const bool* mask, evt_taps taps, float* out,
           float* points, int n_maps, int K, int H, int W, int r, cudaStream_t st) {
    const T* h = static_cast<const T*>(heat);
    constexpr int VEC = 16 / sizeof(T);
    // 16-byte loads when every map starts on 16 bytes
    if ((H * W) % VEC == 0 && reinterpret_cast<uintptr_t>(heat) % 16 == 0)
        decode_kernel<T, VEC><<<n_maps, THREADS, 0, st>>>(h, geo, mask, taps, out, points,
                                                          n_maps, K, H, W, r);
    else
        decode_kernel<T, 1><<<n_maps, THREADS, 0, st>>>(h, geo, mask, taps, out, points,
                                                        n_maps, K, H, W, r);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points: null, or (M, K, 7) float32 that takes each unmasked map's seven
// modulated points, for checking them against the full-map kernel
EVT_EXPORT int evt_decode_keypoints(const void* heat, int heat_bf16, const void* geo,
                                    const void* mask, evt_taps taps, void* out, void* points,
                                    int M, int K, int H, int W, int r, void* stream) {
    const int* g = static_cast<const int*>(geo);
    const bool* mk = static_cast<const bool*>(mask);
    float* o = static_cast<float*>(out);
    float* p = static_cast<float*>(points);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return heat_bf16 ? launch<bf16>(heat, g, mk, taps, o, p, M * K, K, H, W, r, st)
                     : launch<float>(heat, g, mk, taps, o, p, M * K, K, H, W, r, st);
}
