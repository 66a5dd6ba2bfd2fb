// K3: bilinear crop + zero pad + resize of M boxes from a uint8 (H, W, 3)
// frame, with the ImageNet normalize fused, written as the backbone's
// (M, OH, OW, 3) input in float32 or bf16.
// Replaces easy_vitpose_tpu/ops/pallas_sampler.py::_sampler_kernel.
//
// One thread per output pixel (all three channels).  The tap arithmetic is
// that of ops/preprocess.py::sample_crops, step by step with round-to-
// nearest intrinsics so the compiler fuses nothing into an FMA: the
// half-pixel map clamped to the padded crop, taps outside the crop are
// zero, frame indices clamped to the frame.
#include "common.cuh"

struct AxisTaps {
    int g0, g1;        // frame index of tap 0 and 1 (clamped)
    bool in0, in1;     // tap inside the crop (else it reads zero)
    float w0, w1;      // 1 - f and f
};

// geometry of one axis: padded size, pad offset, crop size, crop origin
__device__ __forceinline__ AxisTaps axis_taps(int o, int n_out, int size_p, int lo, int size,
                                              int origin, int n_frame) {
    const float sp = static_cast<float>(size_p);
    float s = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(o), 0.5f),
                                  __fdiv_rn(sp, static_cast<float>(n_out))), 0.5f);
    s = fminf(fmaxf(s, 0.f), __fsub_rn(sp, 1.f));
    const int i0 = static_cast<int>(floorf(s));
    const float f = __fsub_rn(s, static_cast<float>(i0));
    const int i1 = min(i0 + 1, size_p - 1);
    AxisTaps t;
    t.in0 = i0 >= lo && i0 < lo + size;
    t.in1 = i1 >= lo && i1 < lo + size;
    t.g0 = min(max(i0 - lo + origin, 0), n_frame - 1);
    t.g1 = min(max(i1 - lo + origin, 0), n_frame - 1);
    t.w0 = __fsub_rn(1.f, f);
    t.w1 = f;
    return t;
}

// grid (ceil(OH*OW / 256), M); geo rows are [x1, y1, wc, hc, wp, hp, left, top]
template <typename TO>
__global__ void __launch_bounds__(256)
sample_kernel(const uint8_t* __restrict__ frame, const int* __restrict__ geo,
              TO* __restrict__ out, int H, int W, int OH, int OW, float3 mean, float3 stdv) {
    const int m = blockIdx.y;
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= OH * OW) return;
    const int oy = p / OW, ox = p - oy * OW;
    const int* g = geo + m * 8;
    const AxisTaps tx = axis_taps(ox, OW, g[4], g[6], g[2], g[0], W);
    const AxisTaps ty = axis_taps(oy, OH, g[5], g[7], g[3], g[1], H);
    const uint8_t* r0 = frame + (size_t)ty.g0 * W * 3;
    const uint8_t* r1 = frame + (size_t)ty.g1 * W * 3;
    const float mv[3] = {mean.x, mean.y, mean.z}, sv[3] = {stdv.x, stdv.y, stdv.z};
    TO* o = out + ((size_t)m * OH * OW + p) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        // x lerp on each of the two rows, each tap masked to the crop
        const float a00 = tx.in0 ? static_cast<float>(r0[tx.g0 * 3 + c]) : 0.f;
        const float a01 = tx.in1 ? static_cast<float>(r0[tx.g1 * 3 + c]) : 0.f;
        const float a10 = tx.in0 ? static_cast<float>(r1[tx.g0 * 3 + c]) : 0.f;
        const float a11 = tx.in1 ? static_cast<float>(r1[tx.g1 * 3 + c]) : 0.f;
        const float x0 = ty.in0 ? __fadd_rn(__fmul_rn(a00, tx.w0), __fmul_rn(a01, tx.w1)) : 0.f;
        const float x1 = ty.in1 ? __fadd_rn(__fmul_rn(a10, tx.w0), __fmul_rn(a11, tx.w1)) : 0.f;
        const float v = __fadd_rn(__fmul_rn(x0, ty.w0), __fmul_rn(x1, ty.w1));
        o[c] = from_f<TO>(__fdiv_rn(__fsub_rn(v, mv[c]), sv[c]));
    }
}

EVT_EXPORT int evt_sample_crops(const void* frame, const void* geo, void* out, int M, int H,
                                int W, int OH, int OW, float m0, float m1, float m2, float s0,
                                float s1, float s2, int out_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    dim3 grid((OH * OW + 255) / 256, M);
    const uint8_t* f = static_cast<const uint8_t*>(frame);
    const int* g = static_cast<const int*>(geo);
    const float3 mean = make_float3(m0, m1, m2), stdv = make_float3(s0, s1, s2);
    if (out_bf16)
        sample_kernel<bf16><<<grid, 256, 0, st>>>(f, g, static_cast<bf16*>(out), H, W, OH, OW,
                                                  mean, stdv);
    else
        sample_kernel<float><<<grid, 256, 0, st>>>(f, g, static_cast<float*>(out), H, W, OH,
                                                   OW, mean, stdv);
    return static_cast<int>(cudaGetLastError());
}
