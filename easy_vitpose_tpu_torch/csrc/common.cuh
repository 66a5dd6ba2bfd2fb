// Shared helpers of the port's kernels: dtype conversion, warp reductions,
// the A&S-erf GELU and the GEMM epilogue.  Each .cu file is its own shared
// library with a plain C interface; every entry point returns the
// cudaError_t of its launch, and evt_error_string names it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define EVT_EXPORT extern "C" __attribute__((visibility("default")))

typedef __nv_bfloat16 bf16;

EVT_EXPORT const char* evt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// round a float32 value to T and back: the "astype(dt)" of the JAX kernels
template <typename T> __device__ __forceinline__ float round_to(float v) {
    return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Abramowitz-Stegun 7.1.26 erf (max abs error 1.5e-7), as the TPU kernels
// (models/fused_block.py::_erf) and the plain versions (models/vit.py::erf_as).
__device__ __forceinline__ float erf_as(float x) {
    const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
                a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
    const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
    const float ax = fabsf(x);
    const float t = 1.0f / (1.0f + p * ax);
    const float poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))));
    return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float gelu_as(float x) {
    return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

enum { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// Finish one GEMM output: GELU, or the residual add of the value rounded to
// the output type (the JAX kernels' "x + a.astype(dt)"), then the cast.
template <typename TO>
__device__ __forceinline__ void epilogue_store(float v, int epi, const TO* res, TO* out,
                                               size_t idx) {
    if (epi == EPI_GELU) v = gelu_as(v);
    if (epi == EPI_RESIDUAL) v = to_f(res[idx]) + round_to<TO>(v);
    out[idx] = from_f<TO>(v);
}
