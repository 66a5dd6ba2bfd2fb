// K2, the int8 (W8A8) block's own kernels, driven by models/quant.py:
// the per-row quantisation and the int8 GEMM with its float32 dequant
// epilogue.  LayerNorm and attention come from block.cu.
// Replaces easy_vitpose_tpu/models/quant.py::_block_q8_kernel.
#include "common.cuh"
#include "gemm_mma.cuh"

// One warp per row: s = amax / 127 (1 for an all-zero row),
// q = clip(rint(h / s), -127, 127) with IEEE division and round-half-even,
// as quant.py::quant_rows.  Built without fast math, so "/" is exact.
template <typename T>
__global__ void __launch_bounds__(256)
rowquant_kernel(const T* __restrict__ h, int8_t* __restrict__ q, float* __restrict__ s,
                int R, int C) {
    const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (row >= R) return;
    const T* hr = h + (size_t)row * C;
    float amax = 0.f;
    for (int i = lane; i < C; i += 32) amax = fmaxf(amax, fabsf(to_f(hr[i])));
    amax = warp_max(amax);
    const float sc = amax > 0.f ? amax / 127.0f : 1.0f;
    if (lane == 0) s[row] = sc;
    int8_t* qr = q + (size_t)row * C;
    for (int i = lane; i < C; i += 32)
        qr[i] = static_cast<int8_t>(fminf(fmaxf(rintf(to_f(hr[i]) / sc), -127.f), 127.f));
}

EVT_EXPORT int evt_rowquant(const void* h, void* q, void* s, int R, int C, int h_bf16,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = (R + 7) / 8;
    if (h_bf16)
        rowquant_kernel<bf16><<<grid, 256, 0, st>>>(static_cast<const bf16*>(h),
                                                    static_cast<int8_t*>(q),
                                                    static_cast<float*>(s), R, C);
    else
        rowquant_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(h),
                                                     static_cast<int8_t*>(q),
                                                     static_cast<float*>(s), R, C);
    return static_cast<int>(cudaGetLastError());
}

// out = epilogue(acc * sx[row] * sw[col] + bias[col]) with int32 acc of
// q (M, K) int8 against wq (N, K) int8.  N % 64 == 0, K % 128 == 0.
EVT_EXPORT int evt_gemm_q8(const void* q, const void* wq, const void* sx, const void* sw,
                           const void* bias, const void* res, void* out, int M, int N, int K,
                           int epi, int out_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* fsx = static_cast<const float*>(sx);
    const float* fsw = static_cast<const float*>(sw);
    if (out_bf16)
        mma_gemm::launch<true, float, bf16>(q, wq, fsx, fsw, bias, res, out, M, N, K, epi, st);
    else
        mma_gemm::launch<true, float, float>(q, wq, fsx, fsw, bias, res, out, M, N, K, epi, st);
    return static_cast<int>(cudaGetLastError());
}
