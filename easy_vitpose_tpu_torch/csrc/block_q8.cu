// K2, the int8 (W8A8) block's own kernels, driven by models/quant.py:
// the per-row quantisation and the int8 GEMM with its float32 dequant
// epilogue (gemm_q8.cuh: wgmma from a TMA ring, persistent blocks of
// 128 x 192 or 128 x 64 tiles), and the routed expert rows of a ViTPose+
// block's fc2 (grouped_gemm_kernel).  LayerNorm and attention come from
// block.cu.  Replaces easy_vitpose_tpu/models/quant.py::_block_q8_kernel.
#include "common.cuh"
#include "gemm_q8.cuh"

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
// q (M, K) int8 against wq (N, K) int8.  N % 64 == 0, K % 128 == 0, q and
// wq 16-byte aligned.  Output rows lie ldo elements apart (0: N); ldo > N
// writes the leading N columns of an (M, ldo) output (a routed ViTPose+
// fc2's shared rows), the residual's rows still N apart.
EVT_EXPORT int evt_gemm_q8(const void* q, const void* wq, const void* sx, const void* sw,
                           const void* bias, const void* res, void* out, int M, int N, int K,
                           int epi, int out_bf16, int ldo, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* fsx = static_cast<const float*>(sx);
    const float* fsw = static_cast<const float*>(sw);
    const float* fb = static_cast<const float*>(bias);
    return static_cast<int>(
        out_bf16 ? wgq8::launch<bf16>(q, wq, fsx, fsw, fb, res, out, M, N, K, epi, st, ldo)
                 : wgq8::launch<float>(q, wq, fsx, fsw, fb, res, out, M, N, K, epi, st, ldo));
}

// The routed expert product (gemm_q8.cuh's grouped_gemm_kernel): the rows
// of group g of `groups` ((first row, rows, expert, 0) int32, on the device)
// against expert g's NE rows of wq (E, NE, K), written with the residual
// into columns col0 .. col0 + NE of out, whose rows (and res's) are ldo apart.
EVT_EXPORT int evt_gemm_q8_grouped(const void* q, const void* wq, const void* groups,
                                   int n_groups, const void* sx, const void* sw,
                                   const void* bias, const void* res, void* out, int M, int NE,
                                   int K, int E, int ldo, int col0, int out_bf16, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int4* g = static_cast<const int4*>(groups);
    const float* fsx = static_cast<const float*>(sx);
    const float* fsw = static_cast<const float*>(sw);
    const float* fb = static_cast<const float*>(bias);
    return static_cast<int>(
        out_bf16 ? wgq8::launch_grouped<bf16>(q, wq, g, n_groups, fsx, fsw, fb, res, out, M, NE,
                                              K, E, ldo, col0, st)
                 : wgq8::launch_grouped<float>(q, wq, g, n_groups, fsx, fsw, fb, res, out, M,
                                               NE, K, E, ldo, col0, st));
}

// The grouped GEMM's launches since the library was loaded, into out[0].
EVT_EXPORT int evt_gemm_q8_grouped_launches(long long* out) {
    out[0] = wgq8::grouped_launch_count().load();
    return 0;
}

// The int8 GEMM's launches since the library was loaded, by tile (128 x
// 192, 128 x 64), into out[0..1].
EVT_EXPORT int evt_gemm_q8_launches(long long* out) {
    for (int t = 0; t < wgq8::TILES; ++t) out[t] = wgq8::launch_counts()[t].load();
    return 0;
}
