// K4: the UDP modulate, log(clip(gaussian_blur(map), 0.001, 50)), for
// (n_maps, H, W) float32 heatmaps.
// Replaces easy_vitpose_tpu/ops/pallas_kernels.py::_modulate_kernel_body.
//
// One block per map: the map is read once into shared memory, the
// horizontal and then the vertical pass run there with reflect-101 borders
// indexed in the kernel (no padded copy), and the clipped log is written
// once.  Taps are summed in order from 0 with round-to-nearest intrinsics,
// as ops/decode.py::gaussian_blur_2d sums them.
#include "common.cuh"

#define EVT_MAX_TAPS 32
struct evt_taps { float v[EVT_MAX_TAPS]; };

// reflect-101: -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect101(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__global__ void __launch_bounds__(256)
modulate_kernel(const float* __restrict__ maps, evt_taps taps, float* __restrict__ out,
                int H, int W, int r) {
    extern __shared__ float sm[];
    float* src = sm;
    float* hz = sm + H * W;
    const int n = H * W;
    const float* m = maps + (size_t)blockIdx.x * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) src[i] = m[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int y = i / W, x = i - y * W;
        float acc = 0.f;
        for (int k = 0; k <= 2 * r; ++k)
            acc = __fadd_rn(acc, __fmul_rn(src[y * W + reflect101(x + k - r, W)], taps.v[k]));
        hz[i] = acc;
    }
    __syncthreads();
    float* o = out + (size_t)blockIdx.x * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int y = i / W, x = i - y * W;
        float acc = 0.f;
        for (int k = 0; k <= 2 * r; ++k)
            acc = __fadd_rn(acc, __fmul_rn(hz[reflect101(y + k - r, H) * W + x], taps.v[k]));
        o[i] = logf(fminf(fmaxf(acc, 0.001f), 50.0f));
    }
}

EVT_EXPORT int evt_udp_modulate(const void* maps, evt_taps taps, void* out, int n_maps, int H,
                                int W, int r, void* stream) {
    const size_t smem = 2 * sizeof(float) * (size_t)H * W;
    cudaError_t err = cudaFuncSetAttribute(modulate_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    modulate_kernel<<<n_maps, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(maps), taps, static_cast<float*>(out), H, W, r);
    return static_cast<int>(cudaGetLastError());
}
