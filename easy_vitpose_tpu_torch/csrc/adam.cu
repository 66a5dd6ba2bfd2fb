// K8: clip-scaled Adam on one float32 leaf in one pass: read g, mu, nu, p,
// write mu', nu', p'.
// Replaces easy_vitpose_tpu/train/fused_opt.py::_adam_leaf_pallas (body kern).
//
// Bound by bytes: 28 bytes per element, no reuse.  A grid-stride loop over
// the flat leaf, any length.  The step's scalars (clip scale s, lr, 1-b1^t,
// 1-b2^t) are read from a small device buffer, so the step never waits on
// the host.  Every operation is a round-to-nearest intrinsic in the order of
// the plain version (train/fused_opt.py::adam_leaf_plain), with IEEE
// division and square root, so the two agree bit for bit:
//   gs = g*s;  mu' = b1*mu + (1-b1)*gs;  nu' = b2*nu + ((1-b2)*gs)*gs;
//   p' = p - (lr * (mu'/c1)) / (sqrt(nu'/c2) + eps)
#include "common.cuh"

__global__ void __launch_bounds__(256)
adam_kernel(const float* __restrict__ g, const float* __restrict__ mu,
            const float* __restrict__ nu, const float* __restrict__ p,
            const float* __restrict__ scal, float* __restrict__ mu_o, float* __restrict__ nu_o,
            float* __restrict__ p_o, long long n, float b1, float omb1, float b2, float omb2,
            float eps) {
    const float s = scal[0], lr = scal[1], c1 = scal[2], c2 = scal[3];
    for (long long i = blockIdx.x * 256ll + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
        const float gs = __fmul_rn(g[i], s);
        const float m = __fadd_rn(__fmul_rn(b1, mu[i]), __fmul_rn(omb1, gs));
        const float v = __fadd_rn(__fmul_rn(b2, nu[i]), __fmul_rn(__fmul_rn(omb2, gs), gs));
        const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps);
        mu_o[i] = m;
        nu_o[i] = v;
        p_o[i] = __fsub_rn(p[i], __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, c1)), den));
    }
}

EVT_EXPORT int evt_adam(const void* g, const void* mu, const void* nu, const void* p,
                        const void* scal, void* mu_o, void* nu_o, void* p_o, long long n, float b1,
                        float omb1, float b2, float omb2, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long blocks = (n + 255) / 256;
    const int grid = static_cast<int>(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
    adam_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(mu), static_cast<const float*>(nu),
        static_cast<const float*>(p), static_cast<const float*>(scal), static_cast<float*>(mu_o),
        static_cast<float*>(nu_o), static_cast<float*>(p_o), n, b1, omb1, b2, omb2, eps);
    return static_cast<int>(cudaGetLastError());
}
