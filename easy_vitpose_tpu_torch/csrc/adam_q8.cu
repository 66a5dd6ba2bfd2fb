// K9: clip-scaled Adam on one float32 leaf whose moments are stored as
// blockwise geometric 8-bit codes, in one pass: decode mu and sqrt(nu), run
// the update, write p', re-encode both moments.
// Replaces easy_vitpose_tpu/train/fused_opt.py::_adam_leaf_pallas_q8 (body kern).
//
// The codec (train/fused_opt.py::q8_encode / q8_decode): per block of 2048
// elements one float32 absmax scale; a magnitude r = |x| / scale codes to
// level 1 + rint((1 - ln(r) / ln(1e-6)) * (L - 1)), clipped to [1, L], or 0
// when r < 1e-6; mu is signed with L = 127, sqrt(nu) unsigned with L = 255.
//
// Bound by bytes: per element it reads g and p (float32) and two codes and
// writes p' and two codes, 16 bytes, against 28 for float32 moments (K8).
// One thread block per codec block, 256 threads with 8 elements each
// (element tid + 256 j, so each load is coalesced): the block's two absmax
// reductions go through shared memory, and the whole update stays in
// registers between the loads and the stores.  The leaf may have any
// length: g and p read as 0 past its end, and the codes there are the zeros
// the encoder wrote, so the tail neither moves the absmax nor gets a code.
//
// Every operation is a round-to-nearest intrinsic in the order of the plain
// version (train/fused_opt.py::adam_leaf_q8_plain): IEEE division and square
// root, expf, logf and rintf, no contraction into FMAs.  Division by one of
// the codec's constants is a multiply by its float32 reciprocal, as XLA
// folds the JAX codec's "x / c".
#include "common.cuh"

namespace {
constexpr int Q8_BLOCK = 2048, Q8_THREADS = 256, Q8_PER = Q8_BLOCK / Q8_THREADS;

struct Codec {
    float ln_eps;        // float32(ln 1e-6)
    float inv_ln_eps;    // float32 reciprocal of ln_eps
    float inv_l127;      // 1 / 126
    float inv_l255;      // 1 / 254
    float tiny;          // 1e-30, the floor of the absmax
    float zero_below;    // 1e-6: r under it codes to 0
};

// exp(ln_eps * (1 - (mag - 1) / (L - 1))) for a code of magnitude mag >= 1
__device__ __forceinline__ float level_value(float mag, float inv_lm1, const Codec& c) {
    return expf(__fmul_rn(c.ln_eps, __fsub_rn(1.f, __fmul_rn(__fsub_rn(mag, 1.f), inv_lm1))));
}

__device__ __forceinline__ float level_of(float r, float lm1, float levels, const Codec& c) {
    const float t = __fmul_rn(logf(fmaxf(r, c.tiny)), c.inv_ln_eps);
    const float idx = fminf(fmaxf(__fadd_rn(1.f, rintf(__fmul_rn(__fsub_rn(1.f, t), lm1))), 1.f),
                            levels);
    return r < c.zero_below ? 0.f : idx;
}

__device__ __forceinline__ float block_max(float v, float* red) {
    v = warp_max(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float m = red[0];
#pragma unroll
    for (int w = 1; w < Q8_THREADS / 32; ++w) m = fmaxf(m, red[w]);
    return m;
}

__global__ void __launch_bounds__(Q8_THREADS)
adam_q8_kernel(const float* __restrict__ g, const float* __restrict__ p,
               const int8_t* __restrict__ mq, const float* __restrict__ ms,
               const uint8_t* __restrict__ nq, const float* __restrict__ ns,
               const float* __restrict__ scal, float* __restrict__ p_o, int8_t* __restrict__ mq_o,
               float* __restrict__ ms_o, uint8_t* __restrict__ nq_o, float* __restrict__ ns_o,
               long long n, float b1, float omb1, float b2, float omb2, float eps, Codec c) {
    __shared__ float red[2][Q8_THREADS / 32];
    const float s = scal[0], lr = scal[1], c1 = scal[2], c2 = scal[3];
    const long long base = (long long)blockIdx.x * Q8_BLOCK;
    const float mscale = ms[blockIdx.x], nscale = ns[blockIdx.x];
    float mu_n[Q8_PER], vs_n[Q8_PER];
    float am = 0.f, an = 0.f;
#pragma unroll
    for (int j = 0; j < Q8_PER; ++j) {
        const long long i = base + threadIdx.x + j * Q8_THREADS;
        const bool in = i < n;
        const float mqf = static_cast<float>(mq[i]);
        const float mag = fabsf(mqf);
        float mu = 0.f;
        if (mag >= 0.5f) {
            const float e = level_value(mag, c.inv_l127, c);
            mu = __fmul_rn(mqf < 0.f ? -e : e, mscale);
        }
        const float nqf = static_cast<float>(nq[i]);
        const float vs = nqf < 0.5f ? 0.f : __fmul_rn(level_value(nqf, c.inv_l255, c), nscale);
        const float gs = __fmul_rn(in ? g[i] : 0.f, s);
        const float m = __fadd_rn(__fmul_rn(b1, mu), __fmul_rn(omb1, gs));
        const float v = __fadd_rn(__fmul_rn(b2, __fmul_rn(vs, vs)), __fmul_rn(__fmul_rn(omb2, gs), gs));
        if (in) {
            const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps);
            p_o[i] = __fsub_rn(p[i], __fdiv_rn(__fmul_rn(lr, __fdiv_rn(m, c1)), den));
        }
        mu_n[j] = m;
        vs_n[j] = __fsqrt_rn(v);
        am = fmaxf(am, fabsf(m));
        an = fmaxf(an, vs_n[j]);
    }
    am = block_max(am, red[0]);
    an = block_max(an, red[1]);
    if (threadIdx.x == 0) {
        ms_o[blockIdx.x] = am;
        ns_o[blockIdx.x] = an;
    }
    const float am_safe = fmaxf(am, c.tiny), an_safe = fmaxf(an, c.tiny);
#pragma unroll
    for (int j = 0; j < Q8_PER; ++j) {
        const long long i = base + threadIdx.x + j * Q8_THREADS;
        const float idx = level_of(__fdiv_rn(fabsf(mu_n[j]), am_safe), 126.f, 127.f, c);
        const float sgn = mu_n[j] > 0.f ? 1.f : (mu_n[j] < 0.f ? -1.f : 0.f);
        mq_o[i] = static_cast<int8_t>(__fmul_rn(sgn, idx));
        nq_o[i] = static_cast<uint8_t>(level_of(__fdiv_rn(vs_n[j], an_safe), 254.f, 255.f, c));
    }
}
}  // namespace

// g, p: n float32; mq (int8), nq (uint8): nb * 2048 codes; ms, ns: nb
// float32 scales, nb = ceil(n / 2048); scal: (clip scale, lr, 1 - b1^t,
// 1 - b2^t) on the device.  Writes p_o (n), the new codes and scales.
EVT_EXPORT int evt_adam_q8(const void* g, const void* p, const void* mq, const void* ms,
                           const void* nq, const void* ns, const void* scal, void* p_o,
                           void* mq_o, void* ms_o, void* nq_o, void* ns_o, long long n, float b1,
                           float omb1, float b2, float omb2, float eps, float ln_eps,
                           float inv_ln_eps, float inv_l127, float inv_l255, float tiny,
                           float zero_below, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long nb = (n + Q8_BLOCK - 1) / Q8_BLOCK;
    if (nb <= 0 || nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const Codec c{ln_eps, inv_ln_eps, inv_l127, inv_l255, tiny, zero_below};
    adam_q8_kernel<<<static_cast<unsigned>(nb), Q8_THREADS, 0, st>>>(
        static_cast<const float*>(g), static_cast<const float*>(p),
        static_cast<const int8_t*>(mq), static_cast<const float*>(ms),
        static_cast<const uint8_t*>(nq), static_cast<const float*>(ns),
        static_cast<const float*>(scal), static_cast<float*>(p_o), static_cast<int8_t*>(mq_o),
        static_cast<float*>(ms_o), static_cast<uint8_t*>(nq_o), static_cast<float*>(ns_o), n, b1,
        omb1, b2, omb2, eps, c);
    return static_cast<int>(cudaGetLastError());
}
