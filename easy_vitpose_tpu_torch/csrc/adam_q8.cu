// K9: clip-scaled Adam with blockwise geometric 8-bit moments over every
// leaf of a step in one launch: decode mu and sqrt(nu), run the update,
// write p', re-encode both moments.
// Replaces easy_vitpose_tpu/train/fused_opt.py::_adam_leaf_pallas_q8 (body kern).
//
// The codec (train/fused_opt.py::q8_encode / q8_decode): per block of 2048
// elements one float32 absmax scale; a magnitude r = |x| / scale codes to
// level 1 + rint((1 - ln(r) / ln(1e-6)) * (L - 1)), clipped to [1, L], or 0
// when r < 1e-6; mu is signed with L = 127, sqrt(nu) unsigned with L = 255.
//
// Per element it reads g and p (float32) and two codes and writes p' and
// two codes: 16 bytes, against 28 for float32 moments (K8).  The leaves come
// as a table (leaf_table.cuh) whose work unit is one codec block, so each
// block's two absmax reductions stay inside one thread block: resident
// blocks of 256 threads walk the units, each thread with two groups of 4
// elements (one float4 of g, of p and of p', one 4-byte word of each code).
// The whole update stays in registers between the loads and the stores.
// A leaf may have any length: g and p read as 0 past its end, and the codes
// there are the zeros the encoder wrote, so the tail neither moves the
// absmax nor gets a code.  A leaf whose tensors are not aligned for the
// vector accesses takes the scalar path.
//
// What bounds the body: the instruction throughput of its IEEE divisions,
// square roots and logf more than its bytes (scripts/bench_kernel_variants.py
// --adam-q8 times it without the encode, without the decode, and with loads
// only; the encode's divisions, logf and rintf cost the most).  The decode
// depends only on the code: each block computes the two decode tables (129
// code magnitudes of mu, 256 of sqrt(nu)) once with the same expf
// expression and decodes by lookup, which keeps the bits and drops two expf
// per element.  Eight blocks per SM (32 registers a thread) hide more of
// the latency between the loads and the encode than the four that 60
// registers allow (3.16 -> 2.98 ms over ViT-L's leaves on an H100).
//
// Every operation is a round-to-nearest intrinsic in the order of the plain
// version (train/fused_opt.py::adam_leaf_q8_plain): IEEE division and square
// root, expf, logf and rintf, no contraction into FMAs.  Division by one of
// the codec's constants is a multiply by its float32 reciprocal, as XLA
// folds the JAX codec's "x / c".
#include "leaf_table.cuh"

namespace {
using namespace leaf_table;

// table row: n, g, p, mq, ms, nq, ns, p_o, mq_o, ms_o, nq_o, ns_o
constexpr int WIDTH = 12;

struct Codec {
    float ln_eps;        // float32(ln 1e-6)
    float inv_ln_eps;    // float32 reciprocal of ln_eps
    float inv_l127;      // 1 / 126
    float inv_l255;      // 1 / 254
    float tiny;          // 1e-30, the floor of the absmax
    float zero_below;    // 1e-6: r under it codes to 0
};

struct Hyper {
    float s, lr, c1, c2, b1, omb1, b2, omb2, eps;
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
    for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w]);
    return m;
}

// One element: decode its two codes, update; -> mu', sqrt(nu') (before
// they are coded) and p'.
__device__ __forceinline__ void update_one(int8_t mq, uint8_t nq, float g, float p, float mscale,
                                           float nscale, const float* dec_mu,
                                           const float* dec_nu, const Hyper& h, float& m,
                                           float& vs, float& q) {
    float mu = 0.f;
    if (mq != 0) {
        const float e = dec_mu[mq < 0 ? -mq : mq];
        mu = __fmul_rn(mq < 0 ? -e : e, mscale);
    }
    const float vs0 = nq == 0 ? 0.f : __fmul_rn(dec_nu[nq], nscale);
    const float gs = __fmul_rn(g, h.s);
    m = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, gs));
    const float v = __fadd_rn(__fmul_rn(h.b2, __fmul_rn(vs0, vs0)),
                              __fmul_rn(__fmul_rn(h.omb2, gs), gs));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
    q = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(m, h.c1)), den));
    vs = __fsqrt_rn(v);
}

__device__ __forceinline__ int8_t mu_code(float m, float am_safe, const Codec& c) {
    const float idx = level_of(__fdiv_rn(fabsf(m), am_safe), 126.f, 127.f, c);
    const float sgn = m > 0.f ? 1.f : (m < 0.f ? -1.f : 0.f);
    return static_cast<int8_t>(__fmul_rn(sgn, idx));
}

__device__ __forceinline__ uint8_t nu_code(float vs, float an_safe, const Codec& c) {
    return static_cast<uint8_t>(level_of(__fdiv_rn(vs, an_safe), 254.f, 255.f, c));
}

__global__ void __launch_bounds__(THREADS, 8)
adam_q8_table_kernel(Table tb, const float* __restrict__ scal, float b1, float omb1, float b2,
                     float omb2, float eps, Codec c) {
    // decoded magnitudes by code magnitude: mu's |code| <= 128, sqrt(nu)'s <= 255
    __shared__ float dec_mu[129], dec_nu[256];
    __shared__ float red[2][2][THREADS / 32];    // [unit parity][mu, nu][warp]
    for (int i = threadIdx.x; i < 129 + 256; i += THREADS) {
        if (i < 129) dec_mu[i] = i == 0 ? 0.f : level_value(static_cast<float>(i), c.inv_l127, c);
        else dec_nu[i - 129] = i == 129 ? 0.f : level_value(static_cast<float>(i - 129), c.inv_l255, c);
    }
    __syncthreads();
    const Hyper h{scal[0], scal[1], scal[2], scal[3], b1, omb1, b2, omb2, eps};
    int parity = 0;
    for (long long u = blockIdx.x; u < tb.units; u += gridDim.x, parity ^= 1) {
        const Unit w = locate(tb, u);
        const float* g = col<const float>(w.row, 1);
        const float* p = col<const float>(w.row, 2);
        const int8_t* mq = col<const int8_t>(w.row, 3);
        const float* ms = col<const float>(w.row, 4);
        const uint8_t* nq = col<const uint8_t>(w.row, 5);
        const float* ns = col<const float>(w.row, 6);
        float* p_o = col<float>(w.row, 7);
        int8_t* mq_o = col<int8_t>(w.row, 8);
        float* ms_o = col<float>(w.row, 9);
        uint8_t* nq_o = col<uint8_t>(w.row, 10);
        float* ns_o = col<float>(w.row, 11);
        const bool vec = aligned(g, 16) && aligned(p, 16) && aligned(p_o, 16) && aligned(mq, 4) &&
                         aligned(nq, 4) && aligned(mq_o, 4) && aligned(nq_o, 4);
        const long long blk = w.base / UNIT;
        const float mscale = __ldg(ms + blk), nscale = __ldg(ns + blk);
        float m[8], vs[8];
        float am = 0.f, an = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const long long e = w.base + j * HALF + 4 * threadIdx.x;   // codes cover whole blocks
            float gv[4], pv[4], q[4];
            int8_t mc[4];
            uint8_t nc[4];
            if (vec) {
                const char4 a = __ldg(reinterpret_cast<const char4*>(mq + e));
                const uchar4 b = __ldg(reinterpret_cast<const uchar4*>(nq + e));
                mc[0] = a.x; mc[1] = a.y; mc[2] = a.z; mc[3] = a.w;
                nc[0] = b.x; nc[1] = b.y; nc[2] = b.z; nc[3] = b.w;
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    mc[k] = mq[e + k];
                    nc[k] = nq[e + k];
                }
            }
            const bool whole = vec && e + 4 <= w.n;
            if (whole) {
                const float4 g4 = __ldg(reinterpret_cast<const float4*>(g + e));
                const float4 p4 = __ldg(reinterpret_cast<const float4*>(p + e));
                gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
                pv[0] = p4.x; pv[1] = p4.y; pv[2] = p4.z; pv[3] = p4.w;
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const bool in = e + k < w.n;
                    gv[k] = in ? g[e + k] : 0.f;
                    pv[k] = in ? p[e + k] : 0.f;
                }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                update_one(mc[k], nc[k], gv[k], pv[k], mscale, nscale, dec_mu, dec_nu, h,
                           m[4 * j + k], vs[4 * j + k], q[k]);
                am = fmaxf(am, fabsf(m[4 * j + k]));
                an = fmaxf(an, vs[4 * j + k]);
            }
            if (whole) {
                *reinterpret_cast<float4*>(p_o + e) = make_float4(q[0], q[1], q[2], q[3]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (e + k < w.n) p_o[e + k] = q[k];
            }
        }
        am = block_max(am, red[parity][0]);
        an = block_max(an, red[parity][1]);
        if (threadIdx.x == 0) {
            ms_o[blk] = am;
            ns_o[blk] = an;
        }
        const float am_safe = fmaxf(am, c.tiny), an_safe = fmaxf(an, c.tiny);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const long long e = w.base + j * HALF + 4 * threadIdx.x;
            int8_t mc[4];
            uint8_t nc[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                mc[k] = mu_code(m[4 * j + k], am_safe, c);
                nc[k] = nu_code(vs[4 * j + k], an_safe, c);
            }
            if (vec) {
                *reinterpret_cast<char4*>(mq_o + e) = make_char4(mc[0], mc[1], mc[2], mc[3]);
                *reinterpret_cast<uchar4*>(nq_o + e) = make_uchar4(nc[0], nc[1], nc[2], nc[3]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    mq_o[e + k] = mc[k];
                    nq_o[e + k] = nc[k];
                }
            }
        }
    }
}
}  // namespace

// table: the leaf table on the card (leaf_table.cuh), rows of WIDTH
// columns: per leaf g, p (n float32), mq (int8) and nq (uint8) codes of
// nb * 2048, ms and ns scales of nb float32, nb = ceil(n / 2048), and the
// outputs of the same sizes; scal: (clip scale, lr, 1 - b1^t, 1 - b2^t) on
// the card.
EVT_EXPORT int evt_adam_q8_table(void* table, int leaves, long long units, const void* scal,
                                 float b1, float omb1, float b2, float omb2, float eps,
                                 float ln_eps, float inv_ln_eps, float inv_l127, float inv_l255,
                                 float tiny, float zero_below, void* stream) {
    if (leaves <= 0 || units <= 0) return 0;
    const Table tb{static_cast<long long*>(table), leaves, WIDTH, units};
    const Codec c{ln_eps, inv_ln_eps, inv_l127, inv_l255, tiny, zero_below};
    adam_q8_table_kernel<<<resident_grid(adam_q8_table_kernel, units), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const float*>(scal), b1, omb1, b2, omb2, eps, c);
    return static_cast<int>(cudaGetLastError());
}
