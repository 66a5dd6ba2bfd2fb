// K8: clip-scaled Adam with float32 moments over every leaf of a step in one
// launch: read g, mu, nu, p, write mu', nu', p'.
// Replaces easy_vitpose_tpu/train/fused_opt.py::_adam_leaf_pallas (body kern).
//
// Bound by bytes: 28 bytes per element, no reuse.  The leaves come as a
// table (leaf_table.cuh): resident blocks walk its 2048-element work units,
// each thread with two float4 groups of g, mu, nu and p, so one launch does
// a whole step (the port's first K8 launched once per leaf, and the host's
// launches, not the card, set its time).  A leaf's ragged tail, or a leaf
// whose tensors do not start on 16 bytes, takes the scalar path.  The
// step's scalars (clip scale s, lr, 1-b1^t, 1-b2^t) are read from a small
// device buffer, so the step never waits on the host.  Every operation is a
// round-to-nearest intrinsic in the order of the plain version
// (train/fused_opt.py::adam_leaf_plain), with IEEE division and square
// root, so the two agree bit for bit:
//   gs = g*s;  mu' = b1*mu + (1-b1)*gs;  nu' = b2*nu + ((1-b2)*gs)*gs;
//   p' = p - (lr * (mu'/c1)) / (sqrt(nu'/c2) + eps)
#include "leaf_table.cuh"

namespace {
using namespace leaf_table;

// table row: n, g, mu, nu, p, mu_o, nu_o, p_o
constexpr int WIDTH = 8;

struct Hyper {
    float s, lr, c1, c2, b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(float g, float mu, float nu, float p, const Hyper& h,
                                         float& m, float& v, float& q) {
    const float gs = __fmul_rn(g, h.s);
    m = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, gs));
    v = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps);
    q = __fsub_rn(p, __fdiv_rn(__fmul_rn(h.lr, __fdiv_rn(m, h.c1)), den));
}

__global__ void __launch_bounds__(THREADS)
adam_table_kernel(Table tb, const float* __restrict__ scal, float b1, float omb1, float b2,
                  float omb2, float eps) {
    const Hyper h{scal[0], scal[1], scal[2], scal[3], b1, omb1, b2, omb2, eps};
    for (long long u = blockIdx.x; u < tb.units; u += gridDim.x) {
        const Unit w = locate(tb, u);
        const float* g = col<const float>(w.row, 1);
        const float* mu = col<const float>(w.row, 2);
        const float* nu = col<const float>(w.row, 3);
        const float* p = col<const float>(w.row, 4);
        float* mu_o = col<float>(w.row, 5);
        float* nu_o = col<float>(w.row, 6);
        float* p_o = col<float>(w.row, 7);
        const bool vec = aligned(g, 16) && aligned(mu, 16) && aligned(nu, 16) && aligned(p, 16) &&
                         aligned(mu_o, 16) && aligned(nu_o, 16) && aligned(p_o, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const long long e = w.base + j * HALF + 4 * threadIdx.x;
            if (vec && e + 4 <= w.n) {
                const float4 gv = __ldg(reinterpret_cast<const float4*>(g + e));
                const float4 mv = __ldg(reinterpret_cast<const float4*>(mu + e));
                const float4 nv = __ldg(reinterpret_cast<const float4*>(nu + e));
                const float4 pv = __ldg(reinterpret_cast<const float4*>(p + e));
                float4 mo, no, po;
                adam_one(gv.x, mv.x, nv.x, pv.x, h, mo.x, no.x, po.x);
                adam_one(gv.y, mv.y, nv.y, pv.y, h, mo.y, no.y, po.y);
                adam_one(gv.z, mv.z, nv.z, pv.z, h, mo.z, no.z, po.z);
                adam_one(gv.w, mv.w, nv.w, pv.w, h, mo.w, no.w, po.w);
                *reinterpret_cast<float4*>(mu_o + e) = mo;
                *reinterpret_cast<float4*>(nu_o + e) = no;
                *reinterpret_cast<float4*>(p_o + e) = po;
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    if (e + k < w.n) {
                        float m, v, q;
                        adam_one(g[e + k], mu[e + k], nu[e + k], p[e + k], h, m, v, q);
                        mu_o[e + k] = m;
                        nu_o[e + k] = v;
                        p_o[e + k] = q;
                    }
                }
            }
        }
    }
}
}  // namespace

// table: the leaf table on the card (leaf_table.cuh), rows of WIDTH columns;
// scal: (clip scale, lr, 1 - b1^t, 1 - b2^t) on the card.
EVT_EXPORT int evt_adam_table(void* table, int leaves, long long units, const void* scal,
                              float b1, float omb1, float b2, float omb2, float eps,
                              void* stream) {
    if (leaves <= 0 || units <= 0) return 0;
    const Table tb{static_cast<long long*>(table), leaves, WIDTH, units};
    adam_table_kernel<<<resident_grid(adam_table_kernel, units), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        tb, static_cast<const float*>(scal), b1, omb1, b2, omb2, eps);
    return static_cast<int>(cudaGetLastError());
}
