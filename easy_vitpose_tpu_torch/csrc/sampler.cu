// K3: crop geometry, bilinear crop + zero pad + resize of M boxes from a
// uint8 (H, W, 3) frame, or from a stack of S frames (S, H, W, 3) with one
// frame index per box, with the ImageNet normalize fused, in one launch:
// (M, 4) float32 frame-local boxes -> the backbone's (M, OH, OW, 3) input in
// float32 or bf16, and the packed (M, 8) int32 geometry the decode reads.
// Replaces easy_vitpose_tpu/ops/pallas_sampler.py::_sampler_kernel and, for
// a stack, the frame-indexed gather of ops/preprocess.py::sample_crops.
//
// A stacked box reads its own frame: its block offsets the frame pointer by
// its index times H * W * 3.  The index is taken as JAX's gather takes it
// (a negative one counts from the end, then it is clamped to [0, S - 1]), so
// no index reads outside the stack and the host checks none.
//
// The geometry is ops/preprocess.py::crop_geometry on each box: rintf (half
// to even, as torch.round), the +/-10 px inflation clipped to the frame, the
// 3:4 pad with its max(wp, wc) repair.  The tap arithmetic is that of
// ops/preprocess.py::sample_crops, step by step with round-to-nearest
// intrinsics so the compiler fuses nothing into an FMA: the half-pixel map
// clamped to the padded crop, taps outside the crop are zero, frame indices
// clamped to the frame.  The lerps run in TO, the sampling dtype: in bf16
// the weights, each product and each sum are rounded, as JAX's bf16
// sample_crops rounds them (done as packed bf16x2 arithmetic, the same
// bits: see lerp2); the normalize is a float32 IEEE division.
//
// What bounds it on the H100 is bytes: the part of the frame under the boxes
// read once and the crops written once (18.9 MB in bf16 at 64 slots), about
// 7 us at 3.35 TB/s.  A block takes one box and a band of BAND output rows:
// it computes the box's geometry once, the taps of every output column once
// into shared memory and those of its rows once.  A thread takes VEC whole
// pixels of a row (8 in bf16, 4 in float32): a pixel's taps and its four
// frame reads (the three channels of a tap from the aligned words that hold
// them) serve all three channels, and its 3 * VEC values go out in three
// full 16-byte stores (a crop row is OW * 3 contiguous values).
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int BAND = 16;           // output rows per block
constexpr int PAD_BBOX = 10;       // reference easy_ViTPose/inference.py:254

struct Geo { int x1, y1, wc, hc, wp, hp, left, top; };

// ops/preprocess.py::crop_geometry of one [x1, y1, x2, y2] box
__device__ Geo box_geometry(const float* b, int H, int W) {
    const int bx1 = static_cast<int>(rintf(b[0])), by1 = static_cast<int>(rintf(b[1]));
    const int bx2 = static_cast<int>(rintf(b[2])), by2 = static_cast<int>(rintf(b[3]));
    Geo g;
    g.x1 = min(max(bx1 - PAD_BBOX, 0), W);
    g.y1 = min(max(by1 - PAD_BBOX, 0), H);
    const int x2 = min(max(bx2 + PAD_BBOX, 0), W), y2 = min(max(by2 + PAD_BBOX, 0), H);
    g.wc = max(x2 - g.x1, 1);
    g.hc = max(y2 - g.y1, 1);
    const bool pad_horiz = 4 * g.wc < 3 * g.hc;       // aspect 3:4
    // int(w / 0.75) can round below w; the reference keeps the crop size then
    g.wp = max(pad_horiz ? 3 * g.hc / 4 : g.wc, g.wc);
    g.hp = max(pad_horiz ? g.hc : 4 * g.wc / 3, g.hc);
    g.left = pad_horiz ? (g.wp - g.wc) / 2 : 0;
    g.top = pad_horiz ? 0 : (g.hp - g.hc) / 2;
    return g;
}

struct AxisTaps {
    int g0, g1;        // frame index of tap 0 and 1 (clamped)
    bool in0, in1;     // tap inside the crop (else it reads zero)
    float w0, w1;      // 1 - f and f, in the sampling dtype
};

// geometry of one axis: padded size, pad offset, crop size, crop origin
template <typename TO>
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
    t.w1 = round_to<TO>(f);
    t.w0 = round_to<TO>(__fsub_rn(1.f, t.w1));
    return t;
}

// a * w0 + b * w1, each product and the sum rounded to TO
template <typename TO>
__device__ __forceinline__ float lerp(float a, float w0, float b, float w1) {
    return round_to<TO>(__fadd_rn(round_to<TO>(__fmul_rn(a, w0)), round_to<TO>(__fmul_rn(b, w1))));
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// VEC consecutive values rounded to TO, in one store: 16 bytes unless VEC is 1
template <typename TO, int VEC>
__device__ __forceinline__ void store(TO* dst, const float* v) {
    if constexpr (VEC == 1) {
        dst[0] = from_f<TO>(v[0]);
    } else if constexpr (sizeof(TO) == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                                    bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
    }
}

// The three channels of the frame pixel at byte offset off, in the low three
// bytes: with WORDS (every frame 4-byte aligned, the stack a whole number of
// words) from the one or two aligned words that hold them, else byte by
// byte.  No byte past the pixel's word is read, so the stack's last pixel
// reads nothing beyond the stack.
template <bool WORDS>
__device__ __forceinline__ unsigned pixel_bytes(const uint8_t* __restrict__ frame, size_t off) {
    if constexpr (WORDS) {
        const unsigned* w = reinterpret_cast<const unsigned*>(frame) + (off >> 2);
        const unsigned sh = static_cast<unsigned>(off & 3);
        return __funnelshift_r(w[0], sh > 1 ? w[1] : 0u, sh * 8);
    } else {
        return frame[off] | (static_cast<unsigned>(frame[off + 1]) << 8) |
               (static_cast<unsigned>(frame[off + 2]) << 16);
    }
}

__device__ __forceinline__ float channel(unsigned p, int c) {
    return static_cast<float>((p >> (8 * c)) & 0xffu);
}

// The bf16 lerp on bf16 operands, two lanes at once (bf16x2 in 32 bits:
// channels 0 and 1, or channel 2 and an unused lane).  mul.rn and add.rn
// each round once and, having a rounding mode, are never contracted into an
// FMA.  A correctly rounded bf16 product or sum is lerp<bf16>'s float32
// product or sum rounded to bf16: a product of two bf16 values is exact in
// float32, and so is a sum of two non-negative bf16 values unless one is
// below 2^-15 of the other, when both round to the larger.  So these are
// lerp<bf16>'s bits, in a third of the instructions.
__device__ __forceinline__ unsigned lerp2(unsigned a, unsigned w0, unsigned b, unsigned w1) {
    unsigned d;
    asm("{\n\t.reg .b32 p, q;\n\t"
        "mul.rn.bf16x2 p, %1, %2;\n\t"
        "mul.rn.bf16x2 q, %3, %4;\n\t"
        "add.rn.bf16x2 %0, p, q;\n\t}"
        : "=r"(d) : "r"(a), "r"(w0), "r"(b), "r"(w1));
    return d;
}

// bf16 bits of a float32 that a bf16 holds exactly (a byte, a rounded weight)
__device__ __forceinline__ unsigned bf16_bits(float x) { return __float_as_uint(x) >> 16; }
__device__ __forceinline__ unsigned pair(unsigned lo, unsigned hi) { return lo | (hi << 16); }
__device__ __forceinline__ float lo_float(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi_float(unsigned x) { return __uint_as_float(x & 0xffff0000u); }
// channels 0 and 1 of a pixel as a bf16 pair, and channel 2
__device__ __forceinline__ unsigned ch01(unsigned p) {
    return pair(bf16_bits(channel(p, 0)), bf16_bits(channel(p, 1)));
}
__device__ __forceinline__ unsigned ch2(unsigned p) { return bf16_bits(channel(p, 2)); }

// grid (ceil(OH / BAND), M); dynamic shared memory: OW column taps.  A thread
// takes VEC whole output pixels of a row: their 3 * VEC values go out in
// three stores, and each pixel's taps and frame reads serve its three
// channels.
template <typename TO, int VEC, bool WORDS>
__global__ void __launch_bounds__(THREADS)
crop_kernel(const uint8_t* __restrict__ stack, const int* __restrict__ frame_idx, int S,
            const float* __restrict__ boxes, int* __restrict__ geo, TO* __restrict__ out,
            int H, int W, int OH, int OW, float3 mean, float3 stdv) {
    extern __shared__ AxisTaps col[];
    __shared__ AxisTaps rows[BAND];
    __shared__ Geo sg;
    const int m = blockIdx.y, r0 = blockIdx.x * BAND, t = threadIdx.x;
    int fi = frame_idx ? frame_idx[m] : 0;
    fi = min(max(fi < 0 ? fi + S : fi, 0), S - 1);
    const uint8_t* __restrict__ frame = stack + (size_t)fi * H * W * 3;
    if (t == 0) {
        sg = box_geometry(boxes + m * 4, H, W);
        if (blockIdx.x == 0) {
            const int packed[8] = {sg.x1, sg.y1, sg.wc, sg.hc, sg.wp, sg.hp, sg.left, sg.top};
#pragma unroll
            for (int i = 0; i < 8; ++i) geo[m * 8 + i] = packed[i];
        }
    }
    __syncthreads();
    const Geo g = sg;
    const int n_rows = min(BAND, OH - r0);
    for (int o = t; o < OW; o += THREADS)
        col[o] = axis_taps<TO>(o, OW, g.wp, g.left, g.wc, g.x1, W);
    if (t < n_rows) rows[t] = axis_taps<TO>(r0 + t, OH, g.hp, g.top, g.hc, g.y1, H);
    __syncthreads();

    const float mv[3] = {mean.x, mean.y, mean.z}, sv[3] = {stdv.x, stdv.y, stdv.z};
    const int groups = OW / VEC;
    TO* band = out + ((size_t)m * OH + r0) * OW * 3;
    for (int q = t; q < n_rows * groups; q += THREADS) {
        const int rr = q / groups, j = q - rr * groups;
        const AxisTaps ty = rows[rr];
        const size_t row0 = (size_t)ty.g0 * W * 3, row1 = (size_t)ty.g1 * W * 3;
        float v[3 * VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
            const AxisTaps tx = col[j * VEC + e];
            // the four taps, each masked to the crop (zero outside it)
            const unsigned p00 = tx.in0 ? pixel_bytes<WORDS>(frame, row0 + tx.g0 * 3) : 0u;
            const unsigned p01 = tx.in1 ? pixel_bytes<WORDS>(frame, row0 + tx.g1 * 3) : 0u;
            const unsigned p10 = tx.in0 ? pixel_bytes<WORDS>(frame, row1 + tx.g0 * 3) : 0u;
            const unsigned p11 = tx.in1 ? pixel_bytes<WORDS>(frame, row1 + tx.g1 * 3) : 0u;
            // x lerp on each of the two rows, then the y lerp
            if constexpr (std::is_same_v<TO, bf16>) {
                const unsigned wx0 = bf16_bits(tx.w0), wx1 = bf16_bits(tx.w1);
                const unsigned wx0_2 = pair(wx0, wx0), wx1_2 = pair(wx1, wx1);
                const unsigned x0 = ty.in0 ? lerp2(ch01(p00), wx0_2, ch01(p01), wx1_2) : 0u;
                const unsigned x1 = ty.in1 ? lerp2(ch01(p10), wx0_2, ch01(p11), wx1_2) : 0u;
                const unsigned z0 = ty.in0 ? lerp2(ch2(p00), wx0, ch2(p01), wx1) : 0u;
                const unsigned z1 = ty.in1 ? lerp2(ch2(p10), wx0, ch2(p11), wx1) : 0u;
                const unsigned wy0 = bf16_bits(ty.w0), wy1 = bf16_bits(ty.w1);
                const unsigned xy = lerp2(x0, pair(wy0, wy0), x1, pair(wy1, wy1));
                const float val[3] = {lo_float(xy), hi_float(xy), lo_float(lerp2(z0, wy0, z1, wy1))};
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    v[3 * e + c] = __fdiv_rn(__fsub_rn(val[c], mv[c]), sv[c]);
            } else {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float x0 = ty.in0 ? lerp<TO>(channel(p00, c), tx.w0, channel(p01, c),
                                                       tx.w1) : 0.f;
                    const float x1 = ty.in1 ? lerp<TO>(channel(p10, c), tx.w0, channel(p11, c),
                                                       tx.w1) : 0.f;
                    const float val = lerp<TO>(x0, ty.w0, x1, ty.w1);
                    v[3 * e + c] = __fdiv_rn(__fsub_rn(val, mv[c]), sv[c]);
                }
            }
        }
        TO* dst = band + (size_t)rr * OW * 3 + j * VEC * 3;
#pragma unroll
        for (int s = 0; s < 3; ++s) store<TO, VEC>(dst + s * VEC, v + s * VEC);
    }
}

template <typename TO, int VEC>
void launch_vec(const uint8_t* stack, const int* fidx, int S, const float* boxes, int* geo,
                TO* out, int M, int H, int W, int OH, int OW, float3 mean, float3 stdv,
                cudaStream_t st) {
    const dim3 grid((OH + BAND - 1) / BAND, M);
    const size_t smem = sizeof(AxisTaps) * OW;
    // aligned 32-bit frame reads when every frame of the stack starts on 4
    // bytes and the stack ends on a word: then no word read runs past it
    const bool words = reinterpret_cast<uintptr_t>(stack) % 4 == 0 && (size_t)H * W * 3 % 4 == 0;
    if (words)
        crop_kernel<TO, VEC, true><<<grid, THREADS, smem, st>>>(stack, fidx, S, boxes, geo, out,
                                                                H, W, OH, OW, mean, stdv);
    else
        crop_kernel<TO, VEC, false><<<grid, THREADS, smem, st>>>(stack, fidx, S, boxes, geo, out,
                                                                 H, W, OH, OW, mean, stdv);
}

template <typename TO>
int launch(const uint8_t* stack, const int* fidx, int S, const float* boxes, int* geo, void* out,
           int M, int H, int W, int OH, int OW, float3 mean, float3 stdv, cudaStream_t st) {
    constexpr int VEC = 16 / sizeof(TO);
    TO* o = static_cast<TO*>(out);
    // 16-byte stores when every crop row starts on 16 bytes and holds whole groups
    if (OW % VEC == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)
        launch_vec<TO, VEC>(stack, fidx, S, boxes, geo, o, M, H, W, OH, OW, mean, stdv, st);
    else
        launch_vec<TO, 1>(stack, fidx, S, boxes, geo, o, M, H, W, OH, OW, mean, stdv, st);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frames: (S, H, W, 3) uint8; frame_idx: (M,) int32, or null for S = 1.
EVT_EXPORT int evt_crop_sample(const void* frames, const void* frame_idx, int S,
                               const void* boxes, void* geo, void* out, int M, int H, int W,
                               int OH, int OW, float m0, float m1, float m2, float s0, float s1,
                               float s2, int out_bf16, void* stream) {
    if (S <= 0 || (S > 1 && frame_idx == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    const uint8_t* f = static_cast<const uint8_t*>(frames);
    const int* fi = static_cast<const int*>(frame_idx);
    const float* b = static_cast<const float*>(boxes);
    int* g = static_cast<int*>(geo);
    const float3 mean = make_float3(m0, m1, m2), stdv = make_float3(s0, s1, s2);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return out_bf16 ? launch<bf16>(f, fi, S, b, g, out, M, H, W, OH, OW, mean, stdv, st)
                    : launch<float>(f, fi, S, b, g, out, M, H, W, OH, OW, mean, stdv, st);
}
