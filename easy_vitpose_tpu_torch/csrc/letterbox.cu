// D1: the detector's letterbox, from the uint8 frame to its input, in one
// launch.  Replaces the XLA code of easy_vitpose_tpu/detect/yolo.py::
// letterbox_sample (a clamped bilinear gather with cv2's half-pixel map, 114
// outside the resized image) and the divide by 255 and cast of
// detect_frame_core; in JAX XLA fuses them, where eager PyTorch would issue
// some twenty launches a frame (detect/yolo.py::letterbox_input_plain).
//
// One thread makes one canvas pixel, its three channels: the x taps and the
// y taps of the pixel, four 3-byte frame reads, the x lerp on both rows and
// the y lerp, then (v / 255) rounded once to the output type, written to the
// (ch, cw, 3) NHWC buffer that the detector's channels_last input views.
// The arithmetic is JAX's float32 op for op, with every rounding explicit
// (__f*_rn are never contracted into FMAs): src = (x - left + 0.5) * scale
// - 0.5 clipped to [0, W-1], f = src - floor(src), a * (1 - f) + b * f in x
// then in y, and a true division by 255.
//
// Bound by bytes on the H100: the frame pixels under the taps read once
// (at imgsz 320 on a 1080p frame about two rows and columns in six) and the
// canvas written once; a thread does ~30 float operations, so the latency
// of its dependent loads, not the issue rate, is what a first version pays.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Tap {
    int i0, i1;
    float w0, w1;   // 1 - f and f
};

// One axis of JAX's map: canvas index o -> the two frame indices and weights.
__device__ __forceinline__ Tap axis_tap(int o, int off, float scale, int n) {
    const float src = __fsub_rn(__fmul_rn(__fadd_rn(__fsub_rn(static_cast<float>(o),
                                                              static_cast<float>(off)), 0.5f),
                                          scale), 0.5f);
    const float s = fminf(fmaxf(src, 0.f), static_cast<float>(n - 1));
    const float fl = floorf(s);
    Tap t;
    t.i0 = static_cast<int>(fl);
    t.i1 = min(t.i0 + 1, n - 1);
    t.w1 = __fsub_rn(s, fl);
    t.w0 = __fsub_rn(1.f, t.w1);
    return t;
}

__device__ __forceinline__ float lerp(float a, float wa, float b, float wb) {
    return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
letterbox_kernel(const uint8_t* __restrict__ frame, TO* __restrict__ out, int H, int W, int cw,
                 int ch, int new_w, int new_h, int left, int top, float scale_x, float scale_y) {
    const int p = blockIdx.x * THREADS + threadIdx.x;
    if (p >= cw * ch) return;
    const int y = p / cw, x = p - y * cw;
    float v[3];
    if (x >= left && x < left + new_w && y >= top && y < top + new_h) {
        const Tap tx = axis_tap(x, left, scale_x, W);
        const Tap ty = axis_tap(y, top, scale_y, H);
        const uint8_t* r0 = frame + static_cast<size_t>(ty.i0) * W * 3;
        const uint8_t* r1 = frame + static_cast<size_t>(ty.i1) * W * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float a = lerp(r0[tx.i0 * 3 + c], tx.w0, r0[tx.i1 * 3 + c], tx.w1);
            const float b = lerp(r1[tx.i0 * 3 + c], tx.w0, r1[tx.i1 * 3 + c], tx.w1);
            v[c] = lerp(a, ty.w0, b, ty.w1);
        }
    } else {
        v[0] = v[1] = v[2] = 114.f;
    }
    TO* o = out + static_cast<size_t>(p) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) o[c] = from_f<TO>(__fdiv_rn(v[c], 255.f));
}

template <typename TO>
int launch(const uint8_t* frame, void* out, int H, int W, int cw, int ch, int new_w, int new_h,
           int left, int top, float sx, float sy, cudaStream_t st) {
    const int blocks = (cw * ch + THREADS - 1) / THREADS;
    letterbox_kernel<TO><<<blocks, THREADS, 0, st>>>(frame, static_cast<TO*>(out), H, W, cw, ch,
                                                     new_w, new_h, left, top, sx, sy);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// frame: (H, W, 3) uint8; out: (ch, cw, 3) float32 or bf16; scale_x, scale_y:
// W / new_w and H / new_h rounded to float32.
EVT_EXPORT int evt_letterbox(const void* frame, void* out, int H, int W, int cw, int ch,
                             int new_w, int new_h, int left, int top, float scale_x,
                             float scale_y, int out_bf16, void* stream) {
    if (H <= 0 || W <= 0 || cw <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const uint8_t* f = static_cast<const uint8_t*>(frame);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return out_bf16 ? launch<bf16>(f, out, H, W, cw, ch, new_w, new_h, left, top, scale_x,
                                   scale_y, st)
                    : launch<float>(f, out, H, W, cw, ch, new_w, new_h, left, top, scale_x,
                                    scale_y, st);
}
