// The UDP modulate's Gaussian taps and border rule, shared by the full-map
// kernel (modulate.cu) and the fused decode (decode.cu), so that both sum
// the same products in the same order and give the same bits.
#pragma once

#define EVT_MAX_TAPS 32
struct evt_taps { float v[EVT_MAX_TAPS]; };

// reflect-101: -1 -> 1, n -> n - 2
__device__ __forceinline__ int reflect101(int i, int n) {
    return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

// clip to [0.001, 50], then the natural log
__device__ __forceinline__ float clip_log(float v) {
    return logf(fminf(fmaxf(v, 0.001f), 50.0f));
}
