// Host-side greedy IoU NMS, the native-tier counterpart of the reference's
// Cython kernel (reference vit_utils/nms/cpu_nms.pyx:20-71).  The serving
// path's NMS runs on the card (csrc/nms.cu); this serves host-side
// consumers (dataset result writers, CPU-only tooling) at C speed.
//
// Built at first use by easy_vitpose_tpu_torch/native/__init__.py with the
// host C++ compiler (-O3 -shared -fPIC) into easy_vitpose_tpu_torch/_build.
// ABI: plain C, ctypes-loaded; +1 box-area convention matches the reference.
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// dets: n rows of [x1, y1, x2, y2, score]; keep_out: caller-allocated n ints.
// Returns number of kept indices (written score-descending to keep_out).
int nms_cpu(const float* dets, int n, float thr, int* keep_out) {
    if (n <= 0) return 0;
    std::vector<int> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return dets[a * 5 + 4] > dets[b * 5 + 4];
    });
    std::vector<float> areas(n);
    for (int i = 0; i < n; ++i) {
        const float* d = dets + i * 5;
        areas[i] = (d[2] - d[0] + 1.0f) * (d[3] - d[1] + 1.0f);
    }
    std::vector<char> suppressed(n, 0);
    int kept = 0;
    for (int oi = 0; oi < n; ++oi) {
        int i = order[oi];
        if (suppressed[i]) continue;
        keep_out[kept++] = i;
        const float* di = dets + i * 5;
        for (int oj = oi + 1; oj < n; ++oj) {
            int j = order[oj];
            if (suppressed[j]) continue;
            const float* dj = dets + j * 5;
            float xx1 = std::max(di[0], dj[0]);
            float yy1 = std::max(di[1], dj[1]);
            float xx2 = std::min(di[2], dj[2]);
            float yy2 = std::min(di[3], dj[3]);
            float w = std::max(0.0f, xx2 - xx1 + 1.0f);
            float h = std::max(0.0f, yy2 - yy1 + 1.0f);
            float inter = w * h;
            float ovr = inter / (areas[i] + areas[j] - inter);
            if (ovr > thr) suppressed[j] = 1;
        }
    }
    return kept;
}

}  // extern "C"
