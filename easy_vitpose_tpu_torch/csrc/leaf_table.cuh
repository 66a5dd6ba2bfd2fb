// The table of leaves that the optimizer's kernels walk (K8, K9 and the
// gradient norm): one launch covers every leaf of a step, whatever their
// number.  Built on the host by train/fused_opt.py::_table and copied to
// the card once per step.  int64 layout, for L leaves of W columns:
//
//   [0]                  the norm's ticket counter, 0 on upload
//   [1 .. L + 1]         the first work unit of each leaf, then the total
//   [L + 2 + i * W ...]  leaf i's row: its element count, then pointers
//                        (column 1 is always the gradient g)
//
// A work unit is 2048 consecutive elements of one leaf (one codec block of
// the int8 moments); a leaf of n elements has ceil(n / 2048) units, the last
// one ragged.  A block of 256 threads takes one unit at a time, in a loop
// over units strided by the grid (blocks stay resident and walk the table),
// and finds the unit's leaf by a binary search over the first-unit column,
// which stays in L1 after the first lookups.  Thread t takes elements
// 4t..4t+3 and 1024+4t..1024+4t+3 of the unit, so each warp's float4 (and
// 4-byte code) accesses are contiguous.
#pragma once

#include "common.cuh"

namespace leaf_table {

constexpr int UNIT = 2048, THREADS = 256, HALF = UNIT / 2;

struct Table {
    long long* t;        // the table on the card
    int leaves, width;   // L, W
    long long units;     // total work units
};

// The largest leaf i whose first unit is <= u (empty leaves are skipped):
// train/fused_opt.py::leaf_of_unit is the same search.
__device__ __forceinline__ int find_leaf(const long long* first, int leaves, long long u) {
    int lo = 0, hi = leaves - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(first + mid) <= u) lo = mid;
        else hi = mid - 1;
    }
    return lo;
}

struct Unit {
    const long long* row;   // the leaf's row
    long long base;         // the unit's first element within the leaf
    long long n;            // the leaf's element count
};

__device__ __forceinline__ Unit locate(const Table& tb, long long u) {
    const long long* first = tb.t + 1;
    const int leaf = find_leaf(first, tb.leaves, u);
    const long long* row = tb.t + 2 + tb.leaves + static_cast<long long>(leaf) * tb.width;
    return {row, (u - __ldg(first + leaf)) * UNIT, __ldg(row)};
}

template <typename T>
__device__ __forceinline__ T* col(const long long* row, int c) {
    return reinterpret_cast<T*>(__ldg(row + c));
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Blocks of `kernel` that fill every SM of the current device at its
// occupancy, at most `units` (at least 1); cached per device.
template <typename K>
inline int resident_grid(K kernel, long long units) {
    static int cache[64];
    int dev = 0;
    cudaGetDevice(&dev);
    int& blocks = cache[dev & 63];
    if (blocks == 0) {
        int sms = 0, per = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
        blocks = sms * (per > 0 ? per : 1);
    }
    return static_cast<int>(units < blocks ? (units > 0 ? units : 1) : blocks);
}

}  // namespace leaf_table
