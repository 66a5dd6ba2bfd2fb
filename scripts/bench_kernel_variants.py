"""Time design variants of the bf16 attention and the serving GEMM on a card.

Each variant is a copy of ``csrc/attention_tc.cuh`` or ``csrc/gemm_mma.cuh``
changed by one textual substitution (or, for the GEMM's tile shapes, the
shipped template at other ``Tile`` parameters), compiled into one C++
harness by ``nvcc`` with the port's flags and timed at ViT-B's shapes, 64
crops of 192 tokens (CUDA events, the best of five windows of 50 launches):

* attention, head dim 64: the shipped forward and backward; P's IEEE
  division replaced by ``__fdividef``; ``expf`` by ``__expf``; both; and
  ``__launch_bounds__(128, 3)`` (3 blocks per SM, which caps registers);
* GEMM, the four products of a block (M = 12288) at bf16 and int8: the two
  shipped tiles (128x128 with 64x32 warp tiles, 128x64 with 32x32), 64x64
  warp tiles in 128x128, 256x128 and 128x256 blocks, 128x64 with 64x32
  warp tiles, and the shipped tiles with a 4-stage ring.

Only the timing is compared: a variant's outputs are not checked (the
division and exp variants change the arithmetic).  Prints one JSON line.

With ``--train-gemm`` it times instead variants of the bf16 training GEMM
(``csrc/gemm_wgmma.cuh``): for each, ``csrc/train_block.cu`` is built into
a library of its own (one ``nvcc`` per variant, all at once) and its C
entry points are called on the same bf16 operands, at ViT-B's and ViT-L's
MLP shapes and 64 crops: NT (the fc1 recompute, plain and GELU-saving),
NN (the grad through fc2 with its GELU-gradient epilogue) and the TN pairs
of the MLP and the attention (CUDA events, the median of five windows of
at least 50 ms).  The variants: the shipped ring (3 stages, two blocks per
SM, a slot released one k-tile behind), each slot released as soon as its
products are done (wgmma wait depth 0), and 4 stages at one block per SM,
alone and with that release.

With ``--adam-q8`` it times instead variants of K9's body
(``csrc/adam_q8.cu``), each built into an ``adam_q8`` library of its own
and launched once over one table of ViT-L's 301 leaves (random gradients
and moments from a seed; CUDA events, the median of five windows of at
least 50 ms), beside the shipped K8 on the same leaves: the shipped body;
without the encode (each code a comparison, no division, log or rint);
without the decode (the code's value, no table lookup); loads only (no
encode and each output a sum of its inputs: the bytes alone); and the
IEEE divisions as ``__fdividef``, and ``logf`` as ``__logf`` (both change
the bits); and the shipped body (capped in registers for 8 blocks of 256
threads per SM) uncapped and capped for 6 (the same bits).  It tells
whether bytes or the throughput of the division, log and square root
instructions bound the body (``ncu`` does not run on the card's machine).

With ``--crop-decode`` it times instead variants of the crop kernel (K3,
``csrc/sampler.cu``) on the 1080p frame and 64 boxes of ``chip_smoke.py``
at bf16, and of the fused decode (``csrc/decode.cu``) on 64 x 17 bf16
maps, each variant built into a library of its own (device time,
``chip_smoke.device_ms``; beside it ``chip_smoke.time_ms``, which includes
the host's cost of issuing a launch).  K3: the shipped kernel; the bf16
lerps in float32 with a rounding after each operation (``lerp<bf16>``)
instead of packed bf16 arithmetic; byte loads
in place of the aligned 32-bit frame reads; no frame loads (each tap a
function of its offset); the normalize's IEEE division as a multiply
(changes the bits); the taps and the stores only; bands of 8 and 32
output rows; 64 and 256 threads a block.  The decode: the shipped kernel;
the taps read from the by-value parameter (a local-memory copy) instead of
shared memory; 64 and 256 threads; the argmax alone.  The variants that
keep the arithmetic are checked for the shipped bits.

With ``--nms`` it times instead variants of D2 (``csrc/nms.cu``) on the
k = 300 candidates of the smoke's main-path detector, each a library of
its own (``chip_smoke.device_ms``): the shipped kernel (1024 threads, the
sweep a word of 32 candidates at a time in registers); 256 and 512
threads; the first version's sweep (one shared-memory step per
candidate), at 1024 and at 256 threads (the first version); the bitmask
alone (no sweep) and the sweep alone (every mask word zero, so every valid
candidate is kept); and the IoU's IEEE division as ``__fdividef`` (changes
the bits).  The thread and sweep variants are checked for the shipped
bits.

Usage (a machine with the CUDA toolkit and a card):
    python3 scripts/bench_kernel_variants.py [--out FILE] [--train-gemm | --adam-q8 | --crop-decode]
"""
import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from easy_vitpose_tpu_torch import kernels  # noqa: E402

ATTN = {
    "shipped": [],
    "fdividef": [("s[n][e] = s[n][e] / r.l[e >> 1];",
                  "s[n][e] = __fdividef(s[n][e], r.l[e >> 1]);")],
    "fast_exp": [("expf(", "__expf(")],
    "fdividef_fast_exp": [("s[n][e] = s[n][e] / r.l[e >> 1];",
                           "s[n][e] = __fdividef(s[n][e], r.l[e >> 1]);"), ("expf(", "__expf(")],
    "3_blocks_per_sm": [("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 3)")],
}
# (name, namespace, Tile parameters, N % BN == 0 needed)
GEMM = [
    ("shipped_128x128_w64x32", "mma_gemm", "128, 128, 64, 32, 2"),
    ("shipped_128x64_w32x32", "mma_gemm", "128, 64, 32, 32, 3"),
    ("128x128_w64x64", "mma_gemm", "128, 128, 64, 64, 2"),
    ("256x128_w64x64", "mma_gemm", "256, 128, 64, 64, 1"),
    ("128x256_w64x64", "mma_gemm", "128, 256, 64, 64, 1"),
    ("128x64_w64x32", "mma_gemm", "128, 64, 64, 32, 3"),
    ("4_stages_128x128_w64x32", "gemm_4stages", "128, 128, 64, 32, 2"),
    ("4_stages_128x64_w32x32", "gemm_4stages", "128, 64, 32, 32, 3"),
]

_RELEASE_BEHIND = """        wgmma_wait<1>();               // k-tile kt - 1's products are done: release its slot
        if (kt > 0) {
            const uint32_t prev = empty + 8 * ((kt - 1) % STAGES);
            if ((threadIdx.x & 31) == 0) mbar_arrive(prev);
            if (threadIdx.x == 0 && kt - 1 + STAGES < nk) {
                mbar_wait(prev, ((kt - 1) / STAGES) & 1);
                load(kt - 1 + STAGES);
            }
            __syncwarp();
        }"""
_RELEASE_NOW = """        wgmma_wait<0>();
        if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
        if (threadIdx.x == 0 && kt + STAGES < nk) {
            mbar_wait(empty + 8 * s, (kt / STAGES) & 1);
            load(kt + STAGES);
        }
        __syncwarp();"""
_FOUR_STAGES = ("THREADS = 256, STAGES = 3, MIN_BLOCKS = 2", "THREADS = 256, STAGES = 4, MIN_BLOCKS = 1")
TRAIN_GEMM = {
    "shipped": [],
    "release_at_wait0": [(_RELEASE_BEHIND, _RELEASE_NOW)],
    "4_stages_1_block": [_FOUR_STAGES],
    "4_stages_1_block_release_at_wait0": [_FOUR_STAGES, (_RELEASE_BEHIND, _RELEASE_NOW)],
}

_NO_ENCODE = [("mc[k] = mu_code(m[4 * j + k], am_safe, c);",
               "mc[k] = static_cast<int8_t>(m[4 * j + k] > am_safe);"),
              ("nc[k] = nu_code(vs[4 * j + k], an_safe, c);",
               "nc[k] = static_cast<uint8_t>(vs[4 * j + k] > an_safe);")]
_UPDATE = """                update_one(mc[k], nc[k], gv[k], pv[k], mscale, nscale, dec_mu, dec_nu, h,
                           m[4 * j + k], vs[4 * j + k], q[k]);"""
ADAM_Q8 = {
    "shipped": [],
    "no_encode": _NO_ENCODE,
    "no_decode": [("const float e = dec_mu[mq < 0 ? -mq : mq];", "const float e = mq;"),
                  ("__fmul_rn(dec_nu[nq], nscale)", "__fmul_rn(static_cast<float>(nq), nscale)")],
    "loads_only": _NO_ENCODE + [(_UPDATE, """                m[4 * j + k] = gv[k] + mc[k] * mscale;
                vs[4 * j + k] = pv[k] + nc[k] * nscale;
                q[k] = gv[k] + pv[k];""")],
    "fdividef": [("__fdiv_rn(", "__fdividef(")],
    "fast_logf": [("logf(fmaxf(r, c.tiny))", "__logf(fmaxf(r, c.tiny))")],
    "uncapped_registers": [("__launch_bounds__(THREADS, 8)\nadam_q8_table_kernel",
                            "__launch_bounds__(THREADS)\nadam_q8_table_kernel")],
    "6_blocks_per_sm": [("__launch_bounds__(THREADS, 8)\nadam_q8_table_kernel",
                         "__launch_bounds__(THREADS, 6)\nadam_q8_table_kernel")],
}

_NORMALIZE = "v[3 * e + c] = __fdiv_rn(__fsub_rn(val[c], mv[c]), sv[c]);"
SAMPLER = {
    "shipped": [],
    "float_lerps": [("if constexpr (std::is_same_v<TO, bf16>) {", "if constexpr (false) {")],
    "byte_loads": [("    if (words)\n", "    if (false)\n")],
    "no_frame_loads": [("return __funnelshift_r(w[0], sh > 1 ? w[1] : 0u, sh * 8);",
                        "return static_cast<unsigned>(off * 2654435761u) + sh + (w == nullptr);")],
    "normalize_by_multiply": [(_NORMALIZE,
                               "v[3 * e + c] = __fmul_rn(__fsub_rn(val[c], mv[c]), sv[c]);")],
    "taps_and_stores_only": [(_NORMALIZE, "v[3 * e + c] = static_cast<float>(q + c);")],
    "band_8": [("constexpr int BAND = 16;", "constexpr int BAND = 8;")],
    "band_32": [("constexpr int BAND = 16;", "constexpr int BAND = 32;")],
    "threads_256": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
    "threads_64": [("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")],
}
SAMPLER_SAME_BITS = ("float_lerps", "byte_loads", "band_8", "band_32", "threads_256",
                     "threads_64")
DECODE = {
    "shipped": [],
    "taps_by_value": [("__fmul_rn(to_f(row[reflect101(x + k - r, W)]), s_taps[k])",
                       "__fmul_rn(to_f(row[reflect101(x + k - r, W)]), taps.v[k])")],
    "threads_64": [("constexpr int THREADS = 128;", "constexpr int THREADS = 64;")],
    "threads_256": [("constexpr int THREADS = 128;", "constexpr int THREADS = 256;")],
    "argmax_only": [("    if (t != 0) return;\n\n    // 3.", "    if (t != 0 || bi >= 0) return;\n\n    // 3."),
                    ("    for (int job = t; job < POINTS * taps_n; job += THREADS) {",
                     "    for (int job = t; job < 0; job += THREADS) {")],
}
DECODE_SAME_BITS = ("taps_by_value", "threads_64", "threads_256")

# D2 (csrc/nms.cu): where its time goes; fewer threads for the bitmask; and
# the first version's sweep, one shared-memory step per candidate, in place
# of the shipped one, which resolves a word of 32 candidates in registers
OLD_SWEEP = """            const int iend = min(32 * w + 32, n);
            for (int i = 32 * w; i < iend; ++i) {
                const bool sup = (cur >> (i & 31)) & 1u;
                if (lane == 0) {
                    keep[i] = !sup;
                    before[i] = kept;
                }
                if (!sup) {
                    const unsigned* row = mask + static_cast<size_t>(i) * words;
                    cur |= row[w];
#pragma unroll
                    for (int s = 0; s < MAX_WORDS / 32; ++s) {
                        const int ww = lane + 32 * s;
                        if (ww > w && ww < words) rem[s] |= row[ww];
                    }
                    ++kept;
                }
            }"""
NEW_SWEEP = """            const int i0 = 32 * w, cnt = min(32, n - i0);
            // lane b holds word w of row i0 + b; the 32 steps run in registers
            const unsigned rw = lane < cnt ? mask[static_cast<size_t>(i0 + lane) * words + w] : 0u;
            unsigned kb = 0u;
#pragma unroll
            for (int b = 0; b < 32; ++b) {
                const unsigned rb = __shfl_sync(0xffffffffu, rw, b);
                if (b < cnt && !((cur >> b) & 1u)) {
                    kb |= 1u << b;
                    cur |= rb;
                }
            }
            if (lane < cnt) {
                keep[i0 + lane] = (kb >> lane) & 1u;
                before[i0 + lane] = kept + __popc(kb & ((1u << lane) - 1u));
            }
            kept += __popc(kb);
            for (unsigned m = kb; m; m &= m - 1) {         // the kept rows' later words
                const unsigned* row = mask + static_cast<size_t>(i0 + __ffs(m) - 1) * words;
#pragma unroll
                for (int s = 0; s < MAX_WORDS / 32; ++s) {
                    const int ww = lane + 32 * s;
                    if (ww > w && ww < words) rem[s] |= row[ww];
                }
            }"""
NMS = {
    "shipped": [],
    "threads_256": [("constexpr int THREADS = 1024;", "constexpr int THREADS = 256;")],
    "threads_512": [("constexpr int THREADS = 1024;", "constexpr int THREADS = 512;")],
    "step_sweep": [(NEW_SWEEP, OLD_SWEEP)],
    "step_sweep_256": [(NEW_SWEEP, OLD_SWEEP),
                       ("constexpr int THREADS = 1024;", "constexpr int THREADS = 256;")],
    "mask_only": [("    if (threadIdx.x < 32) {\n        const int lane",
                   "    if (threadIdx.x == 0) n_kept = 0;\n"
                   "    if (threadIdx.x < 0) {\n        const int lane")],
    "sweep_only": [("    for (int t = threadIdx.x; t < n * words; t += THREADS) {",
                    "    for (int t = threadIdx.x; t < n * words; t += THREADS) {\n"
                    "        if (t >= 0) { mask[t] = 0u; continue; }")],
    "fdividef": [("return __fdiv_rn(inter, den);", "return __fdividef(inter, den);")],
}
NMS_SAME_BITS = ("threads_256", "threads_512", "step_sweep", "step_sweep_256")

HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <vector>
#include "common.cuh"
#include "tc.cuh"
#include "gemm_mma.cuh"
@INCLUDES@

typedef cudaError_t (*Gemm)(const void*, const void*, const float*, const float*, const void*,
                            const void*, void*, int, int, int, int, cudaStream_t);
typedef cudaError_t (*Fwd)(const void*, void*, int, int, int, int, float, cudaStream_t);
typedef cudaError_t (*Bwd)(const void*, const void*, void*, void*, void*, int, int, int, int,
                           float, float, cudaStream_t);

static void fill(void* dev, size_t n, uint32_t seed, float scale) {
    std::vector<uint16_t> h(n);
    uint32_t s = seed;
    for (auto& x : h) {
        s = s * 1664525u + 1013904223u;
        float f = ((s >> 8) / 16777216.0f - 0.5f) * scale;
        uint32_t u;
        memcpy(&u, &f, 4);
        x = (uint16_t)(u >> 16);
    }
    cudaMemcpy(dev, h.data(), n * 2, cudaMemcpyHostToDevice);
}

template <typename F>
static float best_ms(F run) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    if (run() != cudaSuccess || cudaDeviceSynchronize() != cudaSuccess) return -1.f;
    float best = 1e9f;
    for (int w = 0; w < 5; ++w) {
        cudaEventRecord(e0);
        for (int i = 0; i < 50; ++i) run();
        cudaEventRecord(e1);
        cudaEventSynchronize(e1);
        float ms;
        cudaEventElapsedTime(&ms, e0, e1);
        if (ms / 50 < best) best = ms / 50;
    }
    return best;
}

int main() {
    const int B = 64, N = 192, D = 768, H = 12, M = B * N;
    void *qkv, *o, *dO, *dqkv, *st;
    cudaMalloc(&qkv, (size_t)M * 3 * D * 2);
    cudaMalloc(&o, (size_t)M * D * 2);
    cudaMalloc(&dO, (size_t)M * D * 2);
    cudaMalloc(&dqkv, (size_t)M * 3 * D * 4);
    cudaMalloc(&st, (size_t)B * H * 3 * N * 4);
    fill(qkv, (size_t)M * 3 * D, 1, 4.f);
    fill(dO, (size_t)M * D, 2, 0.1f);
    const char* an[] = {@ATTN_NAMES@};
    Fwd af[] = {@ATTN_FWD@};
    Bwd ab[] = {@ATTN_BWD@};
    for (int v = 0; v < (int)(sizeof(af) / sizeof(af[0])); ++v) {
        printf("attention %s forward %.4f\n", an[v],
               best_ms([&] { return af[v](qkv, o, B, N, D, H, 0.125f, 0); }));
        printf("attention %s backward %.4f\n", an[v], best_ms([&] {
                   return ab[v](qkv, dO, o, dqkv, st, B, N, D, H, 0.125f, 0.125f, 0);
               }));
    }
    struct Shape { const char* name; int n, k, epi; } shapes[] = {
        {"qkv", 3 * D, D, 0}, {"proj", D, D, 2}, {"fc1", 4 * D, D, 1}, {"fc2", D, 4 * D, 2}};
    const char* gn[] = {@GEMM_NAMES@};
    int gbn[] = {@GEMM_BN@};
    Gemm gb[] = {@GEMM_BF16@};
    Gemm gq[] = {@GEMM_INT8@};
    for (auto& sh : shapes) {
        void *a, *w, *bias, *res, *out;
        float *sx, *sw, *fb;
        cudaMalloc(&a, (size_t)M * sh.k * 2);
        cudaMalloc(&w, (size_t)sh.n * sh.k * 2);
        cudaMalloc(&bias, sh.n * 2);
        cudaMalloc(&res, (size_t)M * sh.n * 2);
        cudaMalloc(&out, (size_t)M * sh.n * 4);
        cudaMalloc(&sx, M * 4);
        cudaMalloc(&sw, sh.n * 4);
        cudaMalloc(&fb, sh.n * 4);
        fill(a, (size_t)M * sh.k, 3, 4.f);
        fill(w, (size_t)sh.n * sh.k, 4, 0.1f);
        fill(bias, sh.n, 5, 0.2f);
        fill(res, (size_t)M * sh.n, 6, 2.f);
        cudaMemset(sx, 0, M * 4);
        cudaMemset(sw, 0, sh.n * 4);
        cudaMemset(fb, 0, sh.n * 4);
        for (int v = 0; v < (int)(sizeof(gb) / sizeof(gb[0])); ++v) {
            if (sh.n % gbn[v]) continue;
            printf("gemm %s %s bf16 %.4f\n", gn[v], sh.name, best_ms([&] {
                       return gb[v](a, w, nullptr, nullptr, bias, res, out, M, sh.n, sh.k * 2,
                                    sh.epi, 0);
                   }));
            printf("gemm %s %s int8 %.4f\n", gn[v], sh.name, best_ms([&] {
                       return gq[v](a, w, sx, sw, fb, res, out, M, sh.n, sh.k, sh.epi, 0);
                   }));
        }
        cudaFree(a); cudaFree(w); cudaFree(bias); cudaFree(res); cudaFree(out);
        cudaFree(sx); cudaFree(sw); cudaFree(fb);
    }
    return 0;
}
"""


def variant_sources(tmp: str) -> str:
    """Write the variant headers into ``tmp``; returns their #include lines."""
    attn = (kernels.CSRC / "attention_tc.cuh").read_text().replace("#pragma once", "")
    includes = []
    for name, subs in ATTN.items():
        src = attn
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"attention variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        src = (src.replace("namespace attn_tc", f"namespace av_{name}")
               .replace("ATTN_TC_DISPATCH", f"DISPATCH_{name}")
               .replace("attn_tc::", f"av_{name}::"))
        with open(os.path.join(tmp, f"av_{name}.cuh"), "w") as f:
            f.write(src)
        includes.append(f'#include "av_{name}.cuh"')
    gemm = (kernels.CSRC / "gemm_mma.cuh").read_text().replace("#pragma once", "")
    if "constexpr int STAGES = 3;" not in gemm:
        raise RuntimeError("gemm_mma.cuh: no 'constexpr int STAGES = 3;'")
    gemm = (gemm.replace("constexpr int STAGES = 3;", "constexpr int STAGES = 4;")
            .replace("namespace mma_gemm", "namespace gemm_4stages"))
    with open(os.path.join(tmp, "gemm_4stages.cuh"), "w") as f:
        f.write(gemm)
    includes.append('#include "gemm_4stages.cuh"')
    return "\n".join(includes)


def harness_source(includes: str) -> str:
    names = list(ATTN)
    fill = {
        "@INCLUDES@": includes,
        "@ATTN_NAMES@": ", ".join(f'"{n}"' for n in names),
        "@ATTN_FWD@": ", ".join(f"av_{n}::fwd_launch<4>" for n in names),
        "@ATTN_BWD@": ", ".join(f"av_{n}::bwd_launch<4>" for n in names),
        "@GEMM_NAMES@": ", ".join(f'"{g[0]}"' for g in GEMM),
        "@GEMM_BN@": ", ".join(g[2].split(", ")[1] for g in GEMM),
        "@GEMM_BF16@": ", ".join(f"{ns}::launch_tile<false, bf16, bf16, {ns}::Tile<{t}>>"
                                 for _, ns, t in GEMM),
        "@GEMM_INT8@": ", ".join(f"{ns}::launch_tile<true, float, bf16, {ns}::Tile<{t}>>"
                                 for _, ns, t in GEMM),
    }
    src = HARNESS
    for k, v in fill.items():
        src = src.replace(k, v)
    return src


def train_gemm_variants(card: str) -> dict:
    """ms per launch of each TRAIN_GEMM variant (see the module doc)."""
    import ctypes
    import shutil

    import torch
    import chip_smoke as cs

    nvcc = kernels.nvcc_path()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, subs in TRAIN_GEMM.items():
        d = os.path.join(tmp, name)
        shutil.copytree(kernels.CSRC, d)
        path = os.path.join(d, "gemm_wgmma.cuh")
        src = open(path).read()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"training GEMM variant {name}: {old[:40]!r}... not in the source")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(d, "libtrain_block.so")
        procs[name] = (so, subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-I", d, "-o", so,
                                             os.path.join(d, "train_block.cu")]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"training GEMM variant {name} did not build")
        lib = ctypes.CDLL(so)
        for fn in ("evt_train_gemm", "evt_train_gemm_tn2"):
            getattr(lib, fn).argtypes = kernels.SIGNATURES["train_block"][fn]
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {"card": card, "train_gemm_ms": {}}
    for model, D in (("vit_b", 768), ("vit_l", 1024)):
        R, H = cs.SLOTS * 192, 4 * D
        x, y = (torch.randn(R, c, device=dev, generator=gen).bfloat16() for c in (D, H))
        w1 = (torch.randn(H, D, device=dev, generator=gen) * 0.05).bfloat16()
        w2 = (torch.randn(D, H, device=dev, generator=gen) * 0.05).bfloat16()
        b1 = torch.zeros(H, device=dev, dtype=torch.bfloat16)
        o = torch.empty(R, H, device=dev, dtype=torch.bfloat16)
        o2 = torch.empty(R, H, device=dev)
        aux = torch.randn(R, H, device=dev, generator=gen)
        wq = (torch.randn(3 * D, D, device=dev, generator=gen) * 0.05).bfloat16()
        q = torch.randn(R, 3 * D, device=dev, generator=gen).bfloat16()
        p0, p1 = torch.empty(3 * D, D, device=dev, dtype=torch.bfloat16), torch.empty(
            D, D, device=dev, dtype=torch.bfloat16)
        h0, h1 = torch.empty(H, D, device=dev, dtype=torch.bfloat16), torch.empty(
            D, H, device=dev, dtype=torch.bfloat16)
        P = lambda t: None if t is None else t.data_ptr()  # noqa: E731

        def nt(lib, mode, bias=None, out2=None):
            return lambda: lib.evt_train_gemm(P(x), P(w1), R, H, D, D, D, 1, 1, mode, P(bias), None,
                                              None, 1, None, P(o), P(out2), H, stream())

        cases = {
            "nt_fc1": lambda lib: nt(lib, 0),
            "nt_fc1_gelu_save": lambda lib: nt(lib, 3, b1, o2),
            "nn_fc2_gelu_grad": lambda lib: lambda: lib.evt_train_gemm(
                P(x), P(w2), R, H, D, D, H, 0, 1, 4, None, None, None, 1, P(aux), None, P(o2), H,
                stream()),
            "tn_pair_mlp": lambda lib: lambda: lib.evt_train_gemm_tn2(
                P(y), P(x), H, D, P(h0), P(x), P(y), D, H, P(h1), R, 1, stream()),
            "tn_pair_attn": lambda lib: lambda: lib.evt_train_gemm_tn2(
                P(q), P(x), 3 * D, D, P(p0), P(x), P(x), D, D, P(p1), R, 1, stream()),
        }
        for name, lib in libs.items():
            row = out["train_gemm_ms"].setdefault(name, {})
            for case, make in cases.items():
                fn = make(lib)
                if fn():
                    raise RuntimeError(f"training GEMM variant {name} refused {case}")
                row[f"{model}_{case}"] = cs.time_ms(torch, fn)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def build_variants(lib_name: str, variants: dict) -> tuple:
    """Each variant of ``csrc/<lib_name>.cu`` (a list of textual
    substitutions) built into a library of its own, one ``nvcc`` each, all
    at once: ({name: ctypes library}, the temporary directory)."""
    import ctypes
    import shutil

    nvcc = kernels.nvcc_path()
    tmp = tempfile.mkdtemp()
    procs = {}
    for name, subs in variants.items():
        d = os.path.join(tmp, name)
        shutil.copytree(kernels.CSRC, d)
        path = os.path.join(d, f"{lib_name}.cu")
        src = open(path).read()
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"{lib_name} variant {name}: {old[:40]!r}... not in the source")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(d, f"lib{lib_name}.so")
        procs[name] = (so, subprocess.Popen([nvcc, *kernels.NVCC_FLAGS, "-I", d, "-o", so, path]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"{lib_name} variant {name} did not build")
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels.SIGNATURES[lib_name].items():
            getattr(lib, fn).argtypes = argtypes
        libs[name] = lib
    return libs, tmp


def crop_decode_variants(card: str) -> dict:
    """ms of one launch of each SAMPLER variant on the smoke's 1080p frame
    and 64 boxes at bf16, and of each DECODE variant on 64 x 17 bf16 maps
    (``chip_smoke.decode_maps``); whether the variants that keep the
    arithmetic give the shipped bits."""
    import shutil

    import numpy as np
    import torch
    import chip_smoke as cs
    from easy_vitpose_tpu_torch.ops import modulate, sampler

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    H, W = cs.FRAME_HW
    M = cs.SLOTS
    frame = torch.from_numpy(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).to(dev)
    boxes = torch.from_numpy(cs.make_boxes(rng, M, H, W)).to(dev)
    mean_std = sampler._mean_std()
    heat = torch.from_numpy(cs.decode_maps(rng, M)).to(dev).bfloat16()
    _, geo = sampler.crop_normalize(frame, boxes)
    mask = torch.arange(M, device=dev) < M - 4
    taps = modulate.taps_struct(11)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    out = {"card": card}
    for lib_name, variants, same_bits in (("sampler", SAMPLER, SAMPLER_SAME_BITS),
                                          ("decode", DECODE, DECODE_SAME_BITS)):
        libs, tmp = build_variants(lib_name, variants)
        res = {"ms": {}, "issued_ms": {}, "same_bits": {}}
        results = {}
        for name, lib in libs.items():
            if lib_name == "sampler":
                y = torch.empty((M, 256, 192, 3), dtype=torch.bfloat16, device=dev)
                g = torch.empty((M, 8), dtype=torch.int32, device=dev)
                fn = lambda: lib.evt_crop_sample(  # noqa: E731
                    frame.data_ptr(), None, 1, boxes.data_ptr(), g.data_ptr(), y.data_ptr(), M, H, W,
                    256, 192, *mean_std, 1, stream())
            else:
                y = torch.empty((M, 17, 3), dtype=torch.float32, device=dev)
                fn = lambda: lib.evt_decode_keypoints(  # noqa: E731
                    heat.data_ptr(), 1, geo.data_ptr(), mask.data_ptr(), taps, y.data_ptr(),
                    None, M, 17, 64, 48, 5, stream())
            if fn():
                raise RuntimeError(f"{lib_name} variant {name} refused the launch")
            res["ms"][name] = cs.device_ms(torch, fn)
            res["issued_ms"][name] = cs.time_ms(torch, fn)
            results[name] = y
        for name in same_bits:
            res["same_bits"][name] = torch.equal(results[name], results["shipped"])
            if not res["same_bits"][name]:
                res.setdefault("values_differing", {})[name] = int(
                    (results[name] != results["shipped"]).sum())
        out[lib_name] = res
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def nms_variants(card: str) -> dict:
    """ms of one launch of each NMS variant on the candidates of the smoke's
    main-path detector (YOLOv8n/320 at bf16, square, random weights scaled
    on the smoke's 1080p frame: k = 300), by ``chip_smoke.device_ms``; and
    whether the variants that keep the arithmetic give the shipped bits."""
    import shutil

    import numpy as np
    import torch
    import chip_smoke as cs
    from easy_vitpose_tpu_torch.detect import yolo

    dev = torch.device("cuda")
    H, W = cs.FRAME_HW
    frame_np = np.random.default_rng(3).integers(0, 256, (H, W, 3), dtype=np.uint8)
    spec = yolo.YoloSpec("n")
    model = yolo.yolo_params_from_jax(yolo.init_yolo_params(0, spec, frame_np, 320), spec,
                                      torch.bfloat16, dev)
    geom = yolo.letterbox_geometry(H, W, 320)
    boxes, scores, cls = cs.detector_candidates(torch, yolo, model, torch.from_numpy(frame_np)
                                                .to(dev), geom, spec, torch.bfloat16)
    k = boxes.shape[0]
    r, _, _, left, top = geom[:5]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    libs, tmp = build_variants("nms", NMS)
    res = {"card": card, "k": k, "valid": int((scores > 0).sum()), "ms": {}, "same_bits": {}}
    results = {}
    for name, lib in libs.items():
        y = torch.empty((300, 7), dtype=torch.float32, device=dev)
        fn = lambda: lib.evt_nms(boxes.data_ptr(), scores.data_ptr(), cls.data_ptr(),  # noqa: E731
                                 y.data_ptr(), 1, k, 300, 0.7, 1, float(left), float(top), r,
                                 stream())
        if fn():
            raise RuntimeError(f"nms variant {name} refused the launch")
        res["ms"][name] = cs.device_ms(torch, fn)
        results[name] = y
    for name in NMS_SAME_BITS:
        res["same_bits"][name] = torch.equal(results[name], results["shipped"])
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def adam_q8_variants(card: str) -> dict:
    """ms of one table launch of each ADAM_Q8 variant (see the module doc)."""
    import shutil

    import torch
    import chip_smoke as cs
    from easy_vitpose_tpu_torch.configs import get_model_config
    from easy_vitpose_tpu_torch.models.vitpose import init_params
    from easy_vitpose_tpu_torch.train import fused_opt as fo

    libs, tmp = build_variants("adam_q8", ADAM_Q8)
    dev = torch.device("cuda")
    kernels.build(["adam", "adam_q8"])
    model = init_params(get_model_config("coco", "l"), 0).to(dev)
    ps = [p.detach().float().contiguous() for p in model.parameters()]
    del model
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda p: torch.randn(p.shape, generator=gen, device=dev) * 1e-3  # noqa: E731
    gs = [rnd(p) for p in ps]
    mq, ms, nq, ns = (list(c) for c in zip(*[(*fo.q8_encode(rnd(p), 127),
                                               *fo.q8_encode(rnd(p).abs(), 255)) for p in ps]))
    tab, _, _ = fo._prepare(ps, (gs, ps, mq, ms, nq, ns), fo.Q8_IN, fo.Q8_OUT)
    scal = torch.tensor([0.37, cs.TRAIN_LR, 1 - 0.9 ** 7, 1 - 0.999 ** 7], device=dev)
    args = (tab.t.data_ptr(), tab.leaves, tab.units, scal.data_ptr(), fo.B1, 1.0 - fo.B1, fo.B2,
            1.0 - fo.B2, fo.EPS, fo.Q8_LN_EPS, fo.Q8_INV_LN_EPS, fo.q8_inv_steps(127),
            fo.q8_inv_steps(255), fo.Q8_TINY, fo.Q8_ZERO_BELOW)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    n = sum(p.numel() for p in ps)
    out = {"card": card, "leaves": len(ps), "parameters": n, "adam_q8_table_ms": {}}
    for name, lib in libs.items():
        fn = lambda: lib.evt_adam_q8_table(*args, stream())  # noqa: E731
        if fn():
            raise RuntimeError(f"K9 variant {name} refused the launch")
        out["adam_q8_table_ms"][name] = cs.time_ms(torch, fn)
    out["tb_s_at_16_bytes"] = {k: 16.0 * n / (v * 1e-3) / 1e12
                               for k, v in out["adam_q8_table_ms"].items()}
    del tab, mq, ms, nq, ns
    mu, nu = [rnd(p) for p in ps], [rnd(p).square() for p in ps]
    tab8, _, _ = fo._prepare(ps, (gs, mu, nu, ps), fo.F32_IN, fo.F32_OUT)
    out["adam_table_ms"] = cs.time_ms(torch, lambda: fo._launch_adam(tab8, scal))
    out["adam_tb_s_at_28_bytes"] = 28.0 * n / (out["adam_table_ms"] * 1e-3) / 1e12
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--train-gemm", action="store_true",
                    help="time the training GEMM's variants instead")
    ap.add_argument("--adam-q8", action="store_true",
                    help="time the variants of K9's body instead")
    ap.add_argument("--crop-decode", action="store_true",
                    help="time the variants of the crop kernel (K3) and the decode instead")
    ap.add_argument("--nms", action="store_true",
                    help="time the variants of the NMS kernel (D2) instead")
    args = ap.parse_args()
    if args.train_gemm or args.adam_q8 or args.crop_decode or args.nms:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        line = json.dumps(train_gemm_variants(card) if args.train_gemm else
                          adam_q8_variants(card) if args.adam_q8 else
                          nms_variants(card) if args.nms else
                          crop_decode_variants(card))
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
        return
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "harness.cu")
        with open(cu, "w") as f:
            f.write(harness_source(variant_sources(tmp)))
        exe = os.path.join(tmp, "harness")
        subprocess.run([kernels.nvcc_path(), *flags, "-I", str(kernels.CSRC), "-I", tmp,
                        "-o", exe, cu], check=True)
        lines = subprocess.run([exe], check=True, capture_output=True,
                               text=True).stdout.splitlines()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "attention_ms": {}, "gemm_ms": {}}
    for line in lines:
        m = re.match(r"attention (\S+) (forward|backward) (\S+)", line)
        if m:
            out["attention_ms"].setdefault(m[1], {})[m[2]] = float(m[3])
            continue
        m = re.match(r"gemm (\S+) (\S+) (bf16|int8) (\S+)", line)
        if m:
            out["gemm_ms"].setdefault(m[1], {})[f"{m[2]}_{m[3]}"] = float(m[4])
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
