// The first design of the wavefront range decode (one thread per stream),
// kept as the "before" yardstick of the timing phase of chip_smoke.py. The
// main path runs csrc/wavefront_decode.cu; this file is built only for that
// timing phase, with the same -DWFD_ABLATE bits as the new design (see
// there): 1 taps, 2 ARM, 4 division, 8 search, 16 refill, 32 barrier. An
// ablated build decodes garbage and exists for timing only.
//
// Wavefront range decode of `tpu`-profile latent grids on NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel coolchic_tpu/ops/pallas_decode.py
// (`_make_kernel`, built and launched by `_build` through pl.pallas_call):
// same function, bit for bit (the integer CDF of bitstream/tpu_cdf.py, the
// int32 X.8 ARM, 128 constriction-compatible range-decoder streams).
//
// Design (simple first):
//   * one CTA per grid, 128 threads, thread = stream = lane (stream of pixel
//     (y, x) is y mod 128). Wavefront d holds the pixels with x + step*y = d;
//     each thread decodes at most one of them per wavefront.
//   * coder state (lower, range, point, word cursor) in native u64
//     registers: scale < 2^40 and left/prob < 2^24, so every product fits.
//     The TPU kernel's u32-pair helpers are not needed.
//   * the last RING (>= OFFMAX + 1) wavefronts of decoded symbols in a
//     shared-memory ring of int8 (symbols are in [-64, 63]). Tap (dy, dx)
//     of lane l reads ring row (d + dx + step*dy) and lane (l + dy) & 127,
//     the TPU kernel's pltpu.roll(row, -dy). One __syncthreads() per
//     wavefront separates a wavefront's stores from the next one's reads.
//   * the grid's ARM weights, the 2561-entry slope table and the taps live
//     in shared memory, loaded once; every thread reads the same weight at
//     the same time (a broadcast). The ARM width is padded with zero
//     weights to DP, a multiple of 4 fixed at build time (-DWFD_DP=...),
//     which is exact.
//   * word refill is a direct load words[cur][g][lane] (zero past the end);
//     IFCE context reads ifce[d][k][g][lane] are coalesced across the CTA.
//   * symbols are written straight to out[g][y][x].
//
// What bounds it: the serial chain of D = (w-1) + (h-1)*step + 1 dependent
// wavefronts (3834 at 512x768), each a few thousand dependent integer
// instructions per thread (the X.8 ARM's multiply-adds, a 7-step search of
// the integer CDF, one u64 division). The bytes it moves take microseconds.
// One CTA per grid uses G of the 132 SMs (8 at the serving batch): the
// kernel is latency-bound by design here, and PERF.md records its time.
//
// Built by ops/wavefront_decode.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -DWFD_DP=<DP>
// into a plain shared library; wavefront_decode_launch is bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#ifndef WFD_DP
#error "build with -DWFD_DP=<padded ARM width, a multiple of 4>"
#endif
#ifndef WFD_ABLATE
#define WFD_ABLATE 0
#endif

namespace {

constexpr int ABLATE = WFD_ABLATE;
constexpr int DP = WFD_DP;
static_assert(DP % 4 == 0 && DP >= 4 && DP <= 64, "DP must be a multiple of 4 in [4, 64]");
constexpr int LANES = 128;
constexpr int PRECISION = 24;
constexpr int SYM_MIN = -64;
constexpr int SYM_MAX = 63;
constexpr int LEAK_STEP = 16;
constexpr uint32_t FREE_WEIGHT = (1u << PRECISION) - 1 - uint32_t(SYM_MAX - SYM_MIN) * LEAK_STEP;
constexpr int MU_MIN_FP = -64 * 256;
constexpr int LOG_SCALE_MIN_FP = -5 * 256;
constexpr int N_POSSIBLE_MU = 32768;
constexpr int N_POSSIBLE_SCALE = 2561;
constexpr uint64_t CSL = 94548;
constexpr uint64_t SL0 = 14032236;

// exp2(-t / 2^24) in X.24 (tpu_cdf.exp2_neg24): degree-6 integer Horner with
// arithmetic (floor) shifts; every intermediate |r * f| < 2^49. The final
// shift by q <= 40 is done in u64 (a u32 shift by >= 32 is undefined).
__device__ __forceinline__ uint32_t exp2_neg24(uint64_t t) {
    uint64_t q = t >> PRECISION;
    if (q > 40) q = 40;
    const long long f = (long long)(t & ((1u << PRECISION) - 1));
    long long r = 1835;
    r = -21395 + ((r * f) >> PRECISION);
    r = 160710 + ((r * f) >> PRECISION);
    r = -930970 + ((r * f) >> PRECISION);
    r = 4030290 + ((r * f) >> PRECISION);
    r = -11629077 + ((r * f) >> PRECISION);
    r = 16777216 + ((r * f) >> PRECISION);
    if (r < 0) r = 0;
    if (r > (1 << PRECISION)) r = 1 << PRECISION;
    return (uint32_t)((uint64_t)r >> q);
}

__device__ __forceinline__ uint32_t left_cum(int s, int mu_fp, uint32_t slope) {
    if (s <= SYM_MIN) return 0;
    const int m = s * 256 - 128 - mu_fp;
    const uint64_t am = (uint64_t)(m < 0 ? -m : m);
    const uint32_t half = exp2_neg24(am * slope) >> 1;
    const uint32_t cdf = m < 0 ? half : (1u << PRECISION) - half;
    return (uint32_t)(((uint64_t)FREE_WEIGHT * cdf) >> PRECISION)
           + (uint32_t)(s - SYM_MIN) * LEAK_STEP;
}

// Shared-memory layout, in 4-byte words then the int8 ring; must match
// ops/wavefront_decode.py:kernel_smem_bytes. Weights are stored [out][in]
// (rows of DP, 16-byte aligned) so a row is read as int4.
//   hidden weights [n_hidden][DP][DP], hidden biases [n_hidden][DP],
//   last weights [2][DP], last biases [2], stab weights [2][DP], stab biases [2],
//   slope [N_POSSIBLE_SCALE], tap offset / dy / dx [DP] each,
//   per-thread layer outputs [DP][128], ring [RING][128] (int8).
__global__ void __launch_bounds__(LANES)
wavefront_decode_kernel(const uint32_t* __restrict__ words,   // [R, G, 128]
                        const int32_t* __restrict__ wtr,      // [G, n_w]
                        const int32_t* __restrict__ btr,      // [G, n_b]
                        const int32_t* __restrict__ stw,      // [G, dim*2]
                        const int32_t* __restrict__ stb,      // [G, 2]
                        const int32_t* __restrict__ ifce,     // [D, rows, G, 128]
                        const int32_t* __restrict__ taps,     // [n_spatial][2] (dy, dx)
                        int32_t* __restrict__ out,            // [G, h, w]
                        int h, int w, int G, int R, int n_spatial, int ifce_rows,
                        int ifce_packed, int dim, int n_hidden, int ring_mask) {
    extern __shared__ int4 smem4[];
    int32_t* smem = reinterpret_cast<int32_t*>(smem4);
    int32_t* s_w = smem;
    int32_t* s_b = s_w + n_hidden * DP * DP;
    int32_t* s_wl = s_b + n_hidden * DP;
    int32_t* s_bl = s_wl + 2 * DP;
    int32_t* s_sw = s_bl + 2;
    int32_t* s_sb = s_sw + 2 * DP;
    uint32_t* s_slope = reinterpret_cast<uint32_t*>(s_sb + 2);
    int32_t* s_toff = reinterpret_cast<int32_t*>(s_slope + N_POSSIBLE_SCALE);
    int32_t* s_tdy = s_toff + DP;
    int32_t* s_tdx = s_tdy + DP;
    int32_t* s_act = s_tdx + DP;
    int8_t* ring = reinterpret_cast<int8_t*>(s_act + DP * LANES);

    const int g = blockIdx.x;
    const int lane = threadIdx.x;
    const int step = max(5, (w + LANES - 1) / LANES);
    const int D = (w - 1) + (h - 1) * step + 1;
    const int n_w = n_hidden * dim * dim + dim * 2;
    const int n_b = n_hidden * dim + 2;

    // ---- load this grid's parameters, transposed to [out][in] and padded
    // with zeros to DP (exact: padded inputs are 0, padded outputs unused)
    const int n_param_words = n_hidden * DP * DP + n_hidden * DP + 4 * DP + 4;
    for (int i = lane; i < n_param_words; i += LANES) smem[i] = 0;
    for (int i = lane; i < (ring_mask + 1) * LANES; i += LANES) ring[i] = 0;
    __syncthreads();
    const int32_t* gw = wtr + (size_t)g * n_w;
    const int32_t* gb = btr + (size_t)g * n_b;
    for (int l = 0; l < n_hidden; ++l) {
        for (int j = lane; j < dim * dim; j += LANES)   // global [in][out]
            s_w[(l * DP + j % dim) * DP + j / dim] = gw[l * dim * dim + j];
        for (int o = lane; o < dim; o += LANES) s_b[l * DP + o] = gb[l * dim + o];
    }
    for (int j = lane; j < dim * 2; j += LANES) {       // global [in][2]
        s_wl[(j % 2) * DP + j / 2] = gw[n_hidden * dim * dim + j];
        s_sw[(j % 2) * DP + j / 2] = stw[(size_t)g * dim * 2 + j];
    }
    if (lane < 2) {
        s_bl[lane] = gb[n_hidden * dim + lane];
        s_sb[lane] = stb[(size_t)g * 2 + lane];
    }
    for (int i = lane; i < N_POSSIBLE_SCALE; i += LANES) {
        const uint64_t s = ((uint64_t)SL0 * exp2_neg24((uint64_t)i * CSL)) >> PRECISION;
        s_slope[i] = s < 1 ? 1u : (uint32_t)s;
    }
    if (lane < n_spatial) {
        const int dy = taps[2 * lane], dx = taps[2 * lane + 1];
        s_tdy[lane] = dy;
        s_tdx[lane] = dx;
        s_toff[lane] = dx + step * dy;
    }
    __syncthreads();

    // ---- coder state
    auto word_at = [&](int r) -> uint64_t {
        return r < R ? (uint64_t)words[((size_t)r * G + g) * LANES + lane] : 0ull;
    };
    auto refill_word = [&](int r, uint64_t p) -> uint64_t {
        return (ABLATE & 16) ? (uint32_t)(p ^ (p >> 32)) : word_at(r);
    };
    uint64_t lower = 0, range = ~0ull;
    uint64_t point = (word_at(0) << 32) | word_at(1);
    int cur = 2;

    for (int d = 0; d < D; ++d) {
        const int y_lo = max(0, (d - w + step) / step);
        const int y_hi = min(h - 1, d / step);
        const int y = y_lo + ((lane - y_lo) & (LANES - 1));
        const bool active = y <= y_hi;
        const int x = d - step * y;
        int sym = 0;

        if (active) {
            // ---- context: spatial taps (X.8), then the raw X.8 IFCE context
            int32_t ctx[DP];
#pragma unroll
            for (int k = 0; k < DP; ++k) {
                int32_t v = 0;
                if (ABLATE & 1) {
                    v = d ^ k;
                } else if (k < n_spatial) {
                    const int yk = y + s_tdy[k], xk = x + s_tdx[k];
                    if (yk >= 0 && xk >= 0 && xk < w)
                        v = (int32_t)ring[((d + s_toff[k]) & ring_mask) * LANES
                                          + ((lane + s_tdy[k]) & (LANES - 1))] * 256;
                } else if (k < dim) {
                    const int kk = k - n_spatial;
                    if (ifce_packed) {
                        const int32_t p =
                            ifce[(((size_t)d * ifce_rows + kk / 2) * G + g) * LANES + lane];
                        v = (kk & 1) ? (p >> 16) : (int32_t)(int16_t)(p & 0xFFFF);
                    } else {
                        v = ifce[(((size_t)d * ifce_rows + kk) * G + g) * LANES + lane];
                    }
                }
                ctx[k] = v;
            }

            // ---- int32 X.8 ARM (certified overflow-free by the encoder);
            // a hidden layer's outputs go through this thread's s_act column
            int32_t st0 = s_sb[0], st1 = s_sb[1];
            int32_t mu_raw = s_bl[0], ls_raw = s_bl[1];
#pragma unroll
            for (int i = 0; i < DP; ++i) {
                st0 += s_sw[i] * ctx[i];
                st1 += s_sw[DP + i] * ctx[i];
            }
            for (int l = 0; l < ((ABLATE & 2) ? 0 : n_hidden); ++l) {
#pragma unroll 1
                for (int o = 0; o < dim; ++o) {
                    const int4* wrow = reinterpret_cast<const int4*>(s_w + (l * DP + o) * DP);
                    int32_t acc = s_b[l * DP + o];
#pragma unroll
                    for (int i4 = 0; i4 < DP / 4; ++i4) {
                        const int4 w4 = wrow[i4];
                        acc += w4.x * ctx[4 * i4] + w4.y * ctx[4 * i4 + 1]
                               + w4.z * ctx[4 * i4 + 2] + w4.w * ctx[4 * i4 + 3];
                    }
                    s_act[o * LANES + lane] = max(acc, 0) >> 8;
                }
#pragma unroll
                for (int i = 0; i < DP; ++i) ctx[i] = i < dim ? s_act[i * LANES + lane] : 0;
            }
#pragma unroll
            for (int i = 0; i < DP; ++i) {
                mu_raw += s_wl[i] * ctx[i];
                ls_raw += s_wl[DP + i] * ctx[i];
            }
            mu_raw = (mu_raw + st0) >> 8;   // arithmetic: X.16 -> X.8
            ls_raw = (ls_raw + st1) >> 8;
            if (ABLATE & 2) {   // every context value stays live
                int32_t x = 0;
#pragma unroll
                for (int i = 0; i < DP; ++i) x ^= ctx[i] << (i & 7);
                mu_raw = x >> 6;
                ls_raw = x >> 8;
            }

            const int mu_fp = min(max(mu_raw - MU_MIN_FP, 0), N_POSSIBLE_MU - 1) + MU_MIN_FP;
            const uint32_t slope =
                s_slope[min(max(ls_raw - LOG_SCALE_MIN_FP, 0), N_POSSIBLE_SCALE - 1)];

            // ---- quantile (point - lower) / (range >> 24), clamped to 2^24 - 1
            // (equal to the TPU kernel's 25-step restoring division)
            const uint64_t scale = range >> PRECISION;
            uint64_t q = (ABLATE & 4) ? point : (point - lower) / scale;
            if (ABLATE & 4) q &= (1u << PRECISION) - 1;
            if (q > (1u << PRECISION) - 1) q = (1u << PRECISION) - 1;
            const uint32_t quant = (uint32_t)q;

            // ---- 7-step binary search: max s with left_cum(s) <= quant
            int s = SYM_MIN;
            uint32_t left, prob;
            if (ABLATE & 8) {
                s = (int)(((quant ^ (uint32_t)mu_fp ^ slope) >> 17) & 127) + SYM_MIN;
                left = quant & 0xFFFF;
                prob = 4096;
            } else {
#pragma unroll 1
                for (int st = 64; st >= 1; st >>= 1) {
                    const int cand = s + st;
                    if (cand <= SYM_MAX && left_cum(cand, mu_fp, slope) <= quant) s = cand;
                }
                left = left_cum(s, mu_fp, slope);
                prob = s >= SYM_MAX ? (1u << PRECISION) - left
                                    : left_cum(s + 1, mu_fp, slope) - left;
            }

            // ---- advance and renormalise
            lower += scale * left;
            range = scale * prob;
            if (range < (1ull << 32)) {
                lower <<= 32;
                range <<= 32;
                point = (point << 32) | refill_word(cur, point);
                ++cur;
            }
            sym = s;
            out[((size_t)g * h + y) * w + x] = s;
        }
        ring[(d & ring_mask) * LANES + lane] = (int8_t)sym;
        if (ABLATE & 32) {
            __syncwarp();
        } else {
            __syncthreads();
        }
    }
}

}  // namespace

// Launches one CTA per grid on `stream`. Returns the cudaError_t of the
// launch (0 on success), or -1 when dim_padded is not this build's DP.
extern "C" int wavefront_decode_launch(
    const void* words, const void* wtr, const void* btr, const void* stw,
    const void* stb, const void* ifce, const void* taps, void* out, int h, int w,
    int G, int R, int n_spatial, int ifce_rows, int ifce_packed, int dim,
    int n_hidden, int dim_padded, int ring_rows, void* stream) {
    if (dim_padded != DP || dim > DP) return -1;
    const size_t smem = 4 * (size_t)(n_hidden * DP * DP + n_hidden * DP + 4 * DP + 4
                                     + N_POSSIBLE_SCALE + 3 * DP + DP * LANES)
                        + (size_t)ring_rows * LANES;
    cudaError_t err = cudaFuncSetAttribute(wavefront_decode_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    wavefront_decode_kernel<<<G, LANES, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wtr),
        static_cast<const int32_t*>(btr), static_cast<const int32_t*>(stw),
        static_cast<const int32_t*>(stb), static_cast<const int32_t*>(ifce),
        static_cast<const int32_t*>(taps), static_cast<int32_t*>(out), h, w, G, R,
        n_spatial, ifce_rows, ifce_packed, dim, n_hidden, ring_rows - 1);
    return (int)cudaGetLastError();
}
