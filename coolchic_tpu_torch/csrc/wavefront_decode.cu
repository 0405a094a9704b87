// Wavefront range decode of `tpu`-profile latent grids on NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel coolchic_tpu/ops/pallas_decode.py
// (`_make_kernel`, built and launched by `_build` through pl.pallas_call):
// same function, bit for bit (the integer CDF of bitstream/tpu_cdf.py, the
// int32 X.8 ARM, 128 constriction-compatible range-decoder streams).
//
// What bounds it. A grid is decoded over D = (w-1) + (h-1)*step + 1 serial
// wavefronts (3834 at 512x768); at each, each of the 128 streams decodes at
// most one pixel, and the next wavefront needs its symbols. The bytes moved
// take microseconds; the time is D times the time of one wavefront. With
// one thread per stream (the first design, 2.4x as slow; PERF.md) a
// wavefront was one warp per SM sub-partition running ~2000 dependent
// instructions (an X.8 ARM of serial 20-term dot products, nine serial
// evaluations of the CDF in 64-bit arithmetic, a u64 division), so every
// instruction paid its full latency. This design spreads a stream over a
// team of threads, so that a wavefront is bound by the instructions the
// sub-partitions issue (most of them the ARM's multiply-adds and the CDF
// evaluations) and by the lockstep of the one barrier per wavefront, not by
// one thread's latency:
//
//   * a team of T threads (-DWFD_TEAM, 4 or 8) per stream, in one warp: the
//     CTA is 128*T threads, one per grid. stream = threadIdx.x / T; the ring
//     lane rotation (stream + dy) & 127 is unchanged. Member m owns the ARM
//     inputs and hidden outputs j*T + m (j < J = ceil(DP/T)): it computes
//     those context values, the J outputs of each hidden layer as J
//     independent accumulators, and its share of the stabiliser and of the
//     last layer (their weights held in registers), which the team sums with
//     __shfl_xor_sync (int32 wrapping adds: any order gives the same
//     certified result). Hidden activations are all-gathered through a
//     per-stream shared-memory row (double buffered, one __syncwarp per
//     layer). The SM holds 4*T warps, so the schedulers interleave them.
//   * hidden weights in shared memory, rows padded (RS words, RS/4 odd) so
//     that the T distinct rows a quarter-warp reads fall in distinct banks;
//     the activation rows likewise (AS).
//   * an 8-ary symbol search: two rounds of 8 cut points (strides 16, 2)
//     spread over the team, each round one evaluation of left_cum per member
//     (two at T = 4) and a popcount of the team's ballot; a third round
//     evaluates left_cum at base, base+1, base+2 and gives the symbol, `left`
//     and `prob` by shuffles. Three serial evaluations instead of nine.
//   * left_cum on 32-bit operands: every product is one 32x32->64 multiply,
//     and a Horner step is one 64-bit multiply-add and one shift (bounds at
//     exp2_neg24_32 and left_cum_32 in tpu_cdf.cuh, proved by the CPU tests).
//   * the quantile by an FP64 reciprocal estimate, corrected exactly with
//     two integer multiply-compares (bounds at quantile(), tpu_cdf.cuh); it
//     depends only on the coder state, so it overlaps the context and the ARM.
//   * loads off the chain: the IFCE context of wavefront d+1 is loaded into
//     registers during wavefront d; the next refill word is always already
//     in a register; the taps' ring offsets, lanes and bounds live in
//     registers, and a context value is chosen without branches (an IFCE
//     int16 is sign-extended by one prmt); the row range of a wavefront is
//     advanced by counters, not divisions.
//   * a warp whose streams are all idle at a wavefront skips the decode.
//
// Kept from that first design: one __syncthreads() per wavefront, the int8
// shared-memory ring of the last RING (>= OFFMAX + 1) wavefronts, the ARM
// width padded with zero weights to DP (a multiple of 4, -DWFD_DP; exact),
// u64 coder state, direct word loads (zero past the end), symbols written
// straight to out[g][y][x]. One CTA per grid still leaves most SMs idle at
// a small batch; spreading a grid over a cluster is later work.
//
// -DWFD_ABLATE=<bits> stubs parts for timing only (the decode is then
// garbage; chip_smoke.py's timing phase is the only builder): 1 taps (the
// context becomes d ^ k, no ring or IFCE reads), 2 ARM (mu and log-scale from
// two context values), 4 division (quantile from the point's low bits),
// 8 search (symbol from the quantile, fixed left and prob), 16 refill (the
// refill word from the point, no load); the JAX package's _ABLATE knob has
// the same parts. 32 barrier (a __syncwarp in place of the wavefront's
// __syncthreads: the warps drift apart, which shows what the lockstep costs).
//
// Built by ops/wavefront_decode.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -DWFD_DP=<DP> -DWFD_TEAM=<T>
// into a plain shared library; wavefront_decode_launch is bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "tpu_cdf.cuh"

#ifndef WFD_DP
#error "build with -DWFD_DP=<padded ARM width, a multiple of 4>"
#endif
#ifndef WFD_TEAM
#error "build with -DWFD_TEAM=<threads per stream, 4 or 8>"
#endif
#ifndef WFD_ABLATE
#define WFD_ABLATE 0
#endif

namespace {

using namespace tpu_decode;

constexpr int ABLATE = WFD_ABLATE;
constexpr int DP = WFD_DP;
constexpr int T = WFD_TEAM;
static_assert(DP % 4 == 0 && DP >= 4 && DP <= 64, "DP must be a multiple of 4 in [4, 64]");
static_assert(T == 4 || T == 8, "a team is 4 or 8 threads");
constexpr int LANES = 128;
constexpr int THREADS = LANES * T;
constexpr unsigned TEAM_BITS = (1u << T) - 1;
constexpr int J = (DP + T - 1) / T;       // ARM inputs / hidden outputs per member
constexpr int OP = J * T;                 // hidden outputs, padded (zero rows)
constexpr int RS = odd4(DP);              // weight row stride (words)
constexpr int AS = odd4(round4(OP));      // activation row stride (words)
constexpr int ARITY = 8;                  // cut points per search round
constexpr int EVALS = ARITY / T;          // left_cum evaluations per member and round

// Shared-memory layout in 4-byte words, then the int8 ring; must match
// ops/wavefront_decode.py:kernel_smem_bytes.
//   activation rows [2][128][AS], hidden weights [n_hidden][OP][RS] ([out][in]),
//   per-input (stab0, stab1, last0, last1) weights [OP] as int4,
//   hidden biases [n_hidden][OP], (last0 + stab0, last1 + stab1) biases [4],
//   slope [N_POSSIBLE_SCALE], ring [RING][128] (int8).
__host__ __device__ constexpr int smem_words(int n_hidden) {
    return 2 * LANES * AS + n_hidden * OP * RS + 4 * OP + n_hidden * OP + 4
           + N_POSSIBLE_SCALE;
}

__global__ void __launch_bounds__(THREADS)
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
    int32_t* s_act = smem;
    int32_t* s_w = s_act + 2 * LANES * AS;
    int4* s_ls = reinterpret_cast<int4*>(s_w + n_hidden * OP * RS);
    int32_t* s_b = reinterpret_cast<int32_t*>(s_ls + OP);
    int32_t* s_bias2 = s_b + n_hidden * OP;
    uint32_t* s_slope = reinterpret_cast<uint32_t*>(s_bias2 + 4);
    int8_t* ring = reinterpret_cast<int8_t*>(s_slope + N_POSSIBLE_SCALE);

    const int g = blockIdx.x;
    const int tid = threadIdx.x;
    const int stream = tid / T;
    const int mem = tid % T;
    const int team0 = (tid & 31) & ~(T - 1);   // the team's first lane in the warp
    const int step = max(5, (w + LANES - 1) / LANES);
    const int D = (w - 1) + (h - 1) * step + 1;
    const int n_w = n_hidden * dim * dim + dim * 2;
    const int n_b = n_hidden * dim + 2;

    // ---- this grid's parameters, transposed to [out][in] and padded with
    // zeros (exact: padded inputs are 0, padded outputs have zero weights)
    const int n_param_words = smem_words(n_hidden) - N_POSSIBLE_SCALE;
    for (int i = tid; i < n_param_words; i += THREADS) smem[i] = 0;
    for (int i = tid; i < (ring_mask + 1) * LANES; i += THREADS) ring[i] = 0;
    __syncthreads();
    const int32_t* gw = wtr + (size_t)g * n_w;
    const int32_t* gb = btr + (size_t)g * n_b;
    for (int l = 0; l < n_hidden; ++l) {
        for (int j = tid; j < dim * dim; j += THREADS)   // global [in][out]
            s_w[(l * OP + j % dim) * RS + j / dim] = gw[l * dim * dim + j];
        for (int o = tid; o < dim; o += THREADS) s_b[l * OP + o] = gb[l * dim + o];
    }
    int32_t* s_ls32 = reinterpret_cast<int32_t*>(s_ls);
    for (int j = tid; j < dim * 2; j += THREADS) {       // global [in][2]
        s_ls32[4 * (j / 2) + (j % 2)] = stw[(size_t)g * dim * 2 + j];
        s_ls32[4 * (j / 2) + 2 + (j % 2)] = gw[n_hidden * dim * dim + j];
    }
    if (tid < 2) s_bias2[tid] = gb[n_hidden * dim + tid] + stb[(size_t)g * 2 + tid];
    for (int i = tid; i < N_POSSIBLE_SCALE; i += THREADS) {
        const uint64_t s = ((uint64_t)SL0 * exp2_neg24_32(i, CSL)) >> PRECISION;
        s_slope[i] = s < 1 ? 1u : (uint32_t)s;
    }

    // ---- this member's inputs k = j*T + mem, held in registers for the
    // whole kernel. A tap (dy, dx): its ring row offset dx + step*dy, ring
    // lane (stream + dy) & 127, dx, and the least row -dy it is valid at. An
    // IFCE input: the offset of its context word in a wavefront's block, and
    // the prmt selector that extracts it (the word, or its low or high int16
    // sign-extended); its row bound is out of reach, so it never reads the
    // ring. A zero input (k >= dim) is an IFCE input whose word is 0.
    int roff[J], rsel[J], rdx[J], rymin[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int k = j * T + mem;
        roff[j] = 0;
        rsel[j] = 0x3210;
        rdx[j] = 0;
        rymin[j] = 1 << 30;
        if (k < n_spatial) {
            const int dy = taps[2 * k], dx = taps[2 * k + 1];
            roff[j] = dx + step * dy;
            rsel[j] = (stream + dy) & (LANES - 1);
            rdx[j] = dx;
            rymin[j] = -dy;
        } else if (k < dim) {
            const int kk = k - n_spatial;
            roff[j] = ((ifce_packed ? kk / 2 : kk) * G + g) * LANES + stream;
            rsel[j] = !ifce_packed ? 0x3210 : (kk & 1) ? 0xBB32 : 0x9910;
        }
    }
    // IFCE words of wavefront d (zero past the end and for taps)
    const size_t ifce_wf = (size_t)ifce_rows * G * LANES;
    auto load_ifce = [&](int d, int32_t (&v)[J]) {
        const int32_t* block = ifce + (size_t)d * ifce_wf;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int k = j * T + mem;
            v[j] = !(ABLATE & 1) && k >= n_spatial && k < dim && d < D ? block[roff[j]] : 0;
        }
    };
    int32_t ifc[J];
    load_ifce(0, ifc);
    __syncthreads();
    // this member's (stab0, stab1, last0, last1) weights, for the whole kernel
    int4 ls[J];
#pragma unroll
    for (int j = 0; j < J; ++j) ls[j] = s_ls[j * T + mem];

    // ---- coder state; the next refill word is always already loaded
    auto word_at = [&](int r) -> uint32_t {
        return r < R ? words[((size_t)r * G + g) * LANES + stream] : 0u;
    };
    uint64_t lower = 0, range = ~0ull;
    uint64_t point = ((uint64_t)word_at(0) << 32) | word_at(1);
    int cur = 2;
    uint32_t next_word = (ABLATE & 16) ? 0u : word_at(cur);

    int32_t* act0 = s_act + stream * AS;
    int32_t* act1 = s_act + (LANES + stream) * AS;
    // rows y_lo..y_hi of wavefront d, advanced by counters: y_hi = min(h-1,
    // d / step) with rem = d - step * (d / step); y_lo = ceil((d - w + 1) /
    // step) with x_lo = d - step * y_lo the column of row y_lo.
    int y_div = 0, rem = 0, y_lo = 0, x_lo = 0;

    for (int d = 0; d < D; ++d) {
        const int y_hi = min(h - 1, y_div);
        const int y = y_lo + ((stream - y_lo) & (LANES - 1));
        const bool active = y <= y_hi;
        const int x = d - step * y;
        int sym = 0;
        const bool busy = __any_sync(FULL, active);
        const uint64_t scale = range >> PRECISION;
        uint32_t quant = 0;
        int32_t c[J];

        if (busy) {
            // ---- the quantile depends on the coder state only
            quant = (ABLATE & 4) ? (uint32_t)point & QMAX : quantile(point - lower, scale);

            // ---- this member's context values (X.8), without branches
#pragma unroll
            for (int j = 0; j < J; ++j) {
                if (ABLATE & 1) {
                    c[j] = d ^ (j * T + mem);
                    continue;
                }
                const bool tap_ok = y >= rymin[j] && (unsigned)(x + rdx[j]) < (unsigned)w;
                int32_t s8 = 0;
                if (tap_ok) s8 = ring[((d + roff[j]) & ring_mask) * LANES + rsel[j]];
                c[j] = tap_ok ? s8 * 256 : prmt_sext(ifc[j], rsel[j]);
            }
        }
        // the IFCE words of the next wavefront, a wavefront ahead of use
        load_ifce(d + 1, ifc);

        if (busy) {
            int mu_raw, ls_raw;
            if (ABLATE & 2) {   // every context value stays live
                int32_t mix = 0;
#pragma unroll
                for (int j = 0; j < J; ++j) mix ^= c[j];
                mu_raw = __shfl_sync(FULL, mix, team0) >> 6;
                ls_raw = __shfl_sync(FULL, mix, team0 + 1) >> 8;
            } else {
                // ---- int32 X.8 ARM (certified overflow-free by the encoder:
                // every partial sum of a layer is bounded by the certified
                // sum of absolute terms, so any order is exact)
                int32_t p0 = 0, p1 = 0;
#pragma unroll
                for (int j = 0; j < J; ++j) {      // stabiliser share
                    p0 += ls[j].x * c[j];
                    p1 += ls[j].y * c[j];
                }
                if (n_hidden > 0) {
#pragma unroll
                    for (int j = 0; j < J; ++j) act0[j * T + mem] = c[j];
                    __syncwarp();
                }
#pragma unroll 1
                for (int l = 0; l < n_hidden; ++l) {
                    const int4* a4 = reinterpret_cast<const int4*>((l & 1) ? act1 : act0);
                    const int32_t* wl = s_w + l * OP * RS;
                    int32_t acc[J];
#pragma unroll
                    for (int j = 0; j < J; ++j) acc[j] = s_b[l * OP + j * T + mem];
                    // unrolled by 2 only: a full unroll hoists every weight
                    // load of the layer and spills registers
#pragma unroll 2
                    for (int i4 = 0; i4 < DP / 4; ++i4) {
                        const int4 a = a4[i4];
#pragma unroll
                        for (int j = 0; j < J; ++j) {
                            const int4 w4 =
                                reinterpret_cast<const int4*>(wl + (j * T + mem) * RS)[i4];
                            acc[j] += w4.x * a.x + w4.y * a.y + w4.z * a.z + w4.w * a.w;
                        }
                    }
#pragma unroll
                    for (int j = 0; j < J; ++j) c[j] = max(acc[j], 0) >> 8;
                    if (l + 1 < n_hidden) {
                        int32_t* nxt = (l & 1) ? act0 : act1;
#pragma unroll
                        for (int j = 0; j < J; ++j) nxt[j * T + mem] = c[j];
                        __syncwarp();
                    }
                }
#pragma unroll
                for (int j = 0; j < J; ++j) {      // last-layer share
                    p0 += ls[j].z * c[j];
                    p1 += ls[j].w * c[j];
                }
#pragma unroll
                for (int off = T / 2; off >= 1; off >>= 1) {
                    p0 += __shfl_xor_sync(FULL, p0, off);
                    p1 += __shfl_xor_sync(FULL, p1, off);
                }
                mu_raw = (p0 + s_bias2[0]) >> 8;   // arithmetic: X.16 -> X.8
                ls_raw = (p1 + s_bias2[1]) >> 8;
            }
            const int mu_fp = min(max(mu_raw - MU_MIN_FP, 0), N_POSSIBLE_MU - 1) + MU_MIN_FP;
            const uint32_t slope =
                s_slope[min(max(ls_raw - LOG_SCALE_MIN_FP, 0), N_POSSIBLE_SCALE - 1)];

            // ---- symbol k = s - SYM_MIN: max k with left_cum <= quant
            uint32_t left, prob;
            int k;
            if (ABLATE & 8) {
                k = (int)(((quant ^ (uint32_t)mu_fp ^ slope) >> 17) & 127);
                left = quant & 0xFFFF;
                prob = 4096;
            } else {
                // two 8-ary rounds narrow [0, 127] to [base, base + 1]; cut
                // point i of a round is base + i * st (i = 0 always passes)
                int base = 0;
#pragma unroll
                for (int st = N_SYM / ARITY; st >= 2; st /= ARITY) {
                    int cnt = 0;
#pragma unroll
                    for (int e = 0; e < EVALS; ++e) {
                        const bool le =
                            left_cum_32(base + (e * T + mem) * st, mu_fp, slope) <= quant;
                        cnt += __popc((__ballot_sync(FULL, le) >> team0) & TEAM_BITS);
                    }
                    base += (cnt - 1) * st;
                }
                // left_cum at base, base + 1, base + 2 (members 0, 1, 2)
                const uint32_t v = left_cum_32(min(base + mem, N_SYM - 1), mu_fp, slope);
                const int up = (__ballot_sync(FULL, v <= quant) >> (team0 + 1)) & 1;
                k = base + up;
                left = __shfl_sync(FULL, v, team0 + up);
                const uint32_t nxt = __shfl_sync(FULL, v, team0 + up + 1);
                prob = k == N_SYM - 1 ? (1u << PRECISION) - left : nxt - left;
            }

            // ---- advance and renormalise
            if (active) {
                lower += mul_scale(left, scale);
                range = mul_scale(prob, scale);
                if (range < (1ull << 32)) {
                    lower <<= 32;
                    range <<= 32;
                    point = (point << 32)
                            | ((ABLATE & 16) ? (uint32_t)(point ^ (point >> 32)) : next_word);
                    ++cur;
                    if (!(ABLATE & 16)) next_word = word_at(cur);
                }
                sym = k + SYM_MIN;
                if (mem == 0) out[((size_t)g * h + y) * w + x] = sym;
            }
        }
        if (mem == 0) ring[(d & ring_mask) * LANES + stream] = (int8_t)sym;

        // advance the row range to wavefront d + 1
        if (++rem == step) {
            rem = 0;
            ++y_div;
        }
        if (++x_lo == w) {
            x_lo -= step;
            ++y_lo;
        }
        if (ABLATE & 32) {
            __syncwarp();
        } else {
            __syncthreads();
        }
    }
}

}  // namespace

// Launches one CTA of 128 * T threads per grid on `stream`. Returns the
// cudaError_t of the launch (0 on success), or -1 when dim_padded or team
// is not this build's DP or T, or the shared memory does not fit. The
// kernel's shared-memory limit is raised once per library.
extern "C" int wavefront_decode_launch(
    const void* words, const void* wtr, const void* btr, const void* stw,
    const void* stb, const void* ifce, const void* taps, void* out, int h, int w,
    int G, int R, int n_spatial, int ifce_rows, int ifce_packed, int dim,
    int n_hidden, int dim_padded, int team, int ring_rows, void* stream) {
    if (dim_padded != DP || team != T || dim > DP) return -1;
    const size_t smem = 4 * (size_t)smem_words(n_hidden) + (size_t)ring_rows * LANES;
    if (smem > (size_t)SMEM_LIMIT) return -1;
    static const cudaError_t attr_err = cudaFuncSetAttribute(
        wavefront_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (attr_err != cudaSuccess) return (int)attr_err;
    wavefront_decode_kernel<<<G, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wtr),
        static_cast<const int32_t*>(btr), static_cast<const int32_t*>(stw),
        static_cast<const int32_t*>(stb), static_cast<const int32_t*>(ifce),
        static_cast<const int32_t*>(taps), static_cast<int32_t*>(out), h, w, G, R,
        n_spatial, ifce_rows, ifce_packed, dim, n_hidden, ring_rows - 1);
    return (int)cudaGetLastError();
}
