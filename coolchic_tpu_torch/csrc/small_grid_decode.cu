// Range decode of the `tpu`-profile latent grids coded on fewer than 128
// streams (8 or 1: codec.grid_n_streams), on NVIDIA Hopper.
//
// It replaces no TPU kernel: the JAX package decodes these grids with its
// host C++ range decoder, as the port did before this kernel. It computes
// what that decoder (csrc/rangecoder.cpp, rc_code_grid_streams, model 1)
// computes for such a grid, bit for bit: the same wavefront walk (pixel
// (y, x) belongs to wavefront d = x + step * y, the pixels of a wavefront
// are coded by ascending y), pixel (y, x) on stream y mod n_streams, the
// int32 X.8 ARM and the integer CDF of bitstream/tpu_cdf.py
// (tpu_cdf.cuh, shared with wavefront_decode.cu).
//
// What bounds it. The symbols of one stream form one serial chain (3072 a
// stream on a 128x192 grid at 8 streams), and the ARM of wavefront d needs
// the symbols of wavefront d - 1. A grid fills a small part of one SM, so
// the kernel is bound by latency: the serial wavefronts, each one ARM
// forward and then the longest run of one stream's symbols in it. The
// design:
//   * one CTA per (grid, image), the grids of a launch in a job table: the
//     grids of a batch with no IFCE inputs (levels 3-9 of a 10-grid ladder,
//     for every image) decode side by side in one launch;
//   * the whole grid in shared memory as int8 with a zero border (PAD rows
//     above, PAD columns on each side), so that a causal tap is one load
//     with no bounds test;
//   * two phases a wavefront, each closed by the CTA's barrier: (1) every
//     pixel of the wavefront (at most P = min(h, ceil(w / step)), 39 on
//     128x192) runs its ARM forward at once, a team of T threads a pixel as
//     in wavefront_decode.cu, and leaves its mu and slope in shared memory;
//     (2) one warp a stream decodes the stream's pixels of the wavefront in
//     coding order (up to ceil(P / n_streams) symbols in a row): its 32
//     lanes evaluate left_cum at all 128 symbols, 4 independent chains a
//     lane, so that a symbol costs one quantile, one round of the CDF, four
//     ballots and two shuffles;
//   * the IFCE context (level 2 of a hop ladder) is read at the pixel's
//     coarse position (y / 2, x / 2) of the context grid, which is the
//     host's nearest x2 upsample, one wavefront ahead of its use.
//
// Built by ops/small_grid_decode.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -DSGD_DP=<DP> -DSGD_TEAM=<T>
// into a plain shared library; small_grid_decode_launch is bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#include "tpu_cdf.cuh"

#ifndef SGD_DP
#error "build with -DSGD_DP=<padded ARM width, a multiple of 4>"
#endif
#ifndef SGD_TEAM
#error "build with -DSGD_TEAM=<threads per pixel, 4 or 8>"
#endif

namespace {

using namespace tpu_decode;

constexpr int DP = SGD_DP;
constexpr int T = SGD_TEAM;
static_assert(DP % 4 == 0 && DP >= 4 && DP <= 64, "DP must be a multiple of 4 in [4, 64]");
static_assert(T == 4 || T == 8, "a team is 4 or 8 threads");
constexpr int MAX_THREADS = 1024;
constexpr int J = (DP + T - 1) / T;       // ARM inputs / hidden outputs per member
constexpr int OP = J * T;                 // hidden outputs, padded (zero rows)
constexpr int RS = odd4(DP);              // weight row stride (words)
constexpr int AS = odd4(round4(OP));      // activation row stride (words)
constexpr int PAD = 4;                    // the grid's zero border: taps reach dy -4, dx +-4
constexpr int PER_LANE = N_SYM / 32;      // cut points of the symbol search a lane
// a job: h, w, n_streams, image, first stream, out offset, IFCE offset, IFCE width
constexpr int JOB_FIELDS = 8;

// Shared-memory layout in 4-byte words, then the int8 grid; must match
// ops/small_grid_decode.py:smem_bytes. rows = threads / T pixel slots.
//   activation rows [2][rows][AS], hidden weights [n_hidden][OP][RS] ([out][in]),
//   per-input (stab0, stab1, last0, last1) weights [OP] as int4,
//   hidden biases [n_hidden][OP], (last0 + stab0, last1 + stab1) biases [4],
//   slope [N_POSSIBLE_SCALE], mu_fp and slope per slot [2][rows],
//   grid [(h + PAD) * (w + 2 * PAD)] (int8).
__host__ __device__ constexpr int smem_words(int n_hidden, int threads) {
    return 2 * (threads / T) * AS + n_hidden * OP * RS + 4 * OP + n_hidden * OP + 4
           + N_POSSIBLE_SCALE + 2 * (threads / T);
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[PER_LANE], int i) {
    uint32_t r = v[0];
#pragma unroll
    for (int e = 1; e < PER_LANE; ++e) r = i == e ? v[e] : r;
    return r;
}

__global__ void __launch_bounds__(MAX_THREADS)
small_grid_decode_kernel(const int32_t* __restrict__ jobs,     // [n_jobs][JOB_FIELDS]
                         const int32_t* __restrict__ streams,  // [n][2]: first word, words
                         const uint32_t* __restrict__ words,   // every stream's words
                         const int32_t* __restrict__ wtr,      // [G, n_w]
                         const int32_t* __restrict__ btr,      // [G, n_b]
                         const int32_t* __restrict__ stw,      // [G, dim*2]
                         const int32_t* __restrict__ stb,      // [G, 2]
                         const int32_t* __restrict__ ifce,     // context grids [h_c*w_c][n_ifce]
                         const int32_t* __restrict__ taps,     // [n_spatial][2] (dy, dx)
                         int32_t* __restrict__ out,            // the grids [h, w], int32
                         int n_spatial, int n_ifce, int dim, int n_hidden) {
    extern __shared__ int4 smem4[];
    const int nt = blockDim.x;
    const int rows = nt / T;
    int32_t* smem = reinterpret_cast<int32_t*>(smem4);
    int32_t* s_act = smem;
    int32_t* s_w = s_act + 2 * rows * AS;
    int4* s_ls = reinterpret_cast<int4*>(s_w + n_hidden * OP * RS);
    int32_t* s_b = reinterpret_cast<int32_t*>(s_ls + OP);
    int32_t* s_bias2 = s_b + n_hidden * OP;
    uint32_t* s_slope = reinterpret_cast<uint32_t*>(s_bias2 + 4);
    int32_t* s_mu = reinterpret_cast<int32_t*>(s_slope + N_POSSIBLE_SCALE);
    uint32_t* s_sl = reinterpret_cast<uint32_t*>(s_mu + rows);
    int8_t* grid = reinterpret_cast<int8_t*>(s_sl + rows);

    const int32_t* job = jobs + (size_t)blockIdx.x * JOB_FIELDS;
    const int h = job[0], w = job[1], n_streams = job[2], g = job[3];
    const int stream0 = job[4], out_off = job[5], ifce_off = job[6], ifce_w = job[7];
    const int tid = threadIdx.x;
    const int slot = tid / T;
    const int mem = tid % T;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int step = max(5, (w + 127) / 128);
    const int P = min(h, (w + step - 1) / step);
    const int D = (w - 1) + (h - 1) * step + 1;
    const int WS = w + 2 * PAD;
    const int n_w = n_hidden * dim * dim + dim * 2;
    const int n_b = n_hidden * dim + 2;

    // ---- this image's parameters, transposed to [out][in] and padded with
    // zeros (as in wavefront_decode.cu); the slope table; a zero grid
    const int n_param_words = (int)(reinterpret_cast<int32_t*>(s_slope) - smem);
    for (int i = tid; i < n_param_words; i += nt) smem[i] = 0;
    for (int i = tid; i < (h + PAD) * WS; i += nt) grid[i] = 0;
    __syncthreads();
    const int32_t* gw = wtr + (size_t)g * n_w;
    const int32_t* gb = btr + (size_t)g * n_b;
    for (int l = 0; l < n_hidden; ++l) {
        for (int j = tid; j < dim * dim; j += nt)   // global [in][out]
            s_w[(l * OP + j % dim) * RS + j / dim] = gw[l * dim * dim + j];
        for (int o = tid; o < dim; o += nt) s_b[l * OP + o] = gb[l * dim + o];
    }
    int32_t* s_ls32 = reinterpret_cast<int32_t*>(s_ls);
    for (int j = tid; j < dim * 2; j += nt) {       // global [in][2]
        s_ls32[4 * (j / 2) + (j % 2)] = stw[(size_t)g * dim * 2 + j];
        s_ls32[4 * (j / 2) + 2 + (j % 2)] = gw[n_hidden * dim * dim + j];
    }
    if (tid < 2) s_bias2[tid] = gb[n_hidden * dim + tid] + stb[(size_t)g * 2 + tid];
    for (int i = tid; i < N_POSSIBLE_SCALE; i += nt) {
        const uint64_t s = ((uint64_t)SL0 * exp2_neg24_32(i, CSL)) >> PRECISION;
        s_slope[i] = s < 1 ? 1u : (uint32_t)s;
    }

    // ---- phase 1's roles: a warp runs the ARM if it holds a slot's team
    // (whole warps, for the team's shuffles); slot p takes the pixel of row
    // y = p mod P. This member's inputs k = j*T + mem: a tap's offset in
    // the grid, or an IFCE column, or a zero input (k >= dim).
    const bool arm_warp = warp * 32 < P * T;
    int toff[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int k = j * T + mem;
        toff[j] = k < n_spatial ? taps[2 * k] * WS + taps[2 * k + 1] : 0;
    }
    // this slot's pixel at wavefront dd: (y, x), and whether it has one
    auto pixel = [&](int dd, int& y, int& x) -> bool {
        const int y_lo = dd >= w ? (dd - w) / step + 1 : 0;
        y = y_lo + ((slot - y_lo % P) % P + P) % P;
        x = dd - step * y;
        return slot < P && dd < D && y <= min(h - 1, dd / step);
    };
    // the IFCE inputs of this slot's pixel at wavefront dd (0 where none)
    auto load_ifce = [&](int dd, int32_t (&v)[J]) {
        int y, x;
        const bool on = ifce_off >= 0 && pixel(dd, y, x);
        const int32_t* px =
            ifce + (on ? ifce_off + ((y >> 1) * ifce_w + (x >> 1)) * n_ifce - n_spatial : 0);
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const int k = j * T + mem;
            v[j] = on && k >= n_spatial && k < dim ? px[k] : 0;
        }
    };
    int32_t ifc[J];
    load_ifce(0, ifc);

    // ---- phase 2's roles: warp s decodes stream s; every lane holds the
    // coder state, and the next refill word is always already loaded
    const bool dec_warp = warp < n_streams;
    const int woff = dec_warp ? streams[2 * (stream0 + warp)] : 0;
    const int wcnt = dec_warp ? streams[2 * (stream0 + warp) + 1] : 0;
    auto word_at = [&](int r) -> uint32_t { return r < wcnt ? words[woff + r] : 0u; };
    uint64_t lower = 0, range = ~0ull;
    uint64_t point = ((uint64_t)word_at(0) << 32) | word_at(1);
    int cur = 2;
    uint32_t next_word = word_at(cur);

    __syncthreads();
    int4 ls[J];
#pragma unroll
    for (int j = 0; j < J; ++j) ls[j] = s_ls[j * T + mem];
    int32_t* act0 = s_act + slot * AS;
    int32_t* act1 = s_act + (rows + slot) * AS;

    for (int d = 0; d < D; ++d) {
        // ---- phase 1: the ARM forward of every pixel of the wavefront
        if (arm_warp) {
            int y, x;
            const bool active = pixel(d, y, x);
            if (__any_sync(FULL, active)) {
                const int at = active ? (y + PAD) * WS + x + PAD : 0;
                int32_t c[J];
#pragma unroll
                for (int j = 0; j < J; ++j) {
                    const int k = j * T + mem;
                    c[j] = k < n_spatial ? (active ? grid[at + toff[j]] * 256 : 0) : ifc[j];
                }
                // int32 X.8 ARM, certified overflow-free by the encoder (any
                // order of a layer's sums is exact)
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
                if (active && mem == 0) {
                    const int mu_raw = (p0 + s_bias2[0]) >> 8;   // X.16 -> X.8
                    const int ls_raw = (p1 + s_bias2[1]) >> 8;
                    s_mu[slot] = min(max(mu_raw - MU_MIN_FP, 0), N_POSSIBLE_MU - 1) + MU_MIN_FP;
                    s_sl[slot] =
                        s_slope[min(max(ls_raw - LOG_SCALE_MIN_FP, 0), N_POSSIBLE_SCALE - 1)];
                }
            }
            // the IFCE inputs of the next wavefront, loaded during phase 2
            load_ifce(d + 1, ifc);
        }
        __syncthreads();

        // ---- phase 2: stream `warp` decodes its rows y = warp mod
        // n_streams of the wavefront, by ascending y
        if (dec_warp) {
            const int y_lo = d >= w ? (d - w) / step + 1 : 0;
            const int y_hi = min(h - 1, d / step);
            for (int y = y_lo + ((warp - y_lo % n_streams) % n_streams + n_streams) % n_streams;
                 y <= y_hi; y += n_streams) {
                const int mu_fp = s_mu[y % P];
                const uint32_t slope = s_sl[y % P];
                const uint64_t scale = range >> PRECISION;
                const uint32_t quant = quantile(point - lower, scale);
                // symbol k = s - SYM_MIN: left_cum is strictly increasing and
                // left_cum(0) = 0, so k + 1 is the number of cut points at
                // or below the quantile
                uint32_t v[PER_LANE];
#pragma unroll
                for (int e = 0; e < PER_LANE; ++e)
                    v[e] = left_cum_32(lane * PER_LANE + e, mu_fp, slope);
                int cnt = 0;
#pragma unroll
                for (int e = 0; e < PER_LANE; ++e)
                    cnt += __popc(__ballot_sync(FULL, v[e] <= quant));
                const int k = cnt - 1;
                const int k1 = min(k + 1, N_SYM - 1);
                const uint32_t left = __shfl_sync(FULL, pick(v, k % PER_LANE), k / PER_LANE);
                const uint32_t nxt = __shfl_sync(FULL, pick(v, k1 % PER_LANE), k1 / PER_LANE);
                const uint32_t prob = k == N_SYM - 1 ? (1u << PRECISION) - left : nxt - left;

                // advance and renormalise
                lower += mul_scale(left, scale);
                range = mul_scale(prob, scale);
                if (range < (1ull << 32)) {
                    lower <<= 32;
                    range <<= 32;
                    point = (point << 32) | next_word;
                    next_word = word_at(++cur);
                }
                if (lane == 0) grid[(y + PAD) * WS + d - step * y + PAD] = (int8_t)(k + SYM_MIN);
            }
        }
        __syncthreads();
    }

    // ---- the decoded grid out, as int32
    for (int i = tid; i < h * w; i += nt) out[out_off + i] = grid[(i / w + PAD) * WS + i % w + PAD];
}

}  // namespace

// Launches one CTA of `threads` threads per job on `stream`; the caller
// sizes `threads` (a multiple of 32) to at least P * T and 32 * n_streams
// of every job, and `grid_bytes` to the largest (h + PAD) * (w + 2 * PAD).
// Returns the cudaError_t of the launch (0 on success), or -1 when
// dim_padded or team is not this build's DP or T, or the block or its
// shared memory does not fit. The kernel's shared-memory limit is raised
// once per library.
extern "C" int small_grid_decode_launch(
    const void* jobs, int n_jobs, const void* streams, const void* words, const void* wtr,
    const void* btr, const void* stw, const void* stb, const void* ifce, const void* taps,
    void* out, int n_spatial, int n_ifce, int dim, int n_hidden, int dim_padded, int team,
    int threads, int grid_bytes, void* stream) {
    if (dim_padded != DP || team != T || dim > DP || threads < 32 || threads % 32 != 0
        || threads > MAX_THREADS || n_jobs < 1)
        return -1;
    const size_t smem = 4 * (size_t)smem_words(n_hidden, threads) + (size_t)grid_bytes;
    if (smem > (size_t)SMEM_LIMIT) return -1;
    static const cudaError_t attr_err = cudaFuncSetAttribute(
        small_grid_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (attr_err != cudaSuccess) return (int)attr_err;
    small_grid_decode_kernel<<<n_jobs, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(jobs), static_cast<const int32_t*>(streams),
        static_cast<const uint32_t*>(words), static_cast<const int32_t*>(wtr),
        static_cast<const int32_t*>(btr), static_cast<const int32_t*>(stw),
        static_cast<const int32_t*>(stb), static_cast<const int32_t*>(ifce),
        static_cast<const int32_t*>(taps), static_cast<int32_t*>(out), n_spatial, n_ifce, dim,
        n_hidden);
    return (int)cudaGetLastError();
}
