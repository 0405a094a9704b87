// The weight and bias gradient of the ARM's and the IFCE's float linear
// layers (models/arm.py:_linear) in training, on NVIDIA Hopper:
//
//   dW[g] = dY[g]^T . X[g]   [C_out, C_in]      db[g] = sum over rows of dY[g]   [C_out]
//
// for X [G, B, C_in] and dY [G, B, C_out], f32, C_in and C_out up to 64.
//
// It replaces no TPU kernel: the JAX package leaves this product to XLA.
// It takes the place of the batched cuBLAS GEMM that autograd's backward of
// torch.baddbmm launched, which gives each image one 32x32 output tile, so
// that a G = 8 batch stepped through B = 524 288 rows an image on 8 of the
// H100's 132 SMs.
//
// What bounds it: bytes. Each row brings C_in + C_out floats and takes
// C_out x (C_in + 1) multiply-adds, 420 for 160 bytes at hop's 20 x 20:
// under the card's 10 FMA a byte at the f32 CUDA-core rate. The least time
// is X and dY read once at the HBM rate. The design:
//   * pass 1, a grid of G x S CTAs: CTA (g, s) streams its own contiguous
//     chunk of image g's rows of X and dY once, in tiles of a few hundred
//     rows, with 16-byte cp.async copies into shared memory, two stages, the
//     next tile in flight while the current one is summed. S is chosen by
//     the wrapper from G, B and the card's SM count, so that G x S fills the
//     card a few times over;
//   * inside a CTA each thread owns a 4 x 4 tile of the C_out x (C_in + 1)
//     outputs (the +1 column is the bias: an input of ones), and the CTA's
//     threads split a tile's rows into R row groups; every sum is a full f32
//     FMA on the CUDA cores, with no TF32 and no tensor cores;
//   * at the chunk's end the R row groups' sums are added in a fixed order
//     and CTA (g, s) writes its partial to partial[g, s, C_out, C_in + 1];
//   * pass 2, a second small launch, adds the S partials of each output in
//     the order s = 0, 1, ... and writes dW and db.
// No atomics: the same input gives the same bits, launch after launch.
//
// Built by ops/arm_wgrad.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// into a plain shared library; arm_wgrad_launch is bound with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TO = 4;              // dY channels of a thread's output tile
constexpr int TI = 4;              // X columns of a thread's output tile
constexpr int MAX_C = 64;          // widest C_in and C_out
constexpr int STAGE_FLOATS = 6144; // X and dY of one tile (24 KiB)
constexpr int STAGES = 2;
constexpr int MAX_THREADS = 512;
constexpr int REDUCE_THREADS = 256;
static_assert(MAX_THREADS * TO * TI <= STAGES * STAGE_FLOATS,
              "the row groups' sums fit in the stages' shared memory");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

// Floats between src and the 16-byte boundary below it.
__device__ __forceinline__ int lead_of(const float* src) {
    return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Issue the copy of n floats from src into dst (16-byte aligned) as whole
// 16-byte vectors: element k lands at dst[lead_of(src) + k]. The first
// vector may start before src, inside the tensor (whose start is 16-byte
// aligned); the last one copies only what lies before src + n and fills the
// rest of its 16 bytes with zeros.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, int n) {
    const int lead = lead_of(src);
    const float* base = src - lead;
    const int nvec = (lead + n + 3) >> 2;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        const int valid = min(4, lead + n - 4 * v);
        cp_async16(dst + 4 * v, base + 4 * v, 4 * valid);
    }
}

// Pass 1: CTA (s, g) sums rows [s * chunk, min(B, (s + 1) * chunk)) of image g.
__global__ void __launch_bounds__(MAX_THREADS, 2)
arm_wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         float* __restrict__ partial, int B, int ci, int co, int chunk,
                         int rows_per_tile) {
    extern __shared__ __align__(16) float smem[];
    const int s = blockIdx.x, S = gridDim.x, g = blockIdx.y;
    const int r0 = s * chunk, r1 = min(B, r0 + chunk);
    const int cols = ci + 1;
    const int nib = (cols + TI - 1) / TI, nob = (co + TO - 1) / TO;
    const int m_tiles = nib * nob;
    const int groups = max(1, static_cast<int>(blockDim.x) / m_tiles);
    const int tid = threadIdx.x;
    const bool active = tid < m_tiles * groups;
    const int m = tid % m_tiles, k = tid / m_tiles;
    const int o0 = (m / nib) * TO, i0 = (m % nib) * TI;
    // X columns at or past ci read the tile's last column and take 1 (the
    // bias's input) in its place; dY channels past co read the last one and
    // their sums are never written
    int xcol[TI], dcol[TO];
    bool xin[TI];
#pragma unroll
    for (int j = 0; j < TI; ++j) {
        xin[j] = i0 + j < ci;
        xcol[j] = min(i0 + j, ci - 1);
    }
#pragma unroll
    for (int q = 0; q < TO; ++q) dcol[q] = min(o0 + q, co - 1);

    float acc[TO][TI];
#pragma unroll
    for (int q = 0; q < TO; ++q)
#pragma unroll
        for (int j = 0; j < TI; ++j) acc[q][j] = 0.f;

    // a stage: X's tile at [0, x_floats), dY's after it (16-byte aligned)
    const int x_floats = (rows_per_tile * ci + 3 + 3) & ~3;
    const float* xg = x + (static_cast<size_t>(g) * B) * ci;
    const float* dg = dy + (static_cast<size_t>(g) * B) * co;
    const int n_tiles = r1 > r0 ? (r1 - r0 + rows_per_tile - 1) / rows_per_tile : 0;

    auto issue = [&](int t) {
        if (t < n_tiles) {
            const int ra = r0 + t * rows_per_tile, n = min(rows_per_tile, r1 - ra);
            float* st = smem + (t % STAGES) * STAGE_FLOATS;
            stage_copy(st, xg + static_cast<size_t>(ra) * ci, n * ci);
            stage_copy(st + x_floats, dg + static_cast<size_t>(ra) * co, n * co);
        }
        cp_async_commit();
    };

    issue(0);
    for (int t = 0; t < n_tiles; ++t) {
        issue(t + 1);
        cp_async_wait_prev();
        __syncthreads();
        if (active) {
            const int ra = r0 + t * rows_per_tile, n = min(rows_per_tile, r1 - ra);
            const float* st = smem + (t % STAGES) * STAGE_FLOATS;
            const float* sx = st + lead_of(xg + static_cast<size_t>(ra) * ci);
            const float* sd = st + x_floats + lead_of(dg + static_cast<size_t>(ra) * co);
            for (int r = k; r < n; r += groups) {
                float xv[TI], dv[TO];
#pragma unroll
                for (int j = 0; j < TI; ++j) {
                    const float v = sx[r * ci + xcol[j]];
                    xv[j] = xin[j] ? v : 1.f;
                }
#pragma unroll
                for (int q = 0; q < TO; ++q) dv[q] = sd[r * co + dcol[q]];
#pragma unroll
                for (int q = 0; q < TO; ++q)
#pragma unroll
                    for (int j = 0; j < TI; ++j) acc[q][j] = fmaf(dv[q], xv[j], acc[q][j]);
            }
        }
        __syncthreads();
    }

    // the row groups' sums, added in the order k = 0, 1, ...
    float* red = smem;
    if (active) {
#pragma unroll
        for (int q = 0; q < TO; ++q)
#pragma unroll
            for (int j = 0; j < TI; ++j)
                red[(k * m_tiles + m) * (TO * TI) + q * TI + j] = acc[q][j];
    }
    __syncthreads();
    float* out = partial + (static_cast<size_t>(g) * S + s) * co * cols;
    for (int e = tid; e < co * cols; e += blockDim.x) {
        const int o = e / cols, i = e % cols;
        const int mm = (o / TO) * nib + i / TI, slot = (o % TO) * TI + i % TI;
        float sum = 0.f;
        for (int kk = 0; kk < groups; ++kk) sum += red[(kk * m_tiles + mm) * (TO * TI) + slot];
        out[e] = sum;
    }
}

// Pass 2: each output of image g, the S partials added in the order s = 0, 1, ...
__global__ void __launch_bounds__(REDUCE_THREADS)
arm_wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                        float* __restrict__ db, int S, int ci, int co) {
    const int g = blockIdx.y, cols = ci + 1, n_out = co * cols;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_out) return;
    const float* p = partial + static_cast<size_t>(g) * S * n_out + e;
    float sum = 0.f;
    for (int s = 0; s < S; ++s) sum += p[static_cast<size_t>(s) * n_out];
    const int o = e / cols, i = e % cols;
    if (i < ci)
        dw[(static_cast<size_t>(g) * co + o) * ci + i] = sum;
    else
        db[static_cast<size_t>(g) * co + o] = sum;
}

// Rows of X and dY in one stage of pass 1 (each region starts 16-byte
// aligned after up to 3 floats of lead).
int tile_rows(int ci, int co) {
    int rows = (STAGE_FLOATS - 12) / (ci + co);
    while (((rows * ci + 6) & ~3) + ((rows * co + 6) & ~3) > STAGE_FLOATS) --rows;
    return rows;
}

// Threads of a pass-1 CTA: at least one a 4 x 4 output tile (272 at
// 64 x 64), in row groups.
int block_threads(int ci, int co) {
    const int tiles = ((ci + 1 + TI - 1) / TI) * ((co + TO - 1) / TO);
    return tiles <= 256 ? 256 : MAX_THREADS;
}

}  // namespace

extern "C" {

// x [G, B, ci], dy [G, B, co], partial [G, S, co, ci + 1] scratch, dw
// [G, co, ci], db [G, co]: contiguous f32 on the current device, x and dy
// 16-byte aligned. chunk = rows a CTA of pass 1 sums, S = ceil(B / chunk).
// Returns 0, -1 on arguments the kernel does not take, or the CUDA error.
int arm_wgrad_launch(const void* x, const void* dy, void* partial, void* dw, void* db, int G,
                     int B, int ci, int co, int S, int chunk, void* stream) {
    if (G < 1 || B < 1 || ci < 1 || co < 1 || ci > MAX_C || co > MAX_C || S < 1
        || chunk < 1 || static_cast<long long>(S) * chunk < B
        || static_cast<long long>(S - 1) * chunk >= B
        || (reinterpret_cast<uintptr_t>(x) & 15) != 0
        || (reinterpret_cast<uintptr_t>(dy) & 15) != 0)
        return -1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = sizeof(float) * STAGES * STAGE_FLOATS;
    arm_wgrad_partial_kernel<<<dim3(S, G), block_threads(ci, co), smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<float*>(partial), B, ci, co, chunk, tile_rows(ci, co));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_out = co * (ci + 1);
    arm_wgrad_reduce_kernel<<<dim3((n_out + REDUCE_THREADS - 1) / REDUCE_THREADS, G),
                              REDUCE_THREADS, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(dw), static_cast<float*>(db), S,
        ci, co);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
