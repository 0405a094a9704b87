// Shared by the `tpu`-profile decode kernels (wavefront_decode.cu,
// small_grid_decode.cu): the integer CDF of bitstream/tpu_cdf.py on 32-bit
// operands and the quantile of a range-decoder state. Each function is
// bit-exact against the numpy spec; the bounds it relies on are stated
// beside it and proved by the CPU tests (tests/test_torch_wavefront_decode.py).

#pragma once

#include <cstdint>

namespace tpu_decode {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int round4(int n) { return (n + 3) / 4 * 4; }
constexpr int odd4(int n) { return (n / 4) % 2 ? n : n + 4; }

constexpr int PRECISION = 24;
constexpr uint32_t QMAX = (1u << PRECISION) - 1;
constexpr int SYM_MIN = -64;
constexpr int SYM_MAX = 63;
constexpr int N_SYM = SYM_MAX - SYM_MIN + 1;
constexpr int LEAK_STEP = 16;
constexpr uint32_t FREE_WEIGHT = (1u << PRECISION) - 1 - uint32_t(SYM_MAX - SYM_MIN) * LEAK_STEP;
constexpr int MU_MIN_FP = -64 * 256;
constexpr int LOG_SCALE_MIN_FP = -5 * 256;
constexpr int N_POSSIBLE_MU = 32768;
constexpr int N_POSSIBLE_SCALE = 2561;
constexpr uint32_t CSL = 94548;
constexpr uint32_t SL0 = 14032236;
constexpr int SMEM_LIMIT = 232448;

// exp2(-t / 2^24) in X.24 for t = a * b (tpu_cdf.exp2_neg24), on 32-bit
// operands. Callers pass a < 2^16 and b < 2^24 (|m| <= 32895 and slope <=
// SL0 < 2^24 in left_cum; idx < 2^12 and CSL < 2^17 for the slope table), so
// t < 2^40 is one 32x32->64 multiply. f = t mod 2^24 < 2^24. Through the
// Horner steps |r| < 2^25, so r * f is one signed 32x32->64 multiply with
// |r * f| < 2^49; with the step's constant C (|C| <= 2^24) added as C * 2^24,
// |r * f + C * 2^24| < 2^50, and its arithmetic (floor) shift by 24 fits
// int32. The shift q = t >> 24 < 2^16 is clamped to 31: 0 <= r <= 2^24 after
// the clamp, so r >> q is 0 for every q >= 25, as the reference's min(q, 40)
// gives.
__device__ __forceinline__ uint32_t exp2_neg24_32(uint32_t a, uint32_t b) {
    const uint64_t t = (uint64_t)a * b;
    const int32_t f = (int32_t)((uint32_t)t & QMAX);
    const uint32_t q = min((uint32_t)(t >> PRECISION), 31u);
    // C + ((r * f) >> 24) == (r * f + C * 2^24) >> 24 (C an integer): one
    // 64-bit multiply-add and one shift a step
    auto horner = [f](int32_t r, int64_t c) -> int32_t {
        return (int32_t)(((int64_t)r * f + (c << PRECISION)) >> PRECISION);
    };
    int32_t r = 1835;
    r = horner(r, -21395);
    r = horner(r, 160710);
    r = horner(r, -930970);
    r = horner(r, 4030290);
    r = horner(r, -11629077);
    r = horner(r, 16777216);
    r = min(max(r, 0), 1 << PRECISION);
    return (uint32_t)r >> q;
}

// left_cum of symbol k + SYM_MIN, k in [0, 127] (tpu_cdf.left_cum).
// m = s*256 - 128 - mu_fp with s in [-64, 63] and mu_fp in [-16384, 16383],
// so |m| <= 32895 < 2^16; cdf <= 2^24 and FREE_WEIGHT < 2^24, so their
// product < 2^48 is one 32x32->64 multiply.
__device__ __forceinline__ uint32_t left_cum_32(int k, int mu_fp, uint32_t slope) {
    const int m = (k + SYM_MIN) * 256 - 128 - mu_fp;
    const uint32_t half = exp2_neg24_32((uint32_t)abs(m), slope) >> 1;
    const uint32_t cdf = m < 0 ? half : (1u << PRECISION) - half;
    const uint32_t v = (uint32_t)(((uint64_t)FREE_WEIGHT * cdf) >> PRECISION)
                       + (uint32_t)k * LEAK_STEP;
    return k <= 0 ? 0u : v;
}

// The word p with its bytes permuted by `sel` (prmt's default mode: a
// selector nibble with its top bit set replicates the sign of its byte):
// 0x3210 keeps p, 0x9910 sign-extends its low int16, 0xBB32 its high int16.
__device__ __forceinline__ int32_t prmt_sext(int32_t p, int sel) {
    int32_t r;
    asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(p), "r"(sel));
    return r;
}

// a * scale for a <= 2^24 and scale < 2^40: a * (scale >> 32) < 2^32, and
// the whole product < 2^64.
__device__ __forceinline__ uint64_t mul_scale(uint32_t a, uint64_t scale) {
    return (uint64_t)a * (uint32_t)scale + ((uint64_t)(a * (uint32_t)(scale >> 32)) << 32);
}

// min(t / scale, 2^24 - 1) for t < 2^64, scale in [2^8, 2^40) (range is in
// [2^32, 2^64) between symbols). The FP64 estimate t_d * rcp(scale_d), each
// step correctly rounded, has relative error < 3.1 * 2^-53; while t / scale
// < 2^25 its absolute error is < 2^-26, so its floor q0 is the quotient or
// one off; if t / scale >= 2^25 the estimate exceeds 2^24 - 1 and clamps
// like the quotient. After the clamp, one step down (q * scale > t) or up
// ((q + 1) * scale <= t, q < 2^24 - 1) is exact; q + 1 <= 2^24, so both
// products are < 2^64 (mul_scale).
__device__ __forceinline__ uint32_t quantile(uint64_t t, uint64_t scale) {
    double qd = __dmul_rn(__ull2double_rn(t), __drcp_rn(__ull2double_rn(scale)));
    qd = fmin(qd, (double)QMAX);
    uint32_t q = __double2uint_rz(qd);
    if (mul_scale(q, scale) > t) {
        --q;
    } else if (q < QMAX && mul_scale(q + 1, scale) <= t) {
        ++q;
    }
    return q;
}

}  // namespace tpu_decode
