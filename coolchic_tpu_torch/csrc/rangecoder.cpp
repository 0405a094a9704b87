// Host-side entropy coding for coolchic_tpu_torch (a copy of coolchic_tpu/csrc/rangecoder.cpp).
//
// 1) A range encoder/decoder compatible with the `constriction` crate's
//    queue RangeEncoder/RangeDecoder (State=u64, Word=u32, PRECISION=24)
//    with the QuantizedLaplace(-64, 63) leaky-quantizer model family.
//    This is required to decode reference Cool-Chic bitstreams bit-exactly
//    (reference: coolchic/bitstream/component/rangecoder.py:25-94).
//
// 2) A full-latent-grid wavefront codec: the fixed-point ARM (int64
//    arithmetic, reference coolchic/bitstream/component/armint.py) runs
//    inline with symbol decoding, so one C call decodes a whole grid instead
//    of one Python->native crossing per wavefront diagonal.
//
// Built at first use by bitstream/rangecoder.py (g++ -O3 -march=native -fopenmp -shared -fPIC).

#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>
#include <memory>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int PRECISION = 24;
constexpr int SYM_MIN = -64;
constexpr int SYM_MAX = 63;
// Leaky quantizer: max_probability - (support_size - 1) = (2^24 - 1) - 127.
constexpr double FREE_WEIGHT = double((1u << PRECISION) - 1 - (SYM_MAX - SYM_MIN));
constexpr uint64_t RENORM_LIMIT = 1ull << 32;
constexpr uint32_t QUANTILE_MAX = (1u << PRECISION) - 1;

inline double laplace_cdf(double x, double mu, double b) {
    if (x < mu) return 0.5 * std::exp((x - mu) / b);
    return 1.0 - 0.5 * std::exp(-(x - mu) / b);
}

// Left-sided cumulative of the leaky-quantized Laplace.
inline uint32_t left_cum(int s, double mu, double b) {
    if (s <= SYM_MIN) return 0;
    uint32_t slack = uint32_t(s - SYM_MIN);
    return uint32_t(FREE_WEIGHT * laplace_cdf(double(s) - 0.5, mu, b)) + slack;
}

inline uint32_t right_cum_minus_left(int s, double mu, double b, uint32_t left) {
    if (s >= SYM_MAX) return uint32_t((1u << PRECISION) - left);
    uint32_t slack = uint32_t(s - SYM_MIN);
    uint32_t right = uint32_t(FREE_WEIGHT * laplace_cdf(double(s) + 0.5, mu, b)) + slack + 1;
    return right - left;
}

// Find s maximal with left_cum(s) <= quantile, via the closed-form Laplace
// quantile as an initial guess, then a local walk (left_cum is strictly
// increasing thanks to the leak).
inline int invert_quantile(uint32_t quantile, double mu, double b) {
    double p = (double(quantile) + 0.5) / double(1u << PRECISION);
    double x;
    if (p < 0.5) x = mu + b * std::log(2.0 * p);
    else x = mu - b * std::log(2.0 - 2.0 * p);
    int s = int(std::lround(x));
    if (s < SYM_MIN) s = SYM_MIN;
    if (s > SYM_MAX) s = SYM_MAX;
    while (s > SYM_MIN && left_cum(s, mu, b) > quantile) --s;
    while (s < SYM_MAX && left_cum(s + 1, mu, b) <= quantile) ++s;
    return s;
}

struct Encoder {
    uint64_t lower = 0;
    uint64_t range = ~0ull;
    std::vector<uint32_t> words;

    void encode(uint32_t left, uint32_t prob) {
        uint64_t scale = range >> PRECISION;
        uint64_t new_lower = lower + scale * uint64_t(left);
        if (new_lower < lower) {  // carry into already-emitted words
            for (size_t i = words.size(); i-- > 0;) {
                if (++words[i] != 0) break;
            }
        }
        lower = new_lower;
        range = scale * uint64_t(prob);
        if (range < RENORM_LIMIT) {
            words.push_back(uint32_t(lower >> 32));
            lower <<= 32;
            range <<= 32;
        }
    }

    // Seal: emit the smallest point >= lower that is all-zero after one more
    // word. Guaranteed inside [lower, lower + range) since range >= 2^32.
    // The decoder zero-pads past the end of the stream, so this is the
    // shortest self-consistent termination.
    void seal() {
        uint64_t hi = lower >> 32;
        if (lower & 0xffffffffull) {
            ++hi;
            if (hi >> 32) {  // carry into emitted words, then the word is 0
                for (size_t i = words.size(); i-- > 0;) {
                    if (++words[i] != 0) break;
                }
                hi = 0;
            }
        }
        words.push_back(uint32_t(hi));
    }
};

struct Decoder {
    const uint32_t* words = nullptr;
    int64_t n_words = 0;
    int64_t pos = 0;
    uint64_t lower = 0;
    uint64_t range = ~0ull;
    uint64_t point = 0;

    void init(const uint32_t* w, int64_t n) {
        words = w;
        n_words = n;
        pos = 0;
        lower = 0;
        range = ~0ull;
        point = (next() << 32) | next();
    }

    uint64_t next() { return pos < n_words ? uint64_t(words[pos++]) : 0ull; }

    int decode(double mu, double b) {
        uint64_t scale = range >> PRECISION;
        uint64_t quantile = (point - lower) / scale;  // wrapping subtraction
        if (quantile > QUANTILE_MAX) quantile = QUANTILE_MAX;
        int s = invert_quantile(uint32_t(quantile), mu, b);
        uint32_t left = left_cum(s, mu, b);
        uint32_t prob = right_cum_minus_left(s, mu, b, left);
        advance(scale, left, prob);
        return s;
    }

    inline void advance(uint64_t scale, uint32_t left, uint32_t prob) {
        lower += scale * uint64_t(left);
        range = scale * uint64_t(prob);
        if (range < RENORM_LIMIT) {
            lower <<= 32;
            range <<= 32;
            point = (point << 32) | next();
        }
    }

    inline uint32_t quantile() const {
        uint64_t scale = range >> PRECISION;
        uint64_t q = (point - lower) / scale;
        return q > QUANTILE_MAX ? QUANTILE_MAX : uint32_t(q);
    }
};

// ---------------------------------------------------------------------------
// (mu, scale) dequantization tables (mu_scale.npy equivalent).
// ---------------------------------------------------------------------------
std::vector<float> g_mu_table;
std::vector<float> g_scale_table;

inline void lookup(int64_t idx_mu, int64_t idx_sc, double* mu, double* sc) {
    int64_t n_mu = int64_t(g_mu_table.size());
    int64_t n_sc = int64_t(g_scale_table.size());
    if (idx_mu < 0) idx_mu = 0;
    if (idx_mu >= n_mu) idx_mu = n_mu - 1;
    if (idx_sc < 0) idx_sc = 0;
    if (idx_sc >= n_sc) idx_sc = n_sc - 1;
    *mu = double(g_mu_table[size_t(idx_mu)]);
    *sc = double(g_scale_table[size_t(idx_sc)]);
}

// ---------------------------------------------------------------------------
// Integer-argument CDF evaluation. Every CDF evaluation during grid coding
// has the form exp(((s +- 0.5) - mu) / b) where both s +- 0.5 and mu are
// exact multiples of 2^-8, so the subtraction is exact and the tabulated
// argument m * (1/256) is the same double as the direct subtraction. Calling
// std::exp directly on it is bit-identical to the generic path AND faster
// than any per-scale memo (hundreds of scales are live per grid, so a memo
// thrashes the cache).
// ---------------------------------------------------------------------------
struct ScaleExpTable {
    double b = 0.0;
    inline double expm(int m) const {  // m >= 0
        return std::exp((double(-m) * (1.0 / 256.0)) / b);
    }
};

// Tiny per-index cache of the dequantized scale value.
struct ScaleTableCache {
    std::vector<ScaleExpTable> slots;

    ScaleExpTable* get(int64_t idx_sc_raw) {
        int64_t n_sc = int64_t(g_scale_table.size());
        if (n_sc == 0) return nullptr;
        size_t idx = size_t(idx_sc_raw < 0 ? 0 : (idx_sc_raw >= n_sc ? n_sc - 1 : idx_sc_raw));
        if (slots.size() != size_t(n_sc)) {
            slots.assign(size_t(n_sc), ScaleExpTable());
            for (size_t i = 0; i < size_t(n_sc); ++i)
                slots[i].b = double(g_scale_table[i]);
        }
        return &slots[idx];
    }
};

ScaleTableCache g_scale_cache;

// Find s maximal with left_cum_tab(s) <= quantile. Returns that left
// cumulative AND left_cum(s + 1) (valid when s < SYM_MAX) -- the probability
// mass is prob = left_next - left (the CDF argument of right_cum(s) is
// exactly that of left_cum(s+1)), so the caller needs no further exp calls.
struct InvResult {
    int s;
    uint32_t left;
    uint32_t left_next;  // only meaningful when s < SYM_MAX
};


// ---------------------------------------------------------------------------
// `tpu`-profile integer probability model (normative spec + tables:
// coolchic_tpu/bitstream/tpu_cdf.py). Pure integer math -- bit-identical on
// any host and inside the CUDA wavefront kernel (csrc/wavefront_decode.cu).
// ---------------------------------------------------------------------------
constexpr int TPU_LEAK_STEP = 16;
constexpr uint32_t TPU_FREE_WEIGHT =
    (1u << PRECISION) - 1 - uint32_t(SYM_MAX - SYM_MIN) * TPU_LEAK_STEP;

// Nine normative constants (coolchic_tpu/bitstream/tpu_cdf.py): degree-6
// integer Horner for 2^24 * 2^(-u/2^24), plus the scale-index decay CSL and
// base slope SL0. Pure integer math == bit-identical on host and card.
constexpr int64_t TPU_EXP2_POLY[7] = {16777216, -11629077, 4030290, -930970,
                                      160710, -21395, 1835};
constexpr uint64_t TPU_CSL = 94548;
constexpr uint64_t TPU_SL0 = 14032236;

inline uint32_t tpu_exp2_neg24(uint64_t t) {
    uint64_t q = t >> PRECISION;
    if (q > 40) q = 40;
    int64_t f = int64_t(t & ((1u << PRECISION) - 1));
    int64_t r = TPU_EXP2_POLY[6];
    for (int k = 5; k >= 0; --k) r = TPU_EXP2_POLY[k] + ((r * f) >> PRECISION);
    if (r < 0) r = 0;
    if (r > (1 << PRECISION)) r = 1 << PRECISION;
    return uint32_t(uint64_t(r) >> q);
}

// slope(idx), computed once from the integer formula.
struct TpuSlopeTable {
    std::vector<uint32_t> v;
    void ensure() {
        size_t n = g_scale_table.size() ? g_scale_table.size() : 2561;
        if (v.size() == n) return;
        v.resize(n);
        for (size_t i = 0; i < n; ++i) {
            uint64_t s = (TPU_SL0 * uint64_t(tpu_exp2_neg24(uint64_t(i) * TPU_CSL)))
                         >> PRECISION;
            v[i] = s < 1 ? 1u : uint32_t(s);
        }
    }
};
TpuSlopeTable g_tpu_slope;

inline uint32_t tpu_cdf24(int32_t m, uint32_t slope) {
    uint64_t am = uint64_t(m < 0 ? -int64_t(m) : int64_t(m));
    uint32_t half = tpu_exp2_neg24(am * slope) >> 1;
    return m < 0 ? half : (1u << PRECISION) - half;
}

inline uint32_t tpu_left_cum(int s, int mu_fp, uint32_t slope) {
    if (s <= SYM_MIN) return 0;
    int32_t m = int32_t(s) * 256 - 128 - mu_fp;
    uint64_t c = tpu_cdf24(m, slope);
    return uint32_t((uint64_t(TPU_FREE_WEIGHT) * c) >> PRECISION)
           + uint32_t(s - SYM_MIN) * TPU_LEAK_STEP;
}

// max s with left_cum(s) <= quantile: 7-step binary search (left_cum is
// strictly increasing by construction, see tpu_cdf.py LEAK_STEP).
inline InvResult tpu_invert(uint32_t quantile, int mu_fp, uint32_t slope) {
    int lo = SYM_MIN;
    for (int step = 64; step >= 1; step >>= 1) {
        int cand = lo + step;
        if (cand <= SYM_MAX && tpu_left_cum(cand, mu_fp, slope) <= quantile)
            lo = cand;
    }
    uint32_t l = tpu_left_cum(lo, mu_fp, slope);
    uint32_t ln = lo < SYM_MAX ? tpu_left_cum(lo + 1, mu_fp, slope) : 0;
    return {lo, l, ln};
}

// Laplace CDF at (s - 0.5) given mu = mu_fp * 2^-8: argument index
// m = s*256 - 128 - mu_fp (sign decides the branch).
inline double laplace_cdf_tab(int m, const ScaleExpTable* t) {
    if (m < 0) return 0.5 * t->expm(-m);
    return 1.0 - 0.5 * t->expm(m);
}

inline uint32_t left_cum_tab(int s, int mu_fp, const ScaleExpTable* t) {
    if (s <= SYM_MIN) return 0;
    int m = s * 256 - 128 - mu_fp;
    return uint32_t(FREE_WEIGHT * laplace_cdf_tab(m, t)) + uint32_t(s - SYM_MIN);
}

// Fast approximate log2 (max error ~1e-3): only used for the initial guess
// of the quantile inversion -- the corrective walk below makes the final
// symbol exact regardless of guess error (guess error in symbols is
// <= b * ln2 * err <= e^5 * 0.7 * 1e-3 < 0.11).
inline double fast_log2(double v) {
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    int e = int((bits >> 52) & 0x7ff) - 1023;
    uint64_t mb = (bits & 0xfffffffffffffull) | 0x3ff0000000000000ull;
    double m;
    std::memcpy(&m, &mb, 8);
    double t = m - 1.0;
    double l = t * (1.4426950408889634 -
                    t * (0.7212728853734762 -
                         t * (0.4765394990484316 - t * (0.3219124579536545 -
                                                        t * 0.1391888533622595))));
    return double(e) + l;
}

inline InvResult invert_quantile_tab(uint32_t quantile, double mu, int mu_fp,
                                     const ScaleExpTable* t) {
    constexpr double LN2 = 0.6931471805599453;
    double p = (double(quantile) + 0.5) * (1.0 / double(1u << PRECISION));
    double x;
    if (p < 0.5) x = mu + t->b * (LN2 * fast_log2(2.0 * p));
    else x = mu - t->b * (LN2 * fast_log2(2.0 - 2.0 * p));
    int s = int(std::lround(x));
    if (s < SYM_MIN) s = SYM_MIN;
    if (s > SYM_MAX) s = SYM_MAX;
    uint32_t ls = left_cum_tab(s, mu_fp, t);
    if (ls > quantile) {  // walk down; the previous ls is left(s + 1)
        uint32_t ln = ls;
        do {
            ln = ls;
            --s;
            ls = left_cum_tab(s, mu_fp, t);
        } while (ls > quantile);  // terminates: left_cum(SYM_MIN) == 0
        return {s, ls, ln};
    }
    while (s < SYM_MAX) {  // walk up; the failing probe is left(s + 1)
        uint32_t ln = left_cum_tab(s + 1, mu_fp, t);
        if (ln > quantile) return {s, ls, ln};
        ++s;
        ls = ln;
    }
    return {s, ls, 0};  // s == SYM_MAX: prob = 2^24 - left
}

// ---------------------------------------------------------------------------
// Fixed-point ARM (int64 semantics), reference armint.py:180-203.
//
// Two implementations with identical integer results:
//   * ArmFixedPoint  -- scalar int64, always exact (fallback + spec oracle).
//   * ArmBatchF64    -- SIMD-friendly batched forward in double precision.
//     Every intermediate value of the fixed-point network is an integer; as
//     long as a static per-layer bound (propagated from the actual weight
//     magnitudes and the actual input magnitudes) stays below 2^53, every
//     f64 add/mul/floor is exact and the result equals the int64 path bit
//     for bit. The bound is checked once per grid; on the (never observed)
//     overflow the code falls back to the scalar path.
// ---------------------------------------------------------------------------
constexpr int WEIGHT_SHIFT = 16;
constexpr int N_FRAC_BIT_MU_SCALE = 8;
constexpr int OUTPUT_SHIFT = 2 * WEIGHT_SHIFT - N_FRAC_BIT_MU_SCALE;
constexpr int64_t MU_MIN_FP = int64_t(SYM_MIN) * 256;   // -64 << 8
constexpr int64_t LOG_SCALE_MIN_FP = int64_t(-5) * 256;  // -5 << 8

struct ArmFixedPoint {
    int dim = 0;          // total context count C
    int n_out = 2;        // outputs of the last layer (2 for ARM, C_f for IFCE)
    int n_trunk = 0;      // number of trunk linear layers (n_hidden + 1)
    int act_shift = WEIGHT_SHIFT;  // X.16 reference pipeline; X.8 for tpu model
    int n_raw_tail = 0;            // trailing inputs NOT shifted (X.8 IFCE, model 1)
    // weights[l]: [in, out] row-major (pre-transposed, x @ W convention).
    std::vector<std::vector<int64_t>> weights;
    std::vector<std::vector<int64_t>> biases;   // [out]
    std::vector<int64_t> stab_w;                // [dim, n_out]
    std::vector<int64_t> stab_b;                // [n_out]

    // ctx: [dim] raw integer contexts (spatial already plain ints, IFCE
    // columns pre-scaled by 2^8 handled in the weights).
    inline void forward(const int64_t* ctx, int64_t* out, int output_shift) const {
        int64_t x[64];
        int64_t y[64];
        for (int i = 0; i < dim - n_raw_tail; ++i) x[i] = ctx[i] << act_shift;
        for (int i = dim - n_raw_tail; i < dim; ++i) x[i] = ctx[i];

        int64_t stab[64];
        for (int o = 0; o < n_out; ++o) stab[o] = stab_b[o];
        for (int i = 0; i < dim; ++i) {
            int64_t xi = x[i];
            const int64_t* srow = stab_w.data() + size_t(i) * n_out;
            for (int o = 0; o < n_out; ++o) stab[o] += xi * srow[o];
        }

        for (int l = 0; l < n_trunk - 1; ++l) {
            const int64_t* w = weights[size_t(l)].data();
            const int64_t* b = biases[size_t(l)].data();
            for (int o = 0; o < dim; ++o) y[o] = b[o];
            for (int i = 0; i < dim; ++i) {
                int64_t xi = x[i];
                const int64_t* wrow = w + size_t(i) * dim;
                for (int o = 0; o < dim; ++o) y[o] += xi * wrow[o];
            }
            for (int o = 0; o < dim; ++o) {
                int64_t v = y[o] < 0 ? 0 : y[o];
                x[o] = v >> act_shift;
            }
        }

        const int64_t* w = weights[size_t(n_trunk - 1)].data();
        const int64_t* b = biases[size_t(n_trunk - 1)].data();
        for (int o = 0; o < n_out; ++o) y[o] = b[o] + stab[o];
        for (int i = 0; i < dim; ++i) {
            int64_t xi = x[i];
            const int64_t* wrow = w + size_t(i) * n_out;
            for (int o = 0; o < n_out; ++o) y[o] += xi * wrow[o];
        }
        for (int o = 0; o < n_out; ++o) out[o] = y[o] >> output_shift;
    }
};

// Batched fixed-point ARM in f64 (layout: feature-major, batch contiguous).
struct ArmBatchF64 {
    int dim = 0;
    int n_out = 2;
    int n_trunk = 0;
    int act_shift = WEIGHT_SHIFT;  // X.16 reference pipeline; X.8 for tpu model
    std::vector<std::vector<double>> weights;  // [l]: [in * out] row-major
    std::vector<std::vector<double>> biases;   // [l]: [out]
    std::vector<double> stab_w;                // [dim * n_out]
    std::vector<double> stab_b;                // [n_out]
    bool has_stab = false;

    void init(int d, int no, int nt, const int64_t* w, const int64_t* b,
              const int64_t* sw, const int64_t* sb) {
        dim = d;
        n_out = no;
        n_trunk = nt;
        weights.resize(size_t(nt));
        biases.resize(size_t(nt));
        const int64_t* wp = w;
        const int64_t* bp = b;
        for (int l = 0; l < nt; ++l) {
            int out = (l == nt - 1) ? no : d;
            weights[size_t(l)].assign(wp, wp + size_t(d) * out);
            wp += size_t(d) * out;
            biases[size_t(l)].assign(bp, bp + out);
            bp += out;
        }
        stab_w.assign(sw, sw + size_t(d) * no);
        stab_b.assign(sb, sb + no);
        has_stab = false;
        for (double v : stab_w) has_stab = has_stab || v != 0.0;
        for (double v : stab_b) has_stab = has_stab || v != 0.0;
    }

    // Exactness certificate: propagate per-column absolute bounds (inputs
    // already include the << WEIGHT_SHIFT) through the network; every
    // intermediate |value| must stay < 2^53 for f64 integer arithmetic to be
    // exact. in_bound: [dim].
    bool bounds_ok(const double* in_bound) const {
        constexpr double LIM = 9007199254740992.0;  // 2^53
        std::vector<double> bx(in_bound, in_bound + dim), by;
        std::vector<double> stab_bound(size_t(n_out), 0.0);
        for (int o = 0; o < n_out; ++o) {
            double acc = std::fabs(stab_b[size_t(o)]);
            for (int i = 0; i < dim; ++i)
                acc += bx[size_t(i)] * std::fabs(stab_w[size_t(i) * n_out + o]);
            if (acc >= LIM) return false;
            stab_bound[size_t(o)] = acc;
        }
        for (int l = 0; l < n_trunk; ++l) {
            bool last = l == n_trunk - 1;
            int out = last ? n_out : dim;
            by.assign(size_t(out), 0.0);
            for (int o = 0; o < out; ++o) {
                double acc = std::fabs(biases[size_t(l)][size_t(o)]);
                if (last) acc += stab_bound[size_t(o)];
                for (int i = 0; i < dim; ++i)
                    acc += bx[size_t(i)] * std::fabs(weights[size_t(l)][size_t(i) * out + o]);
                if (acc >= LIM) return false;
                by[size_t(o)] = acc;
            }
            if (!last) {
                const double inv_act = std::ldexp(1.0, -act_shift);
                bx.resize(size_t(out));
                for (int o = 0; o < out; ++o)
                    bx[size_t(o)] = std::floor(by[size_t(o)] * inv_act);
            }
        }
        return true;
    }

    // One tile of BT symbols pushed through ALL layers while it stays in L1
    // (register-blocked: the per-output accumulator row of BT doubles lives
    // in vector registers across the i-loop). Inputs arrive TILE-PACKED:
    // Xt[i * BT + b] for tile-local lane b -- the gather writes and the
    // kernel reads then both stay within a ~dim*BT*8-byte L1 window instead
    // of striding across the whole chunk.
    static constexpr int BT = 64;

#ifdef __AVX512F__
    // Hand-vectorized tile: 32 lanes (4 zmm) x 2 outputs = 8 accumulator
    // registers held across the whole reduction; ~1.5 zmm-FMA/cycle vs ~0.2
    // for the compiler-scheduled generic version.
    void forward_tile(const double* __restrict Xt, int n_lanes, int output_shift,
                      double* __restrict out, int out_stride) const {
        constexpr int N = BT;
        alignas(64) double ping[64 * N];
        alignas(64) double pong[64 * N];
        alignas(64) double stab[64 * N];  // n_out <= 64
        const __m512d vzero = _mm512_setzero_pd();
        const __m512d inv16 = _mm512_set1_pd(std::ldexp(1.0, -act_shift));
        const __m512d vinv_out = _mm512_set1_pd(std::ldexp(1.0, -output_shift));

        // mode 0: hidden layer  -> floor(max(y,0) * 2^-16), row stride N
        // mode 1: last layer    -> (+stab) floor(y * 2^-shift), row stride out_stride
        // mode 2: stabiliser    -> raw accumulation, row stride N
        auto do_layer = [&](const double* __restrict src, const double* __restrict W,
                            const double* __restrict Bv, int in_n, int out_n, int mode,
                            double* __restrict dst, size_t dst_stride) {
            auto emit = [&](int o, int bb, __m512d a0, __m512d a1, __m512d a2, __m512d a3) {
                if (mode == 1 && has_stab) {
                    const double* s = stab + size_t(o) * N + bb;
                    a0 = _mm512_add_pd(a0, _mm512_load_pd(s));
                    a1 = _mm512_add_pd(a1, _mm512_load_pd(s + 8));
                    a2 = _mm512_add_pd(a2, _mm512_load_pd(s + 16));
                    a3 = _mm512_add_pd(a3, _mm512_load_pd(s + 24));
                }
                if (mode == 0) {  // relu then >> WEIGHT_SHIFT (floor == trunc, y >= 0)
                    a0 = _mm512_roundscale_pd(_mm512_mul_pd(_mm512_max_pd(a0, vzero), inv16), 0x09);
                    a1 = _mm512_roundscale_pd(_mm512_mul_pd(_mm512_max_pd(a1, vzero), inv16), 0x09);
                    a2 = _mm512_roundscale_pd(_mm512_mul_pd(_mm512_max_pd(a2, vzero), inv16), 0x09);
                    a3 = _mm512_roundscale_pd(_mm512_mul_pd(_mm512_max_pd(a3, vzero), inv16), 0x09);
                } else if (mode == 1) {  // arithmetic >> output_shift == floor
                    a0 = _mm512_roundscale_pd(_mm512_mul_pd(a0, vinv_out), 0x09);
                    a1 = _mm512_roundscale_pd(_mm512_mul_pd(a1, vinv_out), 0x09);
                    a2 = _mm512_roundscale_pd(_mm512_mul_pd(a2, vinv_out), 0x09);
                    a3 = _mm512_roundscale_pd(_mm512_mul_pd(a3, vinv_out), 0x09);
                }
                double* d = dst + size_t(o) * dst_stride + bb;
                _mm512_storeu_pd(d, a0);
                _mm512_storeu_pd(d + 8, a1);
                _mm512_storeu_pd(d + 16, a2);
                _mm512_storeu_pd(d + 24, a3);
            };

            for (int bb = 0; bb < n_lanes; bb += 32) {
                int o = 0;
                for (; o + 2 <= out_n; o += 2) {
                    __m512d b0 = _mm512_set1_pd(Bv[o]);
                    __m512d b1 = _mm512_set1_pd(Bv[o + 1]);
                    __m512d a00 = b0, a01 = b0, a02 = b0, a03 = b0;
                    __m512d a10 = b1, a11 = b1, a12 = b1, a13 = b1;
                    const double* x = src + bb;
                    const double* wp = W + o;
                    for (int i = 0; i < in_n; ++i, x += N, wp += out_n) {
                        __m512d w0 = _mm512_set1_pd(wp[0]);
                        __m512d w1 = _mm512_set1_pd(wp[1]);
                        __m512d x0 = _mm512_loadu_pd(x);
                        __m512d x1 = _mm512_loadu_pd(x + 8);
                        __m512d x2 = _mm512_loadu_pd(x + 16);
                        __m512d x3 = _mm512_loadu_pd(x + 24);
                        a00 = _mm512_fmadd_pd(w0, x0, a00);
                        a01 = _mm512_fmadd_pd(w0, x1, a01);
                        a02 = _mm512_fmadd_pd(w0, x2, a02);
                        a03 = _mm512_fmadd_pd(w0, x3, a03);
                        a10 = _mm512_fmadd_pd(w1, x0, a10);
                        a11 = _mm512_fmadd_pd(w1, x1, a11);
                        a12 = _mm512_fmadd_pd(w1, x2, a12);
                        a13 = _mm512_fmadd_pd(w1, x3, a13);
                    }
                    emit(o, bb, a00, a01, a02, a03);
                    emit(o + 1, bb, a10, a11, a12, a13);
                }
                if (o < out_n) {
                    __m512d b0 = _mm512_set1_pd(Bv[o]);
                    __m512d a00 = b0, a01 = b0, a02 = b0, a03 = b0;
                    const double* x = src + bb;
                    const double* wp = W + o;
                    for (int i = 0; i < in_n; ++i, x += N, wp += out_n) {
                        __m512d w0 = _mm512_set1_pd(wp[0]);
                        a00 = _mm512_fmadd_pd(w0, _mm512_loadu_pd(x), a00);
                        a01 = _mm512_fmadd_pd(w0, _mm512_loadu_pd(x + 8), a01);
                        a02 = _mm512_fmadd_pd(w0, _mm512_loadu_pd(x + 16), a02);
                        a03 = _mm512_fmadd_pd(w0, _mm512_loadu_pd(x + 24), a03);
                    }
                    emit(o, bb, a00, a01, a02, a03);
                }
            }
        };

        if (has_stab)
            do_layer(Xt, stab_w.data(), stab_b.data(), dim, n_out, 2, stab, N);

        const double* cur = Xt;
        double* nxt = ping;
        for (int l = 0; l < n_trunk; ++l) {
            bool last = l == n_trunk - 1;
            int out_n = last ? n_out : dim;
            if (last) {
                do_layer(cur, weights[size_t(l)].data(), biases[size_t(l)].data(),
                         dim, out_n, 1, out, size_t(out_stride));
            } else {
                do_layer(cur, weights[size_t(l)].data(), biases[size_t(l)].data(),
                         dim, out_n, 0, nxt, size_t(N));
                cur = nxt;
                nxt = (nxt == ping) ? pong : ping;
            }
        }
    }
#else
    void forward_tile(const double* __restrict Xt, int n_lanes, int output_shift,
                      double* __restrict out, int out_stride) const {
        constexpr int N = BT;
        double ping[64][N];
        double pong[64][N];
        double stab[64][N];  // n_out <= 64

        if (has_stab) {
            for (int o = 0; o < n_out; ++o) {
                double acc[N];
                double bb = stab_b[size_t(o)];
                for (int b = 0; b < N; ++b) acc[b] = bb;
                for (int i = 0; i < dim; ++i) {
                    double w = stab_w[size_t(i) * n_out + o];
                    const double* x = Xt + size_t(i) * N;
                    for (int b = 0; b < N; ++b) acc[b] += w * x[b];
                }
                for (int b = 0; b < N; ++b) stab[o][b] = acc[b];
            }
        }

        const double inv_out = std::ldexp(1.0, -output_shift);
        const double inv_act = std::ldexp(1.0, -act_shift);
        const double* cur = Xt;  // row stride N
        double* nxt = &ping[0][0];
        for (int l = 0; l < n_trunk; ++l) {
            bool last = l == n_trunk - 1;
            int out_n = last ? n_out : dim;
            const double* W = weights[size_t(l)].data();
            const double* Bv = biases[size_t(l)].data();
            // Register-blocked micro-kernel: 32 lanes (4 zmm) x 2 outputs =
            // 8 independent accumulator registers with the reduction loop
            // (i) INNERMOST -- the accumulators stay in registers for the
            // whole reduction instead of round-tripping through the stack.
            for (int bb = 0; bb < n_lanes; bb += 32) {
                int o = 0;
                for (; o + 2 <= out_n; o += 2) {
                    double acc0[32], acc1[32];
                    double b0 = Bv[o], b1 = Bv[o + 1];
                    for (int k = 0; k < 32; ++k) acc0[k] = b0;
                    for (int k = 0; k < 32; ++k) acc1[k] = b1;
                    for (int i = 0; i < dim; ++i) {
                        double w0 = W[size_t(i) * out_n + o];
                        double w1 = W[size_t(i) * out_n + o + 1];
                        const double* x = cur + size_t(i) * N + bb;
                        for (int k = 0; k < 32; ++k) {
                            double xv = x[k];
                            acc0[k] += w0 * xv;
                            acc1[k] += w1 * xv;
                        }
                    }
                    if (last) {
                        if (has_stab) {
                            for (int k = 0; k < 32; ++k) acc0[k] += stab[o][bb + k];
                            for (int k = 0; k < 32; ++k) acc1[k] += stab[o + 1][bb + k];
                        }
                        // Arithmetic >> output_shift == floor division by 2^shift.
                        for (int k = 0; k < 32; ++k)
                            out[size_t(o) * out_stride + bb + k] = std::floor(acc0[k] * inv_out);
                        for (int k = 0; k < 32; ++k)
                            out[size_t(o + 1) * out_stride + bb + k] =
                                std::floor(acc1[k] * inv_out);
                    } else {
                        // relu then >> WEIGHT_SHIFT (values >= 0: floor == trunc).
                        for (int k = 0; k < 32; ++k)
                            nxt[size_t(o) * N + bb + k] =
                                std::floor(std::max(acc0[k], 0.0) * inv_act);
                        for (int k = 0; k < 32; ++k)
                            nxt[size_t(o + 1) * N + bb + k] =
                                std::floor(std::max(acc1[k], 0.0) * inv_act);
                    }
                }
                for (; o < out_n; ++o) {
                    double acc[32];
                    double bb_v = Bv[o];
                    for (int k = 0; k < 32; ++k) acc[k] = bb_v;
                    for (int i = 0; i < dim; ++i) {
                        double w = W[size_t(i) * out_n + o];
                        const double* x = cur + size_t(i) * N + bb;
                        for (int k = 0; k < 32; ++k) acc[k] += w * x[k];
                    }
                    if (last) {
                        if (has_stab)
                            for (int k = 0; k < 32; ++k) acc[k] += stab[o][bb + k];
                        for (int k = 0; k < 32; ++k)
                            out[size_t(o) * out_stride + bb + k] = std::floor(acc[k] * inv_out);
                    } else {
                        for (int k = 0; k < 32; ++k)
                            nxt[size_t(o) * N + bb + k] =
                                std::floor(std::max(acc[k], 0.0) * inv_act);
                    }
                }
            }
            if (!last) {
                cur = nxt;
                nxt = (nxt == &ping[0][0]) ? &pong[0][0] : &ping[0][0];
            }
        }
    }
#endif  // __AVX512F__

    // X: tile-packed [ceil(batch/BT)][dim][BT] f64 (inputs already
    // << WEIGHT_SHIFT, exact integers; pad lanes zero-filled). Writes
    // [n_out][bcap] results (after >> output_shift) into `out`.
    void forward_batch(const double* X, int bcap, int batch, int output_shift,
                       double* out, double* /*scratch*/) const {
        for (int b0 = 0; b0 < batch; b0 += BT) {
            int used = std::min(batch - b0, BT);
            int n_lanes = (used + 31) / 32 * 32;  // whole 32-lane blocks only
            forward_tile(X + size_t(b0 / BT) * dim * BT, n_lanes, output_shift,
                         out + b0, bcap);
        }
    }
};

// Env-gated phase profiler (COOLCHIC_RC_PROF=1): accumulates wall time per
// rc_code_grid phase; dumped via rc_prof_dump().
struct RcProf {
    bool on = false;
    double t_order = 0, t_bound = 0, t_gather = 0, t_arm = 0, t_serial = 0, t_fill = 0;
    int64_t symbols = 0;
    RcProf() { on = getenv("COOLCHIC_RC_PROF") != nullptr; }
};
RcProf g_prof;

inline double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return double(ts.tv_sec) + 1e-9 * double(ts.tv_nsec);
};

constexpr int MASK = 9;       // MAX_ARM_MASK_SIZE
constexpr int PAD = (MASK - 1) / 2;

// Normative wavefront step of the `tpu` profile: pixel (y, x) belongs to
// wavefront d = x + step * y. Causality of the 9x9 mask needs step >= 5
// (a dy = -1 tap reaches dx = +4); the 128-lane decode needs the wavefront
// row span ceil(w / step) <= 128. The reference format (model 0) keeps the
// reference's step = MASK + 1 = 10.
inline int tpu_wavefront_step(int w) {
    int s = (w + 127) / 128;
    return s < 5 ? 5 : s;
}

// Shared wavefront walk: calls fn(pos_in_padded_buffer, wavefront_idx) for
// every pixel in normative coding order (reference latent.py:63-146;
// wavefront d = x + step * y, pixels of one wavefront by ascending y). All
// pixels of one wavefront have mutually causal-mask-disjoint contexts, so a
// decoder may batch them (the ARM inputs of wavefront k only touch pixels of
// wavefronts < k). For very narrow grids (w <= MASK) the order is raster and
// every pixel is its own wavefront.
template <typename F>
void wavefront_walk(int h, int w, int step, F&& fn) {
    int w_pad = w + 2 * PAD;
    if (w <= MASK) {  // no wavefront for very narrow grids: raster order
        int k = 0;
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) fn((r + PAD) * w_pad + PAD + c, k++);
        return;
    }
    int max_order = w - 1 + (h - 1) * step;
    for (int d = 0; d <= max_order; ++d) {
        int y_lo = d >= w ? (d - w) / step + 1 : 0;
        int y_hi = d / step;
        if (y_hi > h - 1) y_hi = h - 1;
        for (int y = y_lo; y <= y_hi; ++y)
            fn((y + PAD) * w_pad + PAD + (d - step * y), d);
    }
}

}  // namespace

extern "C" {

// ------------------------- tables -------------------------
void rc_set_tables(const float* mu_tab, int64_t n_mu, const float* sc_tab, int64_t n_sc) {
    g_mu_table.assign(mu_tab, mu_tab + n_mu);
    g_scale_table.assign(sc_tab, sc_tab + n_sc);
}

// ------------------------- raw symbol API -------------------------
void* rc_enc_new() { return new Encoder(); }
void rc_enc_free(void* e) { delete static_cast<Encoder*>(e); }

void rc_enc_encode_raw(void* e, const int32_t* sym, const double* mu, const double* sc,
                       int64_t n) {
    Encoder* enc = static_cast<Encoder*>(e);
    for (int64_t i = 0; i < n; ++i) {
        uint32_t left = left_cum(sym[i], mu[i], sc[i]);
        uint32_t prob = right_cum_minus_left(sym[i], mu[i], sc[i], left);
        enc->encode(left, prob);
    }
}

void rc_enc_encode_idx(void* e, const int32_t* sym, const int64_t* idx_mu,
                       const int64_t* idx_sc, int64_t n) {
    Encoder* enc = static_cast<Encoder*>(e);
    for (int64_t i = 0; i < n; ++i) {
        double mu, sc;
        lookup(idx_mu[i], idx_sc[i], &mu, &sc);
        uint32_t left = left_cum(sym[i], mu, sc);
        uint32_t prob = right_cum_minus_left(sym[i], mu, sc, left);
        enc->encode(left, prob);
    }
}

int64_t rc_enc_n_words_sealed(void* e) {
    // Seal a copy so the encoder can keep encoding afterwards.
    Encoder tmp = *static_cast<Encoder*>(e);
    tmp.seal();
    return int64_t(tmp.words.size());
}

void rc_enc_get_words_sealed(void* e, uint32_t* out) {
    Encoder tmp = *static_cast<Encoder*>(e);
    tmp.seal();
    std::memcpy(out, tmp.words.data(), tmp.words.size() * sizeof(uint32_t));
}

void* rc_dec_new(const uint32_t* words, int64_t n) {
    Decoder* d = new Decoder();
    d->init(words, n);
    return d;
}
void rc_dec_free(void* d) { delete static_cast<Decoder*>(d); }

void rc_dec_decode_raw(void* d, const double* mu, const double* sc, int64_t n, int32_t* out) {
    Decoder* dec = static_cast<Decoder*>(d);
    for (int64_t i = 0; i < n; ++i) out[i] = dec->decode(mu[i], sc[i]);
}

void rc_dec_decode_idx(void* d, const int64_t* idx_mu, const int64_t* idx_sc, int64_t n,
                       int32_t* out) {
    Decoder* dec = static_cast<Decoder*>(d);
    for (int64_t i = 0; i < n; ++i) {
        double mu, sc;
        lookup(idx_mu[i], idx_sc[i], &mu, &sc);
        out[i] = dec->decode(mu, sc);
    }
}

// ------------------------- full-grid wavefront codec -------------------------
//
// weights: concatenation of all trunk layer weight matrices, each [in, out]
//          row-major (pre-transposed for x @ W), in layer order; dims gives
//          (in, out) per layer. stab_w is [dim, 2] row-major.
// ifce_ctx: [h * w, n_ifce] int64 (X.8 fixed point) in raster order, or null.
// data: encode -> int64[h * w] input latents (raster order, in [-64, 63]);
//       decode -> int64[h * w] output buffer.
//
// Returns 0 on success.
static void build_arm(ArmFixedPoint& arm, int dim, int n_out, int n_trunk,
                      const int64_t* weights, const int64_t* biases,
                      const int64_t* stab_w, const int64_t* stab_b) {
    arm.dim = dim;
    arm.n_out = n_out;
    arm.n_trunk = n_trunk;
    arm.weights.resize(size_t(n_trunk));
    arm.biases.resize(size_t(n_trunk));
    const int64_t* wp = weights;
    const int64_t* bp = biases;
    for (int l = 0; l < n_trunk; ++l) {
        int out = (l == n_trunk - 1) ? n_out : dim;
        arm.weights[size_t(l)].assign(wp, wp + size_t(dim) * out);
        wp += size_t(dim) * out;
        arm.biases[size_t(l)].assign(bp, bp + out);
        bp += out;
    }
    arm.stab_w.assign(stab_w, stab_w + size_t(dim) * n_out);
    arm.stab_b.assign(stab_b, stab_b + n_out);
}

// Batched fixed-point ARM forward (used for the IFCE context computation,
// where numpy's int64 matmul has no fast path). f64 SIMD path with a static
// exactness certificate; falls back to scalar int64 otherwise.
int32_t rc_arm_forward(const int64_t* x, int64_t n, int32_t n_spatial_plus_ifce,
                       int32_t n_trunk, const int64_t* weights, const int64_t* biases,
                       const int64_t* stab_w, const int64_t* stab_b,
                       int32_t n_out, int32_t output_shift, int32_t act_shift,
                       int64_t* out) {
    int dim = n_spatial_plus_ifce;
    if (dim > 64 || n_out > 64) return -1;
    const double act_scale = std::ldexp(1.0, act_shift);

    ArmBatchF64 fast;
    fast.init(dim, n_out, n_trunk, weights, biases, stab_w, stab_b);
    fast.act_shift = act_shift;
    double in_bound[64];
    for (int k = 0; k < dim; ++k) {
        int64_t m = 0;
        for (int64_t i = 0; i < n; ++i) {
            int64_t v = x[size_t(i) * dim + k];
            if (v < 0) v = -v;
            if (v > m) m = v;
        }
        in_bound[k] = double(m) * act_scale;
    }

    if (fast.bounds_ok(in_bound)) {
        constexpr int BCAP = 2048;
        constexpr int BT = ArmBatchF64::BT;
        std::vector<double> X(size_t(dim) * BCAP), res(size_t(n_out) * BCAP);
        for (int64_t c0 = 0; c0 < n; c0 += BCAP) {
            int batch = int(std::min(n - c0, int64_t(BCAP)));
            if (batch % BT) {  // zero the pad lanes of the final tile
                size_t t0 = size_t(batch / BT) * dim * BT;
                std::fill(X.begin() + t0, X.begin() + t0 + size_t(dim) * BT, 0.0);
            }
            for (int b = 0; b < batch; ++b) {
                double* xt = X.data() + size_t(b / BT) * dim * BT + (b % BT);
                const int64_t* row = x + size_t(c0 + b) * dim;
                for (int k = 0; k < dim; ++k) xt[size_t(k) * BT] = double(row[k]) * act_scale;
            }
            fast.forward_batch(X.data(), BCAP, batch, output_shift, res.data(), nullptr);
            for (int b = 0; b < batch; ++b)
                for (int o = 0; o < n_out; ++o)
                    out[size_t(c0 + b) * n_out + o] = int64_t(res[size_t(o) * BCAP + b]);
        }
        return 0;
    }

    ArmFixedPoint arm;
    build_arm(arm, dim, n_out, n_trunk, weights, biases, stab_w, stab_b);
    arm.act_shift = act_shift;
    for (int64_t i = 0; i < n; ++i) {
        arm.forward(x + size_t(i) * dim, out + size_t(i) * n_out, output_shift);
    }
    return 0;
}

// Shared implementation: one latent grid coded over `n_streams` interleaved
// range-coder streams. Pixel j of wavefront k goes to stream j % n_streams
// (the `tpu` bitstream profile; n_streams == 1 is the reference format).
// model 0: reference X.16 ARM + f64 Laplace CDF (bit-compatible with the
// reference bitstream). model 1: `tpu` profile -- X.8 int32 ARM + integer
// CDF (tpu_cdf.py spec; params must come from arm8_from_int_layers).
static int32_t code_grid_impl(void** coders, int32_t n_streams, int32_t is_encode,
                              int32_t model,
                              int32_t h, int32_t w,
                              int32_t n_spatial_ctx, int32_t n_ifce_ctx,
                              const int64_t* ifce_ctx,
                              int32_t n_trunk, const int64_t* weights,
                              const int64_t* biases,
                              const int64_t* stab_w, const int64_t* stab_b,
                              const int32_t* ctx_flat_idx, int64_t* data) {
    int dim = n_spatial_ctx + n_ifce_ctx;
    if (dim > 64 || n_streams < 1) return -1;
    if (model == 1) g_tpu_slope.ensure();
    const int act_shift = model == 1 ? 8 : WEIGHT_SHIFT;
    const int out_shift = model == 1 ? 8 : OUTPUT_SHIFT;
    const double act_scale = std::ldexp(1.0, act_shift);
    // Model 1 feeds X.8 IFCE context columns raw (their payload IS the
    // activation scale); model 0 shifts everything and compensates in the
    // weights (reference armint.py semantics).
    const double ifce_scale = model == 1 ? 1.0 : act_scale;

    int w_pad = w + 2 * PAD;
    int h_pad = h + 2 * PAD;
    std::vector<int64_t> buf(size_t(w_pad) * h_pad, 0);

    // 1-D offsets of the spatial context pixels in the padded buffer.
    int offs[64];
    for (int k = 0; k < n_spatial_ctx; ++k) {
        int idx = ctx_flat_idx[k];
        int dy = idx / MASK - PAD;
        int dx = idx % MASK - PAD;
        offs[k] = dy * w_pad + dx;
    }

    // Normative coding order, with wavefront boundaries for batched decode.
    double tp = g_prof.on ? now_s() : 0.0;
    std::vector<int32_t> order;
    order.reserve(size_t(h) * w);
    std::vector<int32_t> wf_start;
    const int wf_step = model == 1 ? tpu_wavefront_step(w) : MASK + 1;
    wavefront_walk(h, w, wf_step, [&](int pos, int wf) {
        while (int(wf_start.size()) <= wf) wf_start.push_back(int32_t(order.size()));
        order.push_back(int32_t(pos));
    });
    wf_start.push_back(int32_t(order.size()));
    if (g_prof.on) {
        double t = now_s();
        g_prof.t_order += t - tp;
        g_prof.symbols += int64_t(h) * w;
        tp = t;
    }

    // f64 SIMD ARM when the static exactness bound holds (always, in practice).
    ArmBatchF64 fast;
    fast.init(dim, 2, n_trunk, weights, biases, stab_w, stab_b);
    fast.act_shift = act_shift;
    double in_bound[64];
    for (int k = 0; k < n_spatial_ctx; ++k)
        in_bound[k] = double(-SYM_MIN) * act_scale;
    for (int k = 0; k < n_ifce_ctx; ++k) {
        int64_t m = 0;
        for (size_t i = 0; i < size_t(h) * w; ++i) {
            int64_t v = ifce_ctx[i * size_t(n_ifce_ctx) + k];
            if (v < 0) v = -v;
            if (v > m) m = v;
        }
        in_bound[n_spatial_ctx + k] = double(m) * ifce_scale;
    }
    bool use_fast = fast.bounds_ok(in_bound);
    if (g_prof.on) {
        double t = now_s();
        g_prof.t_bound += t - tp;
        tp = t;
    }

    Encoder** encs = is_encode ? reinterpret_cast<Encoder**>(coders) : nullptr;
    Decoder** decs = is_encode ? nullptr : reinterpret_cast<Decoder**>(coders);
    int64_t n_mu = int64_t(g_mu_table.size());

    if (is_encode) {  // validate symbols upfront; also fills the context buffer
        for (int yy = 0; yy < h; ++yy) {
            for (int xx = 0; xx < w; ++xx) {
                int64_t sv = data[size_t(yy) * w + xx];
                if (sv < SYM_MIN || sv > SYM_MAX) return -2;
                buf[size_t(yy + PAD) * w_pad + PAD + xx] = sv;
            }
        }
    }

    // Entropy-code one symbol given the fixed-point ARM output (mu, log-scale).
    auto code_symbol = [&](int stream, int pos, int64_t out_mu, int64_t out_ls) {
        int64_t idx_mu = out_mu - MU_MIN_FP;
        if (idx_mu < 0) idx_mu = 0;
        if (idx_mu >= n_mu) idx_mu = n_mu - 1;
        int mu_fp = int(idx_mu) + int(MU_MIN_FP);

        int y = pos / w_pad - PAD;
        int x = pos % w_pad - PAD;
        uint32_t left, prob;
        int s;
        if (model == 1) {  // integer CDF (tpu profile; spec in tpu_cdf.py)
            int64_t idx_sc = out_ls - LOG_SCALE_MIN_FP;
            if (idx_sc < 0) idx_sc = 0;
            if (idx_sc >= int64_t(g_tpu_slope.v.size()))
                idx_sc = int64_t(g_tpu_slope.v.size()) - 1;
            uint32_t slope = g_tpu_slope.v[size_t(idx_sc)];
            if (is_encode) {
                s = int(data[size_t(y) * w + x]);
                left = tpu_left_cum(s, mu_fp, slope);
                prob = (s >= SYM_MAX) ? uint32_t((1u << PRECISION) - left)
                                      : tpu_left_cum(s + 1, mu_fp, slope) - left;
                encs[stream]->encode(left, prob);
            } else {
                Decoder* dec = decs[stream];
                uint64_t scale64 = dec->range >> PRECISION;
                uint32_t quantile = dec->quantile();
                InvResult r = tpu_invert(quantile, mu_fp, slope);
                s = r.s;
                left = r.left;
                prob = (s >= SYM_MAX) ? uint32_t((1u << PRECISION) - left)
                                      : r.left_next - left;
                dec->advance(scale64, left, prob);
                buf[size_t(pos)] = s;
                data[size_t(y) * w + x] = s;
            }
            return;
        }
        double mu = double(g_mu_table[size_t(idx_mu)]);
        ScaleExpTable* t = g_scale_cache.get(out_ls - LOG_SCALE_MIN_FP);
        if (is_encode) {
            s = int(data[size_t(y) * w + x]);
            left = left_cum_tab(s, mu_fp, t);
            prob = (s >= SYM_MAX) ? uint32_t((1u << PRECISION) - left)
                                  : left_cum_tab(s + 1, mu_fp, t) - left;
            encs[stream]->encode(left, prob);
        } else {
            Decoder* dec = decs[stream];
            uint64_t scale64 = dec->range >> PRECISION;
            uint32_t quantile = dec->quantile();
            InvResult r = invert_quantile_tab(quantile, mu, mu_fp, t);
            s = r.s;
            left = r.left;
            prob = (s >= SYM_MAX) ? uint32_t((1u << PRECISION) - left)
                                  : r.left_next - left;
            dec->advance(scale64, left, prob);
            buf[size_t(pos)] = s;
            data[size_t(y) * w + x] = s;
        }
    };

    // Stream id of a pixel: its ROW modulo n_streams. Wavefront pixels have
    // distinct consecutive rows, so (for wavefront span <= n_streams) one
    // wavefront touches each stream at most once AND the lane<->stream
    // mapping in the wavefront kernel is a static lane rotation (docs/tpu_profile.md).
    auto stream_of_pos = [&](int pos) {
        int y = pos / w_pad - PAD;
        return y % n_streams;
    };

    if (!use_fast) {  // scalar int64 fallback, pixel by pixel
        ArmFixedPoint arm;
        build_arm(arm, dim, 2, n_trunk, weights, biases, stab_w, stab_b);
        arm.act_shift = act_shift;
        arm.n_raw_tail = model == 1 ? n_ifce_ctx : 0;
        for (size_t i = 0; i < order.size(); ++i) {
            int32_t pos = order[i];
            int64_t ctx[64];
            for (int k = 0; k < n_spatial_ctx; ++k) ctx[k] = buf[size_t(pos + offs[k])];
            if (n_ifce_ctx > 0) {
                int y = pos / w_pad - PAD;
                int x = pos % w_pad - PAD;
                const int64_t* row = ifce_ctx + (size_t(y) * w + x) * n_ifce_ctx;
                for (int k = 0; k < n_ifce_ctx; ++k) ctx[n_spatial_ctx + k] = row[k];
            }
            int64_t out2[2];
            arm.forward(ctx, out2, out_shift);
            code_symbol(stream_of_pos(pos), pos, out2[0], out2[1]);
        }
        return 0;
    }

    constexpr int BCAP = 2048;
    constexpr int BT = ArmBatchF64::BT;
    std::vector<double> X(size_t(dim) * BCAP), out2(size_t(2) * BCAP);

    // Gather + ARM for a range of 64-lane tiles of one chunk -- the unit of
    // thread parallelism (tiles are disjoint in X and in the output rows).
    auto gather_tile = [&](const int32_t* ord, int batch, int t, double* Xp) {
        int b0 = t * BT;
        int used = std::min(batch - b0, BT);
        double* xt_base = Xp + size_t(t) * dim * BT;
        if (used < BT)
            std::fill(xt_base, xt_base + size_t(dim) * BT, 0.0);
        for (int b = b0; b < b0 + used; ++b) {
            int pos = ord[b];
            double* xt = xt_base + (b - b0);
            for (int k = 0; k < n_spatial_ctx; ++k)
                xt[size_t(k) * BT] = double(buf[size_t(pos + offs[k])]) * act_scale;
            if (n_ifce_ctx > 0) {
                int y = pos / w_pad - PAD;
                int x = pos % w_pad - PAD;
                const int64_t* row = ifce_ctx + (size_t(y) * w + x) * n_ifce_ctx;
                for (int k = 0; k < n_ifce_ctx; ++k)
                    xt[size_t(n_spatial_ctx + k) * BT] = double(row[k]) * ifce_scale;
            }
        }
    };

    auto arm_tile = [&](int batch, int t, double* Xp, double* outp) {
        int used = std::min(batch - t * BT, BT);
        int n_lanes = (used + 31) / 32 * 32;
        fast.forward_tile(Xp + size_t(t) * dim * BT, n_lanes, out_shift,
                          outp + t * BT, BCAP);
    };

    auto gather = [&](const int32_t* ord, int batch) {
        int n_tiles = (batch + BT - 1) / BT;
        for (int t = 0; t < n_tiles; ++t) gather_tile(ord, batch, t, X.data());
    };

    int n_threads = 1;
#ifdef _OPENMP
    {
        const char* e = getenv("COOLCHIC_CODE_THREADS");
        n_threads = e ? std::atoi(e) : omp_get_max_threads();
        if (n_threads < 1) n_threads = 1;
        if (n_threads > 64) n_threads = 64;
    }
#endif

    if (is_encode) {
        // All contexts are known upfront (decoded == encoded for a lossless
        // entropy coder), so the whole grid's ARM runs as one batched pass
        // (chunks split across threads with private buffers), and the
        // entropy loop parallelizes over stream classes.
        size_t n = order.size();
        std::vector<int64_t> mu_v(n), ls_v(n);
#ifdef _OPENMP
        g_scale_cache.get(0);  // size the shared slot table before the region
        #pragma omp parallel num_threads(n_threads)
        {
            std::vector<double> Xp(size_t(dim) * BCAP), outp(size_t(2) * BCAP);
            #pragma omp for schedule(static)
            for (int64_t c0 = 0; c0 < int64_t(n); c0 += BCAP) {
                int batch = int(std::min(int64_t(n) - c0, int64_t(BCAP)));
                int n_tiles = (batch + BT - 1) / BT;
                for (int t = 0; t < n_tiles; ++t) {
                    gather_tile(order.data() + c0, batch, t, Xp.data());
                    arm_tile(batch, t, Xp.data(), outp.data());
                }
                for (int b = 0; b < batch; ++b) {
                    mu_v[size_t(c0) + b] = int64_t(outp[size_t(b)]);
                    ls_v[size_t(c0) + b] = int64_t(outp[size_t(BCAP) + b]);
                }
            }
            // Stream class s % T belongs to thread s % T; per-stream symbol
            // order is the monotone global scan order.
            int tid = omp_get_thread_num();
            int T = omp_get_num_threads();
            for (size_t i = 0; i < n; ++i) {
                int s = stream_of_pos(order[i]);
                if (s % T == tid)
                    code_symbol(s, order[i], mu_v[i], ls_v[i]);
            }
        }
#else
        for (size_t c0 = 0; c0 < n; c0 += BCAP) {
            int batch = int(std::min(n - c0, size_t(BCAP)));
            gather(order.data() + c0, batch);
            fast.forward_batch(X.data(), BCAP, batch, out_shift, out2.data(),
                               nullptr);
            for (int b = 0; b < batch; ++b) {
                mu_v[c0 + b] = int64_t(out2[size_t(b)]);
                ls_v[c0 + b] = int64_t(out2[size_t(BCAP) + b]);
            }
        }
        for (size_t i = 0; i < n; ++i)
            code_symbol(stream_of_pos(order[i]), order[i], mu_v[i], ls_v[i]);
#endif
        return 0;
    }

    // Decode: the ARM inputs of one wavefront only touch already-decoded
    // wavefronts, so each wavefront's ARM runs as one batched forward
    // (tiles split across threads) and the per-wavefront entropy update is
    // serial per STREAM -- with the tpu profile's interleaved streams it
    // parallelizes over stream classes too.
#ifdef _OPENMP
    if (n_threads > 1) {
        g_scale_cache.get(0);  // size the shared slot table before the region
        #pragma omp parallel num_threads(n_threads)
        {
            int tid = omp_get_thread_num();
            int T = omp_get_num_threads();
            for (size_t wf = 0; wf + 1 < wf_start.size(); ++wf) {
                int start = wf_start[wf];
                int end = wf_start[wf + 1];
                for (int c0 = start; c0 < end; c0 += BCAP) {
                    int batch = std::min(end - c0, BCAP);
                    int n_tiles = (batch + BT - 1) / BT;
                    for (int t = tid; t < n_tiles; t += T) {
                        gather_tile(order.data() + c0, batch, t, X.data());
                        arm_tile(batch, t, X.data(), out2.data());
                    }
                    #pragma omp barrier
                    if (n_streams > 1) {
                        for (int b = 0; b < batch; ++b) {
                            int s = stream_of_pos(order[size_t(c0) + b]);
                            if (s % T != tid) continue;
                            code_symbol(s, order[size_t(c0) + b],
                                        int64_t(out2[size_t(b)]),
                                        int64_t(out2[size_t(BCAP) + b]));
                        }
                    } else if (tid == 0) {
                        for (int b = 0; b < batch; ++b)
                            code_symbol(0, order[size_t(c0) + b],
                                        int64_t(out2[size_t(b)]),
                                        int64_t(out2[size_t(BCAP) + b]));
                    }
                    #pragma omp barrier
                }
            }
        }
        return 0;
    }
#endif
    for (size_t wf = 0; wf + 1 < wf_start.size(); ++wf) {
        int start = wf_start[wf];
        int end = wf_start[wf + 1];
        for (int c0 = start; c0 < end; c0 += BCAP) {
            int batch = std::min(end - c0, BCAP);
            if (g_prof.on) tp = now_s();
            gather(order.data() + c0, batch);
            if (g_prof.on) {
                double t = now_s();
                g_prof.t_gather += t - tp;
                tp = t;
            }
            fast.forward_batch(X.data(), BCAP, batch, out_shift, out2.data(),
                               nullptr);
            if (g_prof.on) {
                double t = now_s();
                g_prof.t_arm += t - tp;
                tp = t;
            }
            for (int b = 0; b < batch; ++b)
                code_symbol(stream_of_pos(order[size_t(c0) + b]),
                            order[size_t(c0) + b],
                            int64_t(out2[size_t(b)]),
                            int64_t(out2[size_t(BCAP) + b]));
            if (g_prof.on) g_prof.t_serial += now_s() - tp;
        }
    }
    return 0;
}

int32_t rc_code_grid(void* coder, int32_t is_encode, int32_t h, int32_t w,
                     int32_t n_spatial_ctx, int32_t n_ifce_ctx, const int64_t* ifce_ctx,
                     int32_t n_trunk, const int64_t* weights, const int64_t* biases,
                     const int64_t* stab_w, const int64_t* stab_b,
                     const int32_t* ctx_flat_idx,  // [n_spatial_ctx] 9x9 indices
                     int64_t* data) {
    return code_grid_impl(&coder, 1, is_encode, 0, h, w, n_spatial_ctx, n_ifce_ctx,
                          ifce_ctx, n_trunk, weights, biases, stab_w, stab_b,
                          ctx_flat_idx, data);
}

// `tpu` profile: n_streams interleaved constriction streams per grid, with
// the integer probability model + X.8 int32 ARM (model == 1).
int32_t rc_code_grid_streams(void** coders, int32_t n_streams, int32_t is_encode,
                             int32_t model,
                             int32_t h, int32_t w,
                             int32_t n_spatial_ctx, int32_t n_ifce_ctx,
                             const int64_t* ifce_ctx,
                             int32_t n_trunk, const int64_t* weights,
                             const int64_t* biases,
                             const int64_t* stab_w, const int64_t* stab_b,
                             const int32_t* ctx_flat_idx, int64_t* data) {
    return code_grid_impl(coders, n_streams, is_encode, model, h, w, n_spatial_ctx,
                          n_ifce_ctx, ifce_ctx, n_trunk, weights, biases,
                          stab_w, stab_b, ctx_flat_idx, data);
}



void rc_prof_dump() {
    std::fprintf(stderr,
                 "[rc_prof] symbols=%lld order=%.1fms bound=%.1fms gather=%.1fms "
                 "arm=%.1fms serial=%.1fms\n",
                 (long long)g_prof.symbols, g_prof.t_order * 1e3, g_prof.t_bound * 1e3,
                 g_prof.t_gather * 1e3, g_prof.t_arm * 1e3, g_prof.t_serial * 1e3);
    g_prof = RcProf();
}

}  // extern "C"
