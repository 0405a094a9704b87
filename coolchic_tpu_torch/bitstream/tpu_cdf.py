"""Integer-only normative probability model for the `tpu` bitstream profile.

Why it exists: the reference model evaluates the Laplace CDF with libm
`exp` in f64 (constriction's QuantizedLaplace). A TPU kernel has no f64 and
no libm, so the `tpu` profile defines the 24-bit quantized CDF with PURE
int32/uint32 arithmetic that any platform reproduces bit-exactly:

  argument      m   = s*256 - 128 - mu_fp          (X.8 integer, |m| <= 33024)
  log2 slope    slope(idx) = max(1, SL0 * exp2i(idx * CSL) >> 24)
  t = |m| * slope                                  (X.24 log2 exponent)
  exp2i(t) = poly(t & 0xFFFFFF) >> min(t >> 24, 40)
  poly(u)  = integer Horner, degree 6:  r = C6; r = Ck + (r * u >> 24)
             (max |poly - 2^24 * 2^-u/2^24| = 4 units)
  cdf24(m)  = exp2i(t) >> 1                 for m >= 0   (0.5 * 2^-t)
            = 2^24 - (exp2i(t) >> 1)        for m < 0    (1 - 0.5 * 2^-t)
  left_cum(s) = (FREE_WEIGHT * cdf24(m) >> 24) + (s - SYM_MIN) * LEAK_STEP

Everything reduces to NINE normative integer constants (below) -- no tables
at all, so a TPU lane evaluates the CDF without per-lane gathers. The
per-symbol math never touches floats on any implementation.

The profile also redefines the fixed-point ARM in int32 (X.8 activations and
weights, X.16 biases, >>8 shifts) -- exact for the quantized parameters
(ARM/IFCE weight q-steps are >= 2^-8, reference nnquant/quantstep.py:20-69)
-- with an encoder-side certificate that every intermediate stays < 2^31.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from coolchic_tpu_torch.core.constants import N_POSSIBLE_SCALE

PRECISION = 24
SYM_MIN = -64
SYM_MAX = 63
# Leak per symbol: 16 units instead of the reference's 1. The 3-table exp2
# product can jitter by up to ~6 units against the true CDF; a 16-unit leak
# makes left_cum PROVABLY strictly increasing (so prob >= 10 > 0 for every
# symbol) at a total rate cost of 127*15 extra leak units ~= 0.011% of the
# 24-bit budget.
LEAK_STEP = 16
FREE_WEIGHT = (1 << PRECISION) - 1 - (SYM_MAX - SYM_MIN) * LEAK_STEP
# Max |m|: |s*256 - 128 - mu_fp| <= 64*256 + 128 + 64*256 = 32896 -> 33024 pad.
MAX_ABS_M = 33024


# The nine normative constants: degree-6 integer Horner coefficients of
# 2^24 * 2^(-u/2^24) on u in [0, 2^24) (X.24, ascending powers), the X.24
# per-scale-index log2 decay CSL = round(2^24 * log2(e)/256), and the X.24
# slope at scale index 0, SL0 = round(2^24 * log2(e) * e^5 / 256).
EXP2_POLY = (16777216, -11629077, 4030290, -930970, 160710, -21395, 1835)
CSL = 94548
SL0 = 14032236


@lru_cache(maxsize=1)
def slope_table() -> np.ndarray:
    """slope(idx) for idx 0..N_POSSIBLE_SCALE-1, derived from the integer
    formula (identical everywhere; cached for vectorized host use)."""
    idx = np.arange(N_POSSIBLE_SCALE, dtype=np.uint64)
    v = (np.uint64(SL0) * exp2_neg24(idx * np.uint64(CSL)).astype(np.uint64)
         ) >> np.uint64(PRECISION)
    return np.maximum(v, 1).astype(np.uint32)


# ---------------------------------------------------------------------------
# numpy oracle (vectorized; all uint64 intermediates below stay < 2^56 and
# every operation is exact integer math -- this is the spec both the C++ and
# the CUDA implementations must match bit for bit).
# ---------------------------------------------------------------------------
def exp2_neg24(t: np.ndarray) -> np.ndarray:
    """exp2(-t / 2^24) in X.24, t uint64 >= 0. Returns uint32 <= 2^24.
    Integer Horner (all intermediates |.| < 2^49, arithmetic >> rounds
    toward -inf, as the kernels do)."""
    t = np.asarray(t, dtype=np.uint64)
    q = np.minimum(t >> PRECISION, np.uint64(40))
    f = (t & np.uint64((1 << PRECISION) - 1)).astype(np.int64)
    r = np.full(t.shape, EXP2_POLY[6], dtype=np.int64)
    for k in range(5, -1, -1):
        r = EXP2_POLY[k] + ((r * f) >> PRECISION)
    r = np.clip(r, 0, 1 << PRECISION)
    return (r.astype(np.uint64) >> q).astype(np.uint32)


# ---------------------------------------------------------------------------
# int32 X.8 fixed-point ARM (tpu-profile normative variant).
# ---------------------------------------------------------------------------
ARM8_WEIGHT_SHIFT = 8    # activations and weights are X.8
ARM8_BIAS_SHIFT = 16     # biases are X.16
ARM8_OUT_SHIFT = 8       # X.16 accumulator -> X.8 (mu, log-scale)
INT32_LIM = 1 << 31


def arm8_from_int_layers(int_layers, q_shift_weight, q_shift_bias, *,
                         stabiliser=None, subtract_last_layer=True,
                         n_inter_ft_ctx=0, no_residual_layer=False) -> dict:
    """Quantized integer params -> X.8 fixed point (same folding rules as
    bitstream.fixedpoint.arm_to_fixed_point with 8-bit scales).

    Unlike the X.16 reference pipeline (which feeds IFCE context columns
    pre-scaled by 2^8 and compensates with 8 fewer weight bits), the X.8
    pipeline feeds IFCE columns RAW (their X.8 payload IS the activation
    scale) and spatial columns << 8 -- so every weight column uses the same
    uniform X.8 representation and stays an exact integer for the normative
    q-step grids (q_shift_weight >= -8). n_inter_ft_ctx is accepted for call
    compatibility but needs no weight special-casing here."""
    assert q_shift_weight >= -ARM8_WEIGHT_SHIFT
    assert q_shift_bias >= -ARM8_BIAS_SHIFT
    del n_inter_ft_ctx
    trunk_w, trunk_b = [], []
    n_layers = len(int_layers)
    for li, lay in enumerate(int_layers):
        is_last = li == n_layers - 1
        wq = np.asarray(lay["weight"], dtype=np.int64)
        bq = np.asarray(lay["bias"], dtype=np.int64).copy()
        if is_last and subtract_last_layer:
            bq[1] += -(4 << (-q_shift_bias))
        w_fp = wq * (np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT + q_shift_weight))
        if wq.shape[0] == wq.shape[1] and not no_residual_layer:
            w_fp = w_fp + np.eye(wq.shape[0], dtype=np.int64) * (
                np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT))
        trunk_w.append(w_fp.T.astype(np.int64).copy())
        trunk_b.append((bq * (np.int64(1) << np.int64(ARM8_BIAS_SHIFT + q_shift_bias))
                        ).astype(np.int64))
    dim = int_layers[0]["weight"].shape[1]
    n_out = int_layers[-1]["weight"].shape[0]
    if stabiliser is not None:
        sw = np.asarray(stabiliser["weight"], dtype=np.int64)
        stab_w = (sw * (np.int64(1) << np.int64(ARM8_WEIGHT_SHIFT + q_shift_weight))
                  ).T.copy()
        stab_b = (np.asarray(stabiliser["bias"], dtype=np.int64)
                  * (np.int64(1) << np.int64(ARM8_BIAS_SHIFT + q_shift_bias)))
    else:
        stab_w = np.zeros((dim, n_out), dtype=np.int64)
        stab_b = np.zeros((n_out,), dtype=np.int64)
    return {"trunk_weights": trunk_w, "trunk_biases": trunk_b,
            "stab_weight": stab_w, "stab_bias": stab_b}


def arm8_bounds_ok(arm8: dict, in_bound: np.ndarray) -> bool:
    """Certificate: with per-column input bounds (X.8, i.e. already * 2^8),
    every intermediate of the X.8 pipeline stays < 2^31."""
    bx = np.asarray(in_bound, dtype=np.float64)
    stab_bound = (np.abs(arm8["stab_bias"]).astype(np.float64)
                  + bx @ np.abs(arm8["stab_weight"]).astype(np.float64))
    if (stab_bound >= INT32_LIM).any():
        return False
    n = len(arm8["trunk_weights"])
    for li, (w, b) in enumerate(zip(arm8["trunk_weights"], arm8["trunk_biases"])):
        by = np.abs(b).astype(np.float64) + bx @ np.abs(w).astype(np.float64)
        if li == n - 1:
            by = by + stab_bound
        if (by >= INT32_LIM).any():
            return False
        if li < n - 1:
            bx = np.floor(by / 256.0)
    return True
