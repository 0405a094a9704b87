"""Format-level constants of the Cool-Chic 5.0.1 bitstream, shared by the
training (rate proxy) and bitstream (fixed point) paths.

These values are part of the interchange format and must match the reference
implementation exactly (reference files cited per-constant below).

Reference parity:
  - LOG_SCALE_MIN/MAX: coolchic/component/core/arm.py:18-19
  - ARM_LOG_SHIFT: coolchic/component/core/arm.py:173 (log_shift buffer = -4)
  - MAX_ARM_MASK_SIZE + priority order: coolchic/component/core/arm.py:493-511
  - Fixed point shifts: coolchic/bitstream/component/constants.py:7-39
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Laplace scale reparameterization: b = exp(clamp(raw + ARM_LOG_SHIFT, MIN, MAX))
# ---------------------------------------------------------------------------
LOG_SCALE_MIN = -5
LOG_SCALE_MAX = 5
ARM_LOG_SHIFT = -4

# Rate proxy floor: no latent can cost more than 16 bits.
MIN_PROBA = 2.0 ** -16

# ---------------------------------------------------------------------------
# Spatial context template (causal 9x9 mask).
# ---------------------------------------------------------------------------
MAX_ARM_MASK_SIZE = 9

# Priority in which the 40 causal positions (flattened 9x9 indices 0..39,
# center excluded) are consumed when `n_spatial_ctx` contexts are requested.
# Lower priority value = used first.  This table is normative: it defines the
# meaning of "the first N context pixels" in the bitstream.
PRIORITY_ORDER = np.array(
    [
        38, 35, 30, 25, 23, 31, 36, 37, 39,
        33, 28, 21, 20,  6, 15, 22, 29, 34,
        32, 18, 12, 10,  5,  9, 14, 19, 27,
        24, 13,  8,  2,  1,  3, 11, 17, 26,
        16,  7,  4,  0,
    ],
    dtype=np.int64,
)


def non_zero_pixel_ctx_index(n_spatial_ctx: int) -> np.ndarray:
    """Flattened (9x9 grid) indices of the first ``n_spatial_ctx`` context
    pixels, in ARM input-channel order.

    Mirrors `_get_non_zero_pixel_ctx_index` (reference arm.py:522-562):
    argsort of the priority table (stable) selects positions by priority.
    """
    center = (MAX_ARM_MASK_SIZE**2 - 1) // 2  # 40
    possible = np.arange(center)
    order = np.argsort(PRIORITY_ORDER, kind="stable")
    return possible[order][:n_spatial_ctx]


def ctx_row_col_offsets(n_spatial_ctx: int) -> list[tuple[int, int]]:
    """(dy, dx) offsets of each context pixel relative to the coded pixel:
    index i of the flattened 9x9 window sits at (i // 9 - 4, i % 9 - 4)."""
    half = (MAX_ARM_MASK_SIZE - 1) // 2
    idx = non_zero_pixel_ctx_index(n_spatial_ctx)
    return [(int(i) // MAX_ARM_MASK_SIZE - half, int(i) % MAX_ARM_MASK_SIZE - half)
            for i in idx]


# ---------------------------------------------------------------------------
# Fixed-point bitstream arithmetic (decoder spec).
# ---------------------------------------------------------------------------
AC_MAX_VAL = 64  # latents live in [-64, 63] once written to the bitstream

WEIGHT_SHIFT = 16  # ARM weights use X.16 fixed point
BIAS_SHIFT = 2 * WEIGHT_SHIFT  # ARM biases use X.32 fixed point

N_FRAC_BIT_MU_SCALE = 8  # (mu, log-scale) table resolution = 2^-8
FRAC_ACCURACY_MU_SCALE = 2.0 ** -N_FRAC_BIT_MU_SCALE
N_FRAC_BIT_INTER_FT_CTX = 8  # IFCE context channels are X.8 fixed point

MU_MIN = -AC_MAX_VAL
MU_MAX = AC_MAX_VAL - FRAC_ACCURACY_MU_SCALE
N_POSSIBLE_MU = int((MU_MAX - MU_MIN) // FRAC_ACCURACY_MU_SCALE + 1)  # 32768
N_POSSIBLE_SCALE = int((LOG_SCALE_MAX - LOG_SCALE_MIN) // FRAC_ACCURACY_MU_SCALE + 1)  # 2561

MU_MIN_FIXED_POINT = MU_MIN << N_FRAC_BIT_MU_SCALE  # -16384
LOG_SCALE_MIN_FIXED_POINT = LOG_SCALE_MIN << N_FRAC_BIT_MU_SCALE  # -1280

# Range coder (constriction queue coder compatible).
RC_PRECISION = 24
