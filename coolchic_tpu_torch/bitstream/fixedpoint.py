"""Fixed-point (int64) ARM of the `ref` profile: parameter conversion.

The bitstream decoder replaces the float ARM with integer arithmetic so
encoder and decoder derive identical probabilities on any hardware:
inputs are shifted to X.16, weights are X.16, biases X.32, every hidden
layer output is shifted back to X.16, and the final output is shifted to
X.8 (the (mu, log-scale) table resolution).

Conventions (all normative, reference coolchic/bitstream/component/armint.py):
  - quantized params arrive as INTEGER multiples of a power-of-two q_step:
    q_param = round(param / q_step); fixed = q_param << (target_shift +
    log2(q_step));
  - the -4 log-scale shift is folded into the last trunk bias;
  - square trunk layers are residual: identity is folded into the weights;
  - IFCE context columns are X.8, so their first-layer weight columns (and
    the folded identity diagonal) get 8 fewer bits.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.core.constants import (
    BIAS_SHIFT,
    N_FRAC_BIT_INTER_FT_CTX,
    WEIGHT_SHIFT,
)


def _shift_int(q_param: np.ndarray, shift) -> np.ndarray:
    """q_param * 2**shift with integer exactness (shift always >= 0 here)."""
    q = q_param.astype(np.int64)
    return q * (np.int64(1) << np.asarray(shift, dtype=np.int64))


def arm_to_fixed_point(
    int_layers: list[dict],
    q_shift_weight: int,
    q_shift_bias: int,
    *,
    stabiliser: dict | None,
    subtract_last_layer: bool = True,
    n_inter_ft_ctx: int = 0,
    no_residual_layer: bool = False,
) -> dict:
    """Convert integer quantized ARM params to the fixed-point representation.

    int_layers: trunk layers as dicts {"weight": [out, in] int, "bias": [out]
    int} (values = round(float / q_step)). q_shift_* = log2(q_step) (<= 0).

    Returns {"trunk_weights": list [in, out] int64, "trunk_biases": list,
    "stab_weight": [C, 2], "stab_bias": [2]} ready for the native codec.
    """
    trunk_w: list[np.ndarray] = []
    trunk_b: list[np.ndarray] = []
    n_layers = len(int_layers)

    for li, lay in enumerate(int_layers):
        is_last = li == n_layers - 1
        w = np.asarray(lay["weight"], dtype=np.int64)
        b = np.asarray(lay["bias"], dtype=np.int64).copy()

        if is_last and subtract_last_layer:
            b[1] += -(4 << (-q_shift_bias))

        w_shift = np.full_like(w, WEIGHT_SHIFT + q_shift_weight)
        if n_inter_ft_ctx > 0 and li == 0:
            w_shift[:, -n_inter_ft_ctx:] -= N_FRAC_BIT_INTER_FT_CTX
        w_fp = _shift_int(w, w_shift)

        if w.shape[0] == w.shape[1] and not no_residual_layer:
            eye_shift = np.full_like(w, WEIGHT_SHIFT)
            if n_inter_ft_ctx > 0 and li == 0:
                eye_shift[:, -n_inter_ft_ctx:] -= N_FRAC_BIT_INTER_FT_CTX
            w_fp = w_fp + np.eye(w.shape[0], dtype=np.int64) * (
                np.int64(1) << eye_shift.astype(np.int64)
            )

        trunk_w.append(w_fp.T.copy())
        trunk_b.append(_shift_int(b, BIAS_SHIFT + q_shift_bias))

    dim = int_layers[0]["weight"].shape[1]
    n_out = int_layers[-1]["weight"].shape[0]
    if stabiliser is not None:
        sw = np.asarray(stabiliser["weight"], dtype=np.int64)
        w_shift = np.full_like(sw, WEIGHT_SHIFT + q_shift_weight)
        if n_inter_ft_ctx > 0:
            w_shift[:, -n_inter_ft_ctx:] -= N_FRAC_BIT_INTER_FT_CTX
        stab_w = _shift_int(sw, w_shift).T.copy()
        stab_b = _shift_int(np.asarray(stabiliser["bias"], dtype=np.int64),
                            BIAS_SHIFT + q_shift_bias)
    else:
        stab_w = np.zeros((dim, n_out), dtype=np.int64)
        stab_b = np.zeros((n_out,), dtype=np.int64)

    return {
        "trunk_weights": trunk_w,
        "trunk_biases": trunk_b,
        "stab_weight": stab_w,
        "stab_bias": stab_b,
    }


IFCE_OUTPUT_SHIFT = 2 * WEIGHT_SHIFT - N_FRAC_BIT_INTER_FT_CTX  # -> X.8 context
