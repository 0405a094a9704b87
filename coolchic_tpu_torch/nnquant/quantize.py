"""Encoder-side neural-network quantization: greedy per-module RD search over
(q_step_weight, q_step_bias) grids, picking the best exp-Golomb order per
parameter group.

Modules are processed in sorted name order (arm, ifce, synthesis,
upsampling), matching the reference (coolchic/nnquant/quantizemodel.py:60).
Each module's whole grid is scored by one call of the caller's scorer,
which evaluates the trials as a batch. The choice is the first
lowest-total index, as the JAX package's argmin takes it.

Reference parity: coolchic_tpu/nnquant/quantize.py.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict

import numpy as np

from coolchic_tpu_torch.bitstream.headers import EXPGOL_COUNTS, MODULE_ORDER, Q_STEP_SHIFTS
from coolchic_tpu_torch.bitstream.nncodec import (
    flatten_module_params,
    unflatten_module_params,
)
from coolchic_tpu_torch.core.arch import CoolChicConfig

MAX_Q_VALUE = 65535  # 16-bit magnitude cap on quantized params


def exp_golomb_nbins(symbols: np.ndarray, count: int) -> float:
    """Rate estimate of a signed exp-Golomb code of order `count`
    (reference coolchic.py:1166-1181; <0.5% off the true bit count)."""
    x = np.abs(symbols.astype(np.float64))
    nbins = 2.0 * np.floor(np.log2(2.0 * x / (2.0**count) + 1.0)) + count + (symbols != 0)
    return float(nbins.sum())


def best_expgol(symbols: np.ndarray) -> tuple[int, float]:
    best_cnt, best_rate = 0, float("inf")
    for cnt in EXPGOL_COUNTS:
        r = exp_golomb_nbins(symbols, cnt)
        if r < best_rate:
            best_rate, best_cnt = r, cnt
    return best_cnt, best_rate


def _structure_copy(x):
    """Copy the dict/list containers of a tree, sharing the leaves."""
    if isinstance(x, dict):
        return {k: _structure_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_structure_copy(v) for v in x]
    return x


def _set_module_params(params: dict, cfg: CoolChicConfig, module: str,
                       new_w: list, new_b: list) -> dict:
    """A copy of `params` with one module's arrays replaced (the other
    leaves are shared with the input)."""
    out = _structure_copy(params)
    unflatten_module_params(list(new_w), cfg, module, "weight", out)
    unflatten_module_params(list(new_b), cfg, module, "bias", out)
    return out


def quantize_coolchic(cc_params: dict, cfg: CoolChicConfig,
                      score: Callable[[list[dict]], np.ndarray],
                      lmbda: float, n_pixels: int, verbose: bool = False
                      ) -> tuple[dict, Dict[tuple, int], Dict[tuple, int], float]:
    """Quantize one cool-chic decoder's four modules.

    cc_params: one image's float params as numpy arrays. score(trials) ->
    the RD loss of each trial cc-param tree, WITHOUT the nn rate term, as
    an f32 array (the frame's eval in the decoder's view).

    Returns (quantized params, q_step_shift dict, expgol dict, nn rate bits).
    """
    q_shift: Dict[tuple, int] = {}
    expgol: Dict[tuple, int] = {}
    nn_rate_bits: Dict[str, float] = {m: 0.0 for m in MODULE_ORDER}
    params = cc_params

    for module in sorted(MODULE_ORDER):
        fp_w = [np.asarray(a, dtype=np.float32)
                for a in flatten_module_params(params, cfg, module, "weight")]
        fp_b = [np.asarray(a, dtype=np.float32)
                for a in flatten_module_params(params, cfg, module, "bias")]
        if not fp_w:  # absent module (e.g. no IFCE)
            q_shift[(module, "weight")] = Q_STEP_SHIFTS[(module, "weight")][0]
            q_shift[(module, "bias")] = Q_STEP_SHIFTS[(module, "bias")][0]
            expgol[(module, "weight")] = 0
            expgol[(module, "bias")] = 0
            continue

        # Per combo: validity (16-bit magnitude cap) + exp-Golomb rate of the
        # integerized params.
        combos = []  # (shift_w, shift_b, (eg_w, eg_b), module_rate, total_nn_rate)
        for shift_w, shift_b in itertools.product(
                Q_STEP_SHIFTS[(module, "weight")], Q_STEP_SHIFTS[(module, "bias")]):
            qs_w, qs_b = 2.0**shift_w, 2.0**shift_b
            int_w = [np.round(a / qs_w) for a in fp_w]
            int_b = [np.round(a / qs_b) for a in fp_b]
            if any(np.abs(a).max(initial=0) > MAX_Q_VALUE for a in int_w + int_b):
                continue
            eg_w, rate_w = best_expgol(np.concatenate([a.ravel() for a in int_w]))
            eg_b, rate_b = best_expgol(np.concatenate([a.ravel() for a in int_b]))
            module_rate = rate_w + rate_b
            total_nn_rate = sum(nn_rate_bits.values()) - nn_rate_bits[module] + module_rate
            combos.append((shift_w, shift_b, (eg_w, eg_b), module_rate, total_nn_rate))
        if not combos:
            raise RuntimeError(f"no valid q-step for module {module}")

        # The quantized values are exact in f32 (power-of-two steps).
        trials = [_set_module_params(params, cfg, module,
                                     [np.round(a / 2.0**c[0]) * 2.0**c[0] for a in fp_w],
                                     [np.round(a / 2.0**c[1]) * 2.0**c[1] for a in fp_b])
                  for c in combos]
        losses = np.asarray(score(trials), np.float64)
        totals = losses + lmbda * np.asarray([c[4] for c in combos], np.float64) / n_pixels
        k = int(np.argmin(totals))
        shift_w, shift_b, (eg_w, eg_b), module_rate, _ = combos[k]
        params = trials[k]
        q_shift[(module, "weight")] = shift_w
        q_shift[(module, "bias")] = shift_b
        expgol[(module, "weight")] = eg_w
        expgol[(module, "bias")] = eg_b
        nn_rate_bits[module] = module_rate
        if verbose:
            print(f"  quantize {module:<10} q_step 2^{shift_w}/2^{shift_b} "
                  f"expgol {eg_w}/{eg_b} rate {module_rate / n_pixels:.5f} bpp", flush=True)

    return params, q_shift, expgol, sum(nn_rate_bits.values())
