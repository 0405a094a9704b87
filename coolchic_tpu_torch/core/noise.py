"""Common randomness: a deterministic Gaussian stream shared by encoder and
decoder (used by the Wasserstein / texture-synthesis mode).

The exact sample sequence is normative (the decoder regenerates it), so this
reproduces the Lehmer LCG + Box-Muller construction bit-for-bit in float64
before casting to float32 grids.

Reference parity: coolchic/component/core/noise.py:18-54.
"""

from __future__ import annotations

import math

import numpy as np

_SEED0 = 18101995
_A = 7**5
_M = 2**31 - 1
_PI = 3.14159265359


class CommonGaussianNoise:
    def __init__(self) -> None:
        self._seed = _SEED0

    def _grand(self) -> float:
        self._seed = (_A * self._seed) % _M
        u1 = self._seed / _M
        self._seed = (_A * self._seed) % _M
        u2 = self._seed / _M
        return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * _PI * u2)

    def sample(self, size: tuple[int, ...]) -> np.ndarray:
        numel = int(np.prod(size))
        if numel <= 0:
            raise ValueError(f"Common randomness tensor must be non-empty, got {size}")
        vals = np.array([self._grand() for _ in range(numel)], dtype=np.float32)
        return vals.reshape(size)


def common_randomness_grids(sizes: list[tuple[int, int]]) -> list[np.ndarray]:
    """One float32 [H_i, W_i] grid per requested size, drawn from a single
    generator stream (order matters: largest grid first, like the reference)."""
    gen = CommonGaussianNoise()
    return [gen.sample(s) for s in sizes]
