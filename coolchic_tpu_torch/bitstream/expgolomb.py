"""Signed exp-Golomb decoder for the neural-network parameters.

Sign mapping: x <= 0 -> -2x, x > 0 -> 2x - 1 (sign in the LSB). Order-k code
of the mapped value u: encode v = u + 2^k - 1 with an order-0 exp-Golomb,
then drop the first k bits. The whole payload is PREFIX-padded with zero
bits to a byte boundary.

Reference parity: coolchic/bitstream/neuralnet/expgolomb.py.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.bitstream.bits import BitReader


def decode_exp_golomb(data: bytes, n_padding_bits: int, count: list[int] | np.ndarray
                      ) -> np.ndarray:
    r = BitReader(data, skip_bits=n_padding_bits)
    out = np.empty(len(count), dtype=np.int64)
    for i, k in enumerate(np.asarray(count, dtype=np.int64).tolist()):
        n_zeros = r.read_unary_zeros()
        quotient = r.read(n_zeros + 1) - 1
        remainder = r.read(k) if k > 0 else 0
        u = (quotient << k) + remainder
        out[i] = (u + 1) // 2 if (u & 1) else -(u // 2)
    return out
