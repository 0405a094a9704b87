"""Signed exp-Golomb codec for the neural-network parameters.

Sign mapping: x <= 0 -> -2x, x > 0 -> 2x - 1 (sign in the LSB). Order-k code
of the mapped value u: encode v = u + 2^k - 1 with an order-0 exp-Golomb,
then drop the first k bits. The whole payload is PREFIX-padded with zero
bits to a byte boundary.

Reference parity: coolchic/bitstream/neuralnet/expgolomb.py.
"""

from __future__ import annotations

import numpy as np

from coolchic_tpu_torch.bitstream.bits import BitReader, BitWriter


def encode_exp_golomb(data: list[int] | np.ndarray, count: list[int] | np.ndarray
                      ) -> tuple[bytes, int]:
    """Returns (payload, n_padding_bits)."""
    data = np.asarray(data, dtype=np.int64)
    count = np.asarray(count, dtype=np.int64)
    if data.shape != count.shape:
        raise ValueError("data and count must have the same length")
    if count.size and count.min() < 0:
        raise ValueError("exp-Golomb order must be >= 0")

    w = BitWriter()
    for x, k in zip(data.tolist(), count.tolist()):
        u = -2 * x if x <= 0 else 2 * x - 1
        v = u + (1 << k) - 1
        n_bits_code = (v + 1).bit_length()
        # (n_bits_code - 1) leading zeros then binary(v+1), minus the first
        # k bits: v + 1 >= 2^k, so the removal only eats zeros.
        w.write(0, n_bits_code - 1 - k)
        w.write(v + 1, n_bits_code)
    return w.prepend_pad_to_bytes()


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
