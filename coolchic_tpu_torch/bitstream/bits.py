"""Small MSB-first bit reader/writer used by headers and the exp-Golomb
NN codec. (The reference builds python strings of '0'/'1'; we pack ints.)"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._bits: list[int] = []

    def write(self, value: int, n_bits: int) -> None:
        if value < 0 or value >= (1 << n_bits):
            raise ValueError(f"value {value} does not fit in {n_bits} bits")
        for i in range(n_bits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def write_signed(self, value: int, n_bits: int) -> None:
        """Sign-magnitude: 1 sign bit + (n_bits - 1) magnitude bits."""
        self.write(1 if value < 0 else 0, 1)
        self.write(abs(value), n_bits - 1)

    def n_bits(self) -> int:
        return len(self._bits)

    def append_pad_to_bytes(self) -> bytes:
        """Zero-pad at the END to a whole number of bytes (header convention)."""
        pad = (8 - len(self._bits) % 8) % 8
        return self._pack(self._bits + [0] * pad)

    @staticmethod
    def _pack(bits: list[int]) -> bytes:
        out = bytearray(len(bits) // 8)
        for i, b in enumerate(bits):
            if b:
                out[i >> 3] |= 0x80 >> (i & 7)
        return bytes(out)


class BitReader:
    def __init__(self, data: bytes, skip_bits: int = 0) -> None:
        self._data = data
        self._pos = skip_bits

    def read(self, n_bits: int) -> int:
        v = 0
        for _ in range(n_bits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def read_signed(self, n_bits: int) -> int:
        neg = self.read(1)
        mag = self.read(n_bits - 1)
        return -mag if neg else mag

    def read_unary_zeros(self) -> int:
        """Count zero bits until the next 1 (not consuming the 1)."""
        n = 0
        while True:
            byte = self._data[self._pos >> 3]
            bit = (byte >> (7 - (self._pos & 7))) & 1
            if bit:
                return n
            n += 1
            self._pos += 1
