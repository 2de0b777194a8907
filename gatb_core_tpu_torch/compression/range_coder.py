"""Order-0 adaptive range coder — bit-exact port of Leon's coder
(tools/compression/RangeCoder.cpp/.hpp: TOP=2^56, BOTTOM=2^48 carry-less
renormalization, cumulative-frequency Order0Model with halving rescale).

All arithmetic is uint64 wrap-around (masked) like the C original.
"""

from __future__ import annotations

M64 = (1 << 64) - 1
TOP = 1 << 56
BOTTOM = 1 << 48
MAX_RANGE = BOTTOM


class Order0Model:
    """Adaptive cumulative counts over ``char_count`` symbols
    (RangeCoder.cpp Order0Model)."""

    def __init__(self, char_count: int):
        self._n = char_count + 1
        self.ranges = list(range(self._n))

    def clear(self):
        self.ranges = list(range(self._n))

    def update(self, c: int):
        r = self.ranges
        for i in range(c + 1, self._n):
            r[i] += 1
        if r[-1] >= MAX_RANGE:
            self._rescale()

    def _rescale(self):
        r = self.ranges
        for i in range(1, self._n):
            r[i] //= 2
            if r[i] <= r[i - 1]:
                r[i] = r[i - 1] + 1

    def range_low(self, c: int) -> int:
        return self.ranges[c]

    def range_high(self, c: int) -> int:
        return self.ranges[c + 1]

    def total(self) -> int:
        return self.ranges[-1]

    @property
    def char_count(self) -> int:
        return self._n


class RangeEncoder:
    def __init__(self):
        self.low = 0
        self.range = M64
        self.buffer = bytearray()

    def encode(self, model: Order0Model, c: int):
        self.range = (self.range // model.total()) & M64
        self.low = (self.low + model.range_low(c) * self.range) & M64
        self.range = (self.range
                      * (model.range_high(c) - model.range_low(c))) & M64
        while ((self.low ^ ((self.low + self.range) & M64)) < TOP
               or self.range < BOTTOM):
            if self.range < BOTTOM and \
                    (self.low ^ ((self.low + self.range) & M64)) >= TOP:
                self.range = (-self.low) & (BOTTOM - 1)
            self.buffer.append((self.low >> 56) & 0xFF)
            self.range = (self.range << 8) & M64
            self.low = (self.low << 8) & M64
        model.update(c)

    def flush(self):
        for _ in range(8):
            self.buffer.append((self.low >> 56) & 0xFF)
            self.low = (self.low << 8) & M64
        self.low = 0
        self.range = M64

    def get_buffer(self) -> bytes:
        return bytes(self.buffer)

    def clear(self):
        self.low = 0
        self.range = M64
        self.buffer = bytearray()


class RangeDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.low = 0
        self.range = M64
        self.code = 0
        for _ in range(8):
            self.code = ((self.code << 8) | self._next()) & M64

    def _next(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0

    def next_byte(self, model: Order0Model) -> int:
        self.range = (self.range // model.total()) & M64
        count = ((self.code - self.low) & M64) // self.range
        c = model.char_count - 2
        while model.range_low(c) > count:
            c -= 1
        # removeRange
        self.low = (self.low + model.range_low(c) * self.range) & M64
        self.range = (self.range
                      * (model.range_high(c) - model.range_low(c))) & M64
        while ((self.low ^ ((self.low + self.range) & M64)) < TOP
               or self.range < BOTTOM):
            if self.range < BOTTOM and \
                    (self.low ^ ((self.low + self.range) & M64)) >= TOP:
                self.range = (-self.low) & (BOTTOM - 1)
            self.code = ((self.code << 8) | self._next()) & M64
            self.range = (self.range << 8) & M64
            self.low = (self.low << 8) & M64
        model.update(c)
        return c
