"""Scalar CABAC engine — the specification-model arithmetic coder.

Implements the VVC-style binary arithmetic coder with the two-hypothesis
(two adaptation-rate) probability model:

* per-context state: a 10-bit fast estimate ``p0`` and a 14-bit slow estimate
  ``p1``; the effective probability is ``pState = (p0 << 4) + p1`` (15-bit),
  MPS = ``pState >> 14``  (VTM:CommonLib/Contexts.h BinProbModel_Std,
  VTM:DecoderLib/BinDecoder.cpp / EncoderLib/BinEncoder.cpp).
* LPS range: ``((range >> 5) * (q >> 9) >> 1) + 4`` with
  ``q = min(pState, 32767 - pState)``.
* decoder: 9-bit offset window, doubling renormalisation (range kept in
  [256, 510]).

The *encoder* here uses an arbitrary-precision ``low`` accumulator: carries
propagate through Python's bigint addition, and the final codeword is simply
``low`` emitted over ``9 + renorm_count`` bits.  The emitted value V equals the
lower edge of the final coding interval, hence lies inside every intermediate
interval, so the standard decoder reconstructs the bin sequence exactly.  (The
performance-tier encoder in ``native/`` re-implements this with the classic
outstanding-byte scheme; this model is the oracle it is tested against.)

Context initialisation note: init values use the slope/offset nibble scheme
shaped like the reference's (VTM:CommonLib/Contexts.cpp), but the *table
contents* are this project's own (the reference mount was empty — SURVEY.md §0,
and internal enc/dec consistency is what is verifiable here).
"""
from __future__ import annotations

import numpy as np


def _clip(lo: int, hi: int, v: int) -> int:
    return lo if v < lo else hi if v > hi else v


class CtxState:
    """Vector of context states (p0, p1, shift0, shift1) as numpy arrays."""

    __slots__ = ("p0", "p1", "sh0", "sh1")

    def __init__(self, init_values: np.ndarray, rates: np.ndarray, qp: int):
        n = len(init_values)
        self.p0 = np.zeros(n, np.int32)
        self.p1 = np.zeros(n, np.int32)
        self.sh0 = np.zeros(n, np.int32)
        self.sh1 = np.zeros(n, np.int32)
        for i in range(n):
            iv = int(init_values[i])
            slope_idx, offset_idx = iv >> 4, iv & 15
            m = slope_idx * 5 - 45
            nn = (offset_idx << 3) - 16
            # NOTE (round 4): the round-1..3 engine added a spurious +64
            # here, squashing every init into p(1) in [0.37, 0.99] — e.g.
            # the NEUTRAL offset nibble 10 (nn = 64, intended p = 0.5)
            # landed at pre 127 ~ p 0.99.  Dropping the bias restores the
            # documented slope/offset semantics (contexts.py NEUTRAL/LOW/
            # HIGH now init at ~0.5/0.25/0.75) and makes the init states a
            # sound basis for the decision-pass fractional-bit estimates
            # (cabac/estimate.py).
            pre = _clip(1, 127, ((m * (_clip(0, 63, qp) - 32)) >> 4) + nn)
            self.p0[i] = pre << 3
            self.p1[i] = pre << 7
            r = int(rates[i])
            self.sh0[i] = (r >> 2) + 2
            self.sh1[i] = (r & 3) + 3 + self.sh0[i]

    def state(self, ctx: int) -> int:
        return (int(self.p0[ctx]) << 4) + int(self.p1[ctx])

    def update(self, ctx: int, binval: int) -> None:
        p0, p1 = int(self.p0[ctx]), int(self.p1[ctx])
        s0, s1 = int(self.sh0[ctx]), int(self.sh1[ctx])
        self.p0[ctx] = p0 - (p0 >> s0) + ((1023 * binval) >> s0)
        self.p1[ctx] = p1 - (p1 >> s1) + ((16383 * binval) >> s1)

    def snapshot(self):
        return (self.p0.copy(), self.p1.copy())

    def restore(self, snap) -> None:
        self.p0[:] = snap[0]
        self.p1[:] = snap[1]


def _lps_range(rng: int, p_state: int) -> int:
    q = p_state if p_state < 16384 else 32767 - p_state
    return (((rng >> 5) * (q >> 9)) >> 1) + 4


class CabacEncoder:
    def __init__(self, ctx: CtxState):
        self.ctx = ctx
        self.low = 0
        self.range = 510
        self.nbits = 0          # renormalisation shift count
        self.frac_bits = 0      # RD bit estimate in 1/32768 bit units

    # -- regular (context) bins -------------------------------------------
    def bin(self, ctx_id: int, binval: int) -> int:
        binval = int(binval)
        p = self.ctx.state(ctx_id)
        mps = p >> 14
        lps = _lps_range(self.range, p)
        self.range -= lps
        if binval != mps:
            self.low += self.range
            self.range = lps
        self.ctx.update(ctx_id, binval)
        while self.range < 256:
            self.range <<= 1
            self.low <<= 1
            self.nbits += 1
        return binval

    def bypass(self, binval: int) -> int:
        binval = int(binval)
        self.low <<= 1
        self.nbits += 1
        if binval:
            self.low += self.range
        return binval

    def bypass_bits(self, value: int, n: int) -> int:
        for i in range(n - 1, -1, -1):
            self.bypass((value >> i) & 1)
        return value

    def terminate(self, binval: int) -> int:
        self.range -= 2
        if binval:
            self.low += self.range
            self.range = 2
        while self.range < 256:
            self.range <<= 1
            self.low <<= 1
            self.nbits += 1
        return binval

    def finish(self) -> bytes:
        """Emit the codeword: ``low`` over 9 + nbits bits, byte-padded."""
        total = 9 + self.nbits
        pad = (-total) % 8
        v = self.low << pad
        return int(v).to_bytes((total + pad) // 8, "big")

    @property
    def bit_count(self) -> int:
        return 9 + self.nbits


class CabacDecoder:
    def __init__(self, ctx: CtxState, data: bytes):
        self.ctx = ctx
        self._data = data
        self._pos = 0
        self.range = 510
        self.offset = self._read_bits(9)

    def _read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3] if (self._pos >> 3) < len(self._data) else 0
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def bin(self, ctx_id: int) -> int:
        p = self.ctx.state(ctx_id)
        mps = p >> 14
        lps = _lps_range(self.range, p)
        self.range -= lps
        if self.offset >= self.range:
            binval = 1 - mps
            self.offset -= self.range
            self.range = lps
        else:
            binval = mps
        self.ctx.update(ctx_id, binval)
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return binval

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._read_bits(1)
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            self.range = 2
            binval = 1
        else:
            binval = 0
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._read_bits(1)
        return binval
