"""Bitstream primitives: bit reader/writer, Exp-Golomb VLC, Annex-B NAL framing.

Covers the role of VTM:CommonLib/BitStream.{h,cpp} (Input/OutputBitstream,
emulation prevention), VTM:DecoderLib/AnnexBread.cpp (byteStreamNALUnit) and
VTM:EncoderLib/NALwrite.cpp.  See SURVEY.md §2.1 / §2.4.
"""
from __future__ import annotations

from dataclasses import dataclass, field


class BitWriter:
    """MSB-first bit writer producing an RBSP byte payload."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    def u(self, value: int, n: int) -> int:
        if n < 0 or (n and value >> n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        for i in range(n - 1, -1, -1):
            self._cur = (self._cur << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._cur)
                self._cur = 0
                self._nbits = 0
        return value

    def ue(self, value: int) -> int:
        if value < 0:
            raise ValueError("ue(v) needs non-negative value")
        v = value + 1
        n = v.bit_length()
        self.u(0, n - 1)
        self.u(v, n)
        return value

    def se(self, value: int) -> int:
        self.ue(2 * abs(value) - (1 if value > 0 else 0))
        return value

    def byte_align(self) -> None:
        """rbsp_trailing_bits: stop bit + zero padding."""
        self.u(1, 1)
        while self._nbits:
            self.u(0, 1)

    def write_bytes(self, data: bytes) -> None:
        if self._nbits:
            raise RuntimeError("write_bytes requires byte alignment")
        self._bytes.extend(data)

    def getvalue(self) -> bytes:
        if self._nbits:
            raise RuntimeError("unaligned bitstream; call byte_align()")
        return bytes(self._bytes)

    @property
    def bit_count(self) -> int:
        return 8 * len(self._bytes) + self._nbits


class BitReader:
    """MSB-first bit reader over an RBSP payload."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 64:
                raise ValueError("malformed ue(v)")
        return ((1 << zeros) | self.u(zeros)) - 1 if zeros else 0

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    def byte_align(self) -> None:
        if self.u(1) != 1:
            raise ValueError("expected rbsp stop bit")
        while self._pos & 7:
            if self.u(1) != 0:
                raise ValueError("expected alignment zero bit")

    def remaining_bytes(self) -> bytes:
        if self._pos & 7:
            raise RuntimeError("unaligned")
        return self._data[self._pos >> 3:]

    @property
    def bit_pos(self) -> int:
        return self._pos


# ---------------------------------------------------------------------------
# Emulation prevention (00 00 0x -> 00 00 03 0x) — VTM BitStream.cpp
# addEmulationPreventionByte logic / NALread convertPayloadToRBSP.
# ---------------------------------------------------------------------------

def rbsp_to_ebsp(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def ebsp_to_rbsp(ebsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# NAL units (VVC-style 2-byte NAL header) and Annex-B byte streams
# ---------------------------------------------------------------------------
# nal_unit_type values follow the VVC table (subset used by this build)
NAL_TRAIL = 0
NAL_IDR_W_RADL = 7
NAL_IDR_N_LP = 8
NAL_CRA = 9
NAL_VPS = 14
NAL_SPS = 15
NAL_PPS = 16
NAL_PREFIX_APS = 17
NAL_PH = 19
NAL_SUFFIX_SEI = 24
NAL_PREFIX_SEI = 23


@dataclass
class NalUnit:
    nal_type: int
    payload: bytes            # RBSP (de-emulated)
    layer_id: int = 0
    temporal_id: int = 0

    def header_bytes(self) -> bytes:
        # forbidden_zero(1) nuh_reserved_zero(1) nuh_layer_id(6)
        # nal_unit_type(5) nuh_temporal_id_plus1(3)
        b0 = self.layer_id & 0x3F
        b1 = ((self.nal_type & 0x1F) << 3) | ((self.temporal_id + 1) & 0x7)
        return bytes((b0, b1))


def write_annexb(nals: list[NalUnit]) -> bytes:
    out = bytearray()
    for i, nal in enumerate(nals):
        # 4-byte start code before parameter sets / first NAL, 3-byte otherwise
        long_sc = i == 0 or nal.nal_type in (NAL_VPS, NAL_SPS, NAL_PPS)
        out.extend(b"\x00\x00\x00\x01" if long_sc else b"\x00\x00\x01")
        out.extend(nal.header_bytes())
        out.extend(rbsp_to_ebsp(nal.payload))
    return bytes(out)


def read_annexb(data: bytes) -> list[NalUnit]:
    nals: list[NalUnit] = []
    i = 0
    n = len(data)
    starts: list[int] = []
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for si, start in enumerate(starts):
        end = starts[si + 1] - 3 if si + 1 < len(starts) else n
        # trim the 4-byte start code's single leading zero of the *next*
        # NAL (at most one byte: payloads end with the rbsp stop bit, so a
        # trailing zero here can only belong to the start code)
        if end > start and data[end - 1] == 0 and si + 1 < len(starts):
            end -= 1
        raw = data[start:end]
        if len(raw) < 2:
            continue
        layer_id = raw[0] & 0x3F
        nal_type = (raw[1] >> 3) & 0x1F
        tid = (raw[1] & 0x7) - 1
        nals.append(NalUnit(nal_type, ebsp_to_rbsp(raw[2:]), layer_id, tid))
    return nals
