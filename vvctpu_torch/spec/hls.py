"""High-level syntax: SPS / PPS / slice header / picture-hash SEI.

Role of VTM:CommonLib/Slice.{h,cpp} (parameter-set objects),
VTM:EncoderLib/VLCWriter.cpp + VTM:DecoderLib/VLCReader.cpp (HLS VLC), and
VTM:EncoderLib/SEIEncoder.cpp + DecLib::checkPictureHashSEI (decoded-picture
hash).  Field subset covers what this build's toolset needs; unknown fields
default.  The picture is coded padded to a CTU multiple with a conformance
window crop, the standard mechanism for non-multiple sizes.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

from ..core import bitstream as bs
from ..core import rom

SLICE_I, SLICE_P, SLICE_B = 2, 1, 0


@dataclass
class SPS:
    sps_id: int = 0
    width: int = 0              # padded (CTU multiple)
    height: int = 0
    conf_win: tuple[int, int, int, int] = (0, 0, 0, 0)  # l, r, t, b
    bit_depth: int = 8
    log2_ctu: int = 6
    chroma_format: int = 1      # 1 = 4:2:0
    mts_enabled: bool = False
    lfnst_enabled: bool = False
    mip_enabled: bool = False
    mrl_enabled: bool = False
    ts_enabled: bool = False    # transform skip (unified tx index 5)
    jccr_enabled: bool = False  # joint Cb-Cr residual (CSign = -1)
    mmvd_enabled: bool = False  # merge with MVD
    bcw_enabled: bool = False   # bi-prediction with CU weights {3,4,5}/8
    amvr_enabled: bool = False  # adaptive MVD resolution (1/4, 1, 4 pel)
    smvd_enabled: bool = False  # symmetric MVD (BI, POC-symmetric refs)
    ciip_enabled: bool = False  # combined inter-intra (planar blend)
    sbt_enabled: bool = False   # sub-block transform (inter luma residual)
    dmvr_enabled: bool = False  # decoder-side MV refinement (BI, no syntax)
    bdof_enabled: bool = False  # bi-directional optical flow (BI, no syntax)
    isp_enabled: bool = False   # intra sub-partitions (stripe TBs)
    gpm_enabled: bool = False   # geometric partitioning (B leaves)
    affine_enabled: bool = False  # 4-parameter affine + PROF (uni, 16/32)
    dq_enabled: bool = False    # dependent quantization (4-state trellis)
    mtt_enabled: bool = False   # multi-type tree (binary splits at 16/32)
    tt_enabled: bool = False    # ternary splits at 32 (requires mtt)
    ibc_enabled: bool = False   # intra block copy (I slices, square leaves)
    plt_enabled: bool = False   # palette mode (I slices, square leaves)
    cclm_enabled: bool = False
    lmcs_enabled: bool = False
    sao_enabled: bool = False
    alf_enabled: bool = False
    deblock_enabled: bool = True

    @property
    def out_width(self) -> int:
        return self.width - self.conf_win[0] - self.conf_win[1]

    @property
    def out_height(self) -> int:
        return self.height - self.conf_win[2] - self.conf_win[3]

    def write(self) -> bytes:
        w = bs.BitWriter()
        w.ue(self.sps_id)
        w.ue(self.width)
        w.ue(self.height)
        has_win = any(self.conf_win)
        w.u(int(has_win), 1)
        if has_win:
            for v in self.conf_win:
                w.ue(v)
        w.ue(self.bit_depth - 8)
        w.ue(self.log2_ctu - 4)
        w.ue(self.chroma_format)
        for f in (self.mts_enabled, self.lfnst_enabled, self.cclm_enabled,
                  self.lmcs_enabled, self.sao_enabled, self.alf_enabled,
                  self.deblock_enabled, self.mip_enabled,
                  self.mrl_enabled, self.ts_enabled, self.jccr_enabled,
                  self.mmvd_enabled, self.dmvr_enabled, self.bdof_enabled,
                  self.bcw_enabled, self.amvr_enabled,
                  self.smvd_enabled, self.ciip_enabled, self.sbt_enabled,
                  self.isp_enabled, self.gpm_enabled,
                  self.affine_enabled, self.dq_enabled,
                  self.mtt_enabled, self.tt_enabled, self.ibc_enabled,
                  self.plt_enabled):
            w.u(int(f), 1)
        w.byte_align()
        return w.getvalue()

    @classmethod
    def read(cls, payload: bytes) -> "SPS":
        r = bs.BitReader(payload)
        s = cls()
        s.sps_id = r.ue()
        s.width = r.ue()
        s.height = r.ue()
        if r.u(1):
            s.conf_win = tuple(r.ue() for _ in range(4))
        s.bit_depth = r.ue() + 8
        s.log2_ctu = r.ue() + 4
        s.chroma_format = r.ue()
        (s.mts_enabled, s.lfnst_enabled, s.cclm_enabled, s.lmcs_enabled,
         s.sao_enabled, s.alf_enabled, s.deblock_enabled, s.mip_enabled,
         s.mrl_enabled, s.ts_enabled, s.jccr_enabled, s.mmvd_enabled,
         s.dmvr_enabled, s.bdof_enabled, s.bcw_enabled,
         s.amvr_enabled, s.smvd_enabled, s.ciip_enabled,
         s.sbt_enabled, s.isp_enabled, s.gpm_enabled,
         s.affine_enabled, s.dq_enabled, s.mtt_enabled, s.tt_enabled,
         s.ibc_enabled, s.plt_enabled) = (bool(r.u(1)) for _ in range(27))
        return s


@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 32
    num_tile_cols: int = 1
    num_tile_rows: int = 1
    entropy_sync: bool = False   # WPP

    def write(self) -> bytes:
        w = bs.BitWriter()
        w.ue(self.pps_id)
        w.ue(self.sps_id)
        w.se(self.init_qp - 26)
        w.ue(self.num_tile_cols - 1)
        w.ue(self.num_tile_rows - 1)
        w.u(int(self.entropy_sync), 1)
        w.byte_align()
        return w.getvalue()

    @classmethod
    def read(cls, payload: bytes) -> "PPS":
        r = bs.BitReader(payload)
        p = cls()
        p.pps_id = r.ue()
        p.sps_id = r.ue()
        p.init_qp = r.se() + 26
        p.num_tile_cols = r.ue() + 1
        p.num_tile_rows = r.ue() + 1
        p.entropy_sync = bool(r.u(1))
        return p


def tile_grid(n_ctu_x: int, n_ctu_y: int, cols: int, rows: int):
    """Uniform tile rectangles in CTU units, tile-raster order
    (role of VTM:CommonLib/Slice.cpp PPS tile layout derivation):
    [(cx0, cy0, cx1, cy1), ...]."""
    cols = min(cols, n_ctu_x)     # clamp degenerate grids (empty tiles)
    rows = min(rows, n_ctu_y)
    xs = [k * n_ctu_x // cols for k in range(cols + 1)]
    ys = [k * n_ctu_y // rows for k in range(rows + 1)]
    return [(xs[i], ys[j], xs[i + 1], ys[j + 1])
            for j in range(rows) for i in range(cols)]


@dataclass
class SliceHeader:
    pps_id: int = 0
    slice_type: int = SLICE_I
    poc: int = 0
    qp_delta: int = 0
    ref_pocs: tuple = ()     # reference POCs: (l0,) for P, (l0, l1) for B
    lmcs_cw: tuple = ()      # LMCS codeword model (16 bins) or empty

    def write(self) -> bs.BitWriter:
        w = bs.BitWriter()
        w.ue(self.pps_id)
        w.ue(self.slice_type)
        w.u(self.poc & 0xFFFF, 16)
        w.se(self.qp_delta)
        if self.slice_type != SLICE_I:
            w.ue(len(self.ref_pocs))
            for rp in self.ref_pocs:
                w.se(self.poc - rp)     # delta, positive = past
        w.u(int(bool(self.lmcs_cw)), 1)
        if self.lmcs_cw:
            from . import lmcs as _lmcs
            _lmcs.code_model(w, self.lmcs_cw)
        w.byte_align()
        return w

    @classmethod
    def read(cls, r: bs.BitReader) -> "SliceHeader":
        s = cls()
        s.pps_id = r.ue()
        s.slice_type = r.ue()
        s.poc = r.u(16)
        s.qp_delta = r.se()
        if s.slice_type != SLICE_I:
            n = r.ue()
            s.ref_pocs = tuple(s.poc - r.se() for _ in range(n))
        if r.u(1):
            from . import lmcs as _lmcs
            s.lmcs_cw = _lmcs.parse_model(r)
        r.byte_align()
        return s


# ---------------------------------------------------------------------------
# Decoded-picture-hash SEI (MD5 per plane), SEI payload type 132
# ---------------------------------------------------------------------------
SEI_PIC_HASH = 132


def _plane_bytes(p: np.ndarray, bit_depth: int) -> bytes:
    if bit_depth <= 8:
        return p.astype(np.uint8).tobytes()
    return p.astype("<u2").tobytes()


def _crc16(data: bytes) -> int:
    """CRC-16/CCITT as in the HEVC/VVC picture-hash SEI (crc = 0xFFFF
    seed, poly 0x1021, bit-serial over data + 16 zero bits)."""
    crc = 0xFFFF
    for byte in data + b"\x00\x00":
        for bit in range(7, -1, -1):
            msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) | ((byte >> bit) & 1)
            if msb:
                crc ^= 0x1021
    return crc


def plane_hash(planes: list[np.ndarray], bit_depth: int = 8,
               hash_type: int = 0) -> bytes:
    """Concatenated per-plane digest: 0 = MD5 (16 B), 1 = CRC-16 (2 B),
    2 = checksum (mod-2^32 byte sum, 4 B) — the three VVC
    decoded-picture-hash SEI types."""
    out = b""
    for p in planes:
        data = _plane_bytes(p, bit_depth)
        if hash_type == 0:
            out += hashlib.md5(data).digest()
        elif hash_type == 1:
            out += _crc16(data).to_bytes(2, "big")
        else:
            s = int(np.frombuffer(data, np.uint8).astype(np.uint64).sum())
            out += (s & 0xFFFFFFFF).to_bytes(4, "big")
    return out


def plane_md5(planes: list[np.ndarray], bit_depth: int = 8) -> bytes:
    return plane_hash(planes, bit_depth, 0)


def write_pic_hash_sei(planes: list[np.ndarray], bit_depth: int = 8,
                       hash_type: int = 0) -> bytes:
    w = bs.BitWriter()
    digest = plane_hash(planes, bit_depth, hash_type)
    w.u(SEI_PIC_HASH, 8)          # payload type
    w.u(1 + len(digest), 8)       # payload size
    w.u(hash_type, 8)             # 0 MD5 / 1 CRC / 2 checksum
    for b in digest:
        w.u(b, 8)
    w.byte_align()
    return w.getvalue()


def read_pic_hash_sei(payload: bytes):
    """(hash_type, digest) or None."""
    r = bs.BitReader(payload)
    ptype = r.u(8)
    size = r.u(8)
    if ptype != SEI_PIC_HASH:
        return None
    htype = r.u(8)
    return htype, bytes(r.u(8) for _ in range(size - 1))
