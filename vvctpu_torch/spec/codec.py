"""Spec-model codec: the shared coding-tree traversal + frame encode/decode.

This is the heart of the specification model: ONE traversal routine performs
both encoding and decoding (direction chosen by the CABAC ``io`` adapter), and
prediction/reconstruction run *inside* the traversal, so the encoder's
reconstruction is by construction the decoder's output — the property the
reference gets from sharing CommonLib between EncLib and DecLib (SURVEY.md §1,
VTM:EncoderLib/EncCu.cpp vs DecoderLib/DecCu.cpp both calling
CommonLib/IntraPrediction+TrQuant).

Coding-tree shape this round: CTU 64 with an implicit first quad split, then
signaled QT splits down to 8x8 luma leaves (single tree; chroma 4:2:0 coded
per luma leaf with the derived DM mode).  Frames are coded padded to a CTU
multiple with a conformance-window crop (hls.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..cabac import contexts as C
from ..cabac.engine import CabacDecoder, CabacEncoder
from ..core import bitstream as bs
from ..core import rom
from ..core import trace
from . import hls, intra, transform
from .residual import DecIO, EncIO, code_tb

MIN_LEAF = 8
MID_SIZE = 32  # implicit-split child size inside the 64 CTU


@dataclass
class FrameDecisions:
    """Partition + mode decisions at fixed granularities (padded frame)."""
    split32: np.ndarray   # (H//32, W//32) uint8: split 32 -> 16
    split16: np.ndarray   # (H//16, W//16) uint8: split 16 -> 8
    modes8: np.ndarray    # (H//8,  W//8)  int32: luma mode per 8x8 granule
    bt32: np.ndarray = None     # (H//32, W//32) uint8: 0 / 1 H / 2 V binary
    bt16: np.ndarray = None     # (H//16, W//16) uint8: 0 / 1 H / 2 V binary
    inter8: np.ndarray = None   # (H//8, W//8) uint8: 1 = inter leaf
    mv8: np.ndarray = None      # (H//8, W//8, 2) int32: L0 (mvx, mvy) 1/16
    mv8_l1: np.ndarray = None   # (H//8, W//8, 2) int32: L1 mv (B slices)
    dir8: np.ndarray = None     # (H//8, W//8) uint8: 0=L0, 1=L1, 2=BI
    mts8: np.ndarray = None     # (H//8, W//8) uint8: MTS index (intra luma)
    lfnst8: np.ndarray = None   # (H//8, W//8) uint8: LFNST index (intra luma)
    cmode8: np.ndarray = None   # (H//8, W//8) uint8: 0 = DM, 1 = CCLM
    mrl8: np.ndarray = None     # (H//8, W//8) uint8: MRL reference line 0..2
    jccr8: np.ndarray = None    # (H//8, W//8) uint8: joint Cb-Cr residual
    bcw8: np.ndarray = None     # (H//8, W//8) uint8: BCW weight idx (1=equal)
    ciip8: np.ndarray = None    # (H//8, W//8) uint8: CIIP (inter+planar)
    sbt8: np.ndarray = None     # (H//8, W//8) uint8: SBT idx 0..4 (inter)
    isp8: np.ndarray = None     # (H//8, W//8) uint8: ISP 0 off / 1 H / 2 V
    gpm8: np.ndarray = None     # (H//8, W//8) uint8: GPM 0 off / idx + 1
    aff8: np.ndarray = None     # (H//8, W//8) uint8: affine flag (uni inter)
    admv8: np.ndarray = None    # (H//8, W//8, 2) int32: CPMV1-CPMV0 delta
    ibc8: np.ndarray = None     # (H//8, W//8) uint8: IBC flag (I slices)
    bv8: np.ndarray = None      # (H//8, W//8, 2) int32: block vector (pels)
    plt8: np.ndarray = None     # (H//8, W//8) uint8: palette flag (I slices)
    plt_data: dict = None       # {(x, y, s): (entries, idx)} — derived at
    #                             encode time / parsed at decode time; not
    #                             part of decision equality

    @classmethod
    def empty(cls, h: int, w: int) -> "FrameDecisions":
        from .inter import BCW_DEFAULT
        return cls(np.zeros((h // 32, w // 32), np.uint8),
                   np.zeros((h // 16, w // 16), np.uint8),
                   np.zeros((h // 8, w // 8), np.int32),
                   np.zeros((h // 32, w // 32), np.uint8),
                   np.zeros((h // 16, w // 16), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8, 2), np.int32),
                   np.zeros((h // 8, w // 8, 2), np.int32),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.full((h // 8, w // 8), BCW_DEFAULT, np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8, 2), np.int32),
                   np.zeros((h // 8, w // 8), np.uint8),
                   np.zeros((h // 8, w // 8, 2), np.int32),
                   np.zeros((h // 8, w // 8), np.uint8))

    def equal(self, other: "FrameDecisions") -> bool:
        return (np.array_equal(self.split32, other.split32)
                and np.array_equal(self.split16, other.split16)
                and np.array_equal(self.bt32, other.bt32)
                and np.array_equal(self.bt16, other.bt16)
                and np.array_equal(self.modes8, other.modes8)
                and np.array_equal(self.inter8, other.inter8)
                and np.array_equal(self.mv8, other.mv8)
                and np.array_equal(self.mv8_l1, other.mv8_l1)
                and np.array_equal(self.dir8, other.dir8)
                and np.array_equal(self.mts8, other.mts8)
                and np.array_equal(self.lfnst8, other.lfnst8)
                and np.array_equal(self.cmode8, other.cmode8)
                and np.array_equal(self.mrl8, other.mrl8)
                and np.array_equal(self.jccr8, other.jccr8)
                and np.array_equal(self.bcw8, other.bcw8)
                and np.array_equal(self.ciip8, other.ciip8)
                and np.array_equal(self.sbt8, other.sbt8)
                and np.array_equal(self.isp8, other.isp8)
                and np.array_equal(self.gpm8, other.gpm8)
                and np.array_equal(self.aff8, other.aff8)
                and np.array_equal(self.admv8, other.admv8)
                and np.array_equal(self.ibc8, other.ibc8)
                and np.array_equal(self.bv8, other.bv8)
                and np.array_equal(self.plt8, other.plt8))


def tile_decisions_view(dec: FrameDecisions, x0: int, y0: int, x1: int,
                        y1: int) -> FrameDecisions:
    """Tile-rect view (shared memory) of the decision maps; coordinates in
    pixels, CTU-aligned.  Used by the JAX engine to run one frame_scan per
    tile on tile-local slots."""
    def s(a, g):
        return None if a is None else a[y0 // g:y1 // g, x0 // g:x1 // g]

    return FrameDecisions(
        split32=s(dec.split32, 32), split16=s(dec.split16, 16),
        modes8=s(dec.modes8, 8), bt32=s(dec.bt32, 32),
        bt16=s(dec.bt16, 16), inter8=s(dec.inter8, 8), mv8=s(dec.mv8, 8),
        mv8_l1=s(dec.mv8_l1, 8), dir8=s(dec.dir8, 8), mts8=s(dec.mts8, 8),
        lfnst8=s(dec.lfnst8, 8), cmode8=s(dec.cmode8, 8),
        mrl8=s(dec.mrl8, 8), jccr8=s(dec.jccr8, 8), bcw8=s(dec.bcw8, 8),
        ciip8=s(dec.ciip8, 8), sbt8=s(dec.sbt8, 8), isp8=s(dec.isp8, 8),
        gpm8=s(dec.gpm8, 8), aff8=s(dec.aff8, 8), admv8=s(dec.admv8, 8),
        ibc8=s(dec.ibc8, 8), bv8=s(dec.bv8, 8), plt8=s(dec.plt8, 8),
        plt_data=None if dec.plt_data is None else
        {(x - x0, y - y0, sz): v
         for (x, y, sz), v in dec.plt_data.items()
         if x0 <= x < x1 and y0 <= y < y1})


@dataclass
class _FrameState:
    sps: hls.SPS
    qp: int
    encoding: bool
    dec: FrameDecisions
    # planes (padded sizes)
    src: list[np.ndarray] | None         # encoder only: [Y, Cb, Cr]
    recon: list[np.ndarray] = field(default_factory=list)
    valid: list[np.ndarray] = field(default_factory=list)
    mode_map: np.ndarray | None = None   # (H//4, W//4) int32, -1 = n/a
    refs: list[np.ndarray] | None = None  # margin-padded [Y, Cb, Cr] or None
    inter_map: np.ndarray | None = None   # (H//8, W//8) bool
    mv_map: np.ndarray | None = None      # (H//8, W//8, 2) int32
    col: dict | None = None               # scaled TMVP field (inter.build_col_motion)
    hmvp: list = field(default_factory=list)  # history merge FIFO (per CTU row)
    rdoq: bool = False                    # encoder RDOQ quantizer
    lmcs: tuple | None = None             # (fwd, inv) luma-mapping LUTs
    crs: np.ndarray | None = None         # CRS scale LUT (inter chroma)
    src_orig_y: np.ndarray | None = None  # unmapped source luma (filters)
    dmvr: bool = False                    # DMVR active (BI + symmetric refs)
    bdof: bool = False                    # BDOF active (BI + symmetric refs)
    smvd: bool = False                    # SMVD active (BI + symmetric refs)
    dq: bool = False                      # dependent quantization (trellis)
    ibc_map: np.ndarray | None = None     # (H//8, W//8) bool: IBC leaves
    bv_map: np.ndarray | None = None      # (H//8, W//8, 2) int32: BVs

    @classmethod
    def make(cls, sps, qp, encoding, decisions, src, refs=None, col=None,
             rdoq=False):
        h, w = sps.height, sps.width
        st = cls(sps, qp, encoding, decisions, src)
        st.recon = [np.zeros((h, w), np.int32),
                    np.zeros((h // 2, w // 2), np.int32),
                    np.zeros((h // 2, w // 2), np.int32)]
        st.valid = [np.zeros((h, w), bool),
                    np.zeros((h // 2, w // 2), bool),
                    np.zeros((h // 2, w // 2), bool)]
        st.mode_map = np.full((h // 4, w // 4), -1, np.int32)
        if refs is not None:
            from . import inter
            st.refs = [
                [inter.pad_reference(rf[0], inter.REF_MARGIN),
                 inter.pad_reference(rf[1], inter.REF_MARGIN // 2),
                 inter.pad_reference(rf[2], inter.REF_MARGIN // 2)]
                for rf in refs]
        st.inter_map = np.zeros((h // 8, w // 8, 2), bool)
        st.mv_map = np.zeros((h // 8, w // 8, 2, 2), np.int32)
        st.ibc_map = np.zeros((h // 8, w // 8), bool)
        st.bv_map = np.zeros((h // 8, w // 8, 2), np.int32)
        st.col = col
        st.rdoq = rdoq
        return st


# ---------------------------------------------------------------------------
# intra mode signaling (MPM scheme; VTM CABACWriter::intra_luma_pred_mode)
# ---------------------------------------------------------------------------

def _neighbor_mode(st: _FrameState, x: int, y: int) -> int:
    if x < 0 or y < 0:
        return rom.PLANAR_IDX
    m = int(st.mode_map[y // 4, x // 4])
    if m >= rom.NUM_LUMA_MODE:      # MIP neighbours count as planar (MPM)
        return rom.PLANAR_IDX
    return m if m >= 0 else rom.PLANAR_IDX


def _neighbor_is_mip(st: _FrameState, x: int, y: int) -> int:
    if x < 0 or y < 0:
        return 0
    return int(st.mode_map[y // 4, x // 4] >= rom.NUM_LUMA_MODE)


def code_mip_mode(io, st, x: int, y: int, s: int, mode=None):
    """intra_mip_flag (+ transpose / matrix mode when set).

    Returns the full mode id (>= NUM_LUMA_MODE for MIP) on decode, or None
    when the regular mode path must follow; on encode returns ``mode`` if it
    was a MIP id else None.  Shared by both engines."""
    ctx = C.MIP_FLAG(min(2, _neighbor_is_mip(st, x - 1, y)
                         + _neighbor_is_mip(st, x, y - 1)))
    if io.decoding:
        if not io.bin(ctx):
            return None
        t = io.byp()
        m = io.byp_n(n=3)
        return rom.NUM_LUMA_MODE + 2 * m + t
    is_mip = mode >= rom.NUM_LUMA_MODE
    io.bin(ctx, int(is_mip))
    if not is_mip:
        return None
    v = mode - rom.NUM_LUMA_MODE
    io.byp(v & 1)
    io.byp_n(v >> 1, 3)
    return mode


def code_mrl_idx(io, st, x: int, y: int, k=None) -> int:
    """intra_luma_ref_idx: truncated-unary cmax 2, ctx per bin (MRL)."""
    if io.decoding:
        k = 0
        if io.bin(C.MRL_IDX(0)):
            k = 2 if io.bin(C.MRL_IDX(1)) else 1
        st.dec.mrl8[y // 8, x // 8] = k
        return k
    io.bin(C.MRL_IDX(0), int(k > 0))
    if k > 0:
        io.bin(C.MRL_IDX(1), int(k > 1))
    return k


def isp_parts(s: int, d: int):
    """ISP stripe rects [(dx, dy, w, h)] for an s x s leaf; d: 1 = horizontal
    split (full-width stripes), 2 = vertical.  8x8 leaves use 2 partitions
    (VVC's 4x8/8x4 rule adapted to this build's min-4 TB dimension — the
    reference's 8x2 partitions need 2-wide TBs); 16/32 use 4
    (VTM:CommonLib/UnitTools.cpp CU::getISPSplitDim role)."""
    k = 2 if s == 8 else 4
    if d == 1:
        hs = s // k
        return [(0, i * hs, s, hs) for i in range(k)]
    ws = s // k
    return [(i * ws, 0, ws, s) for i in range(k)]


def isp_kernels(w: int, h: int):
    """Implicit (kind_h, kind_v) for an ISP stripe TB: DST-VII for dims
    <= 16, DCT-II above (the VVC implicit-MTS rule for ISP)."""
    return (rom.DST7 if w <= 16 else rom.DCT2,
            rom.DST7 if h <= 16 else rom.DCT2)


def code_isp_flags(io, dec: FrameDecisions, sps, x: int, y: int,
                   s: int) -> int:
    """intra_subpartitions mode flag (+ split-dimension flag) for a
    regular-mode intra leaf; only on reference line 0, never after MIP.
    Reads/writes dec.isp8; shared by the spec traversal and the pipeline
    entropy walker."""
    if not sps.isp_enabled:
        return 0
    k = int(dec.mrl8[y // 8, x // 8]) if sps.mrl_enabled else 0
    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
    if k != 0:
        if io.decoding:
            dec.isp8[sl8] = 0
        return 0
    if io.decoding:
        isp = 0
        if io.bin(C.ISP_MODE(0)):
            isp = 1 + io.bin(C.ISP_MODE(1))
        dec.isp8[sl8] = isp
        return isp
    isp = int(dec.isp8[y // 8, x // 8])
    io.bin(C.ISP_MODE(0), int(isp > 0))
    if isp:
        io.bin(C.ISP_MODE(1), isp - 1)
    return isp


def _code_intra_mode(io, st: _FrameState, x: int, y: int, w: int,
                     h: int) -> int:
    square = w == h
    if st.sps.mip_enabled and square:
        mode = code_mip_mode(io, st, x, y, w,
                             None if io.decoding
                             else int(st.dec.modes8[y // 8, x // 8]))
        if mode is not None:
            return mode     # MRL is regular-mode only
    if st.sps.mrl_enabled and square:
        code_mrl_idx(io, st, x, y,
                     None if io.decoding
                     else int(st.dec.mrl8[y // 8, x // 8]))
    if square:
        code_isp_flags(io, st.dec, st.sps, x, y, w)
    left = _neighbor_mode(st, x - 1, y + h - 1)
    above = _neighbor_mode(st, x + w - 1, y - 1)
    mpm = intra.mpm_list(left, above)

    if io.decoding:
        if io.bin(C.INTRA_MPM_FLAG(0)):
            if io.bin(C.INTRA_PLANAR_FLAG(0)):
                return rom.PLANAR_IDX
            idx = 1
            while idx < rom.NUM_MPM - 1 and io.byp():
                idx += 1
            return mpm[idx]
        rest = sorted(m for m in range(rom.NUM_LUMA_MODE) if m not in mpm)
        nsym = len(rest)                       # 61
        nb = nsym.bit_length() - 1             # 5
        u = (1 << (nb + 1)) - nsym             # 3
        v = io.byp_n(n=nb)
        idx = v if v < u else ((v << 1) | io.byp()) - u
        return rest[idx]

    mode = int(st.dec.modes8[y // 8, x // 8])
    if mode in mpm:
        io.bin(C.INTRA_MPM_FLAG(0), 1)
        midx = mpm.index(mode)
        io.bin(C.INTRA_PLANAR_FLAG(0), int(midx == 0))
        if midx > 0:
            for i in range(1, midx):
                io.byp(1)
            if midx < rom.NUM_MPM - 1:
                io.byp(0)
    else:
        io.bin(C.INTRA_MPM_FLAG(0), 0)
        rest = sorted(m for m in range(rom.NUM_LUMA_MODE) if m not in mpm)
        nsym = len(rest)
        nb = nsym.bit_length() - 1
        u = (1 << (nb + 1)) - nsym
        idx = rest.index(mode)
        if idx < u:
            io.byp_n(idx, nb)
        else:
            io.byp_n(idx + u, nb + 1)
    return mode


# ---------------------------------------------------------------------------
# leaf coding: predict -> (quantise) -> residual syntax -> reconstruct
# ---------------------------------------------------------------------------

def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def _code_mts_idx(io, idx):
    """Truncated-unary MTS index, ctx per bin (cmax 5; 5 = transform skip)."""
    v = 0
    if io.decoding:
        while v < 5 and io.bin(C.MTS_IDX(v)):
            v += 1
        return v
    for i in range(min(idx, 5)):
        io.bin(C.MTS_IDX(i), 1)
    if idx < 5:
        io.bin(C.MTS_IDX(idx), 0)
    return idx


def _code_lfnst_idx(io, idx=None):
    """Truncated-unary LFNST index, ctx per bin (cmax 2)."""
    if io.decoding:
        if not io.bin(C.LFNST_IDX(0)):
            return 0
        return 2 if io.bin(C.LFNST_IDX(1)) else 1
    io.bin(C.LFNST_IDX(0), int(idx > 0))
    if idx > 0:
        io.bin(C.LFNST_IDX(1), int(idx > 1))
    return idx


def _crs_scale(st: _FrameState, x: int, y: int, w: int, h: int):
    """CRS scale for the leaf: slope LUT at the average reconstructed
    mapped luma of the leaf (spec/lmcs.py build_crs_lut); None if CRS off.
    Requires the leaf's luma to be reconstructed already."""
    if st.crs is None:
        return None
    avg = int(st.recon[0][y:y + h, x:x + w].sum()) >> (_log2(w) + _log2(h))
    return int(st.crs[avg])


def _code_component(io, st: _FrameState, comp: int, x: int, y: int, w: int,
                    h: int, mode: int, cbf_ctx: int, pred=None,
                    mts_ok: bool = False, lev_pre=None,
                    mrl: int = 0, sbt: int = 0, crs_sc=None) -> None:
    plane, valid = st.recon[comp], st.valid[comp]
    is_chroma = comp > 0
    bd = st.sps.bit_depth
    if pred is None:
        top, left = intra.build_references(plane, valid, x, y, w, h, bd,
                                           ref_line=mrl)
        if mode >= rom.NUM_LUMA_MODE:
            pred = intra.mip_predict(top, left, mode - rom.NUM_LUMA_MODE,
                                     w, bd)
        else:
            pred = intra.predict(top, left, mode, w, h, is_chroma, bd,
                                 ref_line=mrl)
    qp = st.qp
    mts_on = mts_ok and (st.sps.mts_enabled or st.sps.ts_enabled)
    lfnst_on = mts_ok and st.sps.lfnst_enabled
    mts_idx = 0
    lfnst_idx = 0
    sl8 = np.s_[y // 8:(y + h) // 8, x // 8:(x + w) // 8]
    if io.decoding:
        cbf = io.bin(cbf_ctx)
        if cbf and mts_on:
            mts_idx = _code_mts_idx(io, None)
            st.dec.mts8[sl8] = mts_idx
        if cbf and lfnst_on and mts_idx == 0:
            lfnst_idx = _code_lfnst_idx(io)
            st.dec.lfnst8[sl8] = lfnst_idx
        lev = code_tb(io, None, _log2(w), _log2(h), is_chroma) if cbf \
            else np.zeros((h, w), np.int32)
    else:
        if mts_on or lfnst_on:
            resi = st.src[comp][y:y + h, x:x + w].astype(np.int32) - pred
            mts_idx, lfnst_idx, lev = transform.choose_tx(
                resi, qp, mode, bd, mts=st.sps.mts_enabled and mts_ok,
                lfnst=lfnst_on, rdoq=st.rdoq,
                ts=st.sps.ts_enabled and mts_ok, dq=st.dq)
            st.dec.mts8[sl8] = mts_idx
            st.dec.lfnst8[sl8] = lfnst_idx
        elif lev_pre is not None:
            lev = lev_pre
        else:
            resi = st.src[comp][y:y + h, x:x + w].astype(np.int32) - pred
            if crs_sc is not None:
                from . import lmcs as lmcsmod
                resi = lmcsmod.crs_fwd(resi, crs_sc)
            coef = transform.forward_transform(resi, bit_depth=bd)
            lev = transform.quantize(coef, qp, intra=True, bit_depth=bd,
                                     rdoq=st.rdoq, dq=st.dq,
                                     lam_rd=transform.lambda_rd_int(qp))
        cbf = int(lev.any())
        io.bin(cbf_ctx, cbf)
        if cbf:
            if mts_on:
                _code_mts_idx(io, mts_idx)
            if lfnst_on and mts_idx == 0:
                _code_lfnst_idx(io, lfnst_idx)
            code_tb(io, lev, _log2(w), _log2(h), is_chroma)
    trace.t_cbf(comp, x, y, w, cbf)
    if sbt and cbf:
        resi = transform.sbt_reconstruct(lev, sbt, qp, bd, dq=st.dq)
        plane[y:y + h, x:x + w] = np.clip(
            pred.astype(np.int32) + resi, 0, (1 << bd) - 1)
    elif crs_sc is not None:
        from . import lmcs as lmcsmod
        resi = transform.inverse_transform(
            transform.dequantize(lev, qp, bd, dq=st.dq), bit_depth=bd) \
            if cbf else np.zeros((h, w), np.int32)
        plane[y:y + h, x:x + w] = np.clip(
            pred.astype(np.int32) + lmcsmod.crs_inv(resi, crs_sc), 0,
            (1 << bd) - 1)
    else:
        kh, kv = transform.MTS_SET[mts_idx if cbf else 0]
        plane[y:y + h, x:x + w] = transform.reconstruct(
            pred, lev, qp, kh, kv, bit_depth=bd,
            lfnst=lfnst_idx if cbf else 0, mode=mode, dq=st.dq)
    valid[y:y + h, x:x + w] = True


def _code_isp_luma(io, st: _FrameState, x: int, y: int, s: int, mode: int,
                   d: int) -> None:
    """ISP luma: stripes coded sequentially, each predicted from the
    reconstructed neighbours (previous stripes included), implicit DST-VII
    kernels, per-stripe cbf (CBF_LUMA ctx 1); no MTS/LFNST syntax
    (role of VTM:EncoderLib/IntraSearch.cpp ISP loops + DecCu xReconIntraQT
    stripe recursion)."""
    bd = st.sps.bit_depth
    lam = transform.lambda_rd_int(st.qp)
    for (dx, dy, w_st, h_st) in isp_parts(s, d):
        px, py = x + dx, y + dy
        top, left = intra.build_references(st.recon[0], st.valid[0], px, py,
                                           w_st, h_st, bd)
        pred = intra.predict(top, left, mode, w_st, h_st, False, bd)
        kh, kv = isp_kernels(w_st, h_st)
        if io.decoding:
            cbf = io.bin(C.CBF_LUMA(1))
            lev = code_tb(io, None, _log2(w_st), _log2(h_st), False) if cbf \
                else np.zeros((h_st, w_st), np.int32)
        else:
            resi = (st.src[0][py:py + h_st, px:px + w_st].astype(np.int32)
                    - pred)
            coef = transform.forward_transform(resi, kh, kv, bd)
            lev = transform.quantize(coef, st.qp, intra=True, bit_depth=bd,
                                     rdoq=st.rdoq, lam_rd=lam, dq=st.dq)
            cbf = int(lev.any())
            io.bin(C.CBF_LUMA(1), cbf)
            if cbf:
                code_tb(io, lev, _log2(w_st), _log2(h_st), False)
        trace.t_cbf(0, px, py, w_st, cbf)
        if cbf:
            r = transform.inverse_transform(
                transform.dequantize(lev, st.qp, bd, dq=st.dq), kh, kv, bd)
        else:
            r = 0
        st.recon[0][py:py + h_st, px:px + w_st] = np.clip(
            pred.astype(np.int32) + r, 0, (1 << bd) - 1)
        st.valid[0][py:py + h_st, px:px + w_st] = True


def _eg_k(io, val, k: int):
    """Exp-Golomb order-k bypass code (HEVC xWriteEpExGolomb scheme)."""
    if io.decoding:
        sym = 0
        while io.byp():
            sym += 1 << k
            k += 1
        return sym + (io.byp_n(n=k) if k else 0)
    sym = int(val)
    while sym >= (1 << k):
        io.byp(1)
        sym -= 1 << k
        k += 1
    io.byp(0)
    if k:
        io.byp_n(sym, k)
    return val


def _code_mvd_comp(io, v) -> int:
    """One MVD component in quarter-pel units (VVC mvd_coding shape)."""
    gt0 = io.bin(C.MVD_FLAG(0), None if io.decoding else int(v != 0))
    if not gt0:
        return 0
    a = None if io.decoding else abs(int(v))
    gt1 = io.bin(C.MVD_FLAG(1), None if io.decoding else int(a > 1))
    if io.decoding:
        a = 1 + (1 + _eg_k(io, None, 1) if gt1 else 0)
    else:
        if gt1:
            _eg_k(io, a - 2, 1)
    sign = io.byp(None if io.decoding else int(v < 0))
    if io.decoding:
        return -a if sign else a
    return v


def code_mv_list(io, mv_map, inter_map, x: int, y: int, s: int, lst: int,
                 mv_enc=None, shift: int = 2, h: int | None = None):
    """mvp_idx + MVD for one reference list at the given AMVR precision
    (shift in 1/16-pel units; 2 = quarter-pel default).  AMVP candidates
    are rounded to the precision grid, so the MVD is always exact.
    Shared by the spec traversal and the pipeline entropy walker."""
    from . import inter as imod
    cands = imod.mvp_candidates(mv_map[:, :, lst], inter_map[:, :, lst],
                                x, y, s, h=h)
    rc = [(imod.round_mv_prec(c[0], shift), imod.round_mv_prec(c[1], shift))
          for c in cands]
    if io.decoding:
        idx = io.byp()
        mvd_x = _code_mvd_comp(io, None)
        mvd_y = _code_mvd_comp(io, None)
        return (rc[idx][0] + (mvd_x << shift),
                rc[idx][1] + (mvd_y << shift))
    mv = mv_enc
    costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1]) for c in rc]
    idx = int(np.argmin(costs))
    io.byp(idx)
    _code_mvd_comp(io, (mv[0] - rc[idx][0]) >> shift)
    _code_mvd_comp(io, (mv[1] - rc[idx][1]) >> shift)
    return mv


def _code_mv_list(io, st: _FrameState, x: int, y: int, s: int, lst: int,
                  mv_enc=None, shift: int = 2, h: int | None = None):
    return code_mv_list(io, st.mv_map, st.inter_map, x, y, s, lst, mv_enc,
                        shift, h=h)


def code_mv_smvd(io, mv_map, inter_map, x: int, y: int, s: int,
                 mv0_enc=None, i1_enc=None, shift: int = 2):
    """SMVD motion data: mvp_idx L0 + one MVD + mvp_idx L1; the L1 MV is
    the L1 predictor minus the mirrored MVD.  Returns (mv0, mv1)."""
    from . import inter as imod
    c0 = imod.mvp_candidates(mv_map[:, :, 0], inter_map[:, :, 0], x, y, s)
    c1 = imod.mvp_candidates(mv_map[:, :, 1], inter_map[:, :, 1], x, y, s)
    rc0 = [(imod.round_mv_prec(c[0], shift), imod.round_mv_prec(c[1], shift))
           for c in c0]
    rc1 = [(imod.round_mv_prec(c[0], shift), imod.round_mv_prec(c[1], shift))
           for c in c1]
    if io.decoding:
        i0 = io.byp()
        mvd_x = _code_mvd_comp(io, None) << shift
        mvd_y = _code_mvd_comp(io, None) << shift
        i1 = io.byp()
        return ((rc0[i0][0] + mvd_x, rc0[i0][1] + mvd_y),
                (rc1[i1][0] - mvd_x, rc1[i1][1] - mvd_y))
    mv0 = mv0_enc
    costs = [abs(mv0[0] - c[0]) + abs(mv0[1] - c[1]) for c in rc0]
    i0 = int(np.argmin(costs))
    io.byp(i0)
    _code_mvd_comp(io, (mv0[0] - rc0[i0][0]) >> shift)
    _code_mvd_comp(io, (mv0[1] - rc0[i0][1]) >> shift)
    io.byp(i1_enc)
    return mv0, (rc1[i1_enc][0] - (mv0[0] - rc0[i0][0]),
                 rc1[i1_enc][1] - (mv0[1] - rc0[i0][1]))


def code_amvr(io, prec=None) -> int:
    """amvr_flag (+ one-bin precision idx): 0 quarter, 1 integer, 2 4-pel."""
    if io.decoding:
        if not io.bin(C.AMVR_FLAG(0)):
            return 0
        return 1 + io.bin(C.AMVR_PREC(0))
    io.bin(C.AMVR_FLAG(0), int(prec > 0))
    if prec > 0:
        io.bin(C.AMVR_PREC(0), prec - 1)
    return prec


def _amvr_for_leaf(io, mv_map, inter_map, x, y, s, d, mv0, mv1,
                   enabled: bool, h: int | None = None) -> int:
    """Shared encode-side AMVR decision + syntax for one explicit leaf."""
    from . import inter as imod
    if not enabled:
        return 0
    mvs, lists = [], []
    if d in (0, 2):
        mvs.append(mv0)
        lists.append(imod.mvp_candidates(mv_map[:, :, 0],
                                         inter_map[:, :, 0], x, y, s, h=h))
    if d in (1, 2):
        mvs.append(mv1)
        lists.append(imod.mvp_candidates(mv_map[:, :, 1],
                                         inter_map[:, :, 1], x, y, s,
                                         h=h))
    prec = imod.amvr_choose(mvs, lists, True)
    return code_amvr(io, prec)


def _code_merge_idx(io, idx=None) -> int:
    """Truncated-unary merge index, first bin ctx-coded (cmax MRG_MAX-1)."""
    from .inter import MRG_MAX
    if io.decoding:
        if not io.bin(C.MERGE_IDX(0)):
            return 0
        v = 1
        while v < MRG_MAX - 1 and io.byp():
            v += 1
        return v
    io.bin(C.MERGE_IDX(0), int(idx > 0))
    for _ in range(1, idx):
        io.byp(1)
    if 0 < idx < MRG_MAX - 1:
        io.byp(0)
    return idx


def _code_mmvd(io, mmvd=None):
    """mmvd_merge_flag + (base, distance TU cmax 7, direction 2 bins).

    Returns the (base, dist_idx, dir_idx) triple or None (regular merge)."""
    if io.decoding:
        if not io.bin(C.MMVD_FLAG(0)):
            return None
        b = io.bin(C.MMVD_BASE(0))
        di = 0
        if io.bin(C.MMVD_DIST(0)):
            di = 1
            while di < 7 and io.byp():
                di += 1
        dd = io.byp_n(n=2)
        return (b, di, dd)
    io.bin(C.MMVD_FLAG(0), int(mmvd is not None))
    if mmvd is None:
        return None
    b, di, dd = mmvd
    io.bin(C.MMVD_BASE(0), b)
    io.bin(C.MMVD_DIST(0), int(di > 0))
    for _ in range(1, di):
        io.byp(1)
    if 0 < di < 7:
        io.byp(0)
    io.byp_n(dd, 2)
    return mmvd


def _code_bcw_idx(io, widx=None) -> int:
    """bcw_idx: first bin ctx-coded (unequal weight?), bypass picks 3 vs 5."""
    from .inter import BCW_DEFAULT
    if io.decoding:
        if not io.bin(C.BCW_IDX(0)):
            return BCW_DEFAULT
        return 2 if io.byp() else 0
    io.bin(C.BCW_IDX(0), int(widx != BCW_DEFAULT))
    if widx != BCW_DEFAULT:
        io.byp(int(widx == 2))
    return widx


def _code_sbt_idx(io, idx=None) -> int:
    """SBT index: ctx-coded sbt_flag + (dir, pos) bypass bins.
    idx: 0 none, 1 V-left, 2 V-right, 3 H-top, 4 H-bottom."""
    if io.decoding:
        if not io.bin(C.SBT_FLAG(0)):
            return 0
        hor = io.byp()
        pos = io.byp()
        return 1 + 2 * hor + pos
    io.bin(C.SBT_FLAG(0), int(idx > 0))
    if idx > 0:
        io.byp((idx - 1) >> 1)
        io.byp((idx - 1) & 1)
    return idx


def _ciip_blend(st: _FrameState, mc_pred: np.ndarray, comp: int, px: int,
                py: int, sz: int) -> np.ndarray:
    """CIIP: equal blend of the MC prediction with planar intra from the
    reconstructed neighbours (role of VTM CIIP; documented simplification:
    the neighbour-adaptive {1,2,3}/4 weight is fixed at the 2/4
    midpoint)."""
    bd = st.sps.bit_depth
    top, left = intra.build_references(st.recon[comp], st.valid[comp],
                                       px, py, sz, sz, bd)
    pl = intra.predict(top, left, rom.PLANAR_IDX, sz, sz, comp > 0, bd)
    return np.clip((mc_pred + pl + 1) >> 1, 0, (1 << bd) - 1)


def _inter_pred(st: _FrameState, x: int, y: int, s: int, d: int, mv0, mv1,
                widx: int = 1, ciip: bool = False, gpm: int = 0,
                aff=None, h: int | None = None):
    """[Y, Cb, Cr] motion-compensated predictions for the leaf.

    BI leaves run DMVR (per 16x16 subblock, refs symmetric) and BDOF
    (per 4x4 optical flow) when enabled — decoder-side refinements with no
    syntax (spec/inter.py dmvr_offset / bdof_blend).  widx: BCW weight
    index (unequal weights disable DMVR/BDOF, as in VVC); ciip blends the
    final prediction with planar intra (also disables DMVR/BDOF); gpm
    (partition idx + 1) blends the two uni predictions with the geometric
    mask (role of VTM InterPrediction::motionCompensationGeo; masks
    rom.gpm_mask; disables DMVR/BDOF/BCW)."""
    from . import inter as imod
    bd = st.sps.bit_depth
    mx = (1 << bd) - 1
    hh = s if h is None else h
    if hh != s:
        # rectangular (BT) leaf: plain translational MC only (DMVR/BDOF/
        # GPM/affine/CIIP are square-leaf tools in this build)
        def pf(comp, px, py, pw, ph):
            outs = []
            for lst, mv in ((0, mv0), (1, mv1)):
                if d != 2 and lst != d:
                    continue
                ref = st.refs[lst][comp]
                if comp == 0:
                    outs.append(imod.mc_luma(ref, px, py, pw, ph, mv[0],
                                             mv[1], bd))
                else:
                    outs.append(imod.mc_chroma(ref, px, py, pw, ph, mv[0],
                                               mv[1], bd,
                                               imod.REF_MARGIN // 2))
            if len(outs) == 2:
                return imod.bcw_average(outs[0], outs[1], widx, bd)
            return outs[0]

        out = [pf(0, x, y, s, hh),
               pf(1, x // 2, y // 2, s // 2, hh // 2),
               pf(2, x // 2, y // 2, s // 2, hh // 2)]
        if st.lmcs is not None:
            out[0] = st.lmcs[0][out[0]]
        return out

    if aff is not None:
        # affine (uni): per-4x4-subblock luma MC + PROF; 4x4 chroma
        # subblocks at the granule-centre model MVs
        base = mv0 if d == 0 else mv1
        ref = st.refs[d]
        out = [imod.affine_pred_luma(ref[0], x, y, s, base, aff, bd,
                                     prof=True),
               imod.affine_pred_chroma(ref[1], x // 2, y // 2, s // 2,
                                       base, aff, s, bd,
                                       imod.REF_MARGIN // 2),
               imod.affine_pred_chroma(ref[2], x // 2, y // 2, s // 2,
                                       base, aff, s, bd,
                                       imod.REF_MARGIN // 2)]
        if st.lmcs is not None:
            out[0] = st.lmcs[0][out[0]]
        return out

    if gpm:
        w = rom.gpm_mask(s, gpm - 1)
        wc = w[::2, ::2]
        out = []
        for comp, (px, py, sz, wm, mrg) in enumerate(
                ((x, y, s, w, imod.REF_MARGIN),
                 (x // 2, y // 2, s // 2, wc, imod.REF_MARGIN // 2),
                 (x // 2, y // 2, s // 2, wc, imod.REF_MARGIN // 2))):
            if comp == 0:
                p0 = imod.mc_luma(st.refs[0][0], px, py, sz, sz, mv0[0],
                                  mv0[1], bd)
                p1 = imod.mc_luma(st.refs[1][0], px, py, sz, sz, mv1[0],
                                  mv1[1], bd)
            else:
                p0 = imod.mc_chroma(st.refs[0][comp], px, py, sz, sz,
                                    mv0[0], mv0[1], bd, mrg)
                p1 = imod.mc_chroma(st.refs[1][comp], px, py, sz, sz,
                                    mv1[0], mv1[1], bd, mrg)
            out.append(np.clip((wm * p0 + (8 - wm) * p1 + 4) >> 3, 0, mx))
        if st.lmcs is not None:
            out[0] = st.lmcs[0][out[0]]
        return out

    if d == 2 and widx == imod.BCW_DEFAULT and not ciip \
            and (st.dmvr or st.bdof):
        sub = imod.DMVR_SUB if (st.dmvr and s >= imod.DMVR_SUB) else s
        out_y = np.zeros((s, s), np.int32)
        out_cb = np.zeros((s // 2, s // 2), np.int32)
        out_cr = np.zeros((s // 2, s // 2), np.int32)
        for sy in range(0, s, sub):
            for sx in range(0, s, sub):
                m0, m1 = mv0, mv1
                if st.dmvr and s >= imod.DMVR_SUB:
                    dx, dy = imod.dmvr_offset(st.refs[0][0], st.refs[1][0],
                                              x + sx, y + sy, sub, mv0, mv1)
                    o = (dx << imod.MV_FRAC_BITS, dy << imod.MV_FRAC_BITS)
                    m0 = (mv0[0] + o[0], mv0[1] + o[1])
                    m1 = (mv1[0] - o[0], mv1[1] - o[1])
                if st.bdof:
                    p0e = imod.mc_luma(st.refs[0][0], x + sx - 1, y + sy - 1,
                                       sub + 2, sub + 2, m0[0], m0[1], bd)
                    p1e = imod.mc_luma(st.refs[1][0], x + sx - 1, y + sy - 1,
                                       sub + 2, sub + 2, m1[0], m1[1], bd)
                    blk = imod.bdof_blend(p0e, p1e, bd)
                else:
                    p0 = imod.mc_luma(st.refs[0][0], x + sx, y + sy, sub,
                                      sub, m0[0], m0[1], bd)
                    p1 = imod.mc_luma(st.refs[1][0], x + sx, y + sy, sub,
                                      sub, m1[0], m1[1], bd)
                    blk = np.minimum((p0 + p1 + 1) >> 1, mx)
                out_y[sy:sy + sub, sx:sx + sub] = blk
                cs2 = sub // 2
                cpx, cpy = (x + sx) // 2, (y + sy) // 2
                for comp, tgt in ((1, out_cb), (2, out_cr)):
                    c0 = imod.mc_chroma(st.refs[0][comp], cpx, cpy, cs2, cs2,
                                        m0[0], m0[1], bd,
                                        imod.REF_MARGIN // 2)
                    c1 = imod.mc_chroma(st.refs[1][comp], cpx, cpy, cs2, cs2,
                                        m1[0], m1[1], bd,
                                        imod.REF_MARGIN // 2)
                    tgt[sy // 2:sy // 2 + cs2, sx // 2:sx // 2 + cs2] = \
                        np.minimum((c0 + c1 + 1) >> 1, mx)
        out = [out_y, out_cb, out_cr]
        if st.lmcs is not None:
            out[0] = st.lmcs[0][out[0]]
        return out

    def pred_for(comp, px, py, sz):
        outs = []
        for lst, mv in ((0, mv0), (1, mv1)):
            if d != 2 and lst != d:
                continue
            ref = st.refs[lst][comp]
            if comp == 0:
                outs.append(imod.mc_luma(ref, px, py, sz, sz, mv[0], mv[1],
                                         bd))
            else:
                outs.append(imod.mc_chroma(ref, px, py, sz, sz, mv[0],
                                           mv[1], bd, imod.REF_MARGIN // 2))
        if len(outs) == 2:
            return imod.bcw_average(outs[0], outs[1], widx, bd)
        return outs[0]

    out = [pred_for(0, x, y, s), pred_for(1, x // 2, y // 2, s // 2),
           pred_for(2, x // 2, y // 2, s // 2)]
    if st.lmcs is not None:
        out[0] = st.lmcs[0][out[0]]
    if ciip:
        out = [_ciip_blend(st, out[0], 0, x, y, s),
               _ciip_blend(st, out[1], 1, x // 2, y // 2, s // 2),
               _ciip_blend(st, out[2], 2, x // 2, y // 2, s // 2)]
    return out


def _prep_inter_enc(st: _FrameState, x: int, y: int, s: int,
                    h: int | None = None) -> dict:
    """Encoder-side precompute for one inter leaf: motion from the decision
    maps, merge-candidate match, predictions and quantized levels (needed
    before the skip flag can be coded).  s is the leaf width, h the height
    (square-only tools are gated off on rectangular BT leaves)."""
    from . import inter as imod
    hh = s if h is None else h
    square = hh == s
    gy, gx = y // 8, x // 8
    is_b = len(st.refs) == 2
    d = int(st.dec.dir8[gy, gx]) if is_b else 0
    mv0 = ((int(st.dec.mv8[gy, gx, 0]), int(st.dec.mv8[gy, gx, 1]))
           if d in (0, 2) else (0, 0))
    mv1 = ((int(st.dec.mv8_l1[gy, gx, 0]), int(st.dec.mv8_l1[gy, gx, 1]))
           if d in (1, 2) else (0, 0))
    widx = (int(st.dec.bcw8[gy, gx])
            if st.sps.bcw_enabled and d == 2 and square
            else imod.BCW_DEFAULT)
    aff = None
    if (st.sps.affine_enabled and s >= imod.AFF_MIN_SIZE and d != 2
            and square
            and st.dec.aff8 is not None and st.dec.aff8[gy, gx]):
        aff = (int(st.dec.admv8[gy, gx, 0]), int(st.dec.admv8[gy, gx, 1]))
    cands = imod.merge_candidates(st.inter_map, st.mv_map, x, y, s, is_b,
                                  st.col, st.hmvp, h=hh)
    me = (d, mv0, mv1)
    # merge leaves always use the equal weight, so an unequal-BCW leaf
    # must be coded explicitly; affine leaves are always explicit
    midx = (cands.index(me)
            if me in cands and widx == imod.BCW_DEFAULT and aff is None
            else None)
    mmvd = (imod.mmvd_match(cands, me)
            if midx is None and widx == imod.BCW_DEFAULT and aff is None
            and st.sps.mmvd_enabled else None)
    ciip = (bool(st.dec.ciip8[gy, gx])
            if st.sps.ciip_enabled and square else False)
    gpm = (int(st.dec.gpm8[gy, gx])
           if (st.sps.gpm_enabled and is_b and d == 2 and not ciip
               and square) else 0)
    preds = _inter_pred(st, x, y, s, d, mv0, mv1, widx, ciip, gpm, aff,
                        h=hh)
    bd = st.sps.bit_depth
    levs = []
    sbt = 0
    crs_sc = None
    for comp, (px, py, sz, szh) in enumerate(
            ((x, y, s, hh), (x // 2, y // 2, s // 2, hh // 2),
             (x // 2, y // 2, s // 2, hh // 2))):
        resi = (st.src[comp][py:py + szh, px:px + sz].astype(np.int32)
                - preds[comp])
        if comp == 1 and st.crs is not None:
            # CRS: scale by the slope at the leaf's avg reconstructed
            # mapped luma (twin of the recon-side _crs_scale; the luma
            # recon here equals what _code_component will write)
            from . import lmcs as lmcsmod
            if sbt:
                lr = np.clip(
                    preds[0] + transform.sbt_reconstruct(levs[0], sbt,
                                                         st.qp, bd,
                                                         dq=st.dq),
                    0, (1 << bd) - 1)
            else:
                lr = transform.reconstruct(preds[0], levs[0], st.qp,
                                           bit_depth=bd, dq=st.dq)
            avg = int(lr.sum()) >> (_log2(s) + _log2(hh))
            crs_sc = int(st.crs[avg])
        if comp > 0 and crs_sc is not None:
            from . import lmcs as lmcsmod
            resi = lmcsmod.crs_fwd(resi, crs_sc)
        if comp == 0 and st.sps.sbt_enabled and not ciip and square:
            # SBT is mutually exclusive with CIIP (as in VVC): the blended
            # prediction has no single motion boundary to align a half to;
            # square leaves only
            sbt, lev = transform.choose_sbt(resi, st.qp, bd, rdoq=st.rdoq,
                                            dq=st.dq)
            levs.append(lev)
            continue
        coef = transform.forward_transform(resi, bit_depth=bd)
        levs.append(transform.quantize(
            coef, st.qp, intra=True, bit_depth=bd, rdoq=st.rdoq, dq=st.dq,
            lam_rd=transform.lambda_rd_int(st.qp)))
    all_zero = not any(lv.any() for lv in levs)
    return dict(d=d, mv0=mv0, mv1=mv1, midx=midx, mmvd=mmvd, preds=preds,
                levs=levs, all_zero=all_zero, widx=widx, ciip=ciip,
                sbt=sbt, gpm=gpm, aff=aff)


def _code_inter_leaf(io, st: _FrameState, x: int, y: int, s: int,
                     skip: bool, pre: dict | None = None,
                     h: int | None = None) -> None:
    from . import inter as imod
    hh = s if h is None else h
    square = hh == s
    gy, gx = y // 8, x // 8
    is_b = st.refs is not None and len(st.refs) == 2

    aff = None
    if io.decoding:
        widx = imod.BCW_DEFAULT
        ciip = False
        merge = True if skip else bool(io.bin(C.MERGE_FLAG(0)))
        if merge:
            mmvd = _code_mmvd(io) if st.sps.mmvd_enabled else None
            cands = imod.merge_candidates(st.inter_map, st.mv_map, x, y, s,
                                          is_b, st.col, st.hmvp, h=hh)
            if mmvd is not None:
                d, mv0, mv1 = imod.mmvd_derive(cands[mmvd[0]], mmvd[1],
                                               mmvd[2])
            else:
                midx = _code_merge_idx(io)
                d, mv0, mv1 = cands[midx]
        else:
            if is_b:
                bi = io.bin(C.INTER_DIR(0))
                d = 2 if bi else io.byp()
            else:
                d = 0
            aff_sig = (st.sps.affine_enabled and s >= imod.AFF_MIN_SIZE
                       and d != 2 and square)
            if aff_sig and io.bin(C.AFF_FLAG(0)):
                acands = imod.affine_merge_cands(
                    st.inter_map, st.mv_map, st.dec.aff8, st.dec.admv8,
                    x, y, s, d)
                amrg = bool(io.bin(C.AFFM_FLAG(0))) if acands else False
                if amrg:
                    ai = io.byp() if len(acands) > 1 else 0
                    bx_, by_, dmx, dmy = acands[ai]
                    mv = (bx_, by_)
                else:
                    mv = _code_mv_list(io, st, x, y, s, d, shift=2, h=hh)
                    dmx = _code_mvd_comp(io, None) << 2
                    dmy = _code_mvd_comp(io, None) << 2
                aff = (dmx, dmy)
                mv0 = mv if d == 0 else (0, 0)
                mv1 = mv if d == 1 else (0, 0)
            else:
                shift = imod.AMVR_SHIFTS[code_amvr(io)] \
                    if st.sps.amvr_enabled else 2
                smvd = bool(io.bin(C.SMVD_FLAG(0))) \
                    if d == 2 and st.smvd and square else False
                mv0 = mv1 = (0, 0)
                if smvd:
                    mv0, mv1 = code_mv_smvd(io, st.mv_map, st.inter_map,
                                            x, y, s, shift=shift)
                else:
                    if d in (0, 2):
                        mv0 = _code_mv_list(io, st, x, y, s, 0, shift=shift,
                                            h=hh)
                    if d in (1, 2):
                        mv1 = _code_mv_list(io, st, x, y, s, 1, shift=shift,
                                            h=hh)
                    if d == 1:
                        mv0 = (0, 0)
                if is_b and d == 2 and st.sps.bcw_enabled and square:
                    widx = _code_bcw_idx(io)
        if st.sps.ciip_enabled and not skip and square:
            ciip = bool(io.bin(C.CIIP_FLAG(0)))
        gpm = 0
        if (st.sps.gpm_enabled and is_b and not skip and not ciip
                and d == 2 and square):
            if io.bin(C.GPM_FLAG(0)):
                gpm = 1 + io.byp_n(n=6)
        sbt = _code_sbt_idx(io) \
            if st.sps.sbt_enabled and not skip and not ciip and square \
            else 0
        preds = _inter_pred(st, x, y, s, d, mv0, mv1, widx, ciip, gpm, aff,
                            h=hh)
        sl = np.s_[gy:(y + hh) // 8, gx:(x + s) // 8]
        st.dec.inter8[sl] = 1
        st.dec.dir8[sl] = d
        st.dec.mv8[sl] = mv0
        st.dec.mv8_l1[sl] = mv1
        st.dec.bcw8[sl] = widx
        st.dec.ciip8[sl] = ciip
        st.dec.sbt8[sl] = sbt
        st.dec.gpm8[sl] = gpm
        st.dec.aff8[sl] = int(aff is not None)
        if aff is not None:
            st.dec.admv8[sl] = aff
    else:
        d, mv0, mv1 = pre["d"], pre["mv0"], pre["mv1"]
        midx, preds = pre["midx"], pre["preds"]
        mmvd = pre["mmvd"]
        widx = pre["widx"]
        aff = pre["aff"] if not skip else None
        merged = midx is not None or mmvd is not None

        def code_merge_data():
            if st.sps.mmvd_enabled:
                _code_mmvd(io, None if midx is not None else mmvd)
            if midx is not None:
                _code_merge_idx(io, midx)

        if skip:
            code_merge_data()
        else:
            io.bin(C.MERGE_FLAG(0), int(merged))
            if merged:
                code_merge_data()
            else:
                if is_b:
                    io.bin(C.INTER_DIR(0), int(d == 2))
                    if d != 2:
                        io.byp(d)
                aff = pre["aff"]
                aff_sig = (st.sps.affine_enabled
                           and s >= imod.AFF_MIN_SIZE and d != 2
                           and square)
                if aff_sig:
                    io.bin(C.AFF_FLAG(0), int(aff is not None))
                if aff is not None:
                    base = mv0 if d == 0 else mv1
                    acands = imod.affine_merge_cands(
                        st.inter_map, st.mv_map, st.dec.aff8,
                        st.dec.admv8, x, y, s, d)
                    tgt = (int(base[0]), int(base[1]), int(aff[0]),
                           int(aff[1]))
                    ai = acands.index(tgt) if tgt in acands else -1
                    if acands:
                        io.bin(C.AFFM_FLAG(0), int(ai >= 0))
                    if ai >= 0:
                        if len(acands) > 1:
                            io.byp(ai)
                    else:
                        _code_mv_list(io, st, x, y, s, d, base, shift=2,
                                      h=hh)
                        _code_mvd_comp(io, aff[0] >> 2)
                        _code_mvd_comp(io, aff[1] >> 2)
                else:
                    prec = _amvr_for_leaf(io, st.mv_map, st.inter_map, x, y,
                                          s, d, mv0, mv1,
                                          st.sps.amvr_enabled, h=hh)
                    shift = imod.AMVR_SHIFTS[prec]
                    i1 = imod.smvd_match(st.mv_map, st.inter_map, x, y, s,
                                         mv0, mv1, shift) \
                        if d == 2 and st.smvd and square else None
                    if d == 2 and st.smvd and square:
                        io.bin(C.SMVD_FLAG(0), int(i1 is not None))
                    if i1 is not None:
                        code_mv_smvd(io, st.mv_map, st.inter_map, x, y, s,
                                     mv0, i1, shift=shift)
                    else:
                        if d in (0, 2):
                            _code_mv_list(io, st, x, y, s, 0, mv0,
                                          shift=shift, h=hh)
                        if d in (1, 2):
                            _code_mv_list(io, st, x, y, s, 1, mv1,
                                          shift=shift, h=hh)
                    if is_b and d == 2 and st.sps.bcw_enabled and square:
                        _code_bcw_idx(io, widx)
            if st.sps.ciip_enabled and square:
                io.bin(C.CIIP_FLAG(0), int(pre["ciip"]))
            if (st.sps.gpm_enabled and is_b and not pre["ciip"]
                    and d == 2 and square):
                io.bin(C.GPM_FLAG(0), int(pre["gpm"] > 0))
                if pre["gpm"]:
                    io.byp_n(pre["gpm"] - 1, 6)
            if st.sps.sbt_enabled and not pre["ciip"] and square:
                _code_sbt_idx(io, pre["sbt"])
        # record (and apply) SBT only where it was actually signalled —
        # mirrors the decoder/read-side gate exactly; a decide-pass sbt on
        # a skip/CIIP/rect leaf is a dead value, and letting it through
        # would apply an unsignalled transform to the residual (r5 latent
        # bug: fired as a cross-engine sbt8-plane mismatch once the
        # spec-literal beta table shifted RD)
        sbt = (pre["sbt"] if (not skip and not pre["ciip"] and square)
               else 0)
        sl = np.s_[gy:(y + hh) // 8, gx:(x + s) // 8]
        st.dec.sbt8[sl] = sbt

    trace.t_leaf_inter(x, y, s, mv0 if d != 1 else mv1)
    bd = st.sps.bit_depth
    mx = (1 << bd) - 1
    cs, ch, cx, cy = s // 2, hh // 2, x // 2, y // 2
    if skip:
        for comp, (px, py, sz, szh) in enumerate(
                ((x, y, s, hh), (cx, cy, cs, ch), (cx, cy, cs, ch))):
            trace.t_cbf(comp, px, py, sz, 0)
            st.recon[comp][py:py + szh, px:px + sz] = np.clip(preds[comp],
                                                              0, mx)
            st.valid[comp][py:py + szh, px:px + sz] = True
    else:
        levs = (None, None, None) if io.decoding else pre["levs"]
        _code_component(io, st, 0, x, y, s, hh, 0, C.CBF_LUMA(0),
                        pred=preds[0], lev_pre=levs[0], sbt=sbt)
        crs_sc = _crs_scale(st, x, y, s, hh)
        _code_component(io, st, 1, cx, cy, cs, ch, 0, C.CBF_CB(0),
                        pred=preds[1], lev_pre=levs[1], crs_sc=crs_sc)
        _code_component(io, st, 2, cx, cy, cs, ch, 0, C.CBF_CR(0),
                        pred=preds[2], lev_pre=levs[2], crs_sc=crs_sc)
    sl = np.s_[gy:(y + hh) // 8, gx:(x + s) // 8]
    if aff is not None:
        # per-granule model MVs feed neighbour prediction (the coded
        # syntax carries CPMV0, kept in dec.mv8)
        st.inter_map[:, :, d][sl] = True
        st.mv_map[:, :, d][sl] = imod.affine_granule_mvs(
            mv0 if d == 0 else mv1, aff, s)
    else:
        if d in (0, 2):
            st.inter_map[:, :, 0][sl] = True
            st.mv_map[:, :, 0][sl] = mv0
        if d in (1, 2):
            st.inter_map[:, :, 1][sl] = True
            st.mv_map[:, :, 1][sl] = mv1
    imod.hmvp_push(st.hmvp, (d, mv0, mv1))


def ibc_legal(x: int, y: int, s: int, bvx: int, bvy: int, w: int,
              h: int) -> bool:
    """IBC reference-area constraint (role of the VVC virtual IBC buffer,
    simplified to whole-CTU availability): the source block must lie fully
    inside the frame AND either entirely above the current CTU row, or in
    the same CTU row strictly left of the current CTU."""
    sx, sy = x + bvx, y + bvy
    if sx < 0 or sy < 0 or sx + s > w or sy + s > h:
        return False
    cy0, cx0 = y & ~63, x & ~63
    return (sy + s <= cy0) or (sy >= cy0 and sy + s <= cy0 + 64
                               and sx + s <= cx0)


IBC_BITS = 1     # ibc_flag rate proxy in the decision pass


def _code_ibc_leaf(io, st: _FrameState, x: int, y: int, s: int,
                   bvx: int, bvy: int) -> None:
    """IBC leaf reconstruction: copy-predict all components from the
    already-reconstructed area of the current picture at the block vector
    (integer pels; chroma floor-halved), then plain DCT-II residuals."""
    wF, hF = st.sps.width, st.sps.height
    sx = min(max(x + bvx, 0), wF - s)     # decoder-safety clamp
    sy = min(max(y + bvy, 0), hF - s)
    pred_y = st.recon[0][sy:sy + s, sx:sx + s].copy()
    cs = s // 2
    csx, csy = sx // 2, sy // 2
    pred_cb = st.recon[1][csy:csy + cs, csx:csx + cs].copy()
    pred_cr = st.recon[2][csy:csy + cs, csx:csx + cs].copy()
    _code_component(io, st, 0, x, y, s, s, 0, C.CBF_LUMA(0), pred=pred_y)
    _code_component(io, st, 1, x // 2, y // 2, cs, cs, 0, C.CBF_CB(0),
                    pred=pred_cb)
    _code_component(io, st, 2, x // 2, y // 2, cs, cs, 0, C.CBF_CR(0),
                    pred=pred_cr)
    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
    st.mode_map[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = rom.PLANAR_IDX
    st.ibc_map[sl8] = True
    st.bv_map[sl8] = (bvx, bvy)
    st.dec.ibc8[sl8] = 1
    st.dec.bv8[sl8] = (bvx, bvy)
    st.dec.modes8[sl8] = 0
    trace.t_leaf_intra(x, y, s, -1)


def _code_plt_flag(io, st: _FrameState, x: int, y: int, s: int) -> bool:
    """plt_flag with context from the left/above granules' palette-ness
    (IBC-flag scheme)."""
    gy, gx = y // 8, x // 8
    nb = 0
    if gx > 0 and st.dec.plt8[gy, gx - 1]:
        nb += 1
    if gy > 0 and st.dec.plt8[gy - 1, gx]:
        nb += 1
    ctx = C.PLT_FLAG(min(1, nb))
    if io.decoding:
        return bool(io.bin(ctx))
    flag = int(st.dec.plt8[gy, gx])
    io.bin(ctx, flag)
    return bool(flag)


def _code_plt_leaf(io, st: _FrameState, x: int, y: int, s: int) -> None:
    """Palette leaf: entries + index-map runs, recon = palette[idx] with
    no residual (spec/palette.py; role of VTM DecCu palette recon)."""
    from . import palette as pltmod
    bd = st.sps.bit_depth
    if io.decoding:
        entries, idx = pltmod.code_palette(io, s, bd)
    else:
        entries, idx = pltmod.derive_palette(st.src[0], st.src[1],
                                             st.src[2], x, y, s, bd)
        pltmod.code_palette(io, s, bd, entries, idx)
    if st.dec.plt_data is None:
        st.dec.plt_data = {}
    st.dec.plt_data[(x, y, s)] = (entries, idx)
    ry, rcb, rcr = pltmod.map_block(entries, idx)
    cs, cx, cy = s // 2, x // 2, y // 2
    st.recon[0][y:y + s, x:x + s] = ry
    st.recon[1][cy:cy + cs, cx:cx + cs] = rcb
    st.recon[2][cy:cy + cs, cx:cx + cs] = rcr
    st.valid[0][y:y + s, x:x + s] = True
    st.valid[1][cy:cy + cs, cx:cx + cs] = True
    st.valid[2][cy:cy + cs, cx:cx + cs] = True
    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
    st.mode_map[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = rom.PLANAR_IDX
    st.dec.plt8[sl8] = 1
    st.dec.modes8[sl8] = 0
    trace.t_leaf_intra(x, y, s, -2)


def _code_ibc_flag_bv(io, st: _FrameState, x: int, y: int, s: int):
    """ibc_flag (+ BVP idx and BVD when set).  Returns (bvx, bvy) or
    None; shared geometry with the AMVP scheme (2 candidates from the
    left/above IBC neighbours, integer-pel units)."""
    from . import inter as imod
    gy, gx = y // 8, x // 8
    nb = 0
    if gx > 0 and st.ibc_map[gy, gx - 1]:
        nb += 1
    if gy > 0 and st.ibc_map[gy - 1, gx]:
        nb += 1
    ctx = C.IBC_FLAG(min(1, nb))
    if io.decoding:
        if not io.bin(ctx):
            return None
        cands = imod.mvp_candidates(st.bv_map, st.ibc_map, x, y, s)
        idx = io.byp()
        bvx = cands[idx][0] + _code_mvd_comp(io, None)
        bvy = cands[idx][1] + _code_mvd_comp(io, None)
        return (bvx, bvy)
    flag = int(st.dec.ibc8[gy, gx])
    io.bin(ctx, flag)
    if not flag:
        return None
    bv = (int(st.dec.bv8[gy, gx, 0]), int(st.dec.bv8[gy, gx, 1]))
    cands = imod.mvp_candidates(st.bv_map, st.ibc_map, x, y, s)
    costs = [abs(bv[0] - c[0]) + abs(bv[1] - c[1]) for c in cands]
    idx = int(np.argmin(costs))
    io.byp(idx)
    _code_mvd_comp(io, bv[0] - cands[idx][0])
    _code_mvd_comp(io, bv[1] - cands[idx][1])
    return bv


def _code_leaf(io, st: _FrameState, x: int, y: int, s: int,
               h: int | None = None) -> None:
    hh = s if h is None else h
    square = hh == s
    if st.refs is not None:
        if io.decoding:
            if io.bin(C.SKIP_FLAG(0)):
                _code_inter_leaf(io, st, x, y, s, True, h=hh)
                return
            if io.bin(C.PRED_MODE(0)):
                _code_inter_leaf(io, st, x, y, s, False, h=hh)
                return
        else:
            if st.dec.inter8[y // 8, x // 8]:
                pre = _prep_inter_enc(st, x, y, s, h=hh)
                skip = ((pre["midx"] is not None
                         or pre["mmvd"] is not None) and pre["all_zero"]
                        and not pre["ciip"] and not pre["gpm"])
                io.bin(C.SKIP_FLAG(0), int(skip))
                if not skip:
                    io.bin(C.PRED_MODE(0), 1)
                _code_inter_leaf(io, st, x, y, s, skip, pre, h=hh)
                return
            io.bin(C.SKIP_FLAG(0), 0)
            io.bin(C.PRED_MODE(0), 0)
    if (st.sps.ibc_enabled and st.refs is None and square):
        bv = _code_ibc_flag_bv(io, st, x, y, s)
        if bv is not None:
            _code_ibc_leaf(io, st, x, y, s, bv[0], bv[1])
            return
    if (st.sps.plt_enabled and st.refs is None and square):
        if _code_plt_flag(io, st, x, y, s):
            _code_plt_leaf(io, st, x, y, s)
            return
    mode = _code_intra_mode(io, st, x, y, s, hh)
    trace.t_leaf_intra(x, y, s, mode)
    if io.decoding:
        st.dec.modes8[y // 8:(y + hh) // 8, x // 8:(x + s) // 8] = mode
    mrl = (int(st.dec.mrl8[y // 8, x // 8])
           if st.sps.mrl_enabled and square and mode < rom.NUM_LUMA_MODE
           else 0)
    if io.decoding and mode < rom.NUM_LUMA_MODE:
        st.dec.mrl8[y // 8:(y + hh) // 8, x // 8:(x + s) // 8] = mrl
    isp = (int(st.dec.isp8[y // 8, x // 8])
           if st.sps.isp_enabled and square
           and mode < rom.NUM_LUMA_MODE and mrl == 0 else 0)
    if isp:
        _code_isp_luma(io, st, x, y, s, mode, isp)
    else:
        _code_component(io, st, 0, x, y, s, hh, mode, C.CBF_LUMA(0),
                        mts_ok=(mode < rom.NUM_LUMA_MODE and square),
                        mrl=mrl)
    st.mode_map[y // 4:(y + hh) // 4, x // 4:(x + s) // 4] = mode
    # chroma (4:2:0): derived DM mode (planar for MIP), or CCLM; CRS
    # (LMCS chroma residual scaling) from the reconstructed mapped luma
    dm = mode if mode < rom.NUM_LUMA_MODE else rom.PLANAR_IDX
    cs, ch, cx, cy = s // 2, hh // 2, x // 2, y // 2
    crs_sc = _crs_scale(st, x, y, s, hh)
    if not ((st.sps.cclm_enabled or st.sps.jccr_enabled) and square):
        _code_component(io, st, 1, cx, cy, cs, ch, dm, C.CBF_CB(0),
                        crs_sc=crs_sc)
        _code_component(io, st, 2, cx, cy, cs, ch, dm, C.CBF_CR(0),
                        crs_sc=crs_sc)
        return
    bd = st.sps.bit_depth
    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]

    def chroma_pred(comp, use_cclm):
        if use_cclm:
            return intra.cclm_predict(st.recon[0], st.recon[comp],
                                      st.valid[comp], cx, cy, cs, bd)
        top, left = intra.build_references(st.recon[comp], st.valid[comp],
                                           cx, cy, cs, cs, bd)
        return intra.predict(top, left, dm, cs, cs, True, bd)

    if io.decoding:
        use_cclm = 0
        if st.sps.cclm_enabled:
            use_cclm = 1 - io.bin(C.INTRA_CHROMA_DM(0))
            st.dec.cmode8[sl8] = use_cclm
        joint = 0
        if st.sps.jccr_enabled:
            joint = io.bin(C.JCCR_FLAG(0))
            st.dec.jccr8[sl8] = joint
        if joint:
            _code_joint_chroma(io, st, cx, cy, cs,
                               (chroma_pred(1, use_cclm),
                                chroma_pred(2, use_cclm)), crs_sc=crs_sc)
            return
        _code_component(io, st, 1, cx, cy, cs, cs, dm, C.CBF_CB(0),
                        pred=chroma_pred(1, use_cclm), crs_sc=crs_sc)
        _code_component(io, st, 2, cx, cy, cs, cs, dm, C.CBF_CR(0),
                        pred=chroma_pred(2, use_cclm), crs_sc=crs_sc)
        return
    # encoder: joint (DM vs CCLM) x (separate vs JCCR) integer RD
    lam = transform.lambda_rd_int(st.qp)
    cclm_opts = (0, 1) if st.sps.cclm_enabled else (0,)
    joint_opts = (0, 1) if st.sps.jccr_enabled else (0,)
    cands = []
    for use_cclm in cclm_opts:
        preds = [chroma_pred(1, use_cclm), chroma_pred(2, use_cclm)]
        resis = [(st.src[c][cy:cy + cs, cx:cx + cs].astype(np.int32)
                  - preds[c - 1]) for c in (1, 2)]
        if crs_sc is not None:
            from . import lmcs as lmcsmod
            resis = [lmcsmod.crs_fwd(r, crs_sc) for r in resis]
        from ..cabac import estimate as _est
        _btx = _est.tx_bits(st.qp)
        for joint in joint_opts:
            if joint:
                # JCCR (mode-2 analog, CSign = -1): code one TB C with
                # resCb = C, resCr = -C (VTM:CommonLib/TrQuant.cpp
                # xGetJointResidual); C derived as (resCb - resCr) >> 1
                rj = (resis[0] - resis[1]) >> 1
                coef = transform.forward_transform(rj, bit_depth=bd)
                lev = transform.quantize(coef, st.qp, intra=True,
                                         bit_depth=bd, rdoq=st.rdoq,
                                         lam_rd=lam, dq=st.dq)
                rec = transform.inverse_transform(
                    transform.dequantize(lev, st.qp, bd, dq=st.dq),
                    bit_depth=bd)
                # per-pixel diff capped at 2047: keeps the device twin's
                # int32 cost exact (chroma TBs <= 16x16)
                d0 = np.minimum(np.abs(resis[0].astype(np.int64) - rec),
                                2047)
                d1 = np.minimum(np.abs(resis[1].astype(np.int64) + rec),
                                2047)
                dist = int((d0 * d0).sum() + (d1 * d1).sum())
                cost = transform._rd_cost(
                    dist, transform.level_rate_fp(lev, _btx.lvl_w), lam)
                cands.append((cost, use_cclm, 1, preds, [lev]))
            else:
                levs, cost = [], 0
                for c in (1, 2):
                    coef = transform.forward_transform(resis[c - 1],
                                                       bit_depth=bd)
                    lev = transform.quantize(coef, st.qp, intra=True,
                                             bit_depth=bd, rdoq=st.rdoq,
                                             lam_rd=lam, dq=st.dq)
                    rec = transform.inverse_transform(
                        transform.dequantize(lev, st.qp, bd, dq=st.dq),
                        bit_depth=bd)
                    dd = np.minimum(
                        np.abs(resis[c - 1].astype(np.int64) - rec), 2047)
                    dist = int((dd * dd).sum())
                    cost += transform._rd_cost(
                        dist, transform.level_rate_fp(lev, _btx.lvl_w), lam)
                    levs.append(lev)
                cands.append((cost, use_cclm, 0, preds, levs))
    best = cands[0]
    for cnd in cands[1:]:
        if cnd[0] < best[0]:
            best = cnd
    _, use_cclm, joint, preds, levs = best
    st.dec.cmode8[sl8] = use_cclm
    st.dec.jccr8[sl8] = joint
    if st.sps.cclm_enabled:
        io.bin(C.INTRA_CHROMA_DM(0), int(use_cclm == 0))
    if st.sps.jccr_enabled:
        io.bin(C.JCCR_FLAG(0), joint)
    if joint:
        _code_joint_chroma(io, st, cx, cy, cs, preds, lev=levs[0],
                           crs_sc=crs_sc)
        return
    _code_component(io, st, 1, cx, cy, cs, cs, dm, C.CBF_CB(0),
                    pred=preds[0], lev_pre=levs[0], crs_sc=crs_sc)
    _code_component(io, st, 2, cx, cy, cs, cs, dm, C.CBF_CR(0),
                    pred=preds[1], lev_pre=levs[1], crs_sc=crs_sc)


def _code_joint_chroma(io, st: _FrameState, cx: int, cy: int, cs: int,
                       preds, lev=None, crs_sc=None) -> None:
    """One joint Cb-Cr TB: cbf (CBF_CB ctx) + residual; recon
    Cb = pred + r, Cr = pred - r (CSign = -1); CRS-scaled when LMCS."""
    bd = st.sps.bit_depth
    mx = (1 << bd) - 1
    if io.decoding:
        cbf = io.bin(C.CBF_CB(0))
        lev = code_tb(io, None, _log2(cs), _log2(cs), True) if cbf \
            else np.zeros((cs, cs), np.int32)
    else:
        cbf = int(lev.any())
        io.bin(C.CBF_CB(0), cbf)
        if cbf:
            code_tb(io, lev, _log2(cs), _log2(cs), True)
    trace.t_cbf(1, cx, cy, cs, cbf)
    trace.t_cbf(2, cx, cy, cs, 0)
    if cbf:
        resi = transform.inverse_transform(
            transform.dequantize(lev, st.qp, bd, dq=st.dq), bit_depth=bd)
        if crs_sc is not None:
            from . import lmcs as lmcsmod
            resi = lmcsmod.crs_inv(resi, crs_sc)
    else:
        resi = 0
    st.recon[1][cy:cy + cs, cx:cx + cs] = np.clip(preds[0] + resi, 0, mx)
    st.recon[2][cy:cy + cs, cx:cx + cs] = np.clip(preds[1] - resi, 0, mx)
    st.valid[1][cy:cy + cs, cx:cx + cs] = True
    st.valid[2][cy:cy + cs, cx:cx + cs] = True


def _code_qt(io, st: _FrameState, x: int, y: int, s: int, depth: int) -> None:
    if s > MIN_LEAF:
        ctx = C.SPLIT_QT_FLAG(min(2, depth - 1))
        if io.decoding:
            split = io.bin(ctx)
            tgt = st.dec.split32 if s == 32 else st.dec.split16
            tgt[y // s, x // s] = split
        else:
            src_arr = st.dec.split32 if s == 32 else st.dec.split16
            split = int(src_arr[y // s, x // s])
            io.bin(ctx, split)
        trace.t_split(x, y, s, split)
        if split:
            half = s // 2
            for dy in (0, half):
                for dx in (0, half):
                    _code_qt(io, st, x + dx, y + dy, half, depth + 1)
            return
        if st.sps.mtt_enabled:
            # MTT split of a non-QT-split node: bt_flag (ctx by size) +
            # direction bin + (s == 32, tt enabled) ternary bin; children
            # are two s x s/2 halves (binary) or s/4, s/2, s/4 stripes
            # (ternary) — role of the VVC QTBT+TT multi-type tree,
            # VTM:CommonLib/UnitPartitioner.cpp (mtt_split_cu_flag,
            # mtt_split_cu_vertical_flag, mtt_split_cu_binary_flag)
            barr = st.dec.bt32 if s == 32 else st.dec.bt16
            tt_ok = st.sps.tt_enabled and s == 32
            if io.decoding:
                bt = 0
                fctx = C.BT_FLAG(0 if s == 16 else 1)
                if io.bin(fctx):
                    bt = 1 + io.bin(C.BT_DIR(0))
                    if tt_ok and io.bin(C.TT_FLAG(0)):
                        bt += 2          # 3 = TT-H, 4 = TT-V
                barr[y // s, x // s] = bt
            else:
                bt = int(barr[y // s, x // s])
                fctx = C.BT_FLAG(0 if s == 16 else 1)
                io.bin(fctx, int(bt > 0))
                if bt:
                    io.bin(C.BT_DIR(0), (bt - 1) & 1)
                    if tt_ok:
                        io.bin(C.TT_FLAG(0), int(bt > 2))
            trace.t_split(x, y, s, 4 + bt)
            if bt == 1:      # horizontal halves (w = s, h = s/2)
                _code_leaf(io, st, x, y, s, h=s // 2)
                _code_leaf(io, st, x, y + s // 2, s, h=s // 2)
                return
            if bt == 2:      # vertical halves (w = s/2, h = s)
                _code_leaf(io, st, x, y, s // 2, h=s)
                _code_leaf(io, st, x + s // 2, y, s // 2, h=s)
                return
            if bt == 3:      # ternary horizontal stripes (s/4, s/2, s/4)
                q = s // 4
                _code_leaf(io, st, x, y, s, h=q)
                _code_leaf(io, st, x, y + q, s, h=s // 2)
                _code_leaf(io, st, x, y + s - q, s, h=q)
                return
            if bt == 4:      # ternary vertical stripes
                q = s // 4
                _code_leaf(io, st, x, y, q, h=s)
                _code_leaf(io, st, x + q, y, s // 2, h=s)
                _code_leaf(io, st, x + s - q, y, q, h=s)
                return
    _code_leaf(io, st, x, y, s)


def ctu_block_order(ctu: int):
    """(dx, dy) of the implicit-split MID_SIZE blocks inside a CTU, in
    z-order (QT recursion order; VVC coding_tree order).  For the 64 CTU
    this equals the 2x2 raster; the 128 CTU (r5 ``--ctu 128``) interleaves
    its four 64-quads z-first."""
    n = ctu // MID_SIZE
    out = []
    for m in range(n * n):
        gx = gy = 0
        for b in range((n - 1).bit_length()):
            gx |= ((m >> (2 * b)) & 1) << b
            gy |= ((m >> (2 * b + 1)) & 1) << b
        out.append((gx * MID_SIZE, gy * MID_SIZE))
    return tuple(out)


def _code_ctu(io, st: _FrameState, cx: int, cy: int) -> None:
    ctu = 1 << st.sps.log2_ctu
    for dx, dy in ctu_block_order(ctu):
        _code_qt(io, st, cx + dx, cy + dy, MID_SIZE, 1)


# ---------------------------------------------------------------------------
# frame encode / decode
# ---------------------------------------------------------------------------

def pad_planes(planes: list[np.ndarray], sps: hls.SPS) -> list[np.ndarray]:
    out = []
    for i, p in enumerate(planes):
        tw = sps.width if i == 0 else sps.width // 2
        th = sps.height if i == 0 else sps.height // 2
        ph, pw = p.shape
        out.append(np.pad(p.astype(np.int32),
                          ((0, th - ph), (0, tw - pw)), mode="edge"))
    return out


def crop_planes(planes: list[np.ndarray], sps: hls.SPS) -> list[np.ndarray]:
    l, r, t, b = sps.conf_win
    out = [planes[0][t:sps.height - b, l:sps.width - r]]
    for p in planes[1:]:
        out.append(p[t // 2:(sps.height - b) // 2, l // 2:(sps.width - r) // 2])
    return out


def _filter_src(st: _FrameState):
    """Source planes for SAO/ALF derivation — original (unmapped) domain."""
    if st.src_orig_y is None:
        return st.src
    return [st.src_orig_y, st.src[1], st.src[2]]


def _tile_reset(st: _FrameState) -> None:
    """Prediction break at a tile start: intra availability, MPM map,
    spatial merge/AMVP motion and the HMVP FIFO all reset (VVC tile
    semantics; MC references and TMVP stay frame-wide)."""
    for v in st.valid:
        v[:] = False
    st.mode_map[:] = -1
    if st.inter_map is not None:
        st.inter_map[:] = False
    if st.mv_map is not None:
        st.mv_map[:] = 0
    if st.ibc_map is not None:
        st.ibc_map[:] = False
        st.bv_map[:] = 0
    st.hmvp = []


def _seed_state(slice_type, qp, snap):
    st = C.make_ctx_state(slice_type, qp)
    if snap is not None:
        st.p0[:] = snap[0]
        st.p1[:] = snap[1]
    return st


def bi_sym(sh) -> bool:
    """True when the two references are POC-symmetric around the current
    picture — the condition gating DMVR/BDOF (both engines)."""
    return (len(sh.ref_pocs) == 2
            and sh.ref_pocs[0] < sh.poc < sh.ref_pocs[1]
            and sh.poc - sh.ref_pocs[0] == sh.ref_pocs[1] - sh.poc)


def motion_record(decisions: FrameDecisions, ref_pocs) -> dict:
    """Snapshot of a picture's motion field for the DPB side table (TMVP
    source; role of VTM's per-picture MotionInfo grid)."""
    return dict(inter8=decisions.inter8.copy(),
                dir8=decisions.dir8.copy(),
                mv8=decisions.mv8.copy(),
                mv8_l1=decisions.mv8_l1.copy(),
                ref_pocs=tuple(ref_pocs))


def col_motion(motion: dict | None, poc: int, ref_pocs):
    """Scaled TMVP field for the current picture from the collocated
    reference (ref_pocs[0]); None when unavailable."""
    if not ref_pocs or not motion:
        return None
    rec = motion.get(ref_pocs[0])
    if rec is None:
        return None
    from . import inter as imod
    return imod.build_col_motion(rec["inter8"], rec["dir8"], rec["mv8"],
                                 rec["mv8_l1"], ref_pocs[0],
                                 rec["ref_pocs"], poc, ref_pocs)


def encode_frame(src_planes: list[np.ndarray], sps: hls.SPS, pps: hls.PPS,
                 sh: hls.SliceHeader, decisions: FrameDecisions, refs=None,
                 col=None, rdoq: bool = False):
    """Returns (slice_rbsp, recon_planes [padded]).  refs: previous filtered
    recon [Y, Cb, Cr] (padded frame size) for P slices; col: scaled TMVP
    field (col_motion); rdoq: encoder RDOQ quantizer."""
    qp = pps.init_qp + sh.qp_delta
    trace.set_poc(sh.poc)
    st = _FrameState.make(sps, qp, True, decisions,
                          pad_planes(src_planes, sps), refs, col, rdoq)
    st.dmvr = sps.dmvr_enabled and bi_sym(sh)
    st.bdof = sps.bdof_enabled and bi_sym(sh)
    st.smvd = sps.smvd_enabled and bi_sym(sh)
    st.dq = sps.dq_enabled
    if sh.lmcs_cw:
        from . import lmcs as lmcsmod
        st.lmcs = lmcsmod.build_luts(sh.lmcs_cw, sps.bit_depth)
        st.crs = lmcsmod.build_crs_lut(sh.lmcs_cw, sps.bit_depth)
        st.src_orig_y = st.src[0]
        st.src = [st.lmcs[0][st.src[0]], st.src[1], st.src[2]]
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    wpp = pps.entropy_sync and n_y > 1
    n_tiles = pps.num_tile_cols * pps.num_tile_rows
    if n_tiles > 1 and wpp:
        raise ValueError("tiles + WPP combination not supported")
    if n_tiles > 1 and sps.ibc_enabled:
        raise ValueError("tiles + IBC combination not supported "
                         "(IBC reference area is not tile-constrained)")

    if n_tiles > 1:
        # tiles: independent CABAC + prediction per tile, entry points in
        # the slice payload (SURVEY.md §2.10 "Tiles" axis)
        payloads = []
        recon = None
        rects = hls.tile_grid(n_x, n_y, pps.num_tile_cols,
                              pps.num_tile_rows)
        for ti, (cx0, cy0, cx1, cy1) in enumerate(rects):
            enc = CabacEncoder(C.make_ctx_state(sh.slice_type, qp))
            io = EncIO(enc)
            _tile_reset(st)
            for iy in range(cy0, cy1):
                st.hmvp = []
                for ix in range(cx0, cx1):
                    _code_ctu(io, st, ix * ctu, iy * ctu)
                    enc.terminate(0)
            if ti == len(rects) - 1:
                recon = st.recon
                if st.lmcs is not None:
                    recon[0] = st.lmcs[1][recon[0]]
                if sps.deblock_enabled:
                    from . import deblock
                    recon = deblock.deblock_frame(recon, decisions, qp,
                                                  sps.bit_depth)
                if sps.sao_enabled:
                    from . import sao
                    params = sao.decide_sao(_filter_src(st), recon, qp,
                                            ctu, sps.bit_depth)
                    sao.code_sao_params(io, params, n_y, n_x)
                    recon = sao.apply_sao(recon, params, ctu,
                                          sps.bit_depth)
                if sps.alf_enabled:
                    from . import alf
                    ap = alf.derive_alf_frame(_filter_src(st), recon, qp,
                                              ctu, sps.bit_depth)
                    alf.code_alf_params(io, ap, n_y, n_x)
                    recon = alf.apply_alf_frame(recon, ap, ctu,
                                                sps.bit_depth)
            enc.terminate(1)
            payloads.append(enc.finish())
        w = sh.write()
        ep = bs.BitWriter()
        ep.ue(len(payloads))
        for pl in payloads[:-1]:
            ep.ue(len(pl))
        ep.byte_align()
        w.write_bytes(ep.getvalue())
        for pl in payloads:
            w.write_bytes(pl)
        w.write_bytes(b"\x80")   # rbsp_slice_trailing_bits
        return w.getvalue(), recon

    if not wpp:
        enc = CabacEncoder(C.make_ctx_state(sh.slice_type, qp))
        io = EncIO(enc)
        for iy in range(n_y):
            st.hmvp = []
            for ix in range(n_x):
                _code_ctu(io, st, ix * ctu, iy * ctu)
                enc.terminate(0)
        recon = st.recon
        if st.lmcs is not None:
            recon[0] = st.lmcs[1][recon[0]]
        if sps.deblock_enabled:
            from . import deblock
            recon = deblock.deblock_frame(recon, decisions, qp,
                                          sps.bit_depth)
        if sps.sao_enabled:
            from . import sao
            params = sao.decide_sao(_filter_src(st), recon, qp, ctu,
                                    sps.bit_depth)
            sao.code_sao_params(io, params, n_y, n_x)
            recon = sao.apply_sao(recon, params, ctu, sps.bit_depth)
        if sps.alf_enabled:
            from . import alf
            ap = alf.derive_alf_frame(_filter_src(st), recon, qp, ctu,
                                      sps.bit_depth)
            alf.code_alf_params(io, ap, n_y, n_x)
            recon = alf.apply_alf_frame(recon, ap, ctu, sps.bit_depth)
        enc.terminate(1)
        w = sh.write()
        w.write_bytes(enc.finish())
        # rbsp_slice_trailing_bits: a stop byte so the payload never ends
        # 0x00 (Annex-B reserialization safety; readers ignore it)
        w.write_bytes(b"\x80")
        return w.getvalue(), recon

    # WPP: one CABAC lane per CTU row, context inherited after the first
    # CTU of the row above (SURVEY.md §2.10); reconstruction order is
    # unchanged, only the entropy lanes restart.
    payloads = []
    snap = None
    recon = None
    for iy in range(n_y):
        enc = CabacEncoder(_seed_state(sh.slice_type, qp, snap))
        io = EncIO(enc)
        st.hmvp = []
        for ix in range(n_x):
            _code_ctu(io, st, ix * ctu, iy * ctu)
            if ix == 0:
                snap = (enc.ctx.p0.copy(), enc.ctx.p1.copy())
        if iy == n_y - 1:
            recon = st.recon
            if st.lmcs is not None:
                recon[0] = st.lmcs[1][recon[0]]
            if sps.deblock_enabled:
                from . import deblock
                recon = deblock.deblock_frame(recon, decisions, qp,
                                              sps.bit_depth)
            if sps.sao_enabled:
                from . import sao
                params = sao.decide_sao(_filter_src(st), recon, qp, ctu,
                                        sps.bit_depth)
                sao.code_sao_params(io, params, n_y, n_x)
                recon = sao.apply_sao(recon, params, ctu, sps.bit_depth)
            if sps.alf_enabled:
                from . import alf
                ap = alf.derive_alf_frame(_filter_src(st), recon, qp, ctu,
                                          sps.bit_depth)
                alf.code_alf_params(io, ap, n_y, n_x)
                recon = alf.apply_alf_frame(recon, ap, ctu, sps.bit_depth)
        enc.terminate(1)
        payloads.append(enc.finish())
    w = sh.write()
    ep = bs.BitWriter()
    ep.ue(n_y)
    for pl in payloads[:-1]:
        ep.ue(len(pl))
    ep.byte_align()
    w.write_bytes(ep.getvalue())
    for pl in payloads:
        w.write_bytes(pl)
    w.write_bytes(b"\x80")   # rbsp_slice_trailing_bits (see non-WPP path)
    return w.getvalue(), recon


class StatsIO:
    """Bit-accounting io wrapper (role of VTM:App/DecoderAnalyserApp +
    CommonLib/CodingStatistics): tallies regular bins per syntax class and
    bypass bins into a shared dict, then delegates."""

    def __init__(self, io, stats: dict):
        self._io = io
        self.decoding = io.decoding
        self._st = stats

    def bin(self, ctx, v=None):
        n = C.name_of(ctx)
        self._st[n] = self._st.get(n, 0) + 1
        return self._io.bin(ctx, v)

    def byp(self, v=None):
        self._st["(bypass)"] = self._st.get("(bypass)", 0) + 1
        return self._io.byp(v)

    def byp_n(self, v=None, n=0):
        self._st["(bypass)"] = self._st.get("(bypass)", 0) + n
        return self._io.byp_n(v, n)


def decode_frame(slice_rbsp: bytes, sps: hls.SPS, pps_map: dict[int, hls.PPS],
                 dpb=None, motion=None, stats=None):
    """Returns (recon_planes [padded], SliceHeader, FrameDecisions).
    dpb: {poc: filtered recon planes} for resolving sh.ref_pocs;
    motion: {poc: motion_record} side table for TMVP;
    stats: optional dict tallying bins per syntax class (StatsIO)."""
    r = bs.BitReader(slice_rbsp)
    sh = hls.SliceHeader.read(r)
    pps = pps_map[sh.pps_id]
    qp = pps.init_qp + sh.qp_delta
    trace.set_poc(sh.poc)
    decisions = FrameDecisions.empty(sps.height, sps.width)
    refs = None
    col = None
    if sh.slice_type != hls.SLICE_I:
        refs = [dpb[rp] for rp in sh.ref_pocs]
        col = col_motion(motion, sh.poc, sh.ref_pocs)
    st = _FrameState.make(sps, qp, False, decisions, None, refs, col)
    st.dmvr = sps.dmvr_enabled and bi_sym(sh)
    st.bdof = sps.bdof_enabled and bi_sym(sh)
    st.smvd = sps.smvd_enabled and bi_sym(sh)
    st.dq = sps.dq_enabled
    if sh.lmcs_cw:
        from . import lmcs as lmcsmod
        st.lmcs = lmcsmod.build_luts(sh.lmcs_cw, sps.bit_depth)
        st.crs = lmcsmod.build_crs_lut(sh.lmcs_cw, sps.bit_depth)
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    wpp = pps.entropy_sync and n_y > 1
    n_tiles = pps.num_tile_cols * pps.num_tile_rows
    if n_tiles > 1:
        rects = hls.tile_grid(n_x, n_y, pps.num_tile_cols,
                              pps.num_tile_rows)
        n_sub = r.ue()
        if n_sub != len(rects):
            raise ValueError("tile entry-point count mismatch")
        lens = [r.ue() for _ in range(n_sub - 1)]
        r.byte_align()
        rest = r.remaining_bytes()
        offs = [0]
        for ln in lens:
            offs.append(offs[-1] + ln)
        subs_b = [rest[offs[i]:offs[i + 1]] if i + 1 < len(offs)
                  else rest[offs[i]:] for i in range(n_sub)]
        sao_params_parsed = None
        alf_params_parsed = None
        for ti, (cx0, cy0, cx1, cy1) in enumerate(rects):
            dec_c = CabacDecoder(C.make_ctx_state(sh.slice_type, qp),
                                 subs_b[ti])
            io = DecIO(dec_c) if stats is None \
                else StatsIO(DecIO(dec_c), stats)
            _tile_reset(st)
            for iy in range(cy0, cy1):
                st.hmvp = []
                for ix in range(cx0, cx1):
                    _code_ctu(io, st, ix * ctu, iy * ctu)
                    if dec_c.terminate() != 0:
                        raise ValueError("tile substream desync")
            if ti == len(rects) - 1:
                if sps.sao_enabled:
                    from . import sao
                    sao_params_parsed = sao.code_sao_params(io, None, n_y,
                                                            n_x)
                if sps.alf_enabled:
                    from . import alf
                    alf_params_parsed = alf.code_alf_params(io, None, n_y,
                                                            n_x)
            if dec_c.terminate() != 1:
                raise ValueError("missing end_of_tile")
        recon = st.recon
        if st.lmcs is not None:
            recon[0] = st.lmcs[1][recon[0]]
        if sps.deblock_enabled:
            from . import deblock
            recon = deblock.deblock_frame(recon, decisions, qp,
                                          sps.bit_depth)
        if sao_params_parsed is not None:
            from . import sao
            recon = sao.apply_sao(recon, sao_params_parsed, ctu,
                                  sps.bit_depth)
        if alf_params_parsed is not None:
            from . import alf
            recon = alf.apply_alf_frame(recon, alf_params_parsed, ctu,
                                        sps.bit_depth)
        return recon, sh, decisions
    if wpp:
        n_rows = r.ue()
        if n_rows != n_y:
            raise ValueError("entry-point count mismatch")
        lens = [r.ue() for _ in range(n_rows - 1)]
        r.byte_align()
        rest = r.remaining_bytes()
        offs = [0]
        for ln in lens:
            offs.append(offs[-1] + ln)
        subs = [rest[offs[i]:offs[i + 1]] if i + 1 < len(offs)
                else rest[offs[i]:] for i in range(n_rows)]
        snap = None
        sao_params_parsed = None
        alf_params_parsed = None
        for iy in range(n_y):
            dec = CabacDecoder(_seed_state(sh.slice_type, qp, snap),
                               subs[iy])
            io = DecIO(dec) if stats is None else StatsIO(DecIO(dec), stats)
            st.hmvp = []
            for ix in range(n_x):
                _code_ctu(io, st, ix * ctu, iy * ctu)
                if ix == 0:
                    snap = (dec.ctx.p0.copy(), dec.ctx.p1.copy())
            if iy == n_y - 1 and sps.sao_enabled:
                from . import sao
                sao_params_parsed = sao.code_sao_params(io, None, n_y, n_x)
            if iy == n_y - 1 and sps.alf_enabled:
                from . import alf
                alf_params_parsed = alf.code_alf_params(io, None, n_y, n_x)
            if dec.terminate() != 1:
                raise ValueError("missing end_of_substream")
        recon = st.recon
        if st.lmcs is not None:
            recon[0] = st.lmcs[1][recon[0]]
        if sps.deblock_enabled:
            from . import deblock
            recon = deblock.deblock_frame(recon, decisions, qp,
                                          sps.bit_depth)
        if sao_params_parsed is not None:
            from . import sao
            recon = sao.apply_sao(recon, sao_params_parsed, ctu,
                                  sps.bit_depth)
        if sps.alf_enabled:
            from . import alf
            recon = alf.apply_alf_frame(recon, alf_params_parsed, ctu,
                                        sps.bit_depth)
        return recon, sh, decisions
    dec = CabacDecoder(C.make_ctx_state(sh.slice_type, qp),
                       r.remaining_bytes())
    io = DecIO(dec) if stats is None else StatsIO(DecIO(dec), stats)
    for iy in range(n_y):
        st.hmvp = []
        for ix in range(n_x):
            _code_ctu(io, st, ix * ctu, iy * ctu)
            if dec.terminate() != 0:
                raise ValueError("unexpected end_of_slice")
    recon = st.recon
    if st.lmcs is not None:
        recon[0] = st.lmcs[1][recon[0]]
    if sps.deblock_enabled:
        from . import deblock
        recon = deblock.deblock_frame(recon, decisions, qp, sps.bit_depth)
    if sps.sao_enabled:
        from . import sao
        params = sao.code_sao_params(io, None, n_y, n_x)
        recon = sao.apply_sao(recon, params, ctu, sps.bit_depth)
    if sps.alf_enabled:
        from . import alf
        ap = alf.code_alf_params(io, None, n_y, n_x)
        recon = alf.apply_alf_frame(recon, ap, ctu, sps.bit_depth)
    if dec.terminate() != 1:
        raise ValueError("missing end_of_slice")
    return recon, sh, decisions
