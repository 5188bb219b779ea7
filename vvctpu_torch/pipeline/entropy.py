"""Host entropy stage for the JAX pipeline: syntax <-> (decisions, levels).

The device scan (pipeline/recon.py) produces/consumes dense level planes;
this module walks the identical coding-tree order and codes the identical
syntax as the spec model's fused traversal (spec/codec.py), but with no pixel
math — levels are read from (encode) or written to (decode) the planes.
Bitstream equality with the spec encoder is enforced by
tests/test_pipeline_parity.py.

This split is the SURVEY.md §7.3.1 architecture: device produces decision/
level tensors, the bin packing runs host-side (vectorized lanes / native
packer are the upgrade path).
"""
from __future__ import annotations

import numpy as np

from ..cabac import binarize
from ..cabac import contexts as C
from ..cabac.engine import CabacDecoder, CabacEncoder
from ..core import bitstream as bs
from ..core import rom
from ..core import trace
from ..spec import hls, intra
from ..spec.codec import MID_SIZE, MIN_LEAF, FrameDecisions, ctu_block_order
from ..spec.residual import DecIO, EncIO, code_tb


from ..spec.codec import _code_lfnst_idx, _code_mts_idx
from ..cabac import native as cnative
def _log2(n: int) -> int:
    return int(n).bit_length() - 1


class RecordIO:
    """EncIO-compatible adapter that records bins into a BinSink instead of
    driving the arithmetic coder — the packer replays them afterwards."""
    decoding = False

    def __init__(self, sink):
        self.sink = sink

    def bin(self, ctx, v):
        self.sink.ctx(ctx, int(v))
        return v

    def byp(self, v):
        self.sink.byp(int(v))
        return v

    def byp_n(self, v, n):
        self.sink.byp_bits(int(v), n)
        return v


class _Walker:
    def __init__(self, sps: hls.SPS, dec: FrameDecisions, levels, io,
                 sink=None, is_p: bool = False, is_b: bool = False,
                 col=None, sym: bool = False):
        self.sps = sps
        self.dec = dec
        self.levels = levels      # [ly, lcb, lcr] numpy planes
        self.io = io
        self.sink = sink          # encode fast path: vectorised binarise
        self.is_p = is_p          # any inter slice (P or B)
        self.is_b = is_b
        self.smvd = sps.smvd_enabled and sym
        self.col = col            # scaled TMVP field (codec.col_motion)
        self.hmvp = []            # history merge FIFO (reset per CTU row)
        self.mode_map = np.full((sps.height // 4, sps.width // 4), -1,
                                np.int32)
        self.inter_map = np.zeros((sps.height // 8, sps.width // 8, 2),
                                  bool)
        self.mv_map = np.zeros((sps.height // 8, sps.width // 8, 2, 2),
                               np.int32)
        self.ibc_map = np.zeros((sps.height // 8, sps.width // 8), bool)
        self.bv_map = np.zeros((sps.height // 8, sps.width // 8, 2),
                               np.int32)

    # -- intra mode (identical scheme to spec/codec._code_intra_mode) -----
    def _neighbor_mode(self, x, y):
        if x < 0 or y < 0:
            return rom.PLANAR_IDX
        m = int(self.mode_map[y // 4, x // 4])
        if m >= rom.NUM_LUMA_MODE:   # MIP neighbours count as planar (MPM)
            return rom.PLANAR_IDX
        return m if m >= 0 else rom.PLANAR_IDX

    def _code_mode(self, x, y, s, h=None):
        io = self.io
        hh = s if h is None else h
        square = hh == s
        if self.sps.mip_enabled and square:
            from ..spec.codec import code_mip_mode
            mode = code_mip_mode(io, self, x, y, s,
                                 None if io.decoding
                                 else int(self.dec.modes8[y // 8, x // 8]))
            if mode is not None:
                if io.decoding:
                    self.dec.modes8[y // 8:(y + s) // 8,
                                    x // 8:(x + s) // 8] = mode
                self.mode_map[y // 4:(y + s) // 4,
                              x // 4:(x + s) // 4] = mode
                return mode
        if self.sps.mrl_enabled and square:
            from ..spec.codec import code_mrl_idx
            code_mrl_idx(io, self, x, y,
                         None if io.decoding
                         else int(self.dec.mrl8[y // 8, x // 8]))
        if square:
            from ..spec.codec import code_isp_flags
            code_isp_flags(io, self.dec, self.sps, x, y, s)
        mpm = intra.mpm_list(self._neighbor_mode(x - 1, y + hh - 1),
                             self._neighbor_mode(x + s - 1, y - 1))
        if io.decoding:
            if io.bin(C.INTRA_MPM_FLAG(0)):
                if io.bin(C.INTRA_PLANAR_FLAG(0)):
                    mode = rom.PLANAR_IDX
                else:
                    idx = 1
                    while idx < rom.NUM_MPM - 1 and io.byp():
                        idx += 1
                    mode = mpm[idx]
            else:
                rest = sorted(m for m in range(rom.NUM_LUMA_MODE)
                              if m not in mpm)
                nb = len(rest).bit_length() - 1
                u = (1 << (nb + 1)) - len(rest)
                v = io.byp_n(n=nb)
                idx = v if v < u else ((v << 1) | io.byp()) - u
                mode = rest[idx]
            self.dec.modes8[y // 8:(y + hh) // 8,
                            x // 8:(x + s) // 8] = mode
        else:
            mode = int(self.dec.modes8[y // 8, x // 8])
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
                rest = sorted(m for m in range(rom.NUM_LUMA_MODE)
                              if m not in mpm)
                nb = len(rest).bit_length() - 1
                u = (1 << (nb + 1)) - len(rest)
                idx = rest.index(mode)
                if idx < u:
                    io.byp_n(idx, nb)
                else:
                    io.byp_n(idx + u, nb + 1)
        self.mode_map[y // 4:(y + hh) // 4, x // 4:(x + s) // 4] = mode
        return mode

    # -- residual per component ------------------------------------------
    def _code_component(self, comp, x, y, s, cbf_ctx, mts_ok=False,
                        h=None):
        io = self.io
        hh = s if h is None else h
        plane = self.levels[comp]
        is_chroma = comp > 0
        mts_on = mts_ok and (self.sps.mts_enabled or self.sps.ts_enabled)
        lfnst_on = mts_ok and self.sps.lfnst_enabled
        sl8 = np.s_[y // 8:(y + hh) // 8, x // 8:(x + s) // 8]
        if io.decoding:
            cbf = io.bin(cbf_ctx)
            midx = 0
            if cbf and mts_on:
                midx = _code_mts_idx(io, None)
                self.dec.mts8[sl8] = midx
            if cbf and lfnst_on and midx == 0:
                self.dec.lfnst8[sl8] = _code_lfnst_idx(io)
            if cbf:
                if isinstance(io.c, cnative.NativeDecoder):
                    lev = cnative.native_parse_tb(io.c, _log2(s), _log2(hh),
                                                  is_chroma)
                else:
                    lev = code_tb(io, None, _log2(s), _log2(hh), is_chroma)
                plane[y:y + hh, x:x + s] = lev
            trace.t_cbf(comp, x, y, s, cbf)
        else:
            lev = plane[y:y + hh, x:x + s]
            cbf = int(lev.any())
            io.bin(cbf_ctx, cbf)
            midx = int(self.dec.mts8[y // 8, x // 8]) if mts_on else 0
            if cbf and mts_on:
                _code_mts_idx(io, midx)
            if cbf and lfnst_on and midx == 0:
                _code_lfnst_idx(io, int(self.dec.lfnst8[y // 8, x // 8]))
            trace.t_cbf(comp, x, y, s, cbf)
            if cbf:
                if self.sink is not None:
                    if cnative.available():
                        self.sink._chunks.append(
                            cnative.tb_bins_c(lev, _log2(s), _log2(hh),
                                              is_chroma))
                    else:
                        binarize.tb_bins(self.sink, lev, _log2(s),
                                         _log2(hh), is_chroma)
                else:
                    code_tb(io, lev, _log2(s), _log2(hh), is_chroma)

    def _code_isp_component(self, x, y, s, d):
        """ISP luma stripes: per-stripe cbf (CBF_LUMA ctx 1) + rect TB,
        levels at their natural positions in the luma plane (twin of spec
        _code_isp_luma syntax)."""
        from ..spec.codec import isp_parts
        io = self.io
        plane = self.levels[0]
        for (dx, dy, w_st, h_st) in isp_parts(s, d):
            px, py = x + dx, y + dy
            if io.decoding:
                cbf = io.bin(C.CBF_LUMA(1))
                if cbf:
                    if isinstance(io.c, cnative.NativeDecoder):
                        lev = cnative.native_parse_tb(io.c, _log2(w_st),
                                                      _log2(h_st), False)
                    else:
                        lev = code_tb(io, None, _log2(w_st), _log2(h_st),
                                      False)
                    plane[py:py + h_st, px:px + w_st] = lev
            else:
                lev = plane[py:py + h_st, px:px + w_st]
                cbf = int(lev.any())
                io.bin(C.CBF_LUMA(1), cbf)
                if cbf:
                    if self.sink is not None:
                        if cnative.available():
                            self.sink._chunks.append(
                                cnative.tb_bins_c(lev, _log2(w_st),
                                                  _log2(h_st), False))
                        else:
                            binarize.tb_bins(self.sink, lev, _log2(w_st),
                                             _log2(h_st), False)
                    else:
                        code_tb(io, lev, _log2(w_st), _log2(h_st), False)
            trace.t_cbf(0, px, py, w_st, cbf)

    def _code_mv_list(self, x, y, s, lst, mv_enc=None, shift=2, h=None):
        from ..spec.codec import code_mv_list
        return code_mv_list(self.io, self.mv_map, self.inter_map, x, y, s,
                            lst, mv_enc, shift, h=h)

    def _enc_motion(self, x, y, s, h=None):
        """Encoder-side (d, mv0, mv1, merge_idx) from the decision maps."""
        from ..spec import inter as imod
        hh = s if h is None else h
        square = hh == s
        gy, gx = y // 8, x // 8
        d = int(self.dec.dir8[gy, gx]) if self.is_b else 0
        mv0 = ((int(self.dec.mv8[gy, gx, 0]), int(self.dec.mv8[gy, gx, 1]))
               if d in (0, 2) else (0, 0))
        mv1 = ((int(self.dec.mv8_l1[gy, gx, 0]),
                int(self.dec.mv8_l1[gy, gx, 1]))
               if d in (1, 2) else (0, 0))
        widx = (int(self.dec.bcw8[gy, gx])
                if self.sps.bcw_enabled and d == 2 and square
                else imod.BCW_DEFAULT)
        aff = None
        if (self.sps.affine_enabled and s >= imod.AFF_MIN_SIZE and d != 2
                and square
                and self.dec.aff8 is not None and self.dec.aff8[gy, gx]):
            aff = (int(self.dec.admv8[gy, gx, 0]),
                   int(self.dec.admv8[gy, gx, 1]))
        cands = imod.merge_candidates(self.inter_map, self.mv_map, x, y, s,
                                      self.is_b, self.col, self.hmvp,
                                      h=hh)
        me = (d, mv0, mv1)
        midx = (cands.index(me)
                if me in cands and widx == imod.BCW_DEFAULT
                and aff is None else None)
        mmvd = (imod.mmvd_match(cands, me)
                if midx is None and widx == imod.BCW_DEFAULT
                and aff is None and self.sps.mmvd_enabled else None)
        ciip = (bool(self.dec.ciip8[gy, gx])
                if self.sps.ciip_enabled and square else False)
        gpm = (int(self.dec.gpm8[gy, gx])
               if (self.sps.gpm_enabled and self.is_b and d == 2
                   and not ciip and square) else 0)
        return d, mv0, mv1, midx, mmvd, widx, ciip, gpm, aff

    def _leaf_levels_zero(self, x, y, s, h=None):
        hh = s if h is None else h
        cs, ch, cx, cy = s // 2, (s if h is None else h) // 2, x // 2, y // 2
        return not (self.levels[0][y:y + hh, x:x + s].any()
                    or self.levels[1][cy:cy + ch, cx:cx + cs].any()
                    or self.levels[2][cy:cy + ch, cx:cx + cs].any())

    def _code_inter(self, x, y, s, skip, enc_mot=None, h=None):
        from ..spec import inter as imod
        from ..spec.codec import (_code_bcw_idx, _code_merge_idx,
                                  _code_mmvd, _code_sbt_idx)
        io = self.io
        hh = s if h is None else h
        square = hh == s
        gy, gx = y // 8, x // 8
        aff = None
        if io.decoding:
            widx = imod.BCW_DEFAULT
            ciip = False
            merge = True if skip else bool(io.bin(C.MERGE_FLAG(0)))
            if merge:
                mmvd = _code_mmvd(io) if self.sps.mmvd_enabled else None
                cands = imod.merge_candidates(self.inter_map, self.mv_map,
                                              x, y, s, self.is_b, self.col,
                                              self.hmvp, h=hh)
                if mmvd is not None:
                    d, mv0, mv1 = imod.mmvd_derive(cands[mmvd[0]], mmvd[1],
                                                   mmvd[2])
                else:
                    midx = _code_merge_idx(io)
                    d, mv0, mv1 = cands[midx]
            else:
                from ..spec.codec import _code_mvd_comp, code_amvr
                if self.is_b:
                    bi = io.bin(C.INTER_DIR(0))
                    d = 2 if bi else io.byp()
                else:
                    d = 0
                aff_sig = (self.sps.affine_enabled
                           and s >= imod.AFF_MIN_SIZE and d != 2
                           and square)
                if aff_sig and io.bin(C.AFF_FLAG(0)):
                    acands = imod.affine_merge_cands(
                        self.inter_map, self.mv_map, self.dec.aff8,
                        self.dec.admv8, x, y, s, d)
                    amrg = bool(io.bin(C.AFFM_FLAG(0))) if acands \
                        else False
                    if amrg:
                        ai = io.byp() if len(acands) > 1 else 0
                        bx_, by_, dmx, dmy = acands[ai]
                        mv = (bx_, by_)
                    else:
                        mv = self._code_mv_list(x, y, s, d, shift=2, h=hh)
                        dmx = _code_mvd_comp(io, None) << 2
                        dmy = _code_mvd_comp(io, None) << 2
                    aff = (dmx, dmy)
                    mv0 = mv if d == 0 else (0, 0)
                    mv1 = mv if d == 1 else (0, 0)
                else:
                    shift = imod.AMVR_SHIFTS[code_amvr(io)] \
                        if self.sps.amvr_enabled else 2
                    smvd = bool(io.bin(C.SMVD_FLAG(0))) \
                        if d == 2 and self.smvd and square else False
                    mv0 = mv1 = (0, 0)
                    if smvd:
                        from ..spec.codec import code_mv_smvd
                        mv0, mv1 = code_mv_smvd(io, self.mv_map,
                                                self.inter_map,
                                                x, y, s, shift=shift)
                    else:
                        if d in (0, 2):
                            mv0 = self._code_mv_list(x, y, s, 0,
                                                     shift=shift, h=hh)
                        if d in (1, 2):
                            mv1 = self._code_mv_list(x, y, s, 1,
                                                     shift=shift, h=hh)
                        if d == 1:
                            mv0 = (0, 0)
                    if self.is_b and d == 2 and self.sps.bcw_enabled \
                            and square:
                        widx = _code_bcw_idx(io)
            if self.sps.ciip_enabled and not skip and square:
                ciip = bool(io.bin(C.CIIP_FLAG(0)))
            gpm = 0
            if (self.sps.gpm_enabled and self.is_b and not skip
                    and not ciip and d == 2 and square):
                if io.bin(C.GPM_FLAG(0)):
                    gpm = 1 + io.byp_n(n=6)
            sbt = _code_sbt_idx(io) \
                if self.sps.sbt_enabled and not skip and not ciip \
                and square else 0
            sl = np.s_[gy:(y + hh) // 8, gx:(x + s) // 8]
            self.dec.inter8[sl] = 1
            self.dec.dir8[sl] = d
            self.dec.mv8[sl] = mv0
            self.dec.mv8_l1[sl] = mv1
            self.dec.bcw8[sl] = widx
            self.dec.ciip8[sl] = ciip
            self.dec.sbt8[sl] = sbt
            self.dec.gpm8[sl] = gpm
            self.dec.aff8[sl] = int(aff is not None)
            if aff is not None:
                self.dec.admv8[sl] = aff
        else:
            d, mv0, mv1, midx, mmvd, widx, ciip, gpm, aff = enc_mot
            if skip:
                aff = None
            merged = midx is not None or mmvd is not None

            def code_merge_data():
                if self.sps.mmvd_enabled:
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
                    from ..spec.codec import (_amvr_for_leaf,
                                              _code_mvd_comp, code_mv_smvd)
                    if self.is_b:
                        io.bin(C.INTER_DIR(0), int(d == 2))
                        if d != 2:
                            io.byp(d)
                    aff_sig = (self.sps.affine_enabled
                               and s >= imod.AFF_MIN_SIZE and d != 2
                               and square)
                    if aff_sig:
                        io.bin(C.AFF_FLAG(0), int(aff is not None))
                    if aff is not None:
                        base = mv0 if d == 0 else mv1
                        acands = imod.affine_merge_cands(
                            self.inter_map, self.mv_map, self.dec.aff8,
                            self.dec.admv8, x, y, s, d)
                        tgt = (int(base[0]), int(base[1]), int(aff[0]),
                               int(aff[1]))
                        ai = acands.index(tgt) if tgt in acands else -1
                        if acands:
                            io.bin(C.AFFM_FLAG(0), int(ai >= 0))
                        if ai >= 0:
                            if len(acands) > 1:
                                io.byp(ai)
                        else:
                            self._code_mv_list(x, y, s, d, base, shift=2,
                                               h=hh)
                            _code_mvd_comp(io, aff[0] >> 2)
                            _code_mvd_comp(io, aff[1] >> 2)
                    else:
                        prec = _amvr_for_leaf(io, self.mv_map,
                                              self.inter_map,
                                              x, y, s, d, mv0, mv1,
                                              self.sps.amvr_enabled, h=hh)
                        shift = imod.AMVR_SHIFTS[prec]
                        i1 = imod.smvd_match(self.mv_map, self.inter_map,
                                             x, y, s, mv0, mv1, shift) \
                            if d == 2 and self.smvd and square else None
                        if d == 2 and self.smvd and square:
                            io.bin(C.SMVD_FLAG(0), int(i1 is not None))
                        if i1 is not None:
                            code_mv_smvd(io, self.mv_map, self.inter_map,
                                         x, y, s, mv0, i1, shift=shift)
                        else:
                            if d in (0, 2):
                                self._code_mv_list(x, y, s, 0, mv0,
                                                   shift=shift, h=hh)
                            if d in (1, 2):
                                self._code_mv_list(x, y, s, 1, mv1,
                                                   shift=shift, h=hh)
                        if self.is_b and d == 2 and self.sps.bcw_enabled \
                                and square:
                            _code_bcw_idx(io, widx)
                if self.sps.ciip_enabled and square:
                    io.bin(C.CIIP_FLAG(0), int(ciip))
                if (self.sps.gpm_enabled and self.is_b and not ciip
                        and d == 2 and square):
                    io.bin(C.GPM_FLAG(0), int(gpm > 0))
                    if gpm:
                        io.byp_n(gpm - 1, 6)
                if self.sps.sbt_enabled and not ciip and square:
                    _code_sbt_idx(io, int(self.dec.sbt8[gy, gx]))
        trace.t_leaf_inter(x, y, s, mv0 if d != 1 else mv1)
        sl = np.s_[gy:(y + hh) // 8, gx:(x + s) // 8]
        if aff is not None:
            self.inter_map[:, :, d][sl] = True
            self.mv_map[:, :, d][sl] = imod.affine_granule_mvs(
                mv0 if d == 0 else mv1, aff, s)
        else:
            if d in (0, 2):
                self.inter_map[:, :, 0][sl] = True
                self.mv_map[:, :, 0][sl] = mv0
            if d in (1, 2):
                self.inter_map[:, :, 1][sl] = True
                self.mv_map[:, :, 1][sl] = mv1
        imod.hmvp_push(self.hmvp, (d, mv0, mv1))

    def _code_leaf(self, x, y, s, h=None):
        io = self.io
        hh = s if h is None else h
        square = hh == s
        cs, ch, cx, cy = s // 2, hh // 2, x // 2, y // 2
        if self.is_p:
            if io.decoding:
                if io.bin(C.SKIP_FLAG(0)):
                    self._code_inter(x, y, s, True, h=hh)
                    for comp, (px, py, sz) in enumerate(
                            ((x, y, s), (cx, cy, cs), (cx, cy, cs))):
                        trace.t_cbf(comp, px, py, sz, 0)
                    return
                is_inter = io.bin(C.PRED_MODE(0))
            else:
                is_inter = int(self.dec.inter8[y // 8, x // 8])
                if is_inter:
                    enc_mot = self._enc_motion(x, y, s, h=hh)
                    skip = ((enc_mot[3] is not None
                             or enc_mot[4] is not None)
                            and self._leaf_levels_zero(x, y, s, h=hh)
                            and not enc_mot[6] and not enc_mot[7])
                    io.bin(C.SKIP_FLAG(0), int(skip))
                    if skip:
                        self._code_inter(x, y, s, True, enc_mot, h=hh)
                        for comp, (px, py, sz) in enumerate(
                                ((x, y, s), (cx, cy, cs), (cx, cy, cs))):
                            trace.t_cbf(comp, px, py, sz, 0)
                        return
                    io.bin(C.PRED_MODE(0), 1)
                    self._code_inter(x, y, s, False, enc_mot, h=hh)
                    self._code_component(0, x, y, s, C.CBF_LUMA(0), h=hh)
                    self._code_component(1, cx, cy, cs, C.CBF_CB(0), h=ch)
                    self._code_component(2, cx, cy, cs, C.CBF_CR(0), h=ch)
                    return
                io.bin(C.SKIP_FLAG(0), 0)
                io.bin(C.PRED_MODE(0), 0)
                is_inter = 0
        else:
            is_inter = 0
        if is_inter:
            self._code_inter(x, y, s, False, h=hh)
            self._code_component(0, x, y, s, C.CBF_LUMA(0), h=hh)
        else:
            if self.sps.ibc_enabled and not self.is_p and square:
                from ..spec.codec import _code_ibc_flag_bv
                bv = _code_ibc_flag_bv(io, self, x, y, s)
                if bv is not None:
                    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
                    self.mode_map[y // 4:(y + s) // 4,
                                  x // 4:(x + s) // 4] = rom.PLANAR_IDX
                    self.ibc_map[sl8] = True
                    self.bv_map[sl8] = bv
                    self.dec.ibc8[sl8] = 1
                    self.dec.bv8[sl8] = bv
                    self.dec.modes8[sl8] = 0
                    trace.t_leaf_intra(x, y, s, -1)
                    self._code_component(0, x, y, s, C.CBF_LUMA(0))
                    self._code_component(1, cx, cy, cs, C.CBF_CB(0))
                    self._code_component(2, cx, cy, cs, C.CBF_CR(0))
                    return
            if self.sps.plt_enabled and not self.is_p and square:
                from ..spec import palette as pltmod
                from ..spec.codec import _code_plt_flag
                if _code_plt_flag(io, self, x, y, s):
                    bd = self.sps.bit_depth
                    if io.decoding:
                        entries, idx = pltmod.code_palette(io, s, bd)
                    else:
                        entries, idx = self.dec.plt_data[(x, y, s)]
                        pltmod.code_palette(io, s, bd, entries, idx)
                    if self.dec.plt_data is None:
                        self.dec.plt_data = {}
                    self.dec.plt_data[(x, y, s)] = (entries, idx)
                    sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
                    self.mode_map[y // 4:(y + s) // 4,
                                  x // 4:(x + s) // 4] = rom.PLANAR_IDX
                    self.dec.plt8[sl8] = 1
                    self.dec.modes8[sl8] = 0
                    trace.t_leaf_intra(x, y, s, -2)
                    return
            mode = self._code_mode(x, y, s, h=hh)
            trace.t_leaf_intra(x, y, s, mode)
            if (self.sps.mrl_enabled and io.decoding and square
                    and mode < rom.NUM_LUMA_MODE):
                mrlv = self.dec.mrl8[y // 8, x // 8]
                self.dec.mrl8[y // 8:(y + s) // 8,
                              x // 8:(x + s) // 8] = mrlv
            mrl0 = (int(self.dec.mrl8[y // 8, x // 8]) == 0
                    if self.sps.mrl_enabled and square else True)
            ispv = (int(self.dec.isp8[y // 8, x // 8])
                    if (self.sps.isp_enabled and square and mrl0
                        and mode < rom.NUM_LUMA_MODE) else 0)
            if ispv:
                self._code_isp_component(x, y, s, ispv)
            else:
                self._code_component(0, x, y, s, C.CBF_LUMA(0),
                                     mts_ok=(mode < rom.NUM_LUMA_MODE
                                             and square), h=hh)
            io = self.io
            sl8 = np.s_[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
            if self.sps.cclm_enabled and square:
                if io.decoding:
                    self.dec.cmode8[sl8] = \
                        1 - io.bin(C.INTRA_CHROMA_DM(0))
                else:
                    io.bin(C.INTRA_CHROMA_DM(0),
                           int(self.dec.cmode8[y // 8, x // 8] == 0))
            if self.sps.jccr_enabled and square:
                if io.decoding:
                    joint = io.bin(C.JCCR_FLAG(0))
                    self.dec.jccr8[sl8] = joint
                else:
                    joint = int(self.dec.jccr8[y // 8, x // 8])
                    io.bin(C.JCCR_FLAG(0), joint)
                if joint:
                    self._code_joint_component(cx, cy, cs)
                    return
        self._code_component(1, cx, cy, cs, C.CBF_CB(0), h=ch)
        self._code_component(2, cx, cy, cs, C.CBF_CR(0), h=ch)

    def _code_joint_component(self, cx, cy, cs):
        """One joint Cb-Cr TB (JCCR): cbf (CBF_CB ctx) + residual into the
        Cb level plane; the Cr plane stays zero (twin of spec
        _code_joint_chroma)."""
        from ..cabac import native as cnative
        io = self.io
        plane = self.levels[1]
        if io.decoding:
            cbf = io.bin(C.CBF_CB(0))
            if cbf:
                if isinstance(io.c, cnative.NativeDecoder):
                    lev = cnative.native_parse_tb(io.c, _log2(cs),
                                                  _log2(cs), True)
                else:
                    lev = code_tb(io, None, _log2(cs), _log2(cs), True)
                plane[cy:cy + cs, cx:cx + cs] = lev
        else:
            lev = plane[cy:cy + cs, cx:cx + cs]
            cbf = int(lev.any())
            io.bin(C.CBF_CB(0), cbf)
            if cbf:
                if self.sink is not None:
                    if cnative.available():
                        self.sink._chunks.append(
                            cnative.tb_bins_c(lev, _log2(cs), _log2(cs),
                                              True))
                    else:
                        binarize.tb_bins(self.sink, lev, _log2(cs),
                                         _log2(cs), True)
                else:
                    code_tb(io, lev, _log2(cs), _log2(cs), True)
        trace.t_cbf(1, cx, cy, cs, cbf)
        trace.t_cbf(2, cx, cy, cs, 0)

    def _code_qt(self, x, y, s, depth):
        io = self.io
        if s > MIN_LEAF:
            ctx = C.SPLIT_QT_FLAG(min(2, depth - 1))
            tgt = self.dec.split32 if s == 32 else self.dec.split16
            if io.decoding:
                split = io.bin(ctx)
                tgt[y // s, x // s] = split
            else:
                split = int(tgt[y // s, x // s])
                io.bin(ctx, split)
            trace.t_split(x, y, s, split)
            if split:
                half = s // 2
                for dy in (0, half):
                    for dx in (0, half):
                        self._code_qt(x + dx, y + dy, half, depth + 1)
                return
            if self.sps.mtt_enabled:
                # twin of spec _code_qt's MTT branch (bt_flag + direction
                # + ternary bin at 32 when TT is enabled)
                barr = self.dec.bt32 if s == 32 else self.dec.bt16
                fctx = C.BT_FLAG(0 if s == 16 else 1)
                tt_ok = self.sps.tt_enabled and s == 32
                if io.decoding:
                    bt = 0
                    if io.bin(fctx):
                        bt = 1 + io.bin(C.BT_DIR(0))
                        if tt_ok and io.bin(C.TT_FLAG(0)):
                            bt += 2
                    barr[y // s, x // s] = bt
                else:
                    bt = int(barr[y // s, x // s])
                    io.bin(fctx, int(bt > 0))
                    if bt:
                        io.bin(C.BT_DIR(0), (bt - 1) & 1)
                        if tt_ok:
                            io.bin(C.TT_FLAG(0), int(bt > 2))
                trace.t_split(x, y, s, 4 + bt)
                if bt == 1:
                    self._code_leaf(x, y, s, h=s // 2)
                    self._code_leaf(x, y + s // 2, s, h=s // 2)
                    return
                if bt == 2:
                    self._code_leaf(x, y, s // 2, h=s)
                    self._code_leaf(x + s // 2, y, s // 2, h=s)
                    return
                if bt == 3:
                    q = s // 4
                    self._code_leaf(x, y, s, h=q)
                    self._code_leaf(x, y + q, s, h=s // 2)
                    self._code_leaf(x, y + s - q, s, h=q)
                    return
                if bt == 4:
                    q = s // 4
                    self._code_leaf(x, y, q, h=s)
                    self._code_leaf(x + q, y, s // 2, h=s)
                    self._code_leaf(x + s - q, y, q, h=s)
                    return
        self._code_leaf(x, y, s)

    def walk(self, terminate_fn):
        ctu = 1 << self.sps.log2_ctu
        n_x, n_y = self.sps.width // ctu, self.sps.height // ctu
        for iy in range(n_y):
            self.hmvp = []
            for ix in range(n_x):
                for dx, dy in ctu_block_order(ctu):
                    self._code_qt(ix * ctu + dx, iy * ctu + dy,
                                  MID_SIZE, 1)
                terminate_fn(False)


def _pack_row(arr, st, snap_idx):
    """Pack one substream with explicit ctx state; python fallback mirrors
    the native snapshot packer byte-for-byte."""
    from ..cabac import native as cnative
    from ..cabac.engine import CabacEncoder
    if cnative.available():
        return cnative.pack_bins_state(arr, st, snap_idx)
    enc = CabacEncoder(st)
    snap = None
    for i, (kind, ctx, b) in enumerate(arr):
        if kind == binarize.KIND_CTX:
            enc.bin(int(ctx), int(b))
        elif kind == binarize.KIND_BYP:
            enc.bypass(int(b))
        else:
            enc.terminate(int(b))
        if i + 1 == snap_idx:
            snap = (st.p0.copy(), st.p1.copy())
    return enc.finish(), snap


def _seed_state(slice_type, qp, snap):
    st = C.make_ctx_state(slice_type, qp)
    if snap is not None:
        st.p0[:] = snap[0]
        st.p1[:] = snap[1]
    return st


def encode_frame_syntax_wpp(sps: hls.SPS, pps: hls.PPS, sh: hls.SliceHeader,
                            dec: FrameDecisions, levels,
                            sao_params=None, alf_params=None,
                            col=None) -> bytes:
    """WPP: one CABAC lane per CTU row; row r inherits the context state
    saved after the first CTU of row r-1; entry-point offsets follow the
    slice header (VTM:EncoderLib/EncSlice.cpp substream handling)."""
    from ..spec import sao as saomod
    qp = pps.init_qp + sh.qp_delta
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    is_p = sh.slice_type != hls.SLICE_I
    is_b = sh.slice_type == hls.SLICE_B

    rows = []          # (bin_array, first_ctu_end_index)
    sink = binarize.BinSink()
    from ..spec.codec import bi_sym
    walker = _Walker(sps, dec, levels, RecordIO(sink), sink=sink, is_p=is_p,
                     is_b=is_b, col=col, sym=bi_sym(sh))
    for iy in range(n_y):
        first_end = None
        walker.hmvp = []
        for ix in range(n_x):
            for dx2, dy2 in ctu_block_order(ctu):
                walker._code_qt(ix * ctu + dx2, iy * ctu + dy2,
                                MID_SIZE, 1)
            if ix == 0:
                first_end = len(sink.concat())
        if iy == n_y - 1 and sao_params is not None:
            saomod.code_sao_params(walker.io, sao_params, n_y, n_x)
        if iy == n_y - 1 and alf_params is not None:
            from ..spec import alf as alfmod
            alfmod.code_alf_params(walker.io, alf_params, n_y, n_x)
        sink.term(1)
        rows.append((sink.concat(), first_end))
        sink = binarize.BinSink()
        walker.sink = sink
        walker.io = RecordIO(sink)

    payloads = []
    snap = None
    for iy, (arr, first_end) in enumerate(rows):
        st = _seed_state(sh.slice_type, qp, snap)
        data, snap = _pack_row(arr, st, first_end)
        payloads.append(data)

    w = sh.write()
    ep = bs.BitWriter()
    ep.ue(n_y)
    for pl in payloads[:-1]:
        ep.ue(len(pl))
    ep.byte_align()
    w.write_bytes(ep.getvalue())
    for pl in payloads:
        w.write_bytes(pl)
    w.write_bytes(b"\x80")   # rbsp_slice_trailing_bits (spec codec twin)
    return w.getvalue()


def parse_frame_syntax_wpp(slice_rbsp: bytes, sps: hls.SPS,
                           pps_map: dict[int, hls.PPS], motion=None):
    from ..cabac import native as cnative
    from ..spec import sao as saomod
    r = bs.BitReader(slice_rbsp)
    sh = hls.SliceHeader.read(r)
    pps = pps_map[sh.pps_id]
    qp = pps.init_qp + sh.qp_delta
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
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

    decisions = FrameDecisions.empty(sps.height, sps.width)
    levels = [np.zeros((sps.height, sps.width), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32)]
    from ..spec.codec import col_motion
    from ..spec.codec import bi_sym
    walker = _Walker(sps, decisions, levels, None,
                     is_p=sh.slice_type != hls.SLICE_I,
                     is_b=sh.slice_type == hls.SLICE_B,
                     col=col_motion(motion, sh.poc, sh.ref_pocs)
                     if sh.slice_type != hls.SLICE_I else None,
                     sym=bi_sym(sh))
    sao_params = None
    alf_params = None
    snap = None
    for iy in range(n_y):
        st = _seed_state(sh.slice_type, qp, snap)
        if cnative.available():
            cab = cnative.NativeDecoder(st, subs[iy])
        else:
            cab = CabacDecoder(st, subs[iy])
        walker.io = DecIO(cab)
        walker.hmvp = []
        for ix in range(n_x):
            for dx2, dy2 in ctu_block_order(ctu):
                walker._code_qt(ix * ctu + dx2, iy * ctu + dy2,
                                MID_SIZE, 1)
            if ix == 0:
                snap = (st.p0.copy(), st.p1.copy())
        if iy == n_y - 1 and sps.sao_enabled:
            sao_params = saomod.code_sao_params(walker.io, None, n_y, n_x)
        if iy == n_y - 1 and sps.alf_enabled:
            from ..spec import alf as alfmod
            alf_params = alfmod.code_alf_params(walker.io, None, n_y, n_x)
        if cab.terminate() != 1:
            raise ValueError("missing end_of_substream")
    return sh, decisions, levels, sao_params, alf_params



def encode_frame_syntax_tiles(sps: hls.SPS, pps: hls.PPS,
                              sh: hls.SliceHeader, dec: FrameDecisions,
                              levels, sao_params=None, alf_params=None,
                              col=None) -> bytes:
    """Tiles: independent CABAC + prediction per tile, entry points in the
    payload (twin of spec codec's tiles path: per-CTU terminate(0), SAO/ALF
    at the last tile, terminate(1) per tile)."""
    from ..spec import sao as saomod
    from ..spec.codec import bi_sym
    qp = pps.init_qp + sh.qp_delta
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    rects = hls.tile_grid(n_x, n_y, pps.num_tile_cols, pps.num_tile_rows)
    is_p = sh.slice_type != hls.SLICE_I
    is_b = sh.slice_type == hls.SLICE_B
    payloads = []
    for ti, (cx0, cy0, cx1, cy1) in enumerate(rects):
        sink = binarize.BinSink()
        # a fresh walker per tile = the spec's _tile_reset (new maps)
        walker = _Walker(sps, dec, levels, RecordIO(sink), sink=sink,
                         is_p=is_p, is_b=is_b, col=col, sym=bi_sym(sh))
        for iy in range(cy0, cy1):
            walker.hmvp = []
            for ix in range(cx0, cx1):
                for dx2, dy2 in ctu_block_order(ctu):
                    walker._code_qt(ix * ctu + dx2, iy * ctu + dy2,
                                    MID_SIZE, 1)
                sink.term(0)
        if ti == len(rects) - 1:
            if sao_params is not None:
                saomod.code_sao_params(walker.io, sao_params, n_y, n_x)
            if alf_params is not None:
                from ..spec import alf as alfmod
                alfmod.code_alf_params(walker.io, alf_params, n_y, n_x)
        sink.term(1)
        payloads.append(pack_bins(sink.concat(), sh.slice_type, qp))
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
    return w.getvalue()


def parse_frame_syntax_tiles(slice_rbsp: bytes, sps: hls.SPS,
                             pps_map: dict[int, hls.PPS], motion=None):
    from ..cabac import native as cnative
    from ..spec import sao as saomod
    from ..spec.codec import bi_sym, col_motion
    r = bs.BitReader(slice_rbsp)
    sh = hls.SliceHeader.read(r)
    pps = pps_map[sh.pps_id]
    qp = pps.init_qp + sh.qp_delta
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    rects = hls.tile_grid(n_x, n_y, pps.num_tile_cols, pps.num_tile_rows)
    n_sub = r.ue()
    if n_sub != len(rects):
        raise ValueError("tile entry-point count mismatch")
    lens = [r.ue() for _ in range(n_sub - 1)]
    r.byte_align()
    rest = r.remaining_bytes()
    offs = [0]
    for ln in lens:
        offs.append(offs[-1] + ln)
    subs = [rest[offs[i]:offs[i + 1]] if i + 1 < len(offs)
            else rest[offs[i]:] for i in range(n_sub)]
    decisions = FrameDecisions.empty(sps.height, sps.width)
    levels = [np.zeros((sps.height, sps.width), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32)]
    sao_params = None
    alf_params = None
    for ti, (cx0, cy0, cx1, cy1) in enumerate(rects):
        st = C.make_ctx_state(sh.slice_type, qp)
        if cnative.available():
            cab = cnative.NativeDecoder(st, subs[ti])
        else:
            cab = CabacDecoder(st, subs[ti])
        walker = _Walker(sps, decisions, levels, DecIO(cab),
                         is_p=sh.slice_type != hls.SLICE_I,
                         is_b=sh.slice_type == hls.SLICE_B,
                         col=col_motion(motion, sh.poc, sh.ref_pocs)
                         if sh.slice_type != hls.SLICE_I else None,
                         sym=bi_sym(sh))
        for iy in range(cy0, cy1):
            walker.hmvp = []
            for ix in range(cx0, cx1):
                for dx2, dy2 in ctu_block_order(ctu):
                    walker._code_qt(ix * ctu + dx2, iy * ctu + dy2,
                                    MID_SIZE, 1)
                if cab.terminate() != 0:
                    raise ValueError("tile substream desync")
        if ti == len(rects) - 1:
            if sps.sao_enabled:
                sao_params = saomod.code_sao_params(walker.io, None, n_y,
                                                    n_x)
            if sps.alf_enabled:
                from ..spec import alf as alfmod
                alf_params = alfmod.code_alf_params(walker.io, None, n_y,
                                                    n_x)
        if cab.terminate() != 1:
            raise ValueError("missing end_of_tile")
    return sh, decisions, levels, sao_params, alf_params


def encode_frame_syntax(sps: hls.SPS, pps: hls.PPS, sh: hls.SliceHeader,
                        dec: FrameDecisions, levels,
                        sao_params=None, alf_params=None,
                        fast: bool = True, col=None) -> bytes:
    """levels: [ly, lcb, lcr] numpy int32 planes from the device scan."""
    from ..spec import sao as saomod
    qp = pps.init_qp + sh.qp_delta
    ctu = 1 << sps.log2_ctu
    n_x, n_y = sps.width // ctu, sps.height // ctu
    if pps.num_tile_cols * pps.num_tile_rows > 1:
        return encode_frame_syntax_tiles(sps, pps, sh, dec, levels,
                                         sao_params, alf_params, col=col)
    if pps.entropy_sync and n_y > 1:
        return encode_frame_syntax_wpp(sps, pps, sh, dec, levels, sao_params,
                                       alf_params, col=col)
    is_p = sh.slice_type != hls.SLICE_I
    is_b = sh.slice_type == hls.SLICE_B
    if fast:
        sink = binarize.BinSink()
        io = RecordIO(sink)
        from ..spec.codec import bi_sym
        walker = _Walker(sps, dec, levels, io, sink=sink, is_p=is_p,
                         is_b=is_b, col=col, sym=bi_sym(sh))
        walker.walk(lambda last: sink.term(0))
        if sao_params is not None:
            saomod.code_sao_params(io, sao_params, n_y, n_x)
        if alf_params is not None:
            from ..spec import alf as alfmod
            alfmod.code_alf_params(io, alf_params, n_y, n_x)
        sink.term(1)
        payload = pack_bins(sink.concat(), sh.slice_type, qp)
    else:
        enc = CabacEncoder(C.make_ctx_state(sh.slice_type, qp))
        io = EncIO(enc)
        walker = _Walker(sps, dec, levels, io, is_p=is_p, is_b=is_b,
                         col=col, sym=bi_sym(sh))
        walker.walk(lambda last: enc.terminate(0))
        if sao_params is not None:
            saomod.code_sao_params(io, sao_params, n_y, n_x)
        if alf_params is not None:
            from ..spec import alf as alfmod
            alfmod.code_alf_params(io, alf_params, n_y, n_x)
        enc.terminate(1)
        payload = enc.finish()
    w = sh.write()
    w.write_bytes(payload)
    w.write_bytes(b"\x80")   # rbsp_slice_trailing_bits (spec codec twin)
    return w.getvalue()


def pack_bins(arr: np.ndarray, slice_type: int, qp: int) -> bytes:
    """Drive the arithmetic coder over a recorded (kind, ctx, bin) array.

    Uses the native packer (native/cabac.c) when built; falls back to the
    Python engine (identical output)."""
    from ..cabac import native as cnative
    if cnative.available():
        return cnative.pack_bins(arr, slice_type, qp)
    enc = CabacEncoder(C.make_ctx_state(slice_type, qp))
    for kind, ctx, b in arr:
        if kind == binarize.KIND_CTX:
            enc.bin(int(ctx), int(b))
        elif kind == binarize.KIND_BYP:
            enc.bypass(int(b))
        else:
            enc.terminate(int(b))
    return enc.finish()


def parse_frame_syntax(slice_rbsp: bytes, sps: hls.SPS,
                       pps_map: dict[int, hls.PPS], motion=None):
    """Returns (sh, decisions, [ly, lcb, lcr], sao_params)."""
    r0 = bs.BitReader(slice_rbsp)
    sh0 = hls.SliceHeader.read(r0)
    pps0 = pps_map[sh0.pps_id]
    ctu0 = 1 << sps.log2_ctu
    if pps0.num_tile_cols * pps0.num_tile_rows > 1:
        return parse_frame_syntax_tiles(slice_rbsp, sps, pps_map, motion)
    if pps0.entropy_sync and sps.height // ctu0 > 1:
        return parse_frame_syntax_wpp(slice_rbsp, sps, pps_map, motion)
    r = bs.BitReader(slice_rbsp)
    sh = hls.SliceHeader.read(r)
    pps = pps_map[sh.pps_id]
    qp = pps.init_qp + sh.qp_delta
    decisions = FrameDecisions.empty(sps.height, sps.width)
    levels = [np.zeros((sps.height, sps.width), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32),
              np.zeros((sps.height // 2, sps.width // 2), np.int32)]
    from ..cabac import native as cnative
    if cnative.available():
        cab = cnative.NativeDecoder(C.make_ctx_state(sh.slice_type, qp),
                                    r.remaining_bytes())
    else:
        cab = CabacDecoder(C.make_ctx_state(sh.slice_type, qp),
                          r.remaining_bytes())
    from ..spec.codec import col_motion
    io = DecIO(cab)
    from ..spec.codec import bi_sym
    walker = _Walker(sps, decisions, levels, io,
                     is_p=sh.slice_type != hls.SLICE_I,
                     is_b=sh.slice_type == hls.SLICE_B,
                     col=col_motion(motion, sh.poc, sh.ref_pocs)
                     if sh.slice_type != hls.SLICE_I else None,
                     sym=bi_sym(sh))

    def term(last):
        if cab.terminate() != 0:
            raise ValueError("unexpected end_of_slice")

    walker.walk(term)
    sao_params = None
    alf_params = None
    ctu = 1 << sps.log2_ctu
    if sps.sao_enabled:
        from ..spec import sao as saomod
        sao_params = saomod.code_sao_params(io, None, sps.height // ctu,
                                            sps.width // ctu)
    if sps.alf_enabled:
        from ..spec import alf as alfmod
        alf_params = alfmod.code_alf_params(io, None, sps.height // ctu,
                                            sps.width // ctu)
    if cab.terminate() != 1:
        raise ValueError("missing end_of_slice")
    return sh, decisions, levels, sao_params, alf_params
