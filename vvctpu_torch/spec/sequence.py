"""Sequence-level spec codec: Annex-B assembly, hash SEI, decode verification.

Role of VTM:App/EncoderApp (EncApp::encode loop + NAL emission) and
VTM:App/DecoderApp (DecApp::decode, MD5 verify) for the spec model.  The JAX
pipeline (vvctpu/pipeline/) produces byte-identical streams via the same HLS
writers; only the frame engine differs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import bitstream as bs
from ..core import rom
from . import codec, decide, hls


@dataclass
class EncoderConfig:
    qp: int = 32
    bit_depth: int = 8
    ctu: int = 64
    deblock: bool = True
    sao: bool = True
    intra_period: int = 1   # 1 = all-intra; 0 = first frame only; N = every N
    wpp: bool = False       # wavefront entropy lanes (one per CTU row)
    gop: int = 1            # 1 = low-delay IPPP; >1 = hierarchical-B GOP
    mts: bool = False       # explicit MTS (DST7/DCT8) for intra luma
    mip: bool = False       # matrix intra prediction (generated weights)
    mrl: bool = False       # multi-reference-line intra (lines 0/1/2)
    tskip: bool = False     # transform skip (unified tx index 5)
    jccr: bool = False      # joint Cb-Cr residual coding
    mmvd: bool = False      # merge with MVD
    dmvr: bool = False      # decoder-side MV refinement (BI leaves)
    bcw: bool = False       # bi-prediction with CU weights {3,4,5}/8
    amvr: bool = False      # adaptive MVD resolution (1/4, 1, 4 pel)
    smvd: bool = False      # symmetric MVD (BI leaves, symmetric refs)
    ciip: bool = False      # combined inter-intra prediction
    sbt: bool = False       # sub-block transform (inter luma residual)
    bdof: bool = False      # bi-directional optical flow (BI leaves)
    isp: bool = False       # intra sub-partitions (2/4 stripe TBs per leaf)
    gpm: bool = False       # geometric partitioning (B leaves, 64 masks)
    affine: bool = False    # 4-parameter affine + PROF (uni, 16/32 leaves)
    lfnst: bool = False     # low-frequency non-separable secondary transform
    cclm: bool = False      # cross-component linear-model chroma prediction
    rdoq: bool = True       # encoder RDOQ quantizer (decoder-transparent)
    dq: bool = False        # dependent quantization (4-state trellis)
    mtt: bool = False       # multi-type tree (binary splits at 16/32)
    tt: bool = False        # ternary splits at 32 (with mtt)
    ibc: bool = False       # intra block copy (I slices, square leaves)
    plt: bool = False       # palette mode (I slices, square leaves)
    tile_cols: int = 1      # tile grid columns (prediction+entropy break)
    tile_rows: int = 1      # tile grid rows
    subpic_cols: int = 1    # subpicture grid (independent encodes, layers)
    subpic_rows: int = 1
    lmcs: bool = False      # luma mapping (reshaper)
    alf: bool = False       # adaptive loop filter (luma Wiener, CTU flags)
    mctf: bool = False      # motion-compensated temporal source prefilter
    rc_bits_per_frame: int = 0   # >0 enables rate control
    hash_type: int = 0      # picture-hash SEI: 0 MD5 / 1 CRC / 2 checksum


    def make_sps(self, width: int, height: int) -> hls.SPS:
        if self.ctu not in (64, 128):
            raise ValueError(f"CTU size {self.ctu} not supported (64/128)")
        if self.ctu == 128 and (self.ibc or self.plt):
            # the IBC/palette reference-area rule hardcodes the 64-CTU
            # row geometry (spec/codec.py bv legality) — documented gate
            raise ValueError("--ctu 128 requires IBC and palette off")
        pw = -(-width // self.ctu) * self.ctu
        ph = -(-height // self.ctu) * self.ctu
        return hls.SPS(width=pw, height=ph,
                       conf_win=(0, pw - width, 0, ph - height),
                       bit_depth=self.bit_depth,
                       log2_ctu=int(self.ctu).bit_length() - 1,
                       deblock_enabled=self.deblock,
                       sao_enabled=self.sao, mts_enabled=self.mts,
                       lfnst_enabled=self.lfnst, cclm_enabled=self.cclm,
                       lmcs_enabled=self.lmcs, alf_enabled=self.alf,
                       mip_enabled=self.mip, mrl_enabled=self.mrl,
                       ts_enabled=self.tskip, jccr_enabled=self.jccr,
                       mmvd_enabled=self.mmvd, dmvr_enabled=self.dmvr,
                       bdof_enabled=self.bdof, bcw_enabled=self.bcw,
                       amvr_enabled=self.amvr, smvd_enabled=self.smvd,
                       ciip_enabled=self.ciip, sbt_enabled=self.sbt,
                       isp_enabled=self.isp, gpm_enabled=self.gpm,
                       affine_enabled=self.affine, dq_enabled=self.dq,
                       mtt_enabled=self.mtt,
                       tt_enabled=self.tt and self.mtt,
                       ibc_enabled=self.ibc, plt_enabled=self.plt)


def gop_plan(n_frames: int, intra_period: int, gop: int):
    """Coding-order plan: list of (poc, slice_type, ref_pocs, qp_delta).

    Hierarchical-B random access (SURVEY.md §2.6 EncGOP): anchors every
    ``gop`` pictures (I per intra_period, else P off the previous anchor),
    the interior filled by binary-subdivision B pictures referencing the
    nearest coded past/future pictures; qp_delta rises with temporal layer.
    """
    out = []

    def is_idr(poc):
        ip = intra_period
        return poc == 0 or (ip == 1) or (ip > 1 and poc % ip == 0)

    def subdivide(lo, hi, tid):
        # breadth-first: each temporal layer's B pictures are CONSECUTIVE
        # in coding order, so they form one frame-batched wavefront group
        # (pipeline/encoder._encode_b_group) — same reference structure as
        # the depth-first order, only the emission order differs
        level = [(lo, hi)]
        t = tid
        while level:
            nxt = []
            for (a, b) in level:
                if b - a < 2:
                    continue
                mid = (a + b) // 2
                out.append((mid, hls.SLICE_B, (a, b), min(t, 5)))
                nxt.append((a, mid))
                nxt.append((mid, b))
            level = nxt
            t += 1

    anchor = 0
    out.append((0, hls.SLICE_I, (), 0))
    while anchor < n_frames - 1:
        nxt = min(anchor + max(gop, 1), n_frames - 1)
        if nxt == anchor:
            break
        if is_idr(nxt):
            out.append((nxt, hls.SLICE_I, (), 0))
        else:
            out.append((nxt, hls.SLICE_P, (anchor,), 1))
        subdivide(anchor, nxt, 2)
        anchor = nxt
    return out


def encode_sequence(frames: list[list[np.ndarray]], cfg: EncoderConfig,
                    decisions_fn=None, decisions_out: list | None = None,
                    checkpoint_path: str | None = None):
    """frames: list of [Y, Cb, Cr] planes (output size).  Returns
    (annexb_bytes, recon_frames[cropped], per_frame_bits).

    checkpoint_path: optional .npz the encoder writes after every anchor
    picture and resumes from if present (SURVEY.md §5 checkpoint/resume —
    absent in the reference, required for preemptible multi-host runs)."""
    if cfg.subpic_cols * cfg.subpic_rows > 1:
        from ..dist.subpic import encode_subpics
        return encode_subpics(frames, cfg,
                              lambda fr, c: encode_sequence(fr, c))
    h, w = frames[0][0].shape
    sps = cfg.make_sps(w, h)
    pps = hls.PPS(init_qp=cfg.qp, entropy_sync=cfg.wpp,
                  num_tile_cols=cfg.tile_cols, num_tile_rows=cfg.tile_rows)
    nals = [bs.NalUnit(bs.NAL_SPS, sps.write()),
            bs.NalUnit(bs.NAL_PPS, pps.write())]
    recons = [None] * len(frames)
    bits = [None] * len(frames)
    dpb = {}   # poc -> filtered recon (padded planes)
    mot = {}   # poc -> motion_record (TMVP side table)
    plan = gop_plan(len(frames), cfg.intra_period, cfg.gop)
    if cfg.mctf:
        from . import mctf as mctfmod
        frames = mctfmod.temporal_filter(frames, cfg.gop)
    rc = RateControl(cfg.rc_bits_per_frame) \
        if cfg.rc_bits_per_frame > 0 else None
    start_idx = 0
    if checkpoint_path:
        import os
        if os.path.exists(checkpoint_path):
            ck = np.load(checkpoint_path, allow_pickle=True)
            start_idx = int(ck["plan_idx"])
            nals = list(ck["nals"].tolist())
            dpb = {int(k): [a for a in v]
                   for k, v in ck["dpb"].item().items()}
            mot = {int(k): v for k, v in ck["mot"].item().items()}
            for poc_d, b, r0, r1, r2 in ck["done"].tolist():
                recons[poc_d] = [r0, r1, r2]
                bits[poc_d] = b
    for idx, (poc, stype, ref_pocs, qpd) in enumerate(plan):
        if idx < start_idx:
            continue
        planes = frames[poc]
        padded_y = codec.pad_planes(planes, sps)[0]
        # temporal sublayer id from the GOP plan layer (anchors 0, B
        # pictures by subdivision depth) — enables BitstreamExtractor-style
        # sublayer extraction (io/streamtools.py)
        tid = 0 if stype != hls.SLICE_B else max(qpd - 1, 1)
        if rc is not None:
            qpd = max(0, min(63 - cfg.qp, qpd + rc.qp_offset()))
        qp = cfg.qp + qpd
        if decisions_fn is not None:
            dec = decisions_fn(poc, planes, sps, cfg)
        elif stype == hls.SLICE_I:
            dec = decide.decide_frame(padded_y, qp, cfg.bit_depth,
                                      mip=cfg.mip, mrl=cfg.mrl,
                                      isp=cfg.isp, mtt=cfg.mtt,
                                      ibc=cfg.ibc,
                                      tt=cfg.tt and cfg.mtt,
                                      plt=cfg.plt)
        elif stype == hls.SLICE_P:
            dec = decide.decide_frame_p(padded_y, dpb[ref_pocs[0]][0], qp,
                                        cfg.bit_depth, mip=cfg.mip,
                                        mrl=cfg.mrl, ciip=cfg.ciip,
                                        isp=cfg.isp, affine=cfg.affine,
                                        mtt=cfg.mtt,
                                        tt=cfg.tt and cfg.mtt,
                                        me_ext=abs(poc - ref_pocs[0]) > 1)
        else:
            dec = decide.decide_frame_b(padded_y, dpb[ref_pocs[0]][0],
                                        dpb[ref_pocs[1]][0], qp,
                                        cfg.bit_depth, mip=cfg.mip,
                                        mrl=cfg.mrl, bcw=cfg.bcw,
                                        ciip=cfg.ciip, isp=cfg.isp,
                                        gpm=cfg.gpm, affine=cfg.affine,
                                        mtt=cfg.mtt,
                                        tt=cfg.tt and cfg.mtt,
                                        me_ext=max(abs(poc - r)
                                                   for r in ref_pocs) > 1)
        if decisions_out is not None:
            decisions_out.append(dec)
        sh = hls.SliceHeader(poc=poc, slice_type=stype, qp_delta=qpd,
                             ref_pocs=ref_pocs)
        if cfg.lmcs:
            from . import lmcs as lmcsmod
            sh.lmcs_cw = lmcsmod.derive_model(padded_y, cfg.bit_depth)
        payload, recon = codec.encode_frame(
            planes, sps, pps, sh, dec,
            refs=[dpb[rp] for rp in ref_pocs] if ref_pocs else None,
            col=codec.col_motion(mot, poc, ref_pocs), rdoq=cfg.rdoq)
        dpb[poc] = recon
        mot[poc] = codec.motion_record(dec, ref_pocs)
        cropped = codec.crop_planes(recon, sps)
        nals.append(bs.NalUnit(
            bs.NAL_IDR_N_LP if stype == hls.SLICE_I else bs.NAL_TRAIL,
            payload, temporal_id=tid))
        nals.append(bs.NalUnit(
            bs.NAL_SUFFIX_SEI,
            hls.write_pic_hash_sei(cropped, cfg.bit_depth, cfg.hash_type),
            temporal_id=tid))
        recons[poc] = cropped
        bits[poc] = 8 * len(payload)
        if rc is not None:
            rc.update(bits[poc])
        if checkpoint_path and stype != hls.SLICE_B:
            done = [(p2, bits[p2], *recons[p2])
                    for p2 in range(len(frames)) if recons[p2] is not None]
            np.savez(checkpoint_path,
                     plan_idx=np.int64(idx + 1),
                     nals=np.asarray(nals, dtype=object),
                     dpb=np.asarray({k: v for k, v in dpb.items()},
                                    dtype=object),
                     mot=np.asarray({k: v for k, v in mot.items()},
                                    dtype=object),
                     done=np.asarray(done, dtype=object))
    return bs.write_annexb(nals), recons, bits


def decode_sequence(data: bytes, check_hash: bool = True, stats=None):
    """Returns (frames [cropped planes], sps).  Raises on hash mismatch.
    stats: optional dict tallying CABAC bins per syntax class (the
    DecoderAnalyser role — SURVEY.md §2.8 CodingStatistics)."""
    from ..io import streamtools
    layout = streamtools.subpic_layout(data)
    if layout is not None:
        from ..dist.subpic import decode_subpics
        return decode_subpics(
            data, layout,
            lambda d, ch: decode_sequence(d, check_hash=ch, stats=stats),
            check_hash)
    sps = None
    pps_map: dict[int, hls.PPS] = {}
    frames = {}     # poc -> cropped planes
    pending = None  # last decoded (cropped) frame awaiting its hash SEI
    pending_poc = -1
    dpb = {}
    mot = {}
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_SPS:
            sps = hls.SPS.read(nal.payload)
        elif nal.nal_type == bs.NAL_PPS:
            p = hls.PPS.read(nal.payload)
            pps_map[p.pps_id] = p
        elif nal.nal_type in (bs.NAL_IDR_N_LP, bs.NAL_IDR_W_RADL,
                              bs.NAL_TRAIL, bs.NAL_CRA):
            recon, sh, ddec = codec.decode_frame(nal.payload, sps, pps_map,
                                                 dpb=dpb, motion=mot,
                                                 stats=stats)
            dpb[sh.poc] = recon
            mot[sh.poc] = codec.motion_record(ddec, sh.ref_pocs)
            pending = codec.crop_planes(recon, sps)
            pending_poc = sh.poc
            frames[sh.poc] = pending
        elif nal.nal_type == bs.NAL_SUFFIX_SEI and check_hash:
            parsed = hls.read_pic_hash_sei(nal.payload)
            if parsed is not None and pending is not None:
                htype, digest = parsed
                got = hls.plane_hash(pending, sps.bit_depth, htype)
                if got != digest:
                    raise ValueError(
                        f"decoded-picture hash mismatch at poc "
                        f"{pending_poc}")
    return [frames[p] for p in sorted(frames)], sps


def psnr(ref: np.ndarray, rec: np.ndarray, bit_depth: int = 8) -> float:
    mse = float(np.mean((ref.astype(np.float64) - rec.astype(np.float64)) ** 2))
    if mse == 0:
        return 99.0
    peak = (1 << bit_depth) - 1
    return 10.0 * np.log10(peak * peak / mse)


# ---------------------------------------------------------------------------
# Rate control (lambda-domain-lite; role of VTM:EncoderLib/RateCtrl.cpp)
# ---------------------------------------------------------------------------
@dataclass
class RateControl:
    """Deterministic integer PI controller on QP, shared by both engines.

    Tracks the accumulated bit error against the per-frame target and maps
    it to a bounded QP offset (a +6 QP step halves bits to first order, so
    the gain is one step per accumulated target's worth of overshoot)."""
    target_bits_per_frame: int
    err: int = 0

    def qp_offset(self) -> int:
        t = max(self.target_bits_per_frame, 1)
        off = (2 * self.err) // t    # one QP per half-target of error
        return max(-10, min(10, off))

    def update(self, actual_bits: int) -> None:
        self.err += actual_bits - self.target_bits_per_frame
        # leaky integrator so ancient history decays
        self.err -= self.err // 16
