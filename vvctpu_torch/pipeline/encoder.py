"""PyTorch encoder/decoder: device passes + host entropy + NAL assembly.

Twin of vvctpu/pipeline/encoder.py for this slice: all-intra, low-delay
P and random access (hierarchical B, any ``gop`` and ``intra_period``),
one tile, CTU 64, the default toolset plus VVC's intra toolset (MTS,
LFNST, ISP, MIP, MRL, CCLM) in every slice type and its inter toolset
(BCW, CIIP, GPM, affine with PROF, DMVR, BDOF, MMVD, AMVR, SMVD, SBT;
DMVR and BDOF in BI-symmetric pictures only), dependent quantization,
and ALF with CC-ALF (parameters derived on the host, filters on the
device).  All-intra frames are reconstructed in groups of up to eight
per frame-batched wave; one temporal layer's B frames are decided frame
by frame and reconstructed in one frame-batched wave.  The bitstreams are byte-identical to the
reference engine's and to the spec model's.  Anything outside the slice
raises.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch
from torch.profiler import record_function

from .. import device as devmod
from ..coding import decide as tdecide
from ..core import bitstream as bs
from ..core import trace as _trace
from ..kernels import loopfilter as lfk
from ..spec import alf as salf
from ..spec import codec as scodec
from ..spec import hls
from ..spec import sequence as sseq
from ..spec.transform import lambda_rd_int
from . import entropy, recon, wave

# EncoderConfig / SPS tool flags this slice leaves off
_OFF_TOOLS = ("tskip", "jccr", "mtt", "tt", "ibc", "plt", "lmcs", "mctf")
_SPS_OFF = ("ts", "jccr", "mtt", "tt", "ibc", "plt", "lmcs")
# frames per frame-batched wave
_GROUP = 8


def check_config(cfg: sseq.EncoderConfig) -> None:
    """Raise ValueError for a configuration outside this slice."""
    bad = [t for t in _OFF_TOOLS if getattr(cfg, t)]
    if cfg.tile_cols * cfg.tile_rows != 1:
        bad.append("tiles")
    if cfg.subpic_cols * cfg.subpic_rows != 1:
        bad.append("subpictures")
    if cfg.rc_bits_per_frame:
        bad.append("rate control")
    if cfg.ctu != 64:
        bad.append(f"ctu={cfg.ctu}")
    if cfg.bit_depth != 8:
        bad.append(f"bit_depth={cfg.bit_depth}")
    if bad:
        raise ValueError("outside the PyTorch port's slice (one tile, CTU "
                         "64, 8-bit; no MTT, IBC, palette, TS, JCCR, LMCS "
                         "or MCTF): " + ", ".join(bad))


def _check_sps(sps: hls.SPS, pps: hls.PPS) -> None:
    bad = [t for t in _SPS_OFF if getattr(sps, f"{t}_enabled")]
    if sps.log2_ctu != 6 or sps.bit_depth != 8:
        bad.append("ctu/bit depth")
    if pps.num_tile_cols * pps.num_tile_rows != 1:
        bad.append("tiles")
    if bad:
        raise ValueError("stream outside the PyTorch port's slice: "
                         + ", ".join(bad))


def _wave_tools(sps: hls.SPS, sym: bool) -> dict:
    """frame_wave_batch's tool flags from the SPS; DMVR and BDOF apply to
    pictures whose two references are POC-symmetric (``sym``)."""
    return dict(mts=sps.mts_enabled, lfnst=sps.lfnst_enabled,
                cclm=sps.cclm_enabled, mip=sps.mip_enabled,
                ciip=sps.ciip_enabled, gpm=sps.gpm_enabled,
                affine=sps.affine_enabled, dmvr=sps.dmvr_enabled and sym,
                bdof=sps.bdof_enabled and sym, sbt=sps.sbt_enabled,
                dq=sps.dq_enabled)


def _decide_tools(sps: hls.SPS, stype) -> dict:
    """The decision passes' tool flags of a slice type from the SPS."""
    kw = dict(mip=sps.mip_enabled, mrl=sps.mrl_enabled, isp=sps.isp_enabled)
    if stype != hls.SLICE_I:
        kw.update(ciip=sps.ciip_enabled, affine=sps.affine_enabled)
    if stype == hls.SLICE_B:
        kw.update(bcw=sps.bcw_enabled, gpm=sps.gpm_enabled)
    return kw


def _wave_frame(sps, dec, py, pcb, pcr, dpb, ref_pocs, device):
    """frame_wave_batch input of one frame: slot tables, the planes on the
    device and, for inter frames, the phase-A rows and the padded device
    reference planes (three per list)."""
    def up(p):
        return torch.as_tensor(np.ascontiguousarray(p, np.int32),
                               device=device)

    fr = dict(py=up(py), pcb=up(pcb), pcr=up(pcr))
    if ref_pocs:
        fr["slots"], fr["inter"] = recon.make_slots_split(
            dec, sps.height, sps.width, 1 << sps.log2_ctu)
        fr["refs"] = tuple(p for r in ref_pocs for p in dpb[r])
    else:
        fr["slots"] = recon.make_slots(dec, sps.height, sps.width,
                                       1 << sps.log2_ctu)
    return fr


def _tid(stype, qpd: int) -> int:
    """Temporal sublayer id of a picture (twin of the reference's GOP-plan
    layer): B pictures sit at max(qp_delta - 1, 1), I and P at 0."""
    return max(qpd - 1, 1) if stype == hls.SLICE_B else 0


def _fetch(ts):
    return [t.cpu().numpy() for t in ts]


@contextmanager
def _stage(name: str, times, device=None):
    """A named pipeline stage: a profiler range and, when ``times`` is a
    dict, the stage's wall seconds added under ``name`` (a CUDA device is
    synchronised at both ends; host-only stages pass no device)."""
    with record_function(name):
        if times is None:
            yield
            return
        sync = device is not None and device.type == "cuda"
        if sync:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def encode_sequence(frames, cfg: sseq.EncoderConfig, device=None,
                    stage_times=None, layer_times=None, decisions_out=None):
    """Encode planes [[y, cb, cr], ...] with ``cfg``; returns (annex-B
    bytes, cropped recon planes, bits per frame).  stage_times: optional
    dict that receives the wall seconds of each pipeline stage;
    layer_times: optional dict that receives the wall seconds spent on
    each temporal layer (keys "layer <temporal id>"); decisions_out:
    optional list that receives each frame's FrameDecisions in coding
    order, as the reference's does."""
    check_config(cfg)
    dev = devmod.resolve(device)
    h, w = frames[0][0].shape
    sps = cfg.make_sps(w, h)
    pps = hls.PPS(init_qp=cfg.qp, entropy_sync=cfg.wpp)
    nals = [bs.NalUnit(bs.NAL_SPS, sps.write()),
            bs.NalUnit(bs.NAL_PPS, pps.write())]
    recons = [None] * len(frames)
    bits = [None] * len(frames)
    # poc -> padded filtered recon planes on the device (none in
    # all-intra, where no picture is referenced)
    dpb = None if cfg.intra_period == 1 else {}
    mot = {}   # poc -> motion_record (TMVP side table)
    plan = sseq.gop_plan(len(frames), cfg.intra_period, cfg.gop)
    # host entropy of frame i overlaps the device passes of frame i + 1;
    # one worker keeps coding order (syntax tracing needs the main thread)
    pool = None if _trace.enabled else ThreadPoolExecutor(max_workers=1)
    try:
        pi = 0
        while pi < len(plan):
            grp = _b_group(plan, pi, all_intra=dpb is None)
            pi += len(grp)
            _, stype, _, qpd = grp[0]
            with _stage(f"layer {_tid(stype, qpd)}", layer_times, dev):
                decs = _encode_group(frames, cfg, sps, pps, grp, dpb, mot,
                                     nals, recons, bits, pool, stage_times,
                                     dev)
            if decisions_out is not None:
                decisions_out.extend(decs)
        flat = []
        for n in nals:
            flat.extend(n.result() if hasattr(n, "result") else [n])
    finally:
        if pool is not None:
            pool.shutdown()
    return bs.write_annexb(flat), recons, bits


def _sym(poc: int, refs) -> bool:
    """True when a picture's two references are POC-symmetric around it
    (codec.bi_sym of its slice header)."""
    return (len(refs) == 2 and refs[0] < poc < refs[1]
            and poc - refs[0] == refs[1] - poc)


def _b_group(plan, i, all_intra: bool = False):
    """Maximal run plan[i:j], at most _GROUP long, of mutually-independent
    entries: in all-intra, consecutive I entries; otherwise B entries
    with equal qp_delta and equal BI symmetry — the frames of one
    temporal layer under the breadth-first GOP plan (twin of the
    reference's)."""
    if all_intra:
        return plan[i:i + _GROUP]
    p0, s0, r0, q0 = plan[i]
    if s0 != hls.SLICE_B or len(r0) != 2:
        return plan[i:i + 1]
    grp = [plan[i]]
    pocs = {p0}
    for j in range(i + 1, min(len(plan), i + _GROUP)):
        poc, stype, refs, qpd = plan[j]
        if (stype != hls.SLICE_B or len(refs) != 2 or qpd != q0
                or _sym(poc, refs) != _sym(p0, r0)
                or any(r in pocs for r in refs)):
            break
        grp.append(plan[j])
        pocs.add(poc)
    return grp


def _encode_group(frames, cfg, sps, pps, grp, dpb, mot, nals, recons, bits,
                  pool, stage_times, dev):
    """Encode plan entries that share slice type and QP and reference no
    picture among themselves: the decisions of every frame, one
    frame-batched wave, then each frame's loop filters and entropy.
    ``dpb`` is None in all-intra.  Returns the frames' decisions."""
    qpd = grp[0][3]
    qp = cfg.qp + qpd
    decs, padded_l, frs = [], [], []
    for poc, stype, ref_pocs, _ in grp:
        padded = scodec.pad_planes(frames[poc], sps)
        # the ext search runs when a reference is more than a frame away
        me_ext = any(abs(poc - r) > 1 for r in ref_pocs)
        tools = _decide_tools(sps, stype)
        with _stage("decide", stage_times, dev):
            if stype == hls.SLICE_I:
                dec = tdecide.decide_frame(padded[0], qp, cfg.bit_depth,
                                           device=dev, **tools)
            elif stype == hls.SLICE_P:
                dec = tdecide.decide_frame_p(
                    padded[0], dpb[ref_pocs[0]][0], qp, cfg.bit_depth,
                    device=dev, me_ext=me_ext, **tools)
            else:
                dec = tdecide.decide_frame_b(
                    padded[0], dpb[ref_pocs[0]][0], dpb[ref_pocs[1]][0], qp,
                    cfg.bit_depth, device=dev, me_ext=me_ext, **tools)
        decs.append(dec)
        padded_l.append(padded)
        frs.append(_wave_frame(sps, dec, *padded, dpb, ref_pocs, dev))
    with _stage("wave", stage_times, dev):
        outs = wave.frame_wave_batch(
            frs, frame_w=sps.width, frame_h=sps.height,
            log2_ctu=sps.log2_ctu, qp=qp, bd=cfg.bit_depth, encode=True,
            rdoq=cfg.rdoq, lam_rd=lambda_rd_int(qp),
            **_wave_tools(sps, _sym(grp[0][0], grp[0][2])))
    # every frame's filters are launched before the group's first entropy
    # job starts on the worker thread, which would slow their many small
    # launches on this one (1080p all-intra on an H100: 9 s against 0.1 s)
    chains = [_filter_frame(cfg, sps, dec, padded, e[0], qp, out, dpb,
                            stage_times, dev)
              for e, dec, padded, out in zip(grp, decs, padded_l, outs)]
    for (poc, stype, ref_pocs, _), dec, out, (chain, alf_params) in zip(
            grp, decs, outs, chains):
        _emit_frame(cfg, sps, pps, dec, poc, stype, ref_pocs, qpd, out,
                    chain, alf_params, mot, nals, recons, bits, pool,
                    stage_times, dev)
    return decs


def _filter_frame(cfg, sps, dec, padded, poc, qp, scan_out, dpb,
                  stage_times, dev):
    """Loop filters of one reconstructed frame on the device: deblock and
    SAO, then, with ALF, one fetch of the planes, the ALF parameters
    derived on the host and the filter applied on the device; with a
    ``dpb``, its padded reference goes in.  Returns (the filter chain's
    device outputs (planes and SAO parameters), ALF parameters or
    None)."""
    lam_sao = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    with _stage("loopfilter", stage_times, dev):
        chain = lfk.finish_frame_j(
            list(scan_out[:3]), dec, qp, lam_sao, padded, ctu=cfg.ctu,
            bd=cfg.bit_depth, deblock_on=sps.deblock_enabled,
            sao_on=sps.sao_enabled)
    alf_params = None
    if sps.alf_enabled:
        with _stage("alf", stage_times, dev):
            alf_params = salf.derive_alf_frame(padded, _fetch(chain[:3]), qp,
                                               cfg.ctu, cfg.bit_depth)
            chain = tuple(lfk.apply_alf_frame(chain[:3], alf_params,
                                              cfg.ctu, cfg.bit_depth)) \
                + tuple(chain[3:])
    if dpb is not None:
        dpb[poc] = recon.pad_refs_dev(chain[:3])
    return chain, alf_params


def _emit_frame(cfg, sps, pps, dec, poc, stype, ref_pocs, qpd, scan_out,
                chain, alf_params, mot, nals, recons, bits, pool,
                stage_times, dev):
    """Tail of one frame: one fetch of its levels, tool planes and filter
    outputs, the chosen tool indices into ``dec``, then host entropy and
    NAL units (on the pool's worker when there is one)."""
    is_intra = stype == hls.SLICE_I
    with _stage("fetch", stage_times, dev):
        (ly, lcb, lcr, mtsp, lfnstp, cmodep, sbtp, cy, ccb, ccr, sao_t,
         sao_o, sao_b) = _fetch(list(scan_out[3:10]) + list(chain))
    if sps.mts_enabled:
        dec.mts8[:] = mtsp.astype(np.uint8)
    if sps.lfnst_enabled:
        dec.lfnst8[:] = lfnstp.astype(np.uint8)
    if sps.cclm_enabled:
        dec.cmode8[:] = cmodep.astype(np.uint8)
    if sps.sbt_enabled:
        dec.sbt8[:] = sbtp.astype(np.uint8)
    sh = hls.SliceHeader(poc=poc, slice_type=stype, qp_delta=qpd,
                         ref_pocs=ref_pocs, lmcs_cw=())
    rec = [cy, ccb, ccr]
    sao_params = None
    if sps.sao_enabled:
        from ..spec.sao import SaoParams
        sao_params = SaoParams(type=sao_t.astype(np.int32),
                               offsets=sao_o.astype(np.int32),
                               band_pos=sao_b.astype(np.int32))
    col = scodec.col_motion(mot, poc, ref_pocs)
    mot[poc] = scodec.motion_record(dec, ref_pocs)

    def tail():
        with _stage("entropy", stage_times):
            payload = entropy.encode_frame_syntax(
                sps, pps, sh, dec, [ly, lcb, lcr], sao_params, alf_params,
                col=col)
        cropped = scodec.crop_planes(rec, sps)
        recons[poc] = cropped
        bits[poc] = 8 * len(payload)
        tid = _tid(stype, qpd)
        return [bs.NalUnit(bs.NAL_IDR_N_LP if is_intra else bs.NAL_TRAIL,
                           payload, temporal_id=tid),
                bs.NalUnit(bs.NAL_SUFFIX_SEI,
                           hls.write_pic_hash_sei(cropped, cfg.bit_depth,
                                                  cfg.hash_type),
                           temporal_id=tid)]

    if pool is not None:
        nals.append(pool.submit(tail))
    else:
        nals.extend(tail())


def decode_sequence(data: bytes, check_hash: bool = True, device=None,
                    stage_times=None, layer_times=None):
    """Two-pass decoder: host CABAC parse of every slice, then device
    reconstruction and loop filters, one group of mutually independent
    frames (one temporal layer's B pictures, or a run of intra pictures)
    per frame-batched wave.  Returns (frames [cropped planes], sps); raises
    on a hash mismatch.  stage_times, layer_times: as in encode_sequence."""
    from ..io import streamtools
    dev = devmod.resolve(device)
    if streamtools.subpic_layout(data) is not None:
        raise ValueError("subpictures are not in this slice")
    with _stage("parse", stage_times):
        sps, pps_map, entries = _parse(data, check_hash)
    frames, dpb = {}, {}
    pending = []   # fetched after the next group's device work is queued
    i = 0
    while i < len(entries):
        grp = _dec_group(entries, i)
        sh = grp[0]["sh"]
        with _stage(f"layer {_tid(sh.slice_type, sh.qp_delta)}",
                    layer_times, dev):
            done = _decode_group(grp, sps, pps_map, dpb, dev, stage_times)
            for pe, pr in pending:
                _dec_fetch(pe, pr, sps, frames, check_hash, stage_times, dev)
        pending = done
        i += len(grp)
    for pe, pr in pending:
        _dec_fetch(pe, pr, sps, frames, check_hash, stage_times, dev)
    return [frames[p] for p in sorted(frames)], sps


def _dec_group(entries, i, cap: int = 8):
    """entries[i:j]: the longest run (at most ``cap``) with the same slice
    type, BI symmetry, QP delta and reference count in which no entry
    references another (twin of the reference decoder's grouping)."""
    def gkey(e):
        sh = e["sh"]
        return (sh.slice_type != hls.SLICE_I, scodec.bi_sym(sh),
                sh.qp_delta, len(sh.ref_pocs), sh.pps_id)

    k0 = gkey(entries[i])
    grp = [entries[i]]
    pocs = {entries[i]["sh"].poc}
    j = i + 1
    while (j < len(entries) and len(grp) < cap and gkey(entries[j]) == k0
           and not any(r in pocs for r in entries[j]["sh"].ref_pocs)):
        grp.append(entries[j])
        pocs.add(entries[j]["sh"].poc)
        j += 1
    return grp


def _parse(data: bytes, check_hash: bool):
    """Host CABAC parse of every slice: (sps, pps_map, entries) with each
    entry's slice header, decisions, level planes, SAO params and hash."""
    sps = None
    pps_map: dict[int, hls.PPS] = {}
    mot, entries = {}, []
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_SPS:
            sps = hls.SPS.read(nal.payload)
        elif nal.nal_type == bs.NAL_PPS:
            p = hls.PPS.read(nal.payload)
            _check_sps(sps, p)
            pps_map[p.pps_id] = p
        elif nal.nal_type in (bs.NAL_IDR_N_LP, bs.NAL_IDR_W_RADL,
                              bs.NAL_TRAIL, bs.NAL_CRA):
            sh, dec, levels, sao_params, alf_params = \
                entropy.parse_frame_syntax(nal.payload, sps, pps_map,
                                           motion=mot)
            mot[sh.poc] = scodec.motion_record(dec, sh.ref_pocs)
            entries.append(dict(sh=sh, dec=dec, levels=levels,
                                sao=sao_params, alf=alf_params,
                                digest=None))
        elif nal.nal_type == bs.NAL_SUFFIX_SEI and check_hash and entries:
            parsed = hls.read_pic_hash_sei(nal.payload)
            if parsed is not None:
                entries[-1]["digest"] = parsed
    return sps, pps_map, entries


def _dec_filters(e, sps, rec, qp, dpb, stage_times, dev):
    """Loop filters on the device and the DPB refresh; returns the
    filtered device planes without fetching them."""
    with _stage("loopfilter", stage_times, dev):
        if sps.deblock_enabled:
            rec = lfk.deblock_frame_j(rec, e["dec"], qp, sps.bit_depth)
        if e["sao"] is not None:
            rec = lfk.apply_sao_j(rec, e["sao"], 1 << sps.log2_ctu,
                                  sps.bit_depth)
    if e["alf"] is not None:
        with _stage("alf", stage_times, dev):
            rec = lfk.apply_alf_frame(rec, e["alf"], 1 << sps.log2_ctu,
                                      sps.bit_depth)
    dpb[e["sh"].poc] = recon.pad_refs_dev(rec)
    return rec


def _dec_fetch(e, rec, sps, frames, check_hash, stage_times, dev):
    """Blocking tail of a decoded frame: one fetch, crop, hash verify."""
    sh = e["sh"]
    with _stage("fetch", stage_times, dev):
        out = scodec.crop_planes(_fetch(rec), sps)
    frames[sh.poc] = out
    if check_hash and e["digest"] is not None:
        htype, digest = e["digest"]
        if hls.plane_hash(out, sps.bit_depth, htype) != digest:
            raise ValueError(f"decoded-picture hash mismatch at poc {sh.poc}")


def _decode_group(grp, sps, pps_map, dpb, device, stage_times):
    """Reconstruct a group of parsed frames in one frame-batched wave and
    queue their loop filters; returns [(entry, filtered device planes)]."""
    sh = grp[0]["sh"]
    qp = pps_map[sh.pps_id].init_qp + sh.qp_delta
    frs = [_wave_frame(sps, e["dec"], *e["levels"], dpb,
                       e["sh"].ref_pocs if sh.slice_type != hls.SLICE_I
                       else (), device) for e in grp]
    with _stage("wave", stage_times, device):
        outs = wave.frame_wave_batch(
            frs, frame_w=sps.width, frame_h=sps.height,
            log2_ctu=sps.log2_ctu, qp=qp, bd=sps.bit_depth, encode=False,
            **_wave_tools(sps, scodec.bi_sym(sh)))
    return [(e, _dec_filters(e, sps, list(out[:3]), qp, dpb, stage_times,
                             device)) for e, out in zip(grp, outs)]
