"""PyTorch encoder/decoder: device passes + host entropy + NAL assembly.

Twin of vvctpu/pipeline/encoder.py for this slice: I and P frames
(``gop == 1``, any ``intra_period``), one tile, the default toolset.  The
bitstreams are byte-identical to the reference engine's and to the spec
model's.  Anything outside the slice raises.
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
from ..spec import codec as scodec
from ..spec import hls
from ..spec import sequence as sseq
from ..spec.transform import lambda_rd_int
from . import entropy, recon, wave

# EncoderConfig / SPS tool flags this slice leaves off
_OFF_TOOLS = ("mts", "mip", "mrl", "tskip", "jccr", "mmvd", "dmvr", "bcw",
              "amvr", "smvd", "ciip", "sbt", "bdof", "isp", "gpm", "affine",
              "lfnst", "cclm", "dq", "mtt", "tt", "ibc", "plt", "lmcs", "alf",
              "mctf")
_SPS_OFF = ("mts", "lfnst", "mip", "mrl", "ts", "jccr", "mmvd", "bcw",
            "amvr", "smvd", "ciip", "sbt", "dmvr", "bdof", "isp", "gpm",
            "affine", "dq", "mtt", "tt", "ibc", "plt", "cclm", "lmcs", "alf")


def check_config(cfg: sseq.EncoderConfig) -> None:
    """Raise ValueError for a configuration outside this slice."""
    bad = [t for t in _OFF_TOOLS if getattr(cfg, t)]
    if cfg.gop != 1:
        bad.append(f"gop={cfg.gop}")
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
        raise ValueError("outside the PyTorch port's slice (low-delay P, "
                         "default toolset): " + ", ".join(bad))


def _check_sps(sps: hls.SPS, pps: hls.PPS) -> None:
    bad = [t for t in _SPS_OFF if getattr(sps, f"{t}_enabled")]
    if sps.log2_ctu != 6 or sps.bit_depth != 8:
        bad.append("ctu/bit depth")
    if pps.num_tile_cols * pps.num_tile_rows != 1:
        bad.append("tiles")
    if bad:
        raise ValueError("stream outside the PyTorch port's slice: "
                         + ", ".join(bad))


def _run_scan(sps, dec, py, pcb, pcr, dpb, ref_pocs, scan_kw, device):
    """Reconstruct one frame (single tile) on the device; returns
    frame_wave's (recon y/cb/cr, levels y/cb/cr).  dpb values are padded
    device ref 3-tuples."""
    is_p = bool(ref_pocs)
    kw = {}
    if is_p:
        slots, isl = recon.make_slots_split(dec, sps.height, sps.width,
                                            1 << sps.log2_ctu)
        kw.update(refs=dpb[ref_pocs[0]], inter=isl)
    else:
        slots = recon.make_slots(dec, sps.height, sps.width,
                                 1 << sps.log2_ctu)

    def up(p):
        return torch.as_tensor(np.ascontiguousarray(p, np.int32),
                               device=device)

    return wave.frame_wave(slots, up(py), up(pcb), up(pcr),
                           frame_w=sps.width, frame_h=sps.height,
                           log2_ctu=sps.log2_ctu, inter_enabled=is_p,
                           **kw, **scan_kw)


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
                    stage_times=None):
    """Encode planes [[y, cb, cr], ...] with ``cfg``; returns (annex-B
    bytes, cropped recon planes, bits per frame).  stage_times: optional
    dict that receives the wall seconds of each pipeline stage."""
    check_config(cfg)
    dev = devmod.resolve(device)
    h, w = frames[0][0].shape
    sps = cfg.make_sps(w, h)
    pps = hls.PPS(init_qp=cfg.qp, entropy_sync=cfg.wpp)
    nals = [bs.NalUnit(bs.NAL_SPS, sps.write()),
            bs.NalUnit(bs.NAL_PPS, pps.write())]
    recons = [None] * len(frames)
    bits = [None] * len(frames)
    dpb = {}   # poc -> padded filtered recon planes on the device
    mot = {}   # poc -> motion_record (TMVP side table)
    # host entropy of frame i overlaps the device passes of frame i + 1;
    # one worker keeps coding order (syntax tracing needs the main thread)
    pool = None if _trace.enabled else ThreadPoolExecutor(max_workers=1)
    try:
        for poc, stype, ref_pocs, qpd in sseq.gop_plan(
                len(frames), cfg.intra_period, cfg.gop):
            padded = scodec.pad_planes(frames[poc], sps)
            qp = cfg.qp + qpd
            if stype == hls.SLICE_P and abs(poc - ref_pocs[0]) != 1:
                raise ValueError("references more than one frame away are "
                                 "not in this slice")
            with _stage("decide", stage_times, dev):
                if stype == hls.SLICE_I:
                    dec = tdecide.decide_frame(padded[0], qp, cfg.bit_depth,
                                               device=dev)
                else:
                    dec = tdecide.decide_frame_p(
                        padded[0], dpb[ref_pocs[0]][0], qp, cfg.bit_depth,
                        device=dev)
            scan_kw = dict(qp=qp, bd=cfg.bit_depth, encode=True,
                           rdoq=cfg.rdoq, lam_rd=lambda_rd_int(qp))
            with _stage("wave", stage_times, dev):
                out = _run_scan(sps, dec, padded[0], padded[1], padded[2],
                                dpb, ref_pocs, scan_kw, dev)
            _finish_frame(cfg, sps, pps, dec, padded, poc, stype, ref_pocs,
                          qpd, qp, out, dpb, mot, nals, recons, bits, pool,
                          stage_times, dev)
        flat = []
        for n in nals:
            flat.extend(n.result() if hasattr(n, "result") else [n])
    finally:
        if pool is not None:
            pool.shutdown()
    return bs.write_annexb(flat), recons, bits


def _finish_frame(cfg, sps, pps, dec, padded, poc, stype, ref_pocs, qpd,
                  qp, scan_out, dpb, mot, nals, recons, bits, pool,
                  stage_times, dev):
    """Post-scan tail of one frame: loop filters on the device, the padded
    reference into the DPB, one fetch, then host entropy and NAL units
    (on the pool's worker when there is one)."""
    is_intra = stype == hls.SLICE_I
    lam_sao = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    with _stage("loopfilter", stage_times, dev):
        chain = lfk.finish_frame_j(
            list(scan_out[:3]), dec, qp, lam_sao, padded, ctu=cfg.ctu,
            bd=cfg.bit_depth, deblock_on=sps.deblock_enabled,
            sao_on=sps.sao_enabled)
        dpb[poc] = recon.pad_refs_dev(chain[:3])
    with _stage("fetch", stage_times, dev):
        ly, lcb, lcr, cy, ccb, ccr, sao_t, sao_o, sao_b = _fetch(
            list(scan_out[3:6]) + list(chain))
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
                sps, pps, sh, dec, [ly, lcb, lcr], sao_params, None, col=col)
        cropped = scodec.crop_planes(rec, sps)
        recons[poc] = cropped
        bits[poc] = 8 * len(payload)
        return [bs.NalUnit(bs.NAL_IDR_N_LP if is_intra else bs.NAL_TRAIL,
                           payload, temporal_id=0),
                bs.NalUnit(bs.NAL_SUFFIX_SEI,
                           hls.write_pic_hash_sei(cropped, cfg.bit_depth,
                                                  cfg.hash_type),
                           temporal_id=0)]

    if pool is not None:
        nals.append(pool.submit(tail))
    else:
        nals.extend(tail())


def decode_sequence(data: bytes, check_hash: bool = True, device=None,
                    stage_times=None):
    """Two-pass decoder: host CABAC parse of every slice, then per-frame
    device reconstruction and loop filters.  Returns (frames [cropped
    planes], sps); raises on a hash mismatch.  stage_times: as in
    encode_sequence."""
    from ..io import streamtools
    dev = devmod.resolve(device)
    if streamtools.subpic_layout(data) is not None:
        raise ValueError("subpictures are not in this slice")
    with _stage("parse", stage_times):
        sps, pps_map, entries = _parse(data, check_hash)
    frames, dpb = {}, {}
    pending = None   # fetched after the next frame's device work is queued
    for e in entries:
        rec = _decode_one(e, sps, pps_map, dpb, dev, stage_times)
        if pending is not None:
            _dec_fetch(*pending, sps, frames, check_hash, stage_times, dev)
        pending = (e, rec)
    if pending is not None:
        _dec_fetch(*pending, sps, frames, check_hash, stage_times, dev)
    return [frames[p] for p in sorted(frames)], sps


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
            sh, dec, levels, sao_params, _alf = entropy.parse_frame_syntax(
                nal.payload, sps, pps_map, motion=mot)
            if sh.slice_type == hls.SLICE_B:
                raise ValueError("B slices are not in this slice")
            mot[sh.poc] = scodec.motion_record(dec, sh.ref_pocs)
            entries.append(dict(sh=sh, dec=dec, levels=levels,
                                sao=sao_params, digest=None))
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


def _decode_one(e, sps, pps_map, dpb, device, stage_times):
    sh, dec, levels = e["sh"], e["dec"], e["levels"]
    qp = pps_map[sh.pps_id].init_qp + sh.qp_delta
    is_p = sh.slice_type != hls.SLICE_I
    scan_kw = dict(qp=qp, bd=sps.bit_depth, encode=False)
    with _stage("wave", stage_times, device):
        ry, rcb, rcr, _, _, _ = _run_scan(sps, dec, levels[0], levels[1],
                                     levels[2], dpb,
                                     sh.ref_pocs if is_p else (), scan_kw,
                                     device)
    return _dec_filters(e, sps, [ry, rcb, rcr], qp, dpb, stage_times,
                        device)
