"""PyTorch encoder/decoder: device passes + host entropy + NAL assembly.

Twin of vvctpu/pipeline/encoder.py for this slice: all-intra, low-delay
P and random access (hierarchical B, any ``gop`` and ``intra_period``),
8- or 10-bit samples, CTU 64 or 128, uniform tile grids (every tile of every
frame of a group one member of the frame-batched wave, its motion
compensation reading the frame's full reference at the tile's offset;
decisions and loop filters over the whole frame, as in the reference)
and subpicture grids (one independent encode per subpicture, merged as
layers, as the reference's dist/subpic.py does), the default toolset
plus the multi-type tree (BT and TT splits) and VVC's intra toolset
(MTS, LFNST, ISP, MIP, MRL, CCLM) in every slice type and its inter
toolset (BCW, CIIP, GPM, affine with PROF, DMVR, BDOF, MMVD, AMVR,
SMVD, SBT; DMVR and BDOF in BI-symmetric pictures only), the
screen-content leaves of I slices at CTU 64 (intra block copy, its
block vectors from a full search on the device, coding/me.py ibc_pass;
palette, decided and derived on the host by the copied spec/palette.py,
its reconstruction scattered by the wave), dependent
quantization, transform skip, joint Cb-Cr residuals, LMCS (one model per
frame, derived on the host from the source luma and signalled in its
slice header) and ALF with CC-ALF (parameters derived on the host,
filters on the device), MCTF (the source's anchor pictures prefiltered on
the device, coding/mctf.py) and rate control (one frame per group, each
frame's QP from the bits of the frames before it), with RDOQ or the
plain quantizer.  With a mesh active (dist/shard.py use_mesh) each
wave's tiles run on the ranks of its tile axis.  All-intra
frames are reconstructed in groups of up to eight per frame-batched
wave; one temporal layer's B frames are decided frame by frame and
reconstructed in one frame-batched wave, each frame with its own LMCS
model.  The bitstreams are byte-identical to the reference engine's
and, where the spec model agrees with it, to the spec model's (at 10
bits they part: the spec model's sub-pel refinement clamps its
prediction at 8 bits).  Anything outside the slice raises.
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
from ..coding import mctf as tmctf
from ..core import bitstream as bs
from ..core import trace as _trace
from ..dist import shard
from ..dist.subpic import decode_subpics, encode_subpics, subpic_rects
from ..kernels import loopfilter as lfk
from ..spec import alf as salf
from ..spec import codec as scodec
from ..spec import hls
from ..spec import lmcs as slmcs
from ..spec import palette as splt
from ..spec import sequence as sseq
from ..spec.transform import lambda_rd_int
from . import entropy, recon, wave

# frames per frame-batched wave
_GROUP = 8


def check_config(cfg: sseq.EncoderConfig) -> None:
    """Raise ValueError for a configuration outside the port: 12 bits, and
    what the spec model refuses (CTUs other than 64 and 128, IBC or
    palette at CTU 128, IBC with tiles)."""
    bad = []
    if cfg.bit_depth not in (8, 10):
        bad.append(f"bit_depth={cfg.bit_depth}")
    if cfg.ctu not in (64, 128):
        bad.append(f"ctu={cfg.ctu}")
    elif cfg.ctu == 128 and (cfg.ibc or cfg.plt):
        bad.append("IBC or palette at CTU 128")
    if cfg.ibc and cfg.tile_cols * cfg.tile_rows > 1:
        bad.append("IBC with tiles")
    if bad:
        raise ValueError("outside the PyTorch port's slice (8 or 10 bits; "
                         "as in the spec model, CTU 64 or 128, IBC and "
                         "palette at CTU 64, no IBC with tiles): "
                         + ", ".join(bad))


def _check_sps(sps: hls.SPS, pps: hls.PPS) -> None:
    bad = []
    if sps.log2_ctu not in (6, 7) or sps.bit_depth not in (8, 10):
        bad.append("ctu/bit depth")
    if sps.log2_ctu == 7 and (sps.ibc_enabled or sps.plt_enabled):
        bad.append("IBC or palette at CTU 128")
    if bad:
        raise ValueError("stream outside the PyTorch port's slice: "
                         + ", ".join(bad))
    _check_tiles(sps, pps)


def _check_tiles(sps: hls.SPS, pps: hls.PPS) -> None:
    """Tiles and WPP are exclusive where the picture has more than one CTU
    row, and tiles and IBC always, as in the spec model."""
    tiles = pps.num_tile_cols * pps.num_tile_rows > 1
    if tiles and pps.entropy_sync and sps.height >> sps.log2_ctu > 1:
        raise ValueError("tiles + WPP combination not supported")
    if tiles and sps.ibc_enabled:
        raise ValueError("tiles + IBC combination not supported (IBC "
                         "reference area is not tile-constrained)")


def _wave_tools(sps: hls.SPS, sym: bool) -> dict:
    """frame_wave_batch's tool flags from the SPS; DMVR and BDOF apply to
    pictures whose two references are POC-symmetric (``sym``)."""
    return dict(mts=sps.mts_enabled, lfnst=sps.lfnst_enabled,
                cclm=sps.cclm_enabled, mip=sps.mip_enabled,
                ciip=sps.ciip_enabled, gpm=sps.gpm_enabled,
                affine=sps.affine_enabled, dmvr=sps.dmvr_enabled and sym,
                bdof=sps.bdof_enabled and sym, sbt=sps.sbt_enabled,
                dq=sps.dq_enabled, tskip=sps.ts_enabled,
                jccr=sps.jccr_enabled)


def _decide_tools(sps: hls.SPS, stype) -> dict:
    """The decision passes' tool flags of a slice type from the SPS."""
    kw = dict(mip=sps.mip_enabled, mrl=sps.mrl_enabled, isp=sps.isp_enabled,
              mtt=sps.mtt_enabled, tt=sps.tt_enabled)
    if stype == hls.SLICE_I:
        kw.update(ibc=sps.ibc_enabled, plt=sps.plt_enabled)
    else:
        kw.update(ciip=sps.ciip_enabled, affine=sps.affine_enabled)
    if stype == hls.SLICE_B:
        kw.update(bcw=sps.bcw_enabled, gpm=sps.gpm_enabled)
    return kw


def _lmcs_luts(cw, bd: int):
    """(forward, inverse, CRS) LUTs of an LMCS codeword model."""
    fwd, inv = slmcs.build_luts(cw, bd)
    return fwd, inv, slmcs.build_crs_lut(cw, bd)


def _wave_frame(sps, pps, dec, py, pcb, pcr, dpb, ref_pocs, device,
                luts=None, plt=None):
    """frame_wave_batch members of one frame, one per tile (the whole
    frame without tiles): each with its rect, slot tables of its part of
    the decisions, its part of the planes on the device and, for inter
    frames, the phase-A rows (per square size and per rect shape of the
    multi-type tree), the frame's padded device reference planes (three
    per list) and the tile's offset in them; with LMCS (``luts`` from
    _lmcs_luts) the frame's forward and CRS LUTs; with palette leaves
    (``plt``, the frame's three palette planes) the member's part of
    them."""
    def up(p):
        return torch.as_tensor(np.ascontiguousarray(p, np.int32),
                               device=device)

    planes = (up(py), up(pcb), up(pcr))
    pl = None if plt is None else [up(p) for p in plt]
    lut = {} if luts is None else dict(fwd_lut=up(luts[0]),
                                       crs_lut=up(luts[2]))
    rects = subpic_rects(sps.width, sps.height, pps.num_tile_cols,
                         pps.num_tile_rows, 1 << sps.log2_ctu)
    ctu = 1 << sps.log2_ctu
    members = []
    for rect in rects:
        x0, y0, x1, y1 = rect
        tdec = dec if len(rects) == 1 else scodec.tile_decisions_view(
            dec, x0, y0, x1, y1)
        fr = dict(rect=rect, py=planes[0][y0:y1, x0:x1],
                  pcb=planes[1][y0 // 2:y1 // 2, x0 // 2:x1 // 2],
                  pcr=planes[2][y0 // 2:y1 // 2, x0 // 2:x1 // 2], **lut)
        if pl is not None:
            fr["plt"] = (pl[0][y0:y1, x0:x1],
                         pl[1][y0 // 2:y1 // 2, x0 // 2:x1 // 2],
                         pl[2][y0 // 2:y1 // 2, x0 // 2:x1 // 2])
        if ref_pocs:
            fr["slots"], fr["inter"] = recon.make_slots_split(
                tdec, y1 - y0, x1 - x0, ctu)
            fr["refs"] = tuple(p for r in ref_pocs for p in dpb[r])
            fr["rox"], fr["roy"] = x0, y0
        else:
            fr["slots"] = recon.make_slots(tdec, y1 - y0, x1 - x0, ctu)
        members.append(fr)
    return members


# 8x8-granule factor of each frame_wave_batch output (recon and levels
# of Y, Cb, Cr, then the five tool planes)
_OUT_SCALE = (1, 2, 2, 1, 2, 2, 8, 8, 8, 8, 8)


def _wave(frames_m, sps, **kw):
    """frame_wave_batch over the members of several frames (_wave_frame):
    one call per tile size, with every tile of that size of every frame,
    the tiles of frame i sharing reference index i; each frame's tiles
    are then written into its full planes.  With a mesh active
    (dist/shard.py use_mesh) whose tile axis has one rank per tile, and
    every tile of one size, tile t of every frame runs on rank t
    (shard.sharded_wave).  Returns a frame_wave_batch 11-tuple per
    frame."""
    geo = {}
    for i, members in enumerate(frames_m):
        for j, m in enumerate(members):
            x0, y0, x1, y1 = m["rect"]
            geo.setdefault((x1 - x0, y1 - y0), []).append((i, j))
    mesh = shard.active_mesh()
    if (mesh is not None and len(geo) == 1
            and len(frames_m[0]) == shard.tile_ranks(mesh) > 1):
        # every tile one size and one tile per rank of the mesh's tile
        # axis (the reference's condition): tile t of every frame on rank t
        (tw, th), = geo
        res = shard.sharded_wave(mesh, frames_m, dict(
            frame_w=tw, frame_h=th, log2_ctu=sps.log2_ctu, **kw))
    else:
        res = {}
        for (tw, th), idx in geo.items():
            res.update(zip(idx, wave.frame_wave_batch(
                [dict(frames_m[i][j], ref_idx=i) for i, j in idx],
                frame_w=tw, frame_h=th, log2_ctu=sps.log2_ctu, **kw)))
    outs = []
    for i, members in enumerate(frames_m):
        if len(members) == 1:
            outs.append(res[i, 0])
            continue
        t0 = res[i, 0]
        full = [t.new_zeros((sps.height // g, sps.width // g))
                for t, g in zip(t0, _OUT_SCALE)]
        for j, m in enumerate(members):
            x0, y0, x1, y1 = m["rect"]
            for a, t, g in zip(full, res[i, j], _OUT_SCALE):
                a[y0 // g:y1 // g, x0 // g:x1 // g] = t
        outs.append(tuple(full))
    return outs


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
    order, as the reference's does (with subpictures, each subpicture's
    frames after the previous subpicture's)."""
    check_config(cfg)
    dev = devmod.resolve(device)
    if cfg.subpic_cols * cfg.subpic_rows > 1:
        # one independent encode per subpicture, one after the other on
        # the one card
        return encode_subpics(
            frames, cfg, lambda fr, c: encode_sequence(
                fr, c, device=dev, stage_times=stage_times,
                layer_times=layer_times, decisions_out=decisions_out),
            threads=False)
    if cfg.mctf:
        with _stage("mctf", stage_times, dev):
            frames = tmctf.temporal_filter(frames, cfg.gop, device=dev)
    h, w = frames[0][0].shape
    sps = cfg.make_sps(w, h)
    pps = hls.PPS(init_qp=cfg.qp, entropy_sync=cfg.wpp,
                  num_tile_cols=cfg.tile_cols, num_tile_rows=cfg.tile_rows)
    _check_tiles(sps, pps)
    nals = [bs.NalUnit(bs.NAL_SPS, sps.write()),
            bs.NalUnit(bs.NAL_PPS, pps.write())]
    recons = [None] * len(frames)
    bits = [None] * len(frames)
    # poc -> padded filtered recon planes on the device (none in
    # all-intra, where no picture is referenced)
    dpb = None if cfg.intra_period == 1 else {}
    mot = {}   # poc -> motion_record (TMVP side table)
    plan = sseq.gop_plan(len(frames), cfg.intra_period, cfg.gop)
    # rate control: each frame's QP offset comes from the bits of the
    # frames coded before it, so every group is one frame
    rc = sseq.RateControl(cfg.rc_bits_per_frame) \
        if cfg.rc_bits_per_frame > 0 else None
    # host entropy of frame i overlaps the device passes of frame i + 1;
    # one worker keeps coding order (syntax tracing needs the main thread)
    pool = None if _trace.enabled else ThreadPoolExecutor(max_workers=1)
    try:
        pi = 0
        while pi < len(plan):
            grp = _b_group(plan, pi, all_intra=dpb is None,
                           cap=1 if rc is not None else _GROUP)
            pi += len(grp)
            _, stype, _, qpd = grp[0]
            # the temporal sublayer follows the GOP plan's QP delta, before
            # the rate controller's offset
            tid = _tid(stype, qpd)
            if rc is not None:
                qpd = max(0, min(63 - cfg.qp, qpd + rc.qp_offset()))
            with _stage(f"layer {tid}", layer_times, dev):
                decs = _encode_group(frames, cfg, sps, pps, grp, qpd, tid,
                                     dpb, mot, nals, recons, bits, pool,
                                     stage_times, dev)
            if rc is not None:
                # the frame's bits exist once its entropy job is done (the
                # overlap with the next frame is lost, as in the reference)
                if hasattr(nals[-1], "result"):
                    nals[-1].result()
                rc.update(bits[grp[0][0]])
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


def _b_group(plan, i, all_intra: bool = False, cap: int = _GROUP):
    """Maximal run plan[i:j], at most ``cap`` long, of mutually-independent
    entries: in all-intra, consecutive I entries; otherwise B entries
    with equal qp_delta and equal BI symmetry — the frames of one
    temporal layer under the breadth-first GOP plan (twin of the
    reference's)."""
    if all_intra:
        return plan[i:i + cap]
    p0, s0, r0, q0 = plan[i]
    if s0 != hls.SLICE_B or len(r0) != 2:
        return plan[i:i + 1]
    grp = [plan[i]]
    pocs = {p0}
    for j in range(i + 1, min(len(plan), i + cap)):
        poc, stype, refs, qpd = plan[j]
        if (stype != hls.SLICE_B or len(refs) != 2 or qpd != q0
                or _sym(poc, refs) != _sym(p0, r0)
                or any(r in pocs for r in refs)):
            break
        grp.append(plan[j])
        pocs.add(poc)
    return grp


def _encode_group(frames, cfg, sps, pps, grp, qpd, tid, dpb, mot, nals,
                  recons, bits, pool, stage_times, dev):
    """Encode plan entries that share slice type and QP and reference no
    picture among themselves, at QP cfg.qp + ``qpd`` in temporal sublayer
    ``tid``: the decisions of every frame (on the unmapped source), with
    LMCS each frame's model from its source luma, one frame-batched wave
    (on the mapped source luma), then each frame's loop filters and
    entropy.  ``dpb`` is None in all-intra.  Returns the frames'
    decisions."""
    qp = cfg.qp + qpd
    decs, padded_l, frs, models = [], [], [], []
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
        cw, luts, py = (), None, padded[0]
        if sps.lmcs_enabled:
            with _stage("lmcs", stage_times):
                cw = slmcs.derive_model(padded[0], cfg.bit_depth)
                luts = _lmcs_luts(cw, cfg.bit_depth)
                py = luts[0][padded[0]]
        models.append((cw, None if luts is None else luts[1]))
        pplanes = None
        if sps.plt_enabled and stype == hls.SLICE_I:
            # each palette leaf's entries and index map from the luma the
            # wave codes (mapped under LMCS), as its recon planes
            with _stage("palette", stage_times):
                splt.derive_plt_data(dec, py, padded[1], padded[2],
                                     cfg.bit_depth)
                pplanes = splt.build_planes(dec.plt_data or {}, sps.height,
                                            sps.width)
        frs.append(_wave_frame(sps, pps, dec, py, padded[1], padded[2],
                               dpb, ref_pocs, dev, luts, pplanes))
    with _stage("wave", stage_times, dev):
        outs = _wave(frs, sps, qp=qp, bd=cfg.bit_depth, encode=True,
                     rdoq=cfg.rdoq, lam_rd=lambda_rd_int(qp),
                     **_wave_tools(sps, _sym(grp[0][0], grp[0][2])))
    # every frame's filters are launched before the group's first entropy
    # job starts on the worker thread, which would slow their many small
    # launches on this one (1080p all-intra on an H100: 9 s against 0.1 s)
    chains = [_filter_frame(cfg, sps, dec, padded, e[0], qp, out, dpb,
                            stage_times, dev, inv_lut)
              for e, dec, padded, out, (_, inv_lut) in zip(
                  grp, decs, padded_l, outs, models)]
    for (poc, stype, ref_pocs, _), dec, out, (chain, alf_params), (cw, _) \
            in zip(grp, decs, outs, chains, models):
        _emit_frame(cfg, sps, pps, dec, poc, stype, ref_pocs, qpd, tid, out,
                    chain, alf_params, cw, mot, nals, recons, bits, pool,
                    stage_times, dev)
    return decs


def _filter_frame(cfg, sps, dec, padded, poc, qp, scan_out, dpb,
                  stage_times, dev, inv_lut=None):
    """Loop filters of one reconstructed frame on the device: with LMCS
    the luma's inverse mapping (``inv_lut``), deblock and SAO, then, with
    ALF, one fetch of the planes, the ALF parameters derived on the host
    (against the unmapped source ``padded``) and the filter applied on
    the device; with a ``dpb``, its padded reference goes in.  Returns
    (the filter chain's device outputs (planes and SAO parameters), ALF
    parameters or None)."""
    lam_sao = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    with _stage("loopfilter", stage_times, dev):
        chain = lfk.finish_frame_j(
            list(scan_out[:3]), dec, qp, lam_sao, padded, inv_lut=inv_lut,
            ctu=cfg.ctu, bd=cfg.bit_depth, deblock_on=sps.deblock_enabled,
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


def _emit_frame(cfg, sps, pps, dec, poc, stype, ref_pocs, qpd, tid,
                scan_out, chain, alf_params, lmcs_cw, mot, nals, recons, bits,
                pool, stage_times, dev):
    """Tail of one frame: one fetch of its levels, tool planes and filter
    outputs, the chosen tool indices into ``dec``, then host entropy and
    NAL units of temporal sublayer ``tid`` (on the pool's worker when
    there is one); ``lmcs_cw`` is the frame's LMCS model for its slice
    header (() without LMCS)."""
    is_intra = stype == hls.SLICE_I
    with _stage("fetch", stage_times, dev):
        (ly, lcb, lcr, mtsp, lfnstp, cmodep, sbtp, jccrp, cy, ccb, ccr,
         sao_t, sao_o, sao_b) = _fetch(list(scan_out[3:11]) + list(chain))
    # the transform index plane carries transform skip (index 5) too
    if sps.mts_enabled or sps.ts_enabled:
        dec.mts8[:] = mtsp.astype(np.uint8)
    if sps.lfnst_enabled:
        dec.lfnst8[:] = lfnstp.astype(np.uint8)
    if sps.cclm_enabled:
        dec.cmode8[:] = cmodep.astype(np.uint8)
    if sps.sbt_enabled:
        dec.sbt8[:] = sbtp.astype(np.uint8)
    if sps.jccr_enabled:
        dec.jccr8[:] = jccrp.astype(np.uint8)
    sh = hls.SliceHeader(poc=poc, slice_type=stype, qp_delta=qpd,
                         ref_pocs=ref_pocs, lmcs_cw=lmcs_cw)
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
        # the syntax trace's picture (the copied entropy coder does not set
        # it; the spec model's frame coder does)
        _trace.set_poc(poc)
        with _stage("entropy", stage_times):
            payload = entropy.encode_frame_syntax(
                sps, pps, sh, dec, [ly, lcb, lcr], sao_params, alf_params,
                col=col)
        cropped = scodec.crop_planes(rec, sps)
        recons[poc] = cropped
        bits[poc] = 8 * len(payload)
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


def slice_qps(data: bytes) -> dict:
    """poc -> the QP of its slice, read from the slice headers of a stream
    (rate control moves it off the GOP plan's; with subpictures, the
    last layer's)."""
    init_qp, qps = {}, {}
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_PPS:
            p = hls.PPS.read(nal.payload)
            init_qp[p.pps_id] = p.init_qp
        elif nal.nal_type in (bs.NAL_IDR_N_LP, bs.NAL_IDR_W_RADL,
                              bs.NAL_TRAIL, bs.NAL_CRA):
            sh = hls.SliceHeader.read(bs.BitReader(nal.payload))
            qps[sh.poc] = init_qp[sh.pps_id] + sh.qp_delta
    return qps


def decode_sequence(data: bytes, check_hash: bool = True, device=None,
                    stage_times=None, layer_times=None):
    """Two-pass decoder: host CABAC parse of every slice, then device
    reconstruction and loop filters, one group of mutually independent
    frames (one temporal layer's B pictures, or a run of intra pictures)
    per frame-batched wave.  Returns (frames [cropped planes], sps); raises
    on a hash mismatch.  stage_times, layer_times: as in encode_sequence."""
    from ..io import streamtools
    dev = devmod.resolve(device)
    layout = streamtools.subpic_layout(data)
    if layout is not None:
        return decode_subpics(
            data, layout, lambda d, ch: decode_sequence(
                d, check_hash=ch, device=dev, stage_times=stage_times,
                layer_times=layer_times), check_hash)
    with _stage("parse", stage_times):
        sps, pps_map, entries = _parse(data, check_hash)
    frames, dpb = {}, {}
    pending = []   # fetched after the next group's device work is queued
    i = 0
    while i < len(entries):
        grp = _dec_group(entries, i)
        with _stage(f"layer {grp[0]['tid']}", layer_times, dev):
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
    type, BI symmetry, QP delta, reference count and LMCS use in which no
    entry references another (twin of the reference decoder's grouping;
    the frames of a group may carry different LMCS models)."""
    def gkey(e):
        sh = e["sh"]
        return (sh.slice_type != hls.SLICE_I, scodec.bi_sym(sh),
                sh.qp_delta, len(sh.ref_pocs), bool(sh.lmcs_cw),
                sh.pps_id)

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
            if _trace.enabled:
                _trace.set_poc(hls.SliceHeader.read(
                    bs.BitReader(nal.payload)).poc)
            sh, dec, levels, sao_params, alf_params = \
                entropy.parse_frame_syntax(nal.payload, sps, pps_map,
                                           motion=mot)
            mot[sh.poc] = scodec.motion_record(dec, sh.ref_pocs)
            entries.append(dict(sh=sh, dec=dec, levels=levels,
                                sao=sao_params, alf=alf_params,
                                digest=None, tid=nal.temporal_id))
        elif nal.nal_type == bs.NAL_SUFFIX_SEI and check_hash and entries:
            parsed = hls.read_pic_hash_sei(nal.payload)
            if parsed is not None:
                entries[-1]["digest"] = parsed
    return sps, pps_map, entries


def _dec_filters(e, sps, rec, qp, dpb, stage_times, dev, inv_lut=None):
    """Loop filters on the device (after the LMCS inverse mapping of the
    luma through ``inv_lut``, when the slice has a model) and the DPB
    refresh; returns the filtered device planes without fetching them."""
    with _stage("loopfilter", stage_times, dev):
        if inv_lut is not None:
            rec = [lfk.inverse_map(rec[0], inv_lut)] + list(rec[1:])
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
    """Reconstruct a group of parsed frames in one frame-batched wave
    (each with the LMCS model of its slice header) and queue their loop
    filters; returns [(entry, filtered device planes)]."""
    sh = grp[0]["sh"]
    qp = pps_map[sh.pps_id].init_qp + sh.qp_delta
    luts = [_lmcs_luts(e["sh"].lmcs_cw, sps.bit_depth)
            if e["sh"].lmcs_cw else None for e in grp]
    intra = sh.slice_type == hls.SLICE_I
    frs = [_wave_frame(sps, pps_map[e["sh"].pps_id], e["dec"],
                       *e["levels"], dpb,
                       () if intra else e["sh"].ref_pocs, device, lt,
                       splt.build_planes(e["dec"].plt_data, sps.height,
                                         sps.width)
                       if intra and sps.plt_enabled and e["dec"].plt_data
                       else None)
           for e, lt in zip(grp, luts)]
    with _stage("wave", stage_times, device):
        outs = _wave(frs, sps, qp=qp, bd=sps.bit_depth, encode=False,
                     **_wave_tools(sps, scodec.bi_sym(sh)))
    return [(e, _dec_filters(e, sps, list(out[:3]), qp, dpb, stage_times,
                             device, None if lt is None else lt[1]))
            for e, out, lt in zip(grp, outs, luts)]
