"""Wavefront reconstruction — twin of vvctpu/pipeline/wave.py.

The host orders phase-B leaves into dependency levels: a leaf runs after
every leaf that produces a reference sample available to it (z-order
availability).  The device then runs one batch per (level, leaf class)
and scatters the block results into the recon buffers.  Phase A (every
inter leaf, which depends on nothing in the current frame) runs first.
One engine: an eager loop over the schedule, with the intra toolset
(MIP, MRL, ISP, MTS, LFNST, CCLM) and CIIP on the phase-B leaves,
VVC's inter toolset (BCW, GPM, DMVR, BDOF, affine, SBT) in phase A, and
dependent quantization in every leaf class.  It runs F
mutually independent frames at once (one temporal layer's B frames): the
buffers carry a leading frame axis, every row its frame index, and the
frames' schedules merge by (level, class), so one launch sequence covers
a level of every frame.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rom
from ..device import const
from ..kernels import intra_pred, mc, transform
from ..spec.codec import isp_kernels, isp_parts
from . import plan as planmod
from . import recon
from .recon import MARGIN

# ---------------------------------------------------------------------------
# host: wave schedule
# ---------------------------------------------------------------------------

_MAX_BATCH = 128

# phase-B leaf batches run since the caller last set this to 0 (each is
# one eager launch sequence; the host-bound wave's cost is their number)
batches = 0


def _op_class(op: int, ip: int):
    """(kind, w, h, d) for a phase-B slot op, or None for skip / phase-A."""
    if op in (1, 2, 3):
        s = 8 << (op - 1)
        if ip > 0:
            return ("isp", s, s, ip)
        return ("intra", s, s, 0)
    if op in (7, 8, 9):
        return ("ciip", 8 << (op - 7), 8 << (op - 7), 0)
    if planmod.OP_RECT_INTRA0 <= op < planmod.OP_RECT_INTRA0 + 6:
        w, h = planmod.RECT_SHAPES[op - planmod.OP_RECT_INTRA0]
        return ("rect", w, h, 0)
    if planmod.OP_IBC0 <= op < planmod.OP_IBC0 + 3:
        s = 8 << (op - planmod.OP_IBC0)
        return ("ibc", s, s, 0)
    if planmod.OP_PLT0 <= op < planmod.OP_PLT0 + 3:
        s = 8 << (op - planmod.OP_PLT0)
        return ("plt", s, s, 0)
    return None


def _levels_py(slots: np.ndarray, frame_h: int, frame_w: int) -> np.ndarray:
    """Python reference leveller (fallback when native/wave.c is absent)."""
    gH, gW = frame_h // 8, frame_w // 8
    lvl_map = np.zeros((gH, gW), np.int32)
    lv_out = np.zeros(slots.shape[0], np.int32)
    for i in range(slots.shape[0]):
        cls = _op_class(int(slots[i, 0]), int(slots[i, 15]))
        if cls is None:
            continue
        kind, w, h, _ = cls
        x, y = int(slots[i, 1]), int(slots[i, 2])
        n = w + h
        lv = 0
        gy = y // 8 - 1
        if gy >= 0:
            gx0 = max((x - 8) // 8, 0)
            gx1 = min((x + n) // 8, gW - 1)
            lv = int(lvl_map[gy, gx0:gx1 + 1].max())
        gx = x // 8 - 1
        if gx >= 0:
            gy0 = max((y - 8) // 8, 0)
            gy1 = min((y + n) // 8, gH - 1)
            lv = max(lv, int(lvl_map[gy0:gy1 + 1, gx].max()))
        if kind == "ibc":
            sx = min(max(x + int(slots[i, 4]), 0), frame_w - w)
            sy = min(max(y + int(slots[i, 5]), 0), frame_h - h)
            lv = max(lv, int(lvl_map[sy // 8:(sy + h - 1) // 8 + 1,
                                     sx // 8:(sx + w - 1) // 8 + 1].max()))
        lv += 1
        lvl_map[y // 8:(y + h - 1) // 8 + 1, x // 8:(x + w - 1) // 8 + 1] = lv
        lv_out[i] = lv
    return lv_out


# per-op class geometry tables (0 width = not phase-B); isp resolved from
# the slot's ip column at lookup time
_NOPS = 28
_KIND_RANK = {"ciip": 0, "ibc": 1, "intra": 2, "isp": 3, "plt": 4,
              "rect": 5}


def _op_tables():
    W = np.zeros(_NOPS, np.int32)
    H = np.zeros(_NOPS, np.int32)
    IBC = np.zeros(_NOPS, np.int32)
    KIND = np.zeros(_NOPS, np.int32)      # _KIND_RANK id (isp via ip)
    for op in range(_NOPS):
        cls = _op_class(op, 0)
        if cls is None:
            continue
        kind, w, h, _ = cls
        W[op], H[op] = w, h
        IBC[op] = int(kind == "ibc")
        KIND[op] = _KIND_RANK[kind]
    return W, H, IBC, KIND


_OPT = _op_tables()


def _levels_c(slots: np.ndarray, frame_h: int, frame_w: int):
    """Native leveller via native/wave.c (None if the .so lacks it)."""
    import ctypes

    from ..cabac import native as cnative
    lib = cnative._load()
    fn = getattr(lib, "vvc_wave_levels", None) if lib is not None else None
    if fn is None:
        return None
    W, H, IBC, _ = _OPT
    ops = slots[:, 0]
    geom = np.empty((slots.shape[0], 3), np.int32)
    geom[:, 0] = W[ops]
    geom[:, 1] = H[ops]
    geom[:, 2] = IBC[ops]
    gH, gW = frame_h // 8, frame_w // 8
    lvl_map = np.zeros(gH * gW, np.int32)
    lv_out = np.empty(slots.shape[0], np.int32)
    sl = np.ascontiguousarray(slots, np.int32)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                   ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn(sl.ctypes.data, sl.shape[0], sl.shape[1], geom.ctypes.data,
       gH, gW, frame_w, frame_h, lvl_map.ctypes.data, lv_out.ctypes.data)
    return lv_out


def build_schedule(slots: np.ndarray, frame_h: int, frame_w: int):
    """Order one frame's phase-B leaves into dependency waves.

    Returns [(cls, rows)] in execution order: cls = (kind, w, h, d), rows a
    (k, 16) int32 array of the slot rows in that batch.  Leaves in one batch
    are mutually independent; every leaf's available reference region
    (top/left strips incl. above-right and below-left reach, plus the IBC
    source rect) is produced by strictly earlier batches."""
    return [(cls, rows[:, :16])
            for cls, rows in build_schedule_batch([slots], frame_h, frame_w)]


def build_schedule_batch(slot_list, frame_h: int, frame_w: int):
    """build_schedule over F independent frames: each frame is levelled
    on its own, then all rows merge by (level, class), so one batch holds
    the leaves of that level and class of every frame.  Rows are (k, 17):
    the slot row plus its frame index.  Batches hold at most _MAX_BATCH
    rows per frame.

    Levelling runs in C (native/wave.c) with a Python fallback; grouping is
    vectorised (a stable sort by (level, class) keeps frame order, then
    coding order, inside each batch, identical to the per-leaf reference
    loop for one frame)."""
    W, H, _, KIND = _OPT
    keys, rows = [], []
    for f, slots in enumerate(slot_list):
        slots = np.asarray(slots)
        lv = _levels_c(slots, frame_h, frame_w)
        if lv is None:
            lv = _levels_py(slots, frame_h, frame_w)
        sel = np.nonzero(lv > 0)[0]
        ops = slots[sel, 0]
        ips = np.where((ops >= 1) & (ops <= 3), slots[sel, 15], 0)
        kind = np.where(ips > 0, _KIND_RANK["isp"], KIND[ops])
        d = np.where(ips > 0, ips, 0)
        # combined sort key: (level, kind-rank, w, h, d)
        keys.append((lv[sel].astype(np.int64) << 32)
                    | (kind.astype(np.int64) << 24)
                    | (W[ops].astype(np.int64) << 16)
                    | (H[ops].astype(np.int64) << 8) | d.astype(np.int64))
        rows.append(np.concatenate(
            [slots[sel], np.full((sel.size, 1), f, np.int32)], axis=1))
    key = np.concatenate(keys)
    if key.size == 0:
        return []
    rows = np.concatenate(rows).astype(np.int32)
    order = np.argsort(key, kind="stable")
    key_o = key[order]
    rows_o = rows[order]
    bounds = np.nonzero(np.diff(key_o))[0] + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [key_o.size]])
    inv_kind = {v: k for k, v in _KIND_RANK.items()}
    cap = _MAX_BATCH * len(slot_list)
    out = []
    for s0, e0 in zip(starts, ends):
        k = int(key_o[s0])
        cls = (inv_kind[(k >> 24) & 0xFF], (k >> 16) & 0xFF,
               (k >> 8) & 0xFF, k & 0xFF)
        for c0 in range(s0, e0, cap):
            out.append((cls, rows_o[c0:min(c0 + cap, e0)]))
    return out


# ---------------------------------------------------------------------------
# device: leaf batches
# ---------------------------------------------------------------------------


_scatter = recon._scatter
_comp_local = recon._component
_gather = recon._gather


def _scatter8(plane, vals, f, xs, ys):
    """plane[f, ys // 8, xs // 8] = vals: a leaf's tool index at its
    top-left 8x8 granule."""
    plane[f.long(), (ys // 8).long(), (xs // 8).long()] = vals


def _chroma_leaf(carry, rec_y, f, x, y, mode_dm, cmode, *, s: int,
                 frame_w: int, frame_h: int, n_ctu_x: int, log2_ctu: int,
                 qp: int, bd: int, encode: bool, rdoq: bool, lam_rd: int,
                 cclm: bool, dq: bool = False):
    """Chroma part of a batch of B square intra leaves: DM prediction or,
    with ``cclm``, the RD choice between DM and CCLM (encode) or the
    signalled choice ``cmode`` (decode); separate Cb/Cr residuals.  Cb
    and Cr run as one batch of 2B rows over the stacked chroma planes
    (Cb frames, then Cr frames).  Returns (rec, lev, use_cclm or None),
    rec and lev (2B, s/2, s/2) with the Cb rows first."""
    cs = s // 2
    F = carry["bcb"].shape[0]
    cx2, cy2 = x // 2, y // 2
    x2, y2, f2 = (torch.cat([cx2, cx2]), torch.cat([cy2, cy2]),
                  torch.cat([f, f + F]))
    top, left = intra_pred.build_references(
        carry["bc"], x2, y2, s=cs, is_luma=False, frame_w=frame_w // 2,
        frame_h=frame_h // 2, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd,
        f=f2)
    pred = intra_pred.predict(top, left, torch.cat([mode_dm, mode_dm]),
                              s=cs, is_luma=False, bd=bd)
    use_c = None
    if cclm:
        lm = torch.cat(intra_pred.cclm_predict_pair(
            carry["by"], (carry["bcb"], carry["bcr"]), rec_y, cx2, cy2,
            cs=cs, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd, f=f))
        if encode:
            B = x.shape[0]
            src = _gather(carry["sc"], f2, x2, y2, cs, cs)
            lev_cb, lev_cr, rcb, rcr, use_c = recon.chroma_rd(
                src[:B], src[B:], [(pred[:B], pred[B:]), (lm[:B], lm[B:])],
                cs, qp, bd, rdoq, lam_rd, dq)
            return (torch.cat([rcb, rcr]), torch.cat([lev_cb, lev_cr]),
                    use_c)
        pred = torch.where((torch.cat([cmode, cmode]) > 0)[:, None, None],
                           lm, pred)
    rec, lev = _comp_local(carry["sc"], pred, f2, x2, y2, cs, cs, qp, bd,
                           encode, rdoq, lam_rd, dq)
    return rec, lev, use_c


def _put_leaf(carry, f, x, y, s: int, rec_y, lev_y, chroma, encode: bool,
              midx=None, lidx=None):
    """Scatter a batch of square leaves' recon (and, encoding, levels and
    tool indices) into the carry, in place."""
    rec_c, lev_c, use_c = chroma
    cs = s // 2
    F = carry["bcb"].shape[0]
    x2, y2, f2 = (torch.cat([x // 2, x // 2]), torch.cat([y // 2, y // 2]),
                  torch.cat([f, f + F]))
    _scatter(carry["by"], rec_y, f, x, y, s, s, 1)
    _scatter(carry["bc"], rec_c, f2, x2, y2, cs, cs, 1)
    if not encode:
        return
    _scatter(carry["ly"], lev_y, f, x, y, s, s, 0)
    _scatter(carry["lc"], lev_c, f2, x2, y2, cs, cs, 0)
    if midx is not None:
        _scatter8(carry["mtsp"], midx, f, x, y)
        _scatter8(carry["lfnstp"], lidx, f, x, y)
    if use_c is not None:
        _scatter8(carry["cmodep"], use_c, f, x, y)


def _intra_batch(carry, rows, host, qp: int, lam_rd: int, *, s: int,
                 frame_w: int, frame_h: int, log2_ctu: int, bd: int,
                 encode: bool, rdoq: bool, mts: bool = False,
                 lfnst: bool = False, cclm: bool = False, mip: bool = False,
                 dq: bool = False):
    """One dependency level's square intra s-leaves (of any frames):
    predict (angular on the row's reference line, or MIP), code and
    reconstruct luma (with the MTS/LFNST choice) and chroma, scatter into
    the carry (in place).  rows: (k, 17) device rows, frame index in
    column 16; host: the same rows on the host, which skip the tools no
    row of the batch uses."""
    x, y, mode, f = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 16]
    nm = rom.NUM_LUMA_MODE
    n_ctu_x = frame_w >> log2_ctu
    mrl = rows[:, 9] if host[:, 9].any() else None
    top, left = intra_pred.build_references(
        carry["by"], x, y, s=s, is_luma=True, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd, f=f,
        ref_line=mrl)
    mode_reg = mode.clamp(max=nm - 1)
    pred_y = intra_pred.predict(top, left, mode_reg, s=s, is_luma=True,
                                bd=bd, ref_line=mrl)
    mode_dm = mode
    if mip and (host[:, 3] >= nm).any():
        is_mip = mode >= nm
        pred_y = torch.where(is_mip[:, None, None], intra_pred.mip_predict(
            top, left, mode - nm, s=s, bd=bd), pred_y)
        mode_dm = torch.where(is_mip, rom.PLANAR_IDX, mode)
    midx = lidx = None
    if (mts or lfnst) and encode:
        resi = _gather(carry["sy"], f, x, y, s, s) - pred_y
        midx, lidx, lev_y, rres = transform.choose_tx(
            resi, s, qp, lam_rd, mode_reg, bd, mts=mts, lfnst=lfnst,
            rdoq=rdoq, allow=(mode < nm) if mip else None, dq=dq)
        rec_y = (pred_y + rres).clamp(0, (1 << bd) - 1)
    elif (mts or lfnst) and host[:, 6:8].any():
        lev_y = _gather(carry["sy"], f, x, y, s, s)
        dqc = transform.dequantize(lev_y, s, s, qp, bd, dq=dq)
        if host[:, 7].any():
            dqc = transform.inv_lfnst_switch(dqc, rows[:, 7], mode_reg)
        rres = transform.inverse_transform_rows(dqc, s, rows[:, 6], bd)
        rec_y = (pred_y + rres).clamp(0, (1 << bd) - 1)
    else:
        rec_y, lev_y = _comp_local(carry["sy"], pred_y, f, x, y, s, s, qp,
                                   bd, encode, rdoq, lam_rd, dq)
    chroma = _chroma_leaf(
        carry, rec_y, f, x, y, mode_dm, rows[:, 8], s=s, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, qp=qp, bd=bd,
        encode=encode, rdoq=rdoq, lam_rd=lam_rd,
        cclm=cclm and (encode or bool(host[:, 8].any())), dq=dq)
    _put_leaf(carry, f, x, y, s, rec_y, lev_y, chroma, encode, midx, lidx)


def _isp_batch(carry, rows, host, qp: int, lam_rd: int, *, s: int, d: int,
               frame_w: int, frame_h: int, log2_ctu: int, bd: int,
               encode: bool, rdoq: bool, cclm: bool = False,
               dq: bool = False):
    """One dependency level's ISP s-leaves split in direction ``d``: the
    stripes run in order, each predicted from a per-row window of the
    recon buffer that the previous stripes' recon patches in place, with
    the implicit ISP transform pair; then chroma as for square leaves."""
    x, y, mode, f = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 16]
    n_ctu_x = frame_w >> log2_ctu
    mode_reg = mode.clamp(max=rom.NUM_LUMA_MODE - 1)
    wn = 2 * s + 2
    win = _gather(carry["by"], f, x, y, wn, wn)
    lev_y = torch.zeros((rows.shape[0], s, s), dtype=torch.int32,
                        device=rows.device)
    for (dx, dy, w_st, h_st) in isp_parts(s, d):
        px, py = x + dx, y + dy
        tk, lk = intra_pred.build_references_rect_win(
            win, x, y, px, py, w=w_st, h=h_st, is_luma=True,
            frame_w=frame_w, frame_h=frame_h, n_ctu_x=n_ctu_x,
            log2_ctu=log2_ctu, bd=bd, leaf_w=s, leaf_h=s)
        pred = intra_pred.predict_rect(tk, lk, mode_reg, w=w_st, h=h_st,
                                       is_luma=True, bd=bd)
        kh, kv = isp_kernels(w_st, h_st)
        if encode:
            coef = transform.forward_transform(
                _gather(carry["sy"], f, px, py, w_st, h_st) - pred, h_st,
                w_st, kh, kv, bd)
            lev = transform.quantize(coef, h_st, w_st, qp, intra=True,
                                     bd=bd, rdoq=rdoq, lam_rd=lam_rd, dq=dq)
            lev_y[:, dy:dy + h_st, dx:dx + w_st] = lev
        else:
            lev = _gather(carry["sy"], f, px, py, w_st, h_st)
        win[:, dy + 1:dy + 1 + h_st, dx + 1:dx + 1 + w_st] = \
            transform.reconstruct(pred, lev, h_st, w_st, qp, kh, kv, bd,
                                  dq=dq)
    rec_y = win[:, 1:s + 1, 1:s + 1]
    chroma = _chroma_leaf(
        carry, rec_y, f, x, y, mode_reg, rows[:, 8], s=s, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, qp=qp, bd=bd,
        encode=encode, rdoq=rdoq, lam_rd=lam_rd,
        cclm=cclm and (encode or bool(host[:, 8].any())), dq=dq)
    _put_leaf(carry, f, x, y, s, rec_y, lev_y, chroma, encode)


def _ciip_batch(carry, rows, refs, qp: int, lam_rd: int, *, s: int,
                frame_w: int, frame_h: int, log2_ctu: int, bd: int,
                encode: bool, rdoq: bool, dq: bool = False):
    """One dependency level's CIIP s-leaves: the merge candidate's MC
    prediction (L0, L1 or the BCW-weighted average) averaged with the
    planar intra prediction from the reconstructed neighbours, in luma
    and in both chroma components, then coded and reconstructed (twin of
    the reference's _ciip_batch).  rows: (k, 17) device rows; refs: the
    six (F, Hp, Wp) padded reference stacks of phase A."""
    x, y, f = rows[:, 1], rows[:, 2], rows[:, 16]
    mvx, mvy, m1x, m1y = rows[:, 4], rows[:, 5], rows[:, 11], rows[:, 12]
    dd = rows[:, 13, None, None]
    w = const(mc.BCW_W_NP, rows.device)[rows[:, 14].clamp(0, 2).long()][
        :, None, None]
    n_ctu_x = frame_w >> log2_ctu
    cs = s // 2
    mx = (1 << bd) - 1
    F = carry["bcb"].shape[0]

    def mcpred(r0, r1, px, py, sz, luma):
        fn = mc.mc_luma_block if luma else mc.mc_chroma_block
        p0 = fn(r0, px, py, sz, mvx, mvy, bd, f=f)
        p1 = fn(r1, px, py, sz, m1x, m1y, bd, f=f)
        avg = ((w * p0 + (8 - w) * p1 + 4) >> 3).clamp(0, mx)
        return torch.where(dd == 0, p0, torch.where(dd == 1, p1, avg))

    def planar(buf, px, py, fr, sz, luma):
        top, left = intra_pred.build_references(
            buf, px, py, s=sz, is_luma=luma,
            frame_w=frame_w if luma else frame_w // 2,
            frame_h=frame_h if luma else frame_h // 2, n_ctu_x=n_ctu_x,
            log2_ctu=log2_ctu, bd=bd, f=fr)
        return intra_pred.predict(top, left,
                                  torch.full_like(px, rom.PLANAR_IDX),
                                  s=sz, is_luma=luma, bd=bd)

    pred_y = ((mcpred(refs[0], refs[3], x, y, s, True)
               + planar(carry["by"], x, y, f, s, True) + 1) >> 1).clamp(0,
                                                                      mx)
    rec_y, lev_y = _comp_local(carry["sy"], pred_y, f, x, y, s, s, qp, bd,
                               encode, rdoq, lam_rd, dq)
    # Cb and Cr as one batch of 2B rows over the stacked chroma planes
    x2, y2, f2 = (torch.cat([x // 2, x // 2]), torch.cat([y // 2, y // 2]),
                  torch.cat([f, f + F]))
    mc_c = torch.cat([mcpred(refs[1], refs[4], x // 2, y // 2, cs, False),
                      mcpred(refs[2], refs[5], x // 2, y // 2, cs, False)])
    pred_c = ((mc_c + planar(carry["bc"], x2, y2, f2, cs, False) + 1)
              >> 1).clamp(0, mx)
    rec_c, lev_c = _comp_local(carry["sc"], pred_c, f2, x2, y2, cs, cs, qp,
                               bd, encode, rdoq, lam_rd, dq)
    _put_leaf(carry, f, x, y, s, rec_y, lev_y, (rec_c, lev_c, None), encode)


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def frame_wave(slots, planes_y, planes_cb, planes_cr, *, frame_w: int,
               frame_h: int, qp: int, bd: int, encode: bool,
               log2_ctu: int = 6, inter_enabled: bool = False, refs=None,
               inter=None, rdoq: bool = False, lam_rd: int = 0, **tools):
    """Reconstruct one frame: phase A, then the phase-B intra leaves level
    by level (frame_wave_batch over this one frame).

    slots: (N, 16) int32 numpy slot table (make_slots / make_slots_split);
    planes_*: int32 device planes (source when encoding, parsed levels
    when decoding); refs: the padded (y, cb, cr) reference planes of a P
    frame, or (l0 y, cb, cr, l1 y, cb, cr) of a B frame, and inter:
    {8/16/32: numpy phase-A rows}; tools: the intra tool flags of
    frame_wave_batch.  Returns (recon_y, recon_cb, recon_cr, levels_y,
    levels_cb, levels_cr, mts, lfnst, cmode, sbt); the last four are the
    8x8 grids of the chosen tool indices (encoding; zero when decoding)."""
    fr = dict(slots=slots, py=planes_y, pcb=planes_cb, pcr=planes_cr)
    if inter_enabled:
        fr.update(refs=refs, inter=inter)
    return frame_wave_batch([fr], frame_w=frame_w, frame_h=frame_h, qp=qp,
                            bd=bd, encode=encode, log2_ctu=log2_ctu,
                            rdoq=rdoq, lam_rd=lam_rd, **tools)[0]


def frame_wave_batch(frames_in, *, frame_w: int, frame_h: int, qp: int,
                     bd: int, encode: bool, log2_ctu: int = 6,
                     rdoq: bool = False, lam_rd: int = 0, mts: bool = False,
                     lfnst: bool = False, cclm: bool = False,
                     mip: bool = False, ciip: bool = False,
                     dmvr: bool = False, bdof: bool = False,
                     gpm: bool = False, affine: bool = False,
                     sbt: bool = False, dq: bool = False):
    """Reconstruct F mutually independent frames of one slice type and QP
    in one pass (twin of vvctpu.pipeline.wave.frame_wave_batch).

    frames_in: list of dicts {slots, py, pcb, pcr [, refs, inter]} as
    frame_wave takes them; the planes are int32 tensors on the device all
    frames share.  mts, lfnst, cclm, mip: the SPS intra tools (MRL and
    ISP are read from the slot rows); ciip: the CIIP leaf class of phase
    B; dmvr, bdof, gpm, affine: phase A's inter tools (DMVR and BDOF only
    for BI-symmetric frames, as the callers gate them); sbt: SBT in phase
    A; dq: dependent quantization in every leaf class.  Returns a list
    of per-frame 10-tuples, each equal to frame_wave's for that frame
    alone."""
    F = len(frames_in)
    dev = frames_in[0]["py"].device
    h2, w2 = frame_h // 2, frame_w // 2

    def z(h, w, n=F):
        return torch.zeros((n, h, w), dtype=torch.int32, device=dev)

    def stack(*keys):
        return torch.stack([torch.as_tensor(fr[k], device=dev)
                            for k in keys for fr in frames_in]).to(
                                torch.int32)

    # chroma: one (2F, ...) stack per kind, Cb frames then Cr frames, so
    # that a leaf batch codes both components at once; bcb/bcr, lcb/lcr
    # and scb/scr are views of its halves
    carry = dict(by=z(frame_h + 1 + MARGIN, frame_w + 1 + MARGIN),
                 bc=z(h2 + 1 + MARGIN, w2 + 1 + MARGIN, 2 * F),
                 ly=z(frame_h, frame_w), lc=z(h2, w2, 2 * F),
                 sy=stack("py"), sc=stack("pcb", "pcr"))
    for k in ("b", "l", "s"):
        carry[k + "cb"], carry[k + "cr"] = carry[k + "c"].split(F)
    carry.update(
        mtsp=z(frame_h // 8, frame_w // 8),
        lfnstp=z(frame_h // 8, frame_w // 8),
        cmodep=z(frame_h // 8, frame_w // 8),
        sbtp=z(frame_h // 8, frame_w // 8))
    refs = None
    if frames_in[0].get("refs") is not None:
        # a P frame's three planes serve both lists
        six = [tuple(fr["refs"]) * (2 if len(fr["refs"]) == 3 else 1)
               for fr in frames_in]
        refs = tuple(torch.stack([r[i] for r in six]) for i in range(6))
        for s_sz in (8, 16, 32):
            rows = np.concatenate(
                [np.concatenate([fr["inter"][s_sz],
                                 np.full((fr["inter"][s_sz].shape[0], 1), f,
                                         np.int32)], axis=1)
                 for f, fr in enumerate(frames_in)])
            recon._inter_batch_pass(carry, rows, refs, s_sz, qp, bd, encode,
                                    rdoq, lam_rd, dmvr=dmvr, bdof=bdof,
                                    gpm=gpm, affine=affine, sbt=sbt, dq=dq)

    sched = build_schedule_batch([fr["slots"] for fr in frames_in], frame_h,
                                 frame_w)
    if sched:
        # one upload for the whole schedule: an upload from pageable host
        # memory waits for the stream, so per-batch uploads would
        # serialise the host with the device
        all_rows = torch.as_tensor(
            np.concatenate([rows for _, rows in sched]), device=dev)
    kw = dict(frame_w=frame_w, frame_h=frame_h, log2_ctu=log2_ctu, bd=bd,
              encode=encode, rdoq=rdoq, dq=dq)
    global batches
    batches += len(sched)
    o = 0
    for (kind, w, h, d), rows in sched:
        rt = all_rows[o:o + rows.shape[0]]
        o += rows.shape[0]
        if kind == "intra":
            _intra_batch(carry, rt, rows, qp, lam_rd, s=w, mts=mts,
                         lfnst=lfnst, cclm=cclm, mip=mip, **kw)
        elif kind == "isp":
            _isp_batch(carry, rt, rows, qp, lam_rd, s=w, d=d, cclm=cclm,
                       **kw)
        elif kind == "ciip" and ciip and refs is not None:
            _ciip_batch(carry, rt, refs, qp, lam_rd, s=w, **kw)
        else:
            raise ValueError(f"leaf class {kind!r} is not in this slice")

    return [(carry["by"][f, 1:frame_h + 1, 1:frame_w + 1],
             carry["bcb"][f, 1:h2 + 1, 1:w2 + 1],
             carry["bcr"][f, 1:h2 + 1, 1:w2 + 1],
             carry["ly"][f], carry["lcb"][f], carry["lcr"][f],
             carry["mtsp"][f], carry["lfnstp"][f], carry["cmodep"][f],
             carry["sbtp"][f])
            for f in range(F)]
