"""Wavefront reconstruction — twin of vvctpu/pipeline/wave.py.

The host orders phase-B leaves into dependency levels: a leaf runs after
every leaf that produces a reference sample available to it (z-order
availability).  The device then runs one batch per (level, leaf class)
and scatters the block results into the recon buffers.  Phase A (every
inter leaf, which depends on nothing in the current frame) runs first.
One engine: an eager loop over the schedule, with the intra toolset
(MIP, MRL, ISP, MTS, LFNST, CCLM), CIIP and the rectangular leaves of the
multi-type tree on the phase-B leaves, VVC's inter toolset (BCW, GPM,
DMVR, BDOF, affine, SBT) and the rectangular inter leaves in phase A,
the IBC and palette leaves of I frames, dependent quantization and LMCS
in every leaf class (LMCS's chroma scaling in every class but IBC and
palette).  It runs F mutually independent frames at once (one temporal
layer's B frames): the buffers carry a leading frame axis, every row its
frame index (which also picks its frame's LMCS model), and the frames'
schedules merge by (level, class), so one launch sequence covers a level
of every frame.
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
# None, or a dict to which each frame_wave_batch adds its phase-B batches
# per leaf class (intra, isp, ciip, rect, ibc, plt)
batch_kinds = None


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


def _chroma_leaf(carry, rec_y, f, x, y, mode_dm, cmode, jflag, *, s: int,
                 frame_w: int, frame_h: int, n_ctu_x: int, log2_ctu: int,
                 qp: int, bd: int, encode: bool, rdoq: bool, lam_rd: int,
                 cclm: bool, jccr: bool = False, dq: bool = False):
    """Chroma part of a batch of B square intra leaves: DM prediction or,
    with ``cclm``, the choice between DM and CCLM, and with ``jccr`` the
    choice between separate and joint Cb-Cr residuals: the RD choice when
    encoding (recon.chroma_rd), the signalled choices ``cmode`` and
    ``jflag`` ((B,) or None where no row of the batch uses the tool) when
    decoding; with LMCS the residuals are scaled by each leaf's CRS scale
    from its luma recon ``rec_y``.  Cb and Cr run as one batch of 2B rows
    over the stacked chroma planes (Cb frames, then Cr frames).  Returns
    (rec, lev, use_cclm or None, use_jccr or None), rec and lev (2B, s/2,
    s/2) with the Cb rows first."""
    cs = s // 2
    cx2, cy2 = x // 2, y // 2
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    sc = recon.crs_scale(carry.get("crs"), f, rec_y, s, s, reps=2)
    top, left = intra_pred.build_references(
        carry["bc"], x2, y2, s=cs, is_luma=False, frame_w=frame_w // 2,
        frame_h=frame_h // 2, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd,
        f=f2)
    pred = intra_pred.predict(top, left, torch.cat([mode_dm, mode_dm]),
                              s=cs, is_luma=False, bd=bd)
    B = x.shape[0]
    opts = [pred]
    if cclm:
        opts.append(torch.cat(intra_pred.cclm_predict_pair(
            carry["by"], (carry["bcb"], carry["bcr"]), rec_y, cx2, cy2,
            cs=cs, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd, f=f)))
    if encode and (cclm or jccr):
        src = _gather(carry["sc"], f2, x2, y2, cs, cs)
        lev_cb, lev_cr, rcb, rcr, use_c, use_j = recon.chroma_rd(
            src[:B], src[B:], [(p[:B], p[B:]) for p in opts], cs, qp, bd,
            rdoq, lam_rd, dq, None if sc is None else sc[:B], jccr)
        return (torch.cat([rcb, rcr]), torch.cat([lev_cb, lev_cr]), use_c,
                use_j)
    if cclm and not encode:
        pred = torch.where((torch.cat([cmode, cmode]) > 0)[:, None, None],
                           opts[1], pred)
    rec, lev = _comp_local(carry["sc"], pred, f2, x2, y2, cs, cs, qp, bd,
                           encode, rdoq, lam_rd, dq, sc)
    if jflag is not None:
        # a joint leaf's Cr is its prediction less the Cb residual
        r_cb = transform.inverse_transform(
            transform.dequantize(lev[:B], cs, cs, qp, bd, dq=dq), cs, cs,
            bd=bd)
        if sc is not None:
            r_cb = recon.crs_inv(r_cb, sc[:B])
        rec_cr = (pred[B:] - r_cb).clamp(0, (1 << bd) - 1)
        rec = torch.cat([rec[:B], torch.where(
            (jflag > 0)[:, None, None], rec_cr, rec[B:])])
    return rec, lev, None, None


def _chroma_rows(carry, f, x, y):
    """(x2, y2, f2): the chroma rows of a leaf batch, Cb then Cr, indexing
    the stacked chroma planes (Cb frames, then Cr frames)."""
    F = carry["bcb"].shape[0]
    return (torch.cat([x // 2, x // 2]), torch.cat([y // 2, y // 2]),
            torch.cat([f, f + F]))


def _put_leaf(carry, f, x, y, w: int, h: int, rec_y, lev_y, chroma,
              encode: bool, midx=None, lidx=None):
    """Scatter a batch of w x h leaves' recon (and, encoding, levels and
    tool indices, the latter on every 8x8 granule of each leaf, as the
    spec model records them) into the carry, in place."""
    rec_c, lev_c, use_c, use_j = chroma
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    _scatter(carry["by"], rec_y, f, x, y, w, h, 1)
    _scatter(carry["bc"], rec_c, f2, x2, y2, w // 2, h // 2, 1)
    if not encode:
        return
    _scatter(carry["ly"], lev_y, f, x, y, w, h, 0)
    _scatter(carry["lc"], lev_c, f2, x2, y2, w // 2, h // 2, 0)
    if midx is not None:
        recon.fill8(carry["mtsp"], midx, f, x, y, w, h)
        recon.fill8(carry["lfnstp"], lidx, f, x, y, w, h)
    if use_c is not None:
        recon.fill8(carry["cmodep"], use_c, f, x, y, w, h)
    if use_j is not None:
        recon.fill8(carry["jccrp"], use_j, f, x, y, w, h)


def _intra_batch(carry, rows, host, qp: int, lam_rd: int, *, s: int,
                 frame_w: int, frame_h: int, log2_ctu: int, bd: int,
                 encode: bool, rdoq: bool, mts: bool = False,
                 lfnst: bool = False, cclm: bool = False, mip: bool = False,
                 tskip: bool = False, jccr: bool = False, dq: bool = False):
    """One dependency level's square intra s-leaves (of any frames):
    predict (angular on the row's reference line, or MIP), code and
    reconstruct luma (with the MTS/TS/LFNST choice) and chroma (with the
    DM/CCLM and separate/joint choices), scatter into the carry (in
    place).  rows: (k, 17) device rows, frame index in
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
    if (mts or lfnst or tskip) and encode:
        resi = _gather(carry["sy"], f, x, y, s, s) - pred_y
        midx, lidx, lev_y, rres = transform.choose_tx(
            resi, s, qp, lam_rd, mode_reg, bd, mts=mts, lfnst=lfnst,
            rdoq=rdoq, allow=(mode < nm) if mip else None, dq=dq, ts=tskip)
        rec_y = (pred_y + rres).clamp(0, (1 << bd) - 1)
    elif (mts or lfnst or tskip) and host[:, 6:8].any():
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
        carry, rec_y, f, x, y, mode_dm, rows[:, 8],
        _jflag(rows, host, jccr, encode), s=s, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, qp=qp, bd=bd,
        encode=encode, rdoq=rdoq, lam_rd=lam_rd,
        cclm=cclm and (encode or bool(host[:, 8].any())), jccr=jccr, dq=dq)
    _put_leaf(carry, f, x, y, s, s, rec_y, lev_y, chroma, encode, midx,
              lidx)


def _jflag(rows, host, jccr: bool, encode: bool):
    """The decoder's (B,) joint Cb-Cr flags of a batch (slot column 10),
    or None where the batch has none."""
    if jccr and not encode and host[:, 10].any():
        return rows[:, 10]
    return None


def _isp_batch(carry, rows, host, qp: int, lam_rd: int, *, s: int, d: int,
               frame_w: int, frame_h: int, log2_ctu: int, bd: int,
               encode: bool, rdoq: bool, cclm: bool = False,
               jccr: bool = False, dq: bool = False):
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
        carry, rec_y, f, x, y, mode_reg, rows[:, 8],
        _jflag(rows, host, jccr, encode), s=s, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, qp=qp, bd=bd,
        encode=encode, rdoq=rdoq, lam_rd=lam_rd,
        cclm=cclm and (encode or bool(host[:, 8].any())), jccr=jccr, dq=dq)
    _put_leaf(carry, f, x, y, s, s, rec_y, lev_y, chroma, encode)


def _ciip_batch(carry, rows, refs, qp: int, lam_rd: int, *, s: int,
                frame_w: int, frame_h: int, log2_ctu: int, bd: int,
                encode: bool, rdoq: bool, dq: bool = False):
    """One dependency level's CIIP s-leaves: the merge candidate's MC
    prediction (L0, L1 or the BCW-weighted average) averaged with the
    planar intra prediction from the reconstructed neighbours, in luma
    and in both chroma components, then coded and reconstructed (twin of
    the reference's _ciip_batch).  rows: (k, 17) device rows; refs: the
    six (F, Hp, Wp) padded reference stacks of phase A.  With LMCS the
    luma MC prediction is forward-mapped before the blend (which runs in
    the mapped domain, as the recon buffer does) and the chroma residual
    scaled by each leaf's CRS scale."""
    x, y, f = rows[:, 1], rows[:, 2], rows[:, 16]
    rf, ax, ay = recon.ref_at(carry, f, x, y)
    mvx, mvy, m1x, m1y = rows[:, 4], rows[:, 5], rows[:, 11], rows[:, 12]
    dd = rows[:, 13, None, None]
    w = const(mc.BCW_W_NP, rows.device)[rows[:, 14].clamp(0, 2).long()][
        :, None, None]
    n_ctu_x = frame_w >> log2_ctu
    cs = s // 2
    mx = (1 << bd) - 1

    def mcpred(r0, r1, px, py, sz, luma):
        fn = mc.mc_luma_block if luma else mc.mc_chroma_block
        p0 = fn(r0, px, py, sz, mvx, mvy, bd, f=rf)
        p1 = fn(r1, px, py, sz, m1x, m1y, bd, f=rf)
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

    mc_y = recon.fwd_map(carry.get("fwd"), f,
                         mcpred(refs[0], refs[3], ax, ay, s, True))
    pred_y = ((mc_y + planar(carry["by"], x, y, f, s, True) + 1)
              >> 1).clamp(0, mx)
    rec_y, lev_y = _comp_local(carry["sy"], pred_y, f, x, y, s, s, qp, bd,
                               encode, rdoq, lam_rd, dq)
    sc = recon.crs_scale(carry.get("crs"), f, rec_y, s, s, reps=2)
    # Cb and Cr as one batch of 2B rows over the stacked chroma planes
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    mc_c = torch.cat([mcpred(refs[1], refs[4], ax // 2, ay // 2, cs, False),
                      mcpred(refs[2], refs[5], ax // 2, ay // 2, cs, False)])
    pred_c = ((mc_c + planar(carry["bc"], x2, y2, f2, cs, False) + 1)
              >> 1).clamp(0, mx)
    rec_c, lev_c = _comp_local(carry["sc"], pred_c, f2, x2, y2, cs, cs, qp,
                               bd, encode, rdoq, lam_rd, dq, sc)
    _put_leaf(carry, f, x, y, s, s, rec_y, lev_y,
              (rec_c, lev_c, None, None), encode)


def _rect_batch(carry, rows, qp: int, lam_rd: int, *, w: int, h: int,
                frame_w: int, frame_h: int, log2_ctu: int, bd: int,
                encode: bool, rdoq: bool, dq: bool = False):
    """One dependency level's rectangular (BT and TT) intra leaves of one
    shape, w wide and h high (twin of the reference's _rect_batch): the 67
    regular modes and DM chroma, no square-only tool.  The sibling that
    precedes a leaf in coding order shares its parent's Morton index, so
    the parent square (x & ~(ps-1), y & ~(ps-1)) of side ps = max(w, h)
    counts as coded, as for ISP stripes.  Cb and Cr run as one batch,
    with LMCS scaled by each leaf's CRS scale (the w x h leaf's average
    mapped luma)."""
    x, y, mode, f = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 16]
    n_ctu_x = frame_w >> log2_ctu
    ps = max(w, h)
    px0, py0 = x & ~(ps - 1), y & ~(ps - 1)
    geo = dict(n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd)
    top, left = intra_pred.build_references_rect(
        carry["by"], x, y, w=w, h=h, is_luma=True, frame_w=frame_w,
        frame_h=frame_h, leaf_x=px0, leaf_y=py0, leaf_w=ps, leaf_h=ps, f=f,
        **geo)
    pred_y = intra_pred.predict_rect(top, left, mode, w=w, h=h,
                                     is_luma=True, bd=bd)
    rec_y, lev_y = _comp_local(carry["sy"], pred_y, f, x, y, w, h, qp, bd,
                               encode, rdoq, lam_rd, dq)
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    cw, ch = w // 2, h // 2
    tc, lc = intra_pred.build_references_rect(
        carry["bc"], x2, y2, w=cw, h=ch, is_luma=False,
        frame_w=frame_w // 2, frame_h=frame_h // 2,
        leaf_x=torch.cat([px0, px0]) // 2, leaf_y=torch.cat([py0, py0]) // 2,
        leaf_w=ps // 2, leaf_h=ps // 2, f=f2, **geo)
    pred_c = intra_pred.predict_rect(tc, lc, torch.cat([mode, mode]), w=cw,
                                     h=ch, is_luma=False, bd=bd)
    sc = recon.crs_scale(carry.get("crs"), f, rec_y, w, h, reps=2)
    rec_c, lev_c = _comp_local(carry["sc"], pred_c, f2, x2, y2, cw, ch, qp,
                               bd, encode, rdoq, lam_rd, dq, sc)
    _put_leaf(carry, f, x, y, w, h, rec_y, lev_y,
              (rec_c, lev_c, None, None), encode)


def _ibc_batch(carry, rows, qp: int, lam_rd: int, *, s: int, frame_w: int,
               frame_h: int, bd: int, encode: bool, rdoq: bool,
               dq: bool = False):
    """One dependency level's IBC s-leaves (twin of the reference's
    _ibc_batch): each leaf's luma and chroma copied from its own frame's
    reconstructed (pre-filter) buffers at its block vector (slot columns
    4 and 5, integer pels, the source clamped to the frame; chroma at the
    halved position), then coded and reconstructed with DCT-II residuals
    (RDOQ or the trellis), without the intra tools, the tool planes or
    LMCS's chroma scaling.  The leveller puts every leaf after the
    leaves of its source region."""
    x, y, f = rows[:, 1], rows[:, 2], rows[:, 16]
    sx = (x + rows[:, 4]).clamp(0, frame_w - s)
    sy = (y + rows[:, 5]).clamp(0, frame_h - s)
    cs = s // 2
    pred_y = _gather(carry["by"], f, sx + 1, sy + 1, s, s)
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    sx2, sy2, _ = _chroma_rows(carry, f, sx, sy)
    pred_c = _gather(carry["bc"], f2, sx2 + 1, sy2 + 1, cs, cs)
    rec_y, lev_y = _comp_local(carry["sy"], pred_y, f, x, y, s, s, qp, bd,
                               encode, rdoq, lam_rd, dq)
    rec_c, lev_c = _comp_local(carry["sc"], pred_c, f2, x2, y2, cs, cs, qp,
                               bd, encode, rdoq, lam_rd, dq)
    _put_leaf(carry, f, x, y, s, s, rec_y, lev_y,
              (rec_c, lev_c, None, None), encode)


def _plt_batch(carry, rows, *, s: int):
    """One dependency level's palette s-leaves (twin of the reference's
    _plt_batch): each leaf's precomputed palette reconstruction (the
    frame's palette planes in the carry) scattered into the recon
    buffers; its levels stay zero."""
    x, y, f = rows[:, 1], rows[:, 2], rows[:, 16]
    x2, y2, f2 = _chroma_rows(carry, f, x, y)
    cs = s // 2
    _scatter(carry["by"], _gather(carry["plty"], f, x, y, s, s), f, x, y,
             s, s, 1)
    _scatter(carry["bc"], _gather(carry["pltc"], f2, x2, y2, cs, cs), f2,
             x2, y2, cs, cs, 1)


# ---------------------------------------------------------------------------
# frame loop
# ---------------------------------------------------------------------------


def frame_wave(slots, planes_y, planes_cb, planes_cr, *, frame_w: int,
               frame_h: int, qp: int, bd: int, encode: bool, log2_ctu: int,
               inter_enabled: bool = False, refs=None, inter=None,
               rdoq: bool = False, lam_rd: int = 0, fwd_lut=None,
               crs_lut=None, **tools):
    """Reconstruct one frame: phase A, then the phase-B intra leaves level
    by level (frame_wave_batch over this one frame).

    slots: (N, 16) int32 numpy slot table (make_slots / make_slots_split);
    planes_*: int32 device planes (source when encoding, parsed levels
    when decoding); refs: the padded (y, cb, cr) reference planes of a P
    frame, or (l0 y, cb, cr, l1 y, cb, cr) of a B frame, and inter:
    {8/16/32 and the RECT_SHAPES: numpy phase-A rows}; fwd_lut, crs_lut:
    the frame's LMCS LUTs or None; tools: the tool flags of
    frame_wave_batch.  Returns (recon_y, recon_cb, recon_cr,
    levels_y, levels_cb, levels_cr, mts, lfnst, cmode, sbt, jccr); the
    last five are the 8x8 grids of the chosen tool indices (encoding; zero
    when decoding)."""
    fr = dict(slots=slots, py=planes_y, pcb=planes_cb, pcr=planes_cr)
    if inter_enabled:
        fr.update(refs=refs, inter=inter)
    if fwd_lut is not None:
        fr.update(fwd_lut=fwd_lut, crs_lut=crs_lut)
    return frame_wave_batch([fr], frame_w=frame_w, frame_h=frame_h, qp=qp,
                            bd=bd, encode=encode, log2_ctu=log2_ctu,
                            rdoq=rdoq, lam_rd=lam_rd, **tools)[0]


def _frame_rows(frames_in, key):
    """Every frame's phase-A rows of ``key`` (a square size or a rect
    shape), each with its frame index appended."""
    return np.concatenate(
        [np.concatenate([fr["inter"][key],
                         np.full((fr["inter"][key].shape[0], 1), f,
                                 np.int32)], axis=1)
         for f, fr in enumerate(frames_in)])


def frame_wave_batch(frames_in, *, frame_w: int, frame_h: int, qp: int,
                     bd: int, encode: bool, log2_ctu: int,
                     rdoq: bool = False, lam_rd: int = 0, mts: bool = False,
                     lfnst: bool = False, cclm: bool = False,
                     mip: bool = False, ciip: bool = False,
                     dmvr: bool = False, bdof: bool = False,
                     gpm: bool = False, affine: bool = False,
                     sbt: bool = False, dq: bool = False,
                     tskip: bool = False, jccr: bool = False):
    """Reconstruct F mutually independent frames of one slice type and QP
    in one pass (twin of vvctpu.pipeline.wave.frame_wave_batch).

    frames_in: list of dicts {slots, py, pcb, pcr [, refs, inter [,
    ref_idx, rox, roy]] [, fwd_lut, crs_lut] [, plt]} as frame_wave takes
    them; log2_ctu: the SPS's CTU size;
    the planes are int32 tensors on the device all frames share.  A
    member may be one tile of a frame: its planes and slots are the
    tile's, frame_w and frame_h its size (every member of a call has the
    same), and its motion compensation reads the frame's full reference
    pictures ``refs`` at the tile's offset (rox, roy); members with the
    same ``ref_idx`` (by default the member's position) give the same
    ``refs`` and share one slot of the reference stacks.  With LMCS
    every frame carries its own model's forward and CRS LUTs (2^bd
    entries), and ``py`` is its forward-mapped source luma when
    encoding: the luma is reconstructed in the mapped domain, inter
    predictions are forward-mapped and chroma residuals scaled.  Frames
    with and without LMCS are not mixed in one call.  mts, lfnst, cclm,
    mip, tskip, jccr: the SPS intra tools (MRL and ISP are read from the
    slot rows; transform skip and joint Cb-Cr residuals apply to square
    intra leaves, JCCR to ISP leaves too);
    ciip: the CIIP leaf class of phase B; dmvr, bdof, gpm, affine: phase
    A's inter tools (DMVR and BDOF only for BI-symmetric frames, as the
    callers gate them); sbt: SBT in phase A; dq: dependent quantization
    in every leaf class.  The rectangular (BT and TT) leaves of the multi-type tree run
    in phase A (inter, the rect arrays of make_slots_split in ``inter``)
    and phase B (intra) wherever the slot tables hold them, and so do
    the IBC and palette leaves of I frames (a member with palette leaves
    carries its (y, cb, cr) palette planes in ``plt``).  Returns a
    list of per-frame 11-tuples, each equal to frame_wave's for that
    frame alone."""
    F = len(frames_in)
    lmcs = {fr.get("fwd_lut") is not None for fr in frames_in}
    if len(lmcs) > 1:
        raise ValueError("frames with and without LMCS in one wave")
    lmcs = lmcs.pop()
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
        sbtp=z(frame_h // 8, frame_w // 8),
        jccrp=z(frame_h // 8, frame_w // 8))
    if lmcs:
        # LMCS: each frame's own model, (F, 2^bd) LUTs that every leaf
        # row indexes with its frame index
        carry["fwd"], carry["crs"] = stack("fwd_lut"), stack("crs_lut")
    if any(fr.get("plt") is not None for fr in frames_in):
        # palette: each frame's precomputed recon planes (zero for a frame
        # without palette leaves), chroma stacked as the source's
        def plt(i, h, w):
            return torch.stack([
                torch.zeros((h, w), dtype=torch.int32, device=dev)
                if fr.get("plt") is None
                else torch.as_tensor(fr["plt"][i], device=dev).to(torch.int32)
                for fr in frames_in])

        carry["plty"] = plt(0, frame_h, frame_w)
        carry["pltc"] = torch.cat([plt(1, h2, w2), plt(2, h2, w2)])
    refs = None
    if frames_in[0].get("refs") is not None:
        # one stack slot per reference index the members give (a P
        # frame's three planes serve both lists)
        slot, six = {}, []
        for f, fr in enumerate(frames_in):
            if fr.get("ref_idx", f) not in slot:
                slot[fr.get("ref_idx", f)] = len(six)
                six.append(tuple(fr["refs"])
                           * (2 if len(fr["refs"]) == 3 else 1))
        refs = tuple(torch.stack([r[i] for r in six]) for i in range(6))
        roff = [(slot[fr.get("ref_idx", f)], fr.get("rox", 0),
                 fr.get("roy", 0)) for f, fr in enumerate(frames_in)]
        if roff != [(f, 0, 0) for f in range(F)]:
            carry["roff"] = torch.as_tensor(roff, dtype=torch.int32,
                                            device=dev)
        for s_sz in (8, 16, 32):
            recon._inter_batch_pass(carry, _frame_rows(frames_in, s_sz),
                                    refs, s_sz, qp, bd, encode, rdoq, lam_rd,
                                    dmvr=dmvr, bdof=bdof, gpm=gpm,
                                    affine=affine, sbt=sbt, dq=dq)
        for sh in planmod.RECT_SHAPES:
            recon._inter_batch_pass_rect(carry, _frame_rows(frames_in, sh),
                                         refs, *sh, qp, bd, encode, rdoq,
                                         lam_rd, dq)

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
    if batch_kinds is not None:
        for (kind, *_), _ in sched:
            batch_kinds[kind] = batch_kinds.get(kind, 0) + 1
    o = 0
    for (kind, w, h, d), rows in sched:
        rt = all_rows[o:o + rows.shape[0]]
        o += rows.shape[0]
        if kind == "intra":
            _intra_batch(carry, rt, rows, qp, lam_rd, s=w, mts=mts,
                         lfnst=lfnst, cclm=cclm, mip=mip, tskip=tskip,
                         jccr=jccr, **kw)
        elif kind == "isp":
            _isp_batch(carry, rt, rows, qp, lam_rd, s=w, d=d, cclm=cclm,
                       jccr=jccr, **kw)
        elif kind == "ciip" and ciip and refs is not None:
            _ciip_batch(carry, rt, refs, qp, lam_rd, s=w, **kw)
        elif kind == "rect":
            _rect_batch(carry, rt, qp, lam_rd, w=w, h=h, **kw)
        elif kind == "ibc":
            _ibc_batch(carry, rt, qp, lam_rd, s=w, frame_w=frame_w,
                       frame_h=frame_h, bd=bd, encode=encode, rdoq=rdoq,
                       dq=dq)
        elif kind == "plt":
            _plt_batch(carry, rt, s=w)
        else:
            raise ValueError(f"leaf class {kind!r} is not in this slice")

    return [(carry["by"][f, 1:frame_h + 1, 1:frame_w + 1],
             carry["bcb"][f, 1:h2 + 1, 1:w2 + 1],
             carry["bcr"][f, 1:h2 + 1, 1:w2 + 1],
             carry["ly"][f], carry["lcb"][f], carry["lcr"][f],
             carry["mtsp"][f], carry["lfnstp"][f], carry["cmodep"][f],
             carry["sbtp"][f], carry["jccrp"][f])
            for f in range(F)]
