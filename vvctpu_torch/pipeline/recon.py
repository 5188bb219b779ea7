"""Leaf reconstruction pieces — twin of vvctpu/pipeline/recon.py.

Host-side slot tables (copied), the shared residual/recon chain of one
component for a batch of blocks, the phase-A pass that reconstructs every
inter leaf of one size at once (uni- and bi-prediction with BCW weights,
GPM blends, DMVR, BDOF and affine with PROF, the SBT choice, dependent
quantization) and every rectangular inter leaf of one shape, and the
edge padding of the decoded picture buffer.
Device planes carry a leading frame axis (F, h, w) and every block its
frame index, so one pass serves F mutually independent frames.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..kernels import intra_pred, mc, transform
from ..spec.codec import FrameDecisions
from ..spec.inter import (AFF_MIN_SIZE, BCW_DEFAULT, DMVR_SUB, MV_FRAC_BITS,
                          REF_MARGIN)
from . import plan as planmod

MARGIN = intra_pred.MARGIN


def _index(f, xs, ys, w: int, h: int):
    """[f, y, x] index tensors of (B, h, w) blocks at (xs, ys) of frame f."""
    dev = xs.device
    iy = ys.long()[:, None] + torch.arange(h, device=dev)[None]
    ix = xs.long()[:, None] + torch.arange(w, device=dev)[None]
    return f.long()[:, None, None], iy[:, :, None], ix[:, None, :]


def _gather(plane, f, xs, ys, w: int, h: int):
    """(B, h, w) blocks of an (F, H, W) plane stack at (f, xs, ys)."""
    return plane[_index(f, xs, ys, w, h)]


def crs_scale(crs_lut, f, rec_y, w: int, h: int, reps: int = 1):
    """LMCS chroma residual scaling: each leaf's scale (1.11 fixed point),
    the slope of its frame's CRS LUT at the average of the leaf's
    reconstructed mapped luma (twin of the spec model's _crs_scale).
    crs_lut: (F, 2^bd) per-frame LUTs or None (no LMCS, returns None);
    rec_y: (B, h, w) luma recon of the leaves of frames f.  Returns the
    (reps * B,) scales, the B leaves' repeated for batches that stack
    Cb and Cr rows (reps=2)."""
    if crs_lut is None:
        return None
    avg = rec_y.sum((-2, -1), dtype=torch.int32) >> (
        (w.bit_length() - 1) + (h.bit_length() - 1))
    return crs_lut[f.long(), avg.long()].repeat(reps)


def fwd_map(fwd_lut, f, pred_y):
    """LMCS forward mapping of a batch's luma predictions through each
    row's frame LUT (fwd_lut: (F, 2^bd), or None for no LMCS)."""
    if fwd_lut is None:
        return pred_y
    return fwd_lut[f.long()[:, None, None], pred_y.long()]


def crs_fwd(resi, sc):
    """Forward chroma residual scaling (encoder): (resi << 11) // sc per
    row, a floor division as in the spec model's crs_fwd."""
    return torch.div(resi * (1 << 11), sc[:, None, None],
                     rounding_mode="floor")


def crs_inv(r, sc):
    """Inverse chroma residual scaling: (r * sc) >> 11 per row."""
    return (r * sc[:, None, None]) >> 11


def _component(src, pred, f, xs, ys, w: int, h: int, qp: int, bd: int,
               encode: bool, rdoq: bool = False, lam_rd: int = 0,
               dq: bool = False, crs_sc=None):
    """Residual + recon of a batch of (h, w) component blocks with the
    given predictions (twin of recon._component and wave._comp_local).

    src: source planes when encoding, parsed level planes when decoding,
    (F, H, W); crs_sc: None, or the (B,) LMCS chroma residual scales that
    divide the residual before the transform and multiply it after.
    Returns (rec, lev), both (B, h, w) int32."""
    if encode:
        resi = _gather(src, f, xs, ys, w, h).to(torch.int32) - pred
        if crs_sc is not None:
            resi = crs_fwd(resi, crs_sc)
        coef = transform.forward_transform(resi, h, w, bd=bd)
        lev = transform.quantize(coef, h, w, qp, intra=True, bd=bd,
                                 rdoq=rdoq, lam_rd=lam_rd, dq=dq)
    else:
        lev = _gather(src, f, xs, ys, w, h)
    r = transform.inverse_transform(
        transform.dequantize(lev, h, w, qp, bd, dq=dq), h, w, bd=bd)
    if crs_sc is not None:
        r = crs_inv(r, crs_sc)
    return (pred.to(torch.int32) + r).clamp(0, (1 << bd) - 1), lev


def chroma_rd(bcbk, bcrk, pred_opts, cs: int, qp: int, bd: int,
              rdoq: bool, lam_rd: int, dq: bool = False, crs_sc=None,
              jccr: bool = False):
    """Chroma choice of a batch of leaves (twin of the reference's
    chroma_rd_j): each (Cb, Cr) prediction pair of ``pred_opts`` (DM
    first, then CCLM) is coded separately and, with ``jccr``, jointly (one
    residual (rcb - rcr) >> 1 that Cb adds and Cr subtracts), all in one
    stacked pass; the first minimum in the order (option 0 separate,
    option 0 joint, option 1 separate, ...) wins.

    bcbk, bcrk: (B, cs, cs) source blocks; pred_opts: [(pred_cb, pred_cr)]
    of (B, cs, cs); crs_sc: None or the (B,) LMCS chroma residual scales
    (the residuals are scaled before the joint one is formed, and the
    distortion is taken between scaled residuals).  Returns (lev_cb,
    lev_cr, rec_cb, rec_cr, use_c, use_j) with use_c the (B,) index of the
    chosen option and use_j (B,) 1 where the joint candidate won (its Cr
    levels are zero), else None without ``jccr``."""
    dev = bcbk.device
    P = len(pred_opts)
    mx = (1 << bd) - 1
    res = ([bcbk - pcb for pcb, _ in pred_opts]
           + [bcrk - pcr for _, pcr in pred_opts])
    if crs_sc is not None:
        res = [crs_fwd(r, crs_sc) for r in res]
    if jccr:
        res += [(res[i] - res[P + i]) >> 1 for i in range(P)]
    res = torch.stack(res, 1)
    coef = transform.forward_transform(res, cs, cs, bd=bd)
    lev = transform.quantize(coef, cs, cs, qp, intra=True, bd=bd,
                             rdoq=rdoq, lam_rd=lam_rd, dq=dq)
    rr = transform.inverse_transform(
        transform.dequantize(lev, cs, cs, qp, bd, dq=dq), cs, cs, bd=bd)
    rate_fp = transform.level_rate_fp(
        lev, transform.lvl_weights(qp, dev), dims=(-2, -1)).clamp(
        max=1 << 22)
    rate = lam_rd * (rate_fp >> 8) + ((lam_rd * (rate_fp & 255)) >> 8)

    def dist(a, b):
        return ((a - b).abs().clamp(max=2047) ** 2).sum((-2, -1),
                                                        dtype=torch.int32)

    sep = (dist(res[:, :P], rr[:, :P]) + dist(res[:, P:2 * P],
                                                rr[:, P:2 * P])
           + rate[:, :P] + rate[:, P:2 * P])
    if jccr:
        rj = rr[:, 2 * P:]
        joint = (dist(res[:, :P], rj) + dist(res[:, P:2 * P], -rj)
                 + rate[:, 2 * P:])
        cost = torch.stack([sep, joint], 2).flatten(1)
    else:
        cost = sep
    k = torch.argmin(cost, dim=1)
    i, j = (k >> 1, k & 1) if jccr else (k, None)
    b = torch.arange(i.shape[0], device=dev)
    pcb = torch.stack([p for p, _ in pred_opts], 1)[b, i]
    pcr = torch.stack([p for _, p in pred_opts], 1)[b, i]
    lev_cb, lev_cr = lev[b, i], lev[b, P + i]
    rcb, rcr = rr[b, i], rr[b, P + i]
    if jccr:
        jm = (j > 0)[:, None, None]
        rjb = rr[b, 2 * P + i]
        lev_cb = torch.where(jm, lev[b, 2 * P + i], lev_cb)
        lev_cr = torch.where(jm, 0, lev_cr)
        rcb = torch.where(jm, rjb, rcb)
    if crs_sc is not None:
        rcb, rcr = crs_inv(rcb, crs_sc), crs_inv(rcr, crs_sc)
    rec_cr = pcr + rcr
    if jccr:
        rec_cr = torch.where(jm, pcr - rcb, rec_cr)
    return (lev_cb, lev_cr, (pcb + rcb).clamp(0, mx), rec_cr.clamp(0, mx),
            i.to(torch.int32), None if j is None else j.to(torch.int32))


def fill8(plane, vals, f, xs, ys, w: int, h: int):
    """plane[f, granules of each w x h leaf at (xs, ys)] = vals: a leaf's
    tool index on every 8x8 granule it covers, as the spec model records
    it (the entropy coder reads the top-left one)."""
    plane[_index(f, xs // 8, ys // 8, max(w // 8, 1), max(h // 8, 1))] = \
        vals[:, None, None]


def _scatter(buf, blocks, f, xs, ys, w: int, h: int, off: int):
    """buf[f, ys + off + i, xs + off + j] = blocks[:, i, j], in place.
    Every block must lie inside its frame: callers drop the reference's
    padded rows (x = y = 2^20, which JAX scatters drop) before they reach
    the device."""
    buf[_index(f, xs + off, ys + off, w, h)] = blocks


def ref_at(carry, f, x, y):
    """(reference stack index, x, y) of blocks of members ``f`` at (x, y)
    in their members' planes: a tile's blocks read the full reference
    picture at the tile's offset (twin of the reference's rox/roy).
    carry["roff"] is None or the (F, 3) [stack index, x offset, y offset]
    of each member (frame_wave_batch); None is the identity."""
    ro = carry.get("roff")
    if ro is None:
        return f, x, y
    o = ro[f.long()]
    return o[:, 0], x + o[:, 1], y + o[:, 2]


def _inter_batch_pass(carry, ib_slots, refs, s: int, qp: int, bd: int,
                      encode: bool, rdoq: bool = False, lam_rd: int = 0,
                      dmvr: bool = False, bdof: bool = False,
                      gpm: bool = False, affine: bool = False,
                      sbt: bool = False, dq: bool = False):
    """Phase A: every inter s-leaf of every frame at once (twin of the
    reference's _inter_batch_pass).

    carry: dict of (F, ...) recon buffers, level planes and source planes
    (updated in place) and, with LMCS, the frames' (F, 2^bd) forward and
    CRS LUTs "fwd" and "crs" (the luma prediction is forward-mapped after
    every tool, and the chroma residual scaled by the leaf's CRS scale);
    ib_slots: (B, 14) int32 numpy rows of
    make_slots_split plus the frame index in column 13, whose padded rows
    (x = y = 2^20) are dropped here on the host; refs: the padded (l0 y,
    cb, cr, l1 y, cb, cr) reference planes, each a stack that ref_at
    indexes (one plane per member without carry["roff"]).
    Column 6 picks L0, L1 or BI; BI is the BCW average by column 7 or,
    with ``gpm``, the mask blend of partition column 9.  With ``dmvr`` or
    ``bdof`` the BI leaves of equal weight outside GPM are refined per
    DMVR_SUB sub-block (mirrored integer offset) and per 4x4 (optical
    flow); with ``affine`` the leaves flagged in column 10 (s >= 16) are
    predicted per 4x4 sub-block with PROF from dmv columns 11-12.  With
    ``sbt`` the luma residual takes the SBT RD choice when encoding (the
    index goes to every 8x8 granule of the leaf in carry["sbtp"], as the
    spec model records it) and the parsed index of column 8 when
    decoding.  The spec model records SBT only on signalled leaves (not
    skip, not CIIP, square): phase A holds square non-CIIP leaves only,
    and a skip leaf's all-zero luma levels give index 0.  ``dq``: dependent
    quantization in every component."""
    rows = ib_slots[ib_slots[:, 0] < (1 << 20)]
    if rows.shape[0] == 0:
        return
    dev = carry["by"].device
    slots = torch.as_tensor(np.ascontiguousarray(rows), device=dev)
    cs = s // 2
    x, y, f = slots[:, 0], slots[:, 1], slots[:, 13]
    at = ref_at(carry, f, x, y)
    rf, ax, ay = at
    m0x, m0y, m1x, m1y = (slots[:, c] for c in (2, 3, 4, 5))
    d = slots[:, 6, None, None]
    mx = (1 << bd) - 1
    any_l1 = bool((rows[:, 6] != 0).any())
    gpm = gpm and bool((rows[:, 9] > 0).any())
    w = const(mc.BCW_W_NP, dev)[slots[:, 7].clamp(0, 2).long()][
        :, None, None]
    gw_l = const(mc.gpm_masks(s), dev)[slots[:, 9].clamp(0, 64).long()] \
        if gpm else None

    def blend(p0, p1, gwm):
        avg = ((w * p0 + (8 - w) * p1 + 4) >> 3).clamp(0, mx)
        if gwm is None:
            return avg
        gb = ((gwm * p0 + (8 - gwm) * p1 + 4) >> 3).clamp(0, mx)
        return torch.where(slots[:, 9, None, None] > 0, gb, avg)

    def pred(ref0, ref1, px, py, sz, luma):
        fn = mc.mc_luma_block if luma else mc.mc_chroma_block
        p0 = fn(ref0, px, py, sz, m0x, m0y, bd, f=rf)
        if not any_l1:
            return p0
        p1 = fn(ref1, px, py, sz, m1x, m1y, bd, f=rf)
        gwm = None if gw_l is None else (gw_l if luma
                                         else gw_l[:, ::2, ::2])
        return torch.where(d == 0, p0, torch.where(d == 1, p1,
                                                   blend(p0, p1, gwm)))

    pred_y = pred(refs[0], refs[3], ax, ay, s, True)
    pred_cb = pred(refs[1], refs[4], ax // 2, ay // 2, cs, False)
    pred_cr = pred(refs[2], refs[5], ax // 2, ay // 2, cs, False)
    dmvr = dmvr and s >= DMVR_SUB     # DMVR refines 16x16 sub-blocks
    if dmvr or bdof:
        # BI leaves of equal weight outside GPM (the others keep the
        # prediction above, which the reference's sub-block path equals)
        ri = np.nonzero((rows[:, 6] == 2) & (rows[:, 7] == BCW_DEFAULT)
                        & (rows[:, 9] == 0))[0]
        if ri.size:
            _refine_bi(pred_y, pred_cb, pred_cr, slots,
                       torch.as_tensor(ri, device=dev), refs, s,
                       DMVR_SUB if dmvr else s, dmvr, bdof, bd, at)
    if affine and s >= AFF_MIN_SIZE:
        for lst in (0, 1):
            # L0 for direction 0, else L1, as in the reference
            ai = np.nonzero((rows[:, 10] > 0)
                            & ((rows[:, 6] != 0) == bool(lst)))[0]
            if ai.size:
                _affine_override(pred_y, pred_cb, pred_cr, slots,
                                 torch.as_tensor(ai, device=dev),
                                 refs[3 * lst:3 * lst + 3], s, bd, at)
    # LMCS: the final luma prediction is forward-mapped; the residual is
    # coded and the leaf reconstructed in the mapped domain
    pred_y = fwd_map(carry.get("fwd"), f, pred_y)
    if sbt:
        if encode:
            sidx, lvy, rres = transform.choose_sbt(
                _gather(carry["sy"], f, x, y, s, s) - pred_y, s, qp, lam_rd,
                bd=bd, rdoq=rdoq, dq=dq)
            fill8(carry["sbtp"], sidx, f, x, y, s, s)
        else:
            lvy = _gather(carry["sy"], f, x, y, s, s)
            rres = transform.sbt_resi(lvy, rows[:, 8], s, qp, bd, dq=dq)
        ry = (pred_y + rres).clamp(0, mx)
    else:
        ry, lvy = _component(carry["sy"], pred_y, f, x, y, s, s, qp, bd,
                             encode, rdoq, lam_rd, dq)
    sc = crs_scale(carry.get("crs"), f, ry, s, s)
    rcb, lvcb = _component(carry["scb"], pred_cb, f, x // 2, y // 2, cs, cs,
                           qp, bd, encode, rdoq, lam_rd, dq, sc)
    rcr, lvcr = _component(carry["scr"], pred_cr, f, x // 2, y // 2, cs, cs,
                           qp, bd, encode, rdoq, lam_rd, dq, sc)
    _scatter(carry["by"], ry, f, x, y, s, s, 1)
    _scatter(carry["bcb"], rcb, f, x // 2, y // 2, cs, cs, 1)
    _scatter(carry["bcr"], rcr, f, x // 2, y // 2, cs, cs, 1)
    if encode:
        _scatter(carry["ly"], lvy, f, x, y, s, s, 0)
        _scatter(carry["lcb"], lvcb, f, x // 2, y // 2, cs, cs, 0)
        _scatter(carry["lcr"], lvcr, f, x // 2, y // 2, cs, cs, 0)


def _inter_batch_pass_rect(carry, ib_slots, refs, w: int, h: int, qp: int,
                           bd: int, encode: bool, rdoq: bool = False,
                           lam_rd: int = 0, dq: bool = False):
    """Phase A for rectangular (BT and TT) inter leaves of one shape, w
    wide and h high, of every frame at once (twin of the reference's
    _inter_batch_pass_rect): translational MC, L0, L1 or the rounded
    equal-weight BI average, then the rect transform in each component,
    with RDOQ or, with ``dq``, dependent quantization, and with LMCS the
    mapping and scaling of _inter_batch_pass.

    ib_slots: (B, 8) int32 numpy rows [x, y, mv0x, mv0y, mv1x, mv1y, dir,
    frame index] of make_slots_split's rect arrays, whose padded rows
    (x = y = 2^20) are dropped here on the host; carry and refs as in
    _inter_batch_pass."""
    rows = ib_slots[ib_slots[:, 0] < (1 << 20)]
    if rows.shape[0] == 0:
        return
    dev = carry["by"].device
    slots = torch.as_tensor(np.ascontiguousarray(rows), device=dev)
    cw, ch = w // 2, h // 2
    x, y, f = slots[:, 0], slots[:, 1], slots[:, 7]
    rf, ax, ay = ref_at(carry, f, x, y)
    m0x, m0y, m1x, m1y = (slots[:, c] for c in (2, 3, 4, 5))
    d = slots[:, 6, None, None]
    mx = (1 << bd) - 1
    any_l1 = bool((rows[:, 6] != 0).any())

    def pred(ref0, ref1, px, py, pw, ph, luma):
        fn = mc.mc_luma_block if luma else mc.mc_chroma_block
        p0 = fn(ref0, px, py, pw, m0x, m0y, bd, h=ph, f=rf)
        if not any_l1:
            return p0
        p1 = fn(ref1, px, py, pw, m1x, m1y, bd, h=ph, f=rf)
        avg = ((p0 + p1 + 1) >> 1).clamp(max=mx)
        return torch.where(d == 0, p0, torch.where(d == 1, p1, avg))

    pred_y = fwd_map(carry.get("fwd"), f,
                     pred(refs[0], refs[3], ax, ay, w, h, True))
    ry, lvy = _component(carry["sy"], pred_y, f, x, y, w, h, qp, bd, encode,
                         rdoq, lam_rd, dq)
    _scatter(carry["by"], ry, f, x, y, w, h, 1)
    if encode:
        _scatter(carry["ly"], lvy, f, x, y, w, h, 0)
    sc = crs_scale(carry.get("crs"), f, ry, w, h)
    for c, r0, r1 in (("cb", refs[1], refs[4]), ("cr", refs[2], refs[5])):
        rc, lvc = _component(carry["s" + c], pred(r0, r1, ax // 2, ay // 2,
                                                  cw, ch, False),
                             f, x // 2, y // 2, cw, ch, qp, bd, encode, rdoq,
                             lam_rd, dq, sc)
        _scatter(carry["b" + c], rc, f, x // 2, y // 2, cw, ch, 1)
        if encode:
            _scatter(carry["l" + c], lvc, f, x // 2, y // 2, cw, ch, 0)


def _refine_bi(pred_y, pred_cb, pred_cr, slots, ri, refs, s: int, sub: int,
               dmvr: bool, bdof: bool, bd: int, at):
    """DMVR / BDOF predictions of the BI leaves ``ri`` (rows of ``slots``,
    all of equal weight and outside GPM), written into the prediction
    batches in place: per sub x sub sub-block the mirrored integer offset
    (with ``dmvr``), the (sub+2)-extended luma predictions, the BDOF
    blend (with ``bdof``, else the rounded average), and the chroma
    average at the offset MVs.  at: ref_at of every row of ``slots``."""
    sl = slots[ri]
    f, x, y = (a[ri] for a in at)
    m0x, m0y, m1x, m1y = (sl[:, c] for c in (2, 3, 4, 5))
    mx = (1 << bd) - 1
    cs2 = sub // 2
    for sy0 in range(0, s, sub):
        for sx0 in range(0, s, sub):
            a0x, a0y, a1x, a1y = m0x, m0y, m1x, m1y
            if dmvr:
                off = mc.dmvr_offset(refs[0], refs[3], x + sx0, y + sy0, sub,
                                     m0x, m0y, m1x, m1y, f=f)
                ox = off[:, 0] << MV_FRAC_BITS
                oy = off[:, 1] << MV_FRAC_BITS
                a0x, a0y, a1x, a1y = m0x + ox, m0y + oy, m1x - ox, m1y - oy
            p0e = mc.mc_luma_block(refs[0], x + sx0 - 1, y + sy0 - 1,
                                   sub + 2, a0x, a0y, bd, f=f)
            p1e = mc.mc_luma_block(refs[3], x + sx0 - 1, y + sy0 - 1,
                                   sub + 2, a1x, a1y, bd, f=f)
            if bdof:
                bi = mc.bdof_blend(p0e, p1e, bd)
            else:
                bi = ((4 * p0e[:, 1:-1, 1:-1] + 4 * p1e[:, 1:-1, 1:-1] + 4)
                      >> 3).clamp(0, mx)
            pred_y[ri, sy0:sy0 + sub, sx0:sx0 + sub] = bi
            for pc, r0, r1 in ((pred_cb, refs[1], refs[4]),
                               (pred_cr, refs[2], refs[5])):
                c0 = mc.mc_chroma_block(r0, (x + sx0) // 2, (y + sy0) // 2,
                                        cs2, a0x, a0y, bd, f=f)
                c1 = mc.mc_chroma_block(r1, (x + sx0) // 2, (y + sy0) // 2,
                                        cs2, a1x, a1y, bd, f=f)
                pc[ri, sy0 // 2:sy0 // 2 + cs2, sx0 // 2:sx0 // 2 + cs2] = \
                    ((4 * c0 + 4 * c1 + 4) >> 3).clamp(0, mx)


def _affine_override(pred_y, pred_cb, pred_cr, slots, ai, refs3, s: int,
                     bd: int, at):
    """Affine predictions (per-4x4 MC with PROF in luma) of the leaves
    ``ai`` from one list's (y, cb, cr) references, written into the
    prediction batches in place; CPMV0 is the list's MV (columns 2-3 for
    direction 0, else 4-5), the dmv columns 11-12; at: ref_at of every
    row of ``slots``."""
    sl = slots[ai]
    f, x, y = (a[ai] for a in at)
    l1 = sl[:, 6] != 0
    bmx = torch.where(l1, sl[:, 4], sl[:, 2])
    bmy = torch.where(l1, sl[:, 5], sl[:, 3])
    amx, amy = sl[:, 11], sl[:, 12]
    pred_y[ai] = mc.affine_pred_luma(refs3[0], x, y, s, bmx, bmy, amx, amy,
                                     bd, f=f)
    for pc, r in ((pred_cb, refs3[1]), (pred_cr, refs3[2])):
        pc[ai] = mc.affine_pred_chroma(r, x // 2, y // 2, s // 2, bmx, bmy,
                                       amx, amy, s, bd, f=f)


def _slab_strides(frame_h: int):
    """(luma ref, chroma ref, luma plane, chroma plane, grid8) per-frame
    row strides of stacked batch buffers (frame-batched engine)."""
    return (frame_h + 2 * REF_MARGIN, frame_h // 2 + REF_MARGIN,
            frame_h, frame_h // 2, frame_h // 8)


def make_slots(dec: FrameDecisions, frame_h: int, frame_w: int,
               ctu: int) -> np.ndarray:
    """(N, 16) slot table of a frame's leaves in coding order (CTUs of
    side ``ctu``, the SPS's, in raster order, z-order inside each)."""
    op, xs, ys, modes, mv0, mv1, dirs = planmod.leaf_plan(dec, frame_h,
                                                          frame_w, ctu)
    mts = dec.mts8[ys // 8, xs // 8].astype(np.int32) \
        if dec.mts8 is not None else np.zeros_like(op)
    lf = dec.lfnst8[ys // 8, xs // 8].astype(np.int32) \
        if dec.lfnst8 is not None else np.zeros_like(op)
    cm = dec.cmode8[ys // 8, xs // 8].astype(np.int32) \
        if dec.cmode8 is not None else np.zeros_like(op)
    mr = dec.mrl8[ys // 8, xs // 8].astype(np.int32) \
        if dec.mrl8 is not None else np.zeros_like(op)
    jc = dec.jccr8[ys // 8, xs // 8].astype(np.int32) \
        if dec.jccr8 is not None else np.zeros_like(op)
    ip = dec.isp8[ys // 8, xs // 8].astype(np.int32) \
        if dec.isp8 is not None else np.zeros_like(op)
    z = np.zeros_like(op)
    return np.stack([op, xs, ys, modes, mv0[:, 0], mv0[:, 1], mts, lf, cm,
                     mr, jc, z, z, z, z, ip], axis=1).astype(np.int32)


def make_slots_split(dec: FrameDecisions, frame_h: int, frame_w: int,
                     ctu: int):
    """(scan_slots, {8/16/32: inter_slot_arrays}) — inter leaves pulled out
    of the sequential scan (op -> skip) into fixed-capacity per-size batches
    for the phase-A pass.  Invalid rows use x = y = 2^20 (positive
    out-of-bounds; scatter-dropped, gathers clamp)."""
    op, xs, ys, modes, mv0, mv1, dirs = planmod.leaf_plan(dec, frame_h,
                                                          frame_w, ctu)
    mts = dec.mts8[ys // 8, xs // 8].astype(np.int32) \
        if dec.mts8 is not None else np.zeros_like(op)
    lf = dec.lfnst8[ys // 8, xs // 8].astype(np.int32) \
        if dec.lfnst8 is not None else np.zeros_like(op)
    cm = dec.cmode8[ys // 8, xs // 8].astype(np.int32) \
        if dec.cmode8 is not None else np.zeros_like(op)
    mr = dec.mrl8[ys // 8, xs // 8].astype(np.int32) \
        if dec.mrl8 is not None else np.zeros_like(op)
    jc = dec.jccr8[ys // 8, xs // 8].astype(np.int32) \
        if dec.jccr8 is not None else np.zeros_like(op)
    widx = (dec.bcw8[ys // 8, xs // 8].astype(np.int32)
            if dec.bcw8 is not None
            else np.full_like(op, BCW_DEFAULT))
    ip = dec.isp8[ys // 8, xs // 8].astype(np.int32) \
        if dec.isp8 is not None else np.zeros_like(op)
    slots = np.stack([op, xs, ys, modes, mv0[:, 0], mv0[:, 1], mts, lf, cm,
                      mr, jc, mv1[:, 0], mv1[:, 1], dirs, widx, ip],
                     axis=1).astype(np.int32)
    inter = {}
    for ri, (rw, rh) in enumerate(planmod.RECT_SHAPES):
        opv = planmod.OP_RECT_INTER0 + ri
        cap = (frame_h // rh) * (frame_w // rw)
        arr = np.full((cap, 7), 1 << 20, np.int32)
        m = op == opv
        k = int(m.sum())
        arr[:k, 0] = xs[m]
        arr[:k, 1] = ys[m]
        arr[:k, 2] = mv0[m, 0]
        arr[:k, 3] = mv0[m, 1]
        arr[:k, 4] = mv1[m, 0]
        arr[:k, 5] = mv1[m, 1]
        arr[:k, 6] = dirs[m]
        arr[k:, 2:] = 0
        inter[(rw, rh)] = arr
    for i, s in enumerate((8, 16, 32)):
        opv = i + 4
        cap = (frame_h // s) * (frame_w // s)
        # dummy coordinate must be positive-out-of-bounds: jnp .at[] wraps
        # negative indices instead of dropping them
        arr = np.full((cap, 13), 1 << 20, np.int32)
        m = op == opv
        k = int(m.sum())
        arr[:k, 0] = xs[m]
        arr[:k, 1] = ys[m]
        arr[:k, 2] = mv0[m, 0]
        arr[:k, 3] = mv0[m, 1]
        arr[:k, 4] = mv1[m, 0]
        arr[:k, 5] = mv1[m, 1]
        arr[:k, 6] = dirs[m]
        arr[:k, 7] = (dec.bcw8[ys[m] // 8, xs[m] // 8].astype(np.int32)
                      if dec.bcw8 is not None else BCW_DEFAULT)
        arr[:k, 8] = (dec.sbt8[ys[m] // 8, xs[m] // 8].astype(np.int32)
                      if dec.sbt8 is not None else 0)
        arr[:k, 9] = (dec.gpm8[ys[m] // 8, xs[m] // 8].astype(np.int32)
                      if dec.gpm8 is not None else 0)
        if dec.aff8 is not None:
            arr[:k, 10] = dec.aff8[ys[m] // 8, xs[m] // 8].astype(np.int32)
            arr[:k, 11] = dec.admv8[ys[m] // 8, xs[m] // 8, 0]
            arr[:k, 12] = dec.admv8[ys[m] // 8, xs[m] // 8, 1]
        else:
            arr[:k, 10:] = 0
        arr[k:, 2:] = 0
        arr[k:, 7] = BCW_DEFAULT
        inter[s] = arr
    # ops stay canonical: frame_scan's op->branch table routes phase-A
    # ops (4-6 square inter, 14-17 rect inter) to the no-op branch
    return slots, inter


def _edge_pad(plane, m: int):
    """np.pad(plane, m, mode='edge') on a 2-D tensor."""
    h, w = plane.shape
    dev = plane.device
    iy = (torch.arange(h + 2 * m, device=dev) - m).clamp(0, h - 1)
    ix = (torch.arange(w + 2 * m, device=dev) - m).clamp(0, w - 1)
    return plane[iy[:, None], ix[None, :]]


def pad_refs_dev(rec_planes):
    """Margin-padded (y, cb, cr) reference planes for the decoded picture
    buffer, on the planes' device (bit-identical to np.pad edge)."""
    return (_edge_pad(rec_planes[0], REF_MARGIN),
            _edge_pad(rec_planes[1], REF_MARGIN // 2),
            _edge_pad(rec_planes[2], REF_MARGIN // 2))
