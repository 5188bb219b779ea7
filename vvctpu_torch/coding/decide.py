"""Batched mode and partition decision — twin of vvctpu/coding/decide.py.

Per block size one batched pass builds the in-frame references of every
block, predicts all 67 modes (and the 16 MIP ids), takes the 8x8-tiled
Hadamard SATD and the integer cost SATD << 8 + bits * lambda, and keeps
the first minimum; with MRL or ISP the winner is then refined over
[itself, reference lines 1 and 2, ISP horizontal and vertical].  Inter
frames add the refined uni costs, the BCW-weighted bi cost, the affine
pass, then the CIIP and GPM passes as challengers.  With the multi-type
tree the same passes run on the rectangular grids of the BT shapes and
the TT stripes (67 modes, uni and equal-weight BI), and the copied
mtt_assemble_* choose among the QT, BT and TT splits.  The partition
and the per-block choice are assembled on the host exactly as in the
reference (int64 costs, first minimum in the reference's kind order).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..cabac import estimate as est
from ..core import rom
from ..device import const
from ..kernels import intra_pred, mc
from ..kernels import me_sad as kme
from ..spec.codec import FrameDecisions, isp_parts
from ..spec.decide import (MODE_BITS, TT_GEOM, _bl, _fill_ibc, _fill_plt,
                           lambda_satd_fp, mtt_assemble_b, mtt_assemble_i,
                           mtt_assemble_p, plt_competition)
from ..spec.inter import AFF_DELTAS, AFF_MIN_SIZE, BCW_DEFAULT, mv_bits_q
from . import me as tme


def _hadamard_abs(x, axes, n: int):
    """Sum of |H x H^T| over n x n tiles whose rows and columns are the
    two ``axes`` of x (an integer butterfly; the absolute sum does not
    depend on the Hadamard row order)."""
    for ax in axes:
        half = n // 2
        while half:
            x = x.unflatten(ax, (n // (2 * half), 2, half))
            a = x.select(ax - 1, 0)
            b = x.select(ax - 1, 1)
            x = torch.stack([a + b, a - b], ax - 1).flatten(ax - 2, ax)
            half //= 2
    return x.abs().sum(axes, dtype=torch.int32)


def _satd_rect8(diff, w: int, h: int):
    """Tiled 8x8 Hadamard SATD of (..., h, w) int32 blocks, per-tile
    rounding as in spec.decide (twin of the reference's _satd_rect8)."""
    x = diff.reshape(*diff.shape[:-2], h // 8, 8, w // 8, 8)
    per_tile = (_hadamard_abs(x, (-3, -1), 8) + 4) >> 3
    return per_tile.sum((-2, -1), dtype=torch.int32)


def _satd(diff, s: int):
    """_satd_rect8 of (..., s, s) blocks."""
    return _satd_rect8(diff, s, s)


def _satd4_rect(diff, w: int, h: int):
    """Tiled 4x4 Hadamard SATD of (..., h, w) blocks (ISP stripes)."""
    x = diff.reshape(*diff.shape[:-2], h // 4, 4, w // 4, 4)
    per_tile = (_hadamard_abs(x, (-3, -1), 4) + 2) >> 2
    return per_tile.sum((-2, -1), dtype=torch.int32)


def _bits(fp, lam: int):
    """(fp * lam) >> 8 in wrapping int32, as a host array."""
    return (np.asarray(fp, np.int64) * lam).astype(np.int32) >> 8


def size_pass(buf, lam: int, *, s: int, frame_w: int, frame_h: int,
              bd: int = 8, B=None, mip: bool = False, mrl: bool = False,
              isp: bool = False):
    """Best (cost, mode, mrl, isp) per s-block over the 67 regular modes
    (+ the 16 MIP ids), then, with ``mrl`` or ``isp``, the winner refined
    over [itself, MRL 1, MRL 2, ISP-H, ISP-V]; int32 (nby, nbx) tensors.
    buf: margin-padded original luma plane."""
    dev = buf.device
    nby, nbx, _, ys, xs = tme.tiling(frame_w, frame_h, s, device=dev)
    if B is None:
        B = est.decision_bits(2, 32)
    nm = rom.NUM_LUMA_MODE
    nmip = 2 * rom.NUM_MIP_MODES
    nblk = ys.shape[0]
    geo = dict(is_luma=True, frame_w=frame_w, frame_h=frame_h,
               n_ctu_x=frame_w // 64, bd=bd, in_frame_only=True)
    top, left = intra_pred.build_references(buf, xs, ys, s=s, **geo)
    blk = tme.blocks(buf, ys, xs, s, s, 1)
    modes = torch.arange(nm, dtype=torch.int32, device=dev).repeat(nblk)
    pred = intra_pred.predict(top.repeat_interleave(nm, 0),
                              left.repeat_interleave(nm, 0), modes, s=s,
                              is_luma=True, bd=bd)
    satd = _satd(blk.repeat_interleave(nm, 0) - pred, s).reshape(nblk, nm)
    del pred
    mfp = np.asarray(B.mode_fp[:nm + nmip], np.int64)
    extra = ((B.mrl0_fp if mrl else 0) + (B.isp0_fp if isp else 0)
             + (B.mip0_fp if mip else 0))
    costs = (satd << 8) + torch.as_tensor(_bits(mfp[:nm] + extra, lam),
                                          device=dev)[None]
    if mip:
        ids = torch.arange(nmip, dtype=torch.int32, device=dev).repeat(nblk)
        mpred = intra_pred.mip_predict(top.repeat_interleave(nmip, 0),
                                       left.repeat_interleave(nmip, 0), ids,
                                       s=s, bd=bd)
        msatd = _satd(blk.repeat_interleave(nmip, 0) - mpred, s) \
            .reshape(nblk, nmip)
        del mpred
        costs = torch.cat([costs, (msatd << 8) + torch.as_tensor(
            _bits(mfp[nm:], lam), device=dev)[None]], 1)
    best = torch.argmin(costs, dim=1)
    bcost = torch.gather(costs, 1, best[:, None])[:, 0]
    best = best.to(torch.int32)
    zero = torch.zeros_like(best)
    if not (mrl or isp):
        return tuple(v.reshape(nby, nbx) for v in (bcost, best, zero, zero))

    sent = torch.full_like(bcost, 1 << 30)
    is_reg = best < nm
    mode_c = best.clamp(2, nm - 1)
    mode_r = best.clamp(max=nm - 1)
    mfp_t = torch.as_tensor(mfp.astype(np.int32), device=dev)
    cands = [bcost]
    for k in (1, 2):
        if not mrl:
            cands.append(sent)
            continue
        kk = torch.full_like(best, k)
        tk, lk = intra_pred.build_references(buf, xs, ys, s=s, ref_line=kk,
                                             **geo)
        pred = intra_pred.predict(tk, lk, mode_c, s=s, is_luma=True, bd=bd,
                                  ref_line=kk)
        fp = mfp_t[mode_c.long()] + int(B.mrl1_fp if k == 1 else B.mrl2_fp)
        c = (_satd(blk - pred, s) << 8) + ((fp * lam) >> 8)
        cands.append(torch.where(is_reg & (best >= 2), c, sent))
    for d in (1, 2):
        if not isp:
            cands.append(sent)
            continue
        total = torch.zeros_like(bcost)
        for (dx, dy, w_st, h_st) in isp_parts(s, d):
            tk, lk = intra_pred.build_references_rect(
                buf, xs + dx, ys + dy, w=w_st, h=h_st, **geo)
            pred = intra_pred.predict_rect(tk, lk, mode_r, w=w_st, h=h_st,
                                           is_luma=True, bd=bd)
            part = blk[:, dy:dy + h_st, dx:dx + w_st]
            total = total + _satd4_rect(part - pred, w_st, h_st)
        fp = mfp_t[mode_r.long()] + int((B.mrl0_fp if mrl else 0)
                                        + B.ispd_fp)
        c = (total << 8) + ((fp * lam) >> 8)
        cands.append(torch.where(is_reg, c, sent))
    arr = torch.stack(cands, 1)
    k = torch.argmin(arr, dim=1)
    cost = torch.gather(arr, 1, k[:, None])[:, 0]
    k = k.to(torch.int32)
    mrl_out = torch.where(k <= 2, k, 0)
    isp_out = torch.where(k <= 2, 0, k - 2)
    return tuple(v.reshape(nby, nbx) for v in (cost, best, mrl_out, isp_out))


def rect_size_pass(buf, lam: int, *, bw: int, bh: int, frame_w: int,
                   frame_h: int, bd: int = 8, sy: int | None = None,
                   sx: int | None = None, oy: int = 0, ox: int = 0,
                   mfp=None):
    """Best (cost, mode) per (bw x bh) block over the 67 regular modes
    (twin of the reference's rect_size_pass; the square-only tools stay
    out), the blocks tiled at stride (sy, sx) from offset (oy, ox)
    (default dense).  mfp: the modes' rates in 1/256 bits (default
    MODE_BITS << 8).  Returns int32 (nby, nbx) tensors (cost, mode).
    buf: margin-padded original luma plane."""
    dev = buf.device
    nby, nbx, _, ys, xs = tme.tiling(frame_w, frame_h, bw, bh, sy, sx, oy,
                                     ox, dev)
    nm = rom.NUM_LUMA_MODE
    nblk = ys.shape[0]
    if mfp is None:
        mfp = np.asarray(MODE_BITS, np.int64) << 8
    top, left = intra_pred.build_references_rect(
        buf, xs, ys, w=bw, h=bh, is_luma=True, frame_w=frame_w,
        frame_h=frame_h, n_ctu_x=frame_w // 64, bd=bd, in_frame_only=True)
    blk = tme.blocks(buf, ys, xs, bw, bh, 1)
    modes = torch.arange(nm, dtype=torch.int32, device=dev).repeat(nblk)
    pred = intra_pred.predict_rect(top.repeat_interleave(nm, 0),
                                   left.repeat_interleave(nm, 0), modes,
                                   w=bw, h=bh, is_luma=True, bd=bd)
    satd = _satd_rect8(blk.repeat_interleave(nm, 0) - pred, bw, bh) \
        .reshape(nblk, nm)
    del pred
    costs = (satd << 8) + torch.as_tensor(
        _bits(np.asarray(mfp, np.int64)[:nm], lam), device=dev)[None]
    best = torch.argmin(costs, dim=1)
    cost = torch.gather(costs, 1, best[:, None])[:, 0]
    return cost.reshape(nby, nbx), best.to(torch.int32).reshape(nby, nbx)


_BT_SHAPES = ((16, 8), (8, 16), (32, 16), (16, 32))


def _rect_keys(tt: bool) -> dict:
    """The rect grids, name -> geometry (bw, bh, sy, sx, oy, ox): the 4 BT
    shapes, dense, and with ``tt`` the 4 TT stripe geometries."""
    keys = {sh: sh + (None, None, 0, 0) for sh in _BT_SHAPES}
    if tt:
        keys.update(TT_GEOM)
    return keys


def _rect_grids_intra(jbuf, lam: int, w: int, h: int, bd: int, tt: bool,
                      B):
    """Host dict {(bw, bh) | TT key: (cost int64, mode)} for the 4 BT
    shapes (and the 4 TT stripe geometries with ``tt``), with the mode
    rates of the DecisionBits B: the input of mtt_assemble_i."""
    out = {}
    for name, (bw, bh, sy, sx, oy, ox) in _rect_keys(tt).items():
        c, m = rect_size_pass(jbuf, lam, bw=bw, bh=bh, frame_w=w, frame_h=h,
                              bd=bd, sy=sy, sx=sx, oy=oy, ox=ox,
                              mfp=B.mode_fp)
        out[name] = (_np(c).astype(np.int64), _np(m))
    return out


def _rect_grids_inter(jbuf, jorig, refs, memaps, lam: int, w: int, h: int,
                      bd: int, tt: bool, B, planes):
    """Host dict {(bw, bh) | TT key: (cost, mode, kind, mv0, mv1)} for the
    rect grids of a P frame (one reference: kind 0 intra / 1 uni) or a B
    frame (kind 0 intra / 1 L0 / 2 L1 / 3 BI at equal weight), the first
    minimum in that order: the input of mtt_assemble_p / _b (twin of the
    reference's _rect_grids_inter).  refs, memaps, planes: per list, the
    padded reference, me_pass's maps and the quarter-phase planes."""
    out = {}
    for name, (bw, bh, sy, sx, oy, ox) in _rect_keys(tt).items():
        geo = dict(frame_w=w, frame_h=h, bd=bd, sy=sy, sx=sx, oy=oy, ox=ox)
        ic, im = rect_size_pass(jbuf, lam, bw=bw, bh=bh, mfp=B.mode_fp,
                                **geo)
        costs, umv = [ic], []
        for lst, ref in enumerate(refs):
            rc, rmv = tme.refine_pass(jorig, ref, memaps[lst][name][1], lam,
                                      s=bw, bh=bh, planes=planes[lst], **geo)
            costs.append(rc)
            umv.append(rmv)
        if len(refs) == 2:
            bc, _ = tme.bi_cost_pass(jorig, umv[0], umv[1], lam, s=bw, bh=bh,
                                     planes0=planes[0], planes1=planes[1],
                                     **geo)
            costs.append(bc)
        stk = torch.stack(costs)
        kind = torch.argmin(stk, dim=0)       # first minimum in kind order
        cost = torch.gather(stk, 0, kind[None])[0]
        mv1 = umv[1] if len(refs) == 2 else torch.zeros_like(umv[0])
        out[name] = (_np(cost).astype(np.int64), _np(im),
                     _np(kind).astype(np.int32), _np(umv[0]), _np(mv1))
    return out


def _pad_buf(orig_y, device):
    h, w = orig_y.shape
    buf = np.zeros((h + 1 + intra_pred.MARGIN, w + 1 + intra_pred.MARGIN),
                   np.int32)
    buf[1:h + 1, 1:w + 1] = orig_y
    return torch.as_tensor(buf, device=device)


def decide_frame_device(orig_y: np.ndarray, qp: int, bd: int = 8, *,
                        device, mip: bool = False, mrl: bool = False,
                        isp: bool = False, mtt: bool = False,
                        tt: bool = False, ibc: bool = False,
                        plt: bool = False):
    """Launch the I-frame decision passes; returns a handle for
    decide_frame_assemble (the square sizes' results and, with ``ibc``,
    the block-vector search's still on the device; with ``mtt`` the rect
    grids, with ``tt`` the TT stripes too, on the host).  ``plt`` has
    decide_frame_assemble run the palette competition on the host."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(2, qp)
    jbuf = _pad_buf(orig_y, device)
    res = {s: size_pass(jbuf, lam, s=s, frame_w=w, frame_h=h, bd=bd, B=B,
                        mip=mip, mrl=mrl, isp=isp)
           for s in (8, 16, 32)}
    ipass = None
    if ibc:
        with record_function("ibc_pass"):
            ipass = tme.ibc_pass(
                torch.as_tensor(np.ascontiguousarray(orig_y, np.int32),
                                device=device), lam, frame_w=w, frame_h=h,
                ibc_fp=int(B.ibc_fp))
    rects = _rect_grids_intra(jbuf, lam, w, h, bd, tt, B) if mtt else None
    return dict(res=res, ipass=ipass, rects=rects, h=h, w=w, lam=lam, B=B,
                plt=plt, bd=bd, orig_y=orig_y)


def _split_and_fill(dec, B, lam, cost8, cost16, cost32):
    """QT split flags from the per-size costs (bottom-up, strict-less);
    returns the (use16, use8) upsampled selection masks."""
    h, w = dec.split16.shape[0] * 16, dec.split16.shape[1] * 16
    n16y, n16x = h // 16, w // 16
    n32y, n32x = h // 32, w // 32
    sum8 = (cost8.reshape(n16y, 2, n16x, 2).sum(axis=(1, 3))
            + _bl(B.split_fp, lam))
    split16 = sum8 < cost16
    c16 = np.where(split16, sum8, cost16)
    sum16 = (c16.reshape(n32y, 2, n32x, 2).sum(axis=(1, 3))
             + _bl(B.split_fp, lam))
    split32 = sum16 < cost32
    dec.split32[:] = split32.astype(np.uint8)
    dec.split16[:] = (split16
                      & np.kron(split32, np.ones((2, 2), bool))).astype(
                          np.uint8)
    use16 = np.kron(split32.astype(bool), np.ones((4, 4), bool))
    use8 = np.kron(dec.split16.astype(bool), np.ones((2, 2), bool))
    return use16, use8


def _pick(a32, a16, a8, use16, use8):
    """Per 8x8 granule: the value of the chosen block size (per-block grids
    of 2 dimensions, or of 3 with a trailing vector axis)."""
    def up(a, f):
        return np.kron(a, np.ones((f, f) + (1,) * (a.ndim - 2), a.dtype))

    if a32.ndim == 3:
        use16, use8 = use16[..., None], use8[..., None]
    v = np.where(use16, up(a16, 2), up(a32, 4))
    return np.where(use8, a8, v)


def _ibc_competition(got, ipass):
    """IBC against the intra winner per square size, strict-less: where
    IBC wins its cost replaces the winner's and the winner's MRL and ISP
    are cleared (twin of the reference's assembly).  ``got[s]`` = [cost
    int64, mode, MRL, ISP] host arrays, changed in place.  Returns
    {s: (IBC use mask, block vectors)}."""
    ibc_data = {}
    for s in (8, 16, 32):
        bc, _, bk, bi = got[s]
        ic = ipass[s][0].cpu().numpy().astype(np.int64)
        use = ic < bc
        bc[:] = np.where(use, ic, bc)
        bk[:] = np.where(use, 0, bk)
        bi[:] = np.where(use, 0, bi)
        ibc_data[s] = (use, ipass[s][1].cpu().numpy())
    return ibc_data


def decide_frame_assemble(hd) -> FrameDecisions:
    """Fetch the device results and run the host bottom-up assembly: IBC
    and then palette (the copied plt_competition, host NumPy) compete
    with the intra winners per square size before the partition."""
    res, h, w, lam, B = hd["res"], hd["h"], hd["w"], hd["lam"], hd["B"]
    got = {s: [np.array(t.cpu().numpy()) for t in res[s]] for s in res}
    for s in got:
        got[s][0] = got[s][0].astype(np.int64)
    ibc_data = None
    if hd["ipass"] is not None:
        ibc_data = _ibc_competition(got, hd["ipass"])
    plt_use = None
    if hd["plt"]:
        with record_function("palette_size_pass"):
            plt_use = plt_competition(
                hd["orig_y"], lam, hd["bd"], ibc_data,
                {s: (got[s][0], got[s][2], got[s][3]) for s in got})
    dec = FrameDecisions.empty(h, w)
    if hd["rects"] is not None:
        mtt_assemble_i(dec, got, hd["rects"], lam, ibc_data=ibc_data,
                       plt_use=plt_use, B=B)
        return dec
    use16, use8 = _split_and_fill(dec, B, lam,
                                  *(got[s][0] for s in (8, 16, 32)))
    planes = [_pick(got[32][i], got[16][i], got[8][i], use16, use8)
              for i in (1, 2, 3)]
    dec.modes8[:] = planes[0]
    dec.mrl8[:] = planes[1].astype(np.uint8)
    dec.isp8[:] = planes[2].astype(np.uint8)
    if ibc_data is not None:
        _fill_ibc(dec, ibc_data, use16, use8)
    if plt_use is not None:
        _fill_plt(dec, plt_use, use16, use8)
    return dec


def decide_frame(orig_y: np.ndarray, qp: int, bd: int = 8, *, device,
                 mip: bool = False, mrl: bool = False, isp: bool = False,
                 mtt: bool = False, tt: bool = False, ibc: bool = False,
                 plt: bool = False) -> FrameDecisions:
    """Decisions for a padded luma plane (host assembly)."""
    return decide_frame_assemble(decide_frame_device(
        orig_y, qp, bd, device=device, mip=mip, mrl=mrl, isp=isp, mtt=mtt,
        tt=tt, ibc=ibc, plt=plt))


def ciip_pass(buf, refp0, refp1, kind, mv0, mv1, bwidx, *, s: int,
              frame_w: int, frame_h: int, bd: int = 8):
    """CIIP refinement SADs per s-block (twin of the reference's
    ciip_pass): the SAD of the merge candidate's MC prediction (L0, L1 or
    the BCW-weighted average by ``kind``) and of its rounded average with
    the planar intra prediction from the original neighbours; both 0
    where kind == 0 (intra).

    buf: margin-padded original luma; refp0/refp1: REF_MARGIN-padded
    reference planes; kind, bwidx (nby, nbx); mv0/mv1 (nby, nbx, 2)
    1/16 pel.  Returns (sad_mc, sad_blend), int32 (nby, nbx)."""
    dev = buf.device
    nby, nbx, _, ys, xs = tme.tiling(frame_w, frame_h, s, device=dev)
    mx = (1 << bd) - 1
    k = kind.reshape(-1)[:, None, None].to(torch.int32)
    m0 = mv0.reshape(-1, 2).to(torch.int32)
    m1 = mv1.reshape(-1, 2).to(torch.int32)
    p0 = mc.mc_luma_block(refp0, xs, ys, s, m0[:, 0], m0[:, 1], bd)
    if refp1 is refp0 and mv1 is mv0:
        p1 = p0
    else:
        p1 = mc.mc_luma_block(refp1, xs, ys, s, m1[:, 0], m1[:, 1], bd)
    w = const(mc.BCW_W_NP, dev)[bwidx.reshape(-1).clamp(0, 2).long()][
        :, None, None]
    pb = ((w * p0 + (8 - w) * p1 + 4) >> 3).clamp(0, mx)
    p = torch.where(k == 1, p0, torch.where(k == 2, p1, pb))
    top, left = intra_pred.build_references(
        buf, xs, ys, s=s, is_luma=True, frame_w=frame_w, frame_h=frame_h,
        n_ctu_x=frame_w // 64, bd=bd, in_frame_only=True)
    pl = intra_pred.predict(top, left,
                            torch.full_like(xs, rom.PLANAR_IDX), s=s,
                            is_luma=True, bd=bd)
    blend = ((p + pl + 1) >> 1).clamp(0, mx)
    ob = tme.blocks(buf, ys, xs, s, s, 1)
    inter = k[:, 0, 0] > 0
    sadm = (ob - p).abs().sum((1, 2), dtype=torch.int32)
    sadb = (ob - blend).abs().sum((1, 2), dtype=torch.int32)
    return (torch.where(inter, sadm, 0).reshape(nby, nbx),
            torch.where(inter, sadb, 0).reshape(nby, nbx))


def gpm_pass(orig, refp0, refp1, mv0, mv1, *, s: int, frame_w: int,
             frame_h: int, bd: int = 8):
    """Best GPM partition per s-block (twin of the reference's gpm_pass):
    the two refined uni predictions blended under each of the 64 masks of
    rom.gpm_masks_all(s), the first SAD minimum.  Returns (sad, idx),
    int32 (nby, nbx)."""
    dev = orig.device
    nby, nbx, _, ys, xs = tme.tiling(frame_w, frame_h, s, device=dev)
    masks = const(mc.gpm_masks(s), dev)[None, 1:]      # (1, 64, s, s)
    m0 = mv0.reshape(-1, 2).to(torch.int32)
    m1 = mv1.reshape(-1, 2).to(torch.int32)
    p0 = mc.mc_luma_block(refp0, xs, ys, s, m0[:, 0], m0[:, 1], bd)[:, None]
    p1 = mc.mc_luma_block(refp1, xs, ys, s, m1[:, 0], m1[:, 1], bd)[:, None]
    pb = ((masks * p0 + (8 - masks) * p1 + 4) >> 3).clamp(0, (1 << bd) - 1)
    ob = tme.blocks(orig.to(torch.int32), ys, xs, s, s)[:, None]
    sads = (ob - pb).abs().sum((2, 3), dtype=torch.int32)
    k = torch.argmin(sads, dim=1)
    sad = torch.gather(sads, 1, k[:, None])[:, 0]
    return sad.reshape(nby, nbx), k.to(torch.int32).reshape(nby, nbx)


def _bitlen_arr(v: np.ndarray) -> np.ndarray:
    """Vectorised threshold-sum bit length == spec inter.bitlen_int."""
    a = np.abs(v.astype(np.int64))
    return sum((a >= (1 << k)).astype(np.int64) for k in range(15))


def affine_pass(orig, refp, base_mv, lam: int, aff_fp: int, *, s: int,
                frame_w: int, frame_h: int, bd: int = 8):
    """Best affine dmv per s-block (twin of the reference's affine_pass):
    the 5x5 grid of AFF_DELTAS in row-major (dy, dx) order, (0, 0) held
    out, each predicted without PROF and costed SAD << 8 + lam * (base MV
    bits + dmv bits) + the affine flag's rate; the first minimum wins.
    Returns (cost, dmv), int32 (nby, nbx) and (nby, nbx, 2)."""
    dev = orig.device
    nby, nbx, _, ys, xs = tme.tiling(frame_w, frame_h, s, device=dev)
    b = base_mv.reshape(-1, 2).to(torch.int32)
    ob = tme.blocks(orig.to(torch.int32), ys, xs, s, s)
    lam = int(lam)
    bbits = (2 + 2 * kme._bitlen(b[:, 0] >> 2)
             + 2 * kme._bitlen(b[:, 1] >> 2))
    extra = (int(aff_fp) * lam) >> 8
    deltas = [(dx, dy) for dy in AFF_DELTAS for dx in AFF_DELTAS]
    costs = []
    for dx, dy in deltas:
        if dx == 0 and dy == 0:
            costs.append(torch.full_like(bbits, 1 << 30))
            continue
        pred = mc.affine_pred_luma(refp, xs, ys, s, b[:, 0], b[:, 1],
                                   torch.full_like(xs, dx),
                                   torch.full_like(xs, dy), bd, prof=False)
        sad = (ob - pred).abs().sum((1, 2), dtype=torch.int32)
        bits = bbits + mv_bits_q(dx >> 2, dy >> 2)
        costs.append((sad << 8) + lam * bits + extra)
    arr = torch.stack(costs, 1)
    k = torch.argmin(arr, dim=1)
    cost = torch.gather(arr, 1, k[:, None])[:, 0]
    dmv = torch.as_tensor(np.asarray(deltas, np.int32), device=dev)[k]
    return cost.reshape(nby, nbx), dmv.reshape(nby, nbx, 2)


def _orig_dev(orig_y, device):
    return torch.as_tensor(np.ascontiguousarray(orig_y, np.int32),
                           device=device)


def _np(t):
    return t.cpu().numpy()


def decide_frame_p(orig_y: np.ndarray, ref_y, qp: int, bd: int = 8, *,
                   device, me_ext: bool = False, mip: bool = False,
                   mrl: bool = False, isp: bool = False, ciip: bool = False,
                   affine: bool = False, mtt: bool = False,
                   tt: bool = False) -> FrameDecisions:
    """P-frame decisions (twin of vvctpu.coding.decide.decide_frame_p):
    per block size the first minimum over [intra, uni, affine], then the
    CIIP refinement of uni blocks; with ``mtt`` the BT grids (and with
    ``tt`` the TT stripes, which put me_sad at 11 keys) and the
    multi-type tree's assembly.  ref_y is the REF_MARGIN edge-padded
    reference luma plane on the device (the DPB entry); me_ext widens the
    integer search to +-ME_EXT (the reference is more than one frame
    away); mip, mrl, isp, ciip, affine: the SPS tools."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(1, qp)
    jbuf = _pad_buf(orig_y, device)
    jorig = _orig_dev(orig_y, device)
    refp80 = ref_y
    with record_function("me"):
        memaps = tme.me_pass(jorig, refp80, lam, frame_w=w, frame_h=h,
                             tt=tt and mtt, ext=me_ext)
    planes = tme.quarter_phase_planes(refp80, bd)
    geo = dict(frame_w=w, frame_h=h, bd=bd)

    data = {}
    for s in (8, 16, 32):
        icost, imode, imrl, iisp = size_pass(jbuf, lam, s=s, B=B, mip=mip,
                                             mrl=mrl, isp=isp, **geo)
        rcost, rmv = tme.refine_pass(jorig, refp80, memaps[s][1], lam, s=s,
                                     planes=planes, **geo)
        acost = np.full(tuple(rcost.shape), np.int64(1) << 60, np.int64)
        admv = np.zeros(tuple(rcost.shape) + (2,), np.int32)
        if affine and s >= AFF_MIN_SIZE:
            ac, ad = affine_pass(jorig, refp80, rmv, lam, B.aff_fp, s=s,
                                 **geo)
            acost, admv = _np(ac).astype(np.int64), _np(ad)
        icost = _np(icost).astype(np.int64)
        rcost = _np(rcost).astype(np.int64)
        # first minimum over (intra, uni, affine): a tie keeps the earlier
        stk = np.stack([icost, rcost, acost])
        k3 = np.argmin(stk, axis=0).astype(np.int32)
        cost = stk.min(0)
        cflag = np.zeros(k3.shape, bool)
        if ciip:
            sadm, sadb = ciip_pass(
                jbuf, refp80, refp80,
                torch.as_tensor((k3 == 1).astype(np.int32), device=device),
                rmv, rmv, torch.ones(k3.shape, dtype=torch.int32,
                                     device=device), s=s, **geo)
            sadm = _np(sadm).astype(np.int64)
            sadb = _np(sadb).astype(np.int64)
            cflag = (k3 == 1) & (sadb < sadm)
            cost = np.where(cflag, cost + ((sadb - sadm) << 8), cost)
        data[s] = (cost, _np(imode), k3 > 0, _np(rmv), _np(imrl), cflag,
                   _np(iisp), k3 == 2, admv)

    dec = FrameDecisions.empty(h, w)
    if mtt:
        rects = _rect_grids_inter(jbuf, jorig, [refp80], [memaps], lam, w, h,
                                  bd, tt, B, [planes])
        mtt_assemble_p(dec, data, rects, lam, ciip, affine, B=B)
        return dec
    use16, use8 = _split_and_fill(dec, B, lam,
                                  *(data[s][0] for s in (8, 16, 32)))

    def sel(i, dtype=None):
        a = [data[s][i] if dtype is None else data[s][i].astype(dtype)
             for s in (32, 16, 8)]
        return _pick(*a, use16, use8)

    itf = sel(2, np.uint8).astype(bool)
    mv = sel(3)
    dec.inter8[:] = itf.astype(np.uint8)
    dec.modes8[:] = np.where(itf, 0, sel(1))
    dec.mrl8[:] = np.where(itf, 0, sel(4)).astype(np.uint8)
    dec.isp8[:] = np.where(itf, 0, sel(6)).astype(np.uint8)
    dec.mv8[:] = np.where(itf[..., None], mv, 0)   # already 1/16-pel
    if ciip:
        dec.ciip8[:] = np.where(itf, sel(5, np.uint8), 0).astype(np.uint8)
    if affine:
        af = sel(7, np.uint8)
        dec.aff8[:] = np.where(itf, af, 0).astype(np.uint8)
        dec.admv8[:] = np.where((itf & (af > 0))[..., None], sel(8), 0)
    return dec


def decide_frame_b(orig_y: np.ndarray, ref0_y, ref1_y, qp: int,
                   bd: int = 8, *, device, me_ext: bool = False,
                   mip: bool = False, mrl: bool = False, isp: bool = False,
                   bcw: bool = False, ciip: bool = False, gpm: bool = False,
                   affine: bool = False, mtt: bool = False,
                   tt: bool = False) -> FrameDecisions:
    """B-frame decisions (twin of vvctpu.coding.decide.decide_frame_b):
    per block size the first minimum over [intra, L0, L1, BI, affine L0,
    affine L1] (a tie keeps the earlier kind), then the CIIP refinement of
    merge-able blocks and the GPM challenge; with ``mtt`` (and ``tt``)
    the rect grids and the multi-type tree's assembly, as in
    decide_frame_p.  ref0_y / ref1_y are the REF_MARGIN edge-padded
    reference luma planes on the device; the tool flags are the SPS's."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(0, qp)
    jbuf = _pad_buf(orig_y, device)
    jorig = _orig_dev(orig_y, device)
    refs = (ref0_y, ref1_y)
    with record_function("me"):
        memaps = [tme.me_pass(jorig, r, lam, frame_w=w, frame_h=h,
                              tt=tt and mtt, ext=me_ext) for r in refs]
    planes = [tme.quarter_phase_planes(r, bd) for r in refs]
    geo = dict(frame_w=w, frame_h=h, bd=bd)

    data = {}
    for s in (8, 16, 32):
        icost, imode, imrl, iisp = size_pass(jbuf, lam, s=s, B=B, mip=mip,
                                             mrl=mrl, isp=isp, **geo)
        ucost, umv = [], []
        for lst in range(2):
            rc, rmv = tme.refine_pass(jorig, refs[lst], memaps[lst][s][1],
                                      lam, s=s, planes=planes[lst], **geo)
            ucost.append(rc)
            umv.append(rmv)
        bcost, bwidx = tme.bi_cost_pass(jorig, umv[0], umv[1], lam, s=s,
                                        planes0=planes[0],
                                        planes1=planes[1], bcw=bcw,
                                        bcw_fp=B.bcw_fp, **geo)
        costs = [icost, ucost[0], ucost[1], bcost]
        admv = [np.zeros(tuple(icost.shape) + (2,), np.int32)] * 2
        if affine and s >= AFF_MIN_SIZE:
            for lst in range(2):
                ac, ad = affine_pass(jorig, refs[lst], umv[lst], lam,
                                     B.aff_fp, s=s, **geo)
                costs.append(ac)
                admv[lst] = _np(ad)
        costs = _np(torch.stack(costs)).astype(np.int64)
        if costs.shape[0] == 4:
            costs = np.concatenate([costs, np.full((2,) + costs.shape[1:],
                                                   np.int64(1) << 60)])
        kind = np.argmin(costs, axis=0).astype(np.int32)
        cost = costs.min(0)
        umv_h = [_np(m) for m in umv]
        bwidx = _np(bwidx)
        cflag = np.zeros(kind.shape, bool)
        if ciip:
            kind_c = np.where(kind <= 3, kind, 0).astype(np.int32)
            sadm, sadb = ciip_pass(
                jbuf, refs[0], refs[1],
                torch.as_tensor(kind_c, device=device), umv[0], umv[1],
                torch.as_tensor(bwidx, device=device), s=s, **geo)
            sadm = _np(sadm).astype(np.int64)
            sadb = _np(sadb).astype(np.int64)
            cflag = (kind_c > 0) & (sadb < sadm)
            cost = np.where(cflag, cost + ((sadb - sadm) << 8), cost)
        gval = np.zeros(kind.shape, np.int32)
        if gpm:
            gsad, gidx = gpm_pass(jorig, refs[0], refs[1], umv[0], umv[1],
                                  s=s, **geo)
            gsad = _np(gsad).astype(np.int64)
            gbits = (4 + 2 * _bitlen_arr(umv_h[0][..., 0] >> 2)
                     + 2 * _bitlen_arr(umv_h[0][..., 1] >> 2)
                     + 2 * _bitlen_arr(umv_h[1][..., 0] >> 2)
                     + 2 * _bitlen_arr(umv_h[1][..., 1] >> 2))
            gcost = (gsad << 8) + lam * gbits + _bl(B.gpm_fp, lam)
            guse = gcost < cost
            cost = np.where(guse, gcost, cost)
            kind = np.where(guse, 3, kind).astype(np.int32)
            cflag = cflag & ~guse
            bwidx = np.where(guse, BCW_DEFAULT, bwidx)
            gval = np.where(guse, _np(gidx) + 1, 0).astype(np.int32)
        adm = np.where((kind == 4)[..., None], admv[0],
                       np.where((kind == 5)[..., None], admv[1], 0))
        data[s] = (cost, _np(imode), kind, umv_h[0], umv_h[1], _np(imrl),
                   bwidx, cflag, _np(iisp), gval, adm)

    dec = FrameDecisions.empty(h, w)
    if mtt:
        rects = _rect_grids_inter(jbuf, jorig, refs, memaps, lam, w, h, bd,
                                  tt, B, planes)
        mtt_assemble_b(dec, data, rects, lam, ciip, affine, bcw, gpm, B=B)
        return dec
    use16, use8 = _split_and_fill(dec, B, lam,
                                  *(data[s][0] for s in (8, 16, 32)))

    def sel(i, dtype=None):
        a = [data[s][i] if dtype is None else data[s][i].astype(dtype)
             for s in (32, 16, 8)]
        return _pick(*a, use16, use8)

    kind = sel(2)
    itf = kind > 0
    dec.inter8[:] = itf.astype(np.uint8)
    dec.modes8[:] = np.where(itf, 0, sel(1))
    dec.mrl8[:] = np.where(itf, 0, sel(5)).astype(np.uint8)
    dec.isp8[:] = np.where(itf, 0, sel(8)).astype(np.uint8)
    # kind 1/4 = L0, 2/5 = L1, 3 = BI -> dir 0 / 1 / 2
    dirv = np.where(kind == 3, 2, np.where((kind == 1) | (kind == 4), 0, 1))
    dec.dir8[:] = np.where(itf, dirv, 0).astype(np.uint8)
    use0 = itf & ((kind == 1) | (kind == 3) | (kind == 4))
    use1 = itf & ((kind == 2) | (kind == 3) | (kind == 5))
    dec.mv8[:] = np.where(use0[..., None], sel(3), 0)
    dec.mv8_l1[:] = np.where(use1[..., None], sel(4), 0)
    if bcw:
        dec.bcw8[:] = np.where(itf & (kind == 3), sel(6),
                               BCW_DEFAULT).astype(np.uint8)
    if ciip:
        dec.ciip8[:] = np.where(itf, sel(7, np.uint8), 0).astype(np.uint8)
    if gpm:
        dec.gpm8[:] = np.where(itf & (kind == 3), sel(9),
                               0).astype(np.uint8)
    if affine:
        dec.aff8[:] = (kind >= 4).astype(np.uint8)
        dec.admv8[:] = np.where((kind >= 4)[..., None], sel(10), 0)
    return dec
