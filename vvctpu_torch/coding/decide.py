"""Batched mode and partition decision — twin of vvctpu/coding/decide.py.

Per block size one batched pass builds the in-frame references of every
block, predicts all 67 modes (and the 16 MIP ids), takes the 8x8-tiled
Hadamard SATD and the integer cost SATD << 8 + bits * lambda, and keeps
the first minimum; with MRL or ISP the winner is then refined over
[itself, reference lines 1 and 2, ISP horizontal and vertical].  The QT
partition and the P-frame intra/inter choice are then assembled on the
host exactly as in the reference; B frames choose per block among
intra, L0, L1 and the bi-predicted average.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..cabac import estimate as est
from ..core import rom
from ..kernels import intra_pred
from ..spec.codec import FrameDecisions, isp_parts
from ..spec.decide import _bl, lambda_satd_fp
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


def _satd(diff, s: int):
    """Tiled 8x8 Hadamard SATD of (..., s, s) int32 blocks, per-tile
    rounding as in spec.decide."""
    t = s // 8
    x = diff.reshape(*diff.shape[:-2], t, 8, t, 8)
    per_tile = (_hadamard_abs(x, (-3, -1), 8) + 4) >> 3
    return per_tile.sum((-2, -1), dtype=torch.int32)


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
    nby, nbx = frame_h // s, frame_w // s
    if B is None:
        B = est.decision_bits(2, 32)
    nm = rom.NUM_LUMA_MODE
    nmip = 2 * rom.NUM_MIP_MODES
    ys = (torch.arange(nby, dtype=torch.int32, device=dev) * s)[:, None] \
        .expand(nby, nbx).reshape(-1)
    xs = (torch.arange(nbx, dtype=torch.int32, device=dev) * s)[None, :] \
        .expand(nby, nbx).reshape(-1)
    nblk = ys.shape[0]
    geo = dict(is_luma=True, frame_w=frame_w, frame_h=frame_h,
               n_ctu_x=frame_w // 64, bd=bd, in_frame_only=True)
    top, left = intra_pred.build_references(buf, xs, ys, s=s, **geo)
    ar = torch.arange(s, device=dev)
    blk = buf[(ys.long() + 1)[:, None, None] + ar[None, :, None],
              (xs.long() + 1)[:, None, None] + ar[None, None, :]]
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


def _pad_buf(orig_y, device):
    h, w = orig_y.shape
    buf = np.zeros((h + 1 + intra_pred.MARGIN, w + 1 + intra_pred.MARGIN),
                   np.int32)
    buf[1:h + 1, 1:w + 1] = orig_y
    return torch.as_tensor(buf, device=device)


def decide_frame_device(orig_y: np.ndarray, qp: int, bd: int = 8, *,
                        device, mip: bool = False, mrl: bool = False,
                        isp: bool = False):
    """Launch the I-frame decision passes; returns a handle for
    decide_frame_assemble (results still on the device)."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(2, qp)
    jbuf = _pad_buf(orig_y, device)
    res = {s: size_pass(jbuf, lam, s=s, frame_w=w, frame_h=h, bd=bd, B=B,
                        mip=mip, mrl=mrl, isp=isp)
           for s in (8, 16, 32)}
    return dict(res=res, h=h, w=w, lam=lam, B=B)


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
    """Per 8x8 granule: the value of the chosen block size."""
    v = np.kron(a32, np.ones((4, 4), a32.dtype))
    v = np.where(use16, np.kron(a16, np.ones((2, 2), a16.dtype)), v)
    return np.where(use8, a8, v)


def decide_frame_assemble(hd) -> FrameDecisions:
    """Fetch the device results and run the host bottom-up assembly."""
    res, h, w, lam, B = hd["res"], hd["h"], hd["w"], hd["lam"], hd["B"]
    got = {s: [t.cpu().numpy() for t in res[s]] for s in res}
    dec = FrameDecisions.empty(h, w)
    use16, use8 = _split_and_fill(dec, B, lam,
                                  *(got[s][0].astype(np.int64)
                                    for s in (8, 16, 32)))
    planes = [_pick(got[32][i], got[16][i], got[8][i], use16, use8)
              for i in (1, 2, 3)]
    dec.modes8[:] = planes[0]
    dec.mrl8[:] = planes[1].astype(np.uint8)
    dec.isp8[:] = planes[2].astype(np.uint8)
    return dec


def decide_frame(orig_y: np.ndarray, qp: int, bd: int = 8, *, device,
                 mip: bool = False, mrl: bool = False,
                 isp: bool = False) -> FrameDecisions:
    """Decisions for a padded luma plane (host assembly)."""
    return decide_frame_assemble(decide_frame_device(
        orig_y, qp, bd, device=device, mip=mip, mrl=mrl, isp=isp))


def _orig_dev(orig_y, device):
    return torch.as_tensor(np.ascontiguousarray(orig_y, np.int32),
                           device=device)


def decide_frame_p(orig_y: np.ndarray, ref_y, qp: int, bd: int = 8, *,
                   device, me_ext: bool = False) -> FrameDecisions:
    """P-frame decisions: ref_y is the REF_MARGIN edge-padded reference
    luma plane on the device (the DPB entry); me_ext widens the integer
    search to +-ME_EXT (the reference is more than one frame away)."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(1, qp)
    jbuf = _pad_buf(orig_y, device)
    jorig = _orig_dev(orig_y, device)
    refp80 = ref_y
    with record_function("me"):
        memaps = tme.me_pass(jorig, refp80, lam, frame_w=w, frame_h=h,
                             ext=me_ext)
    planes = tme.quarter_phase_planes(refp80, bd)

    data = {}
    for s in (8, 16, 32):
        icost, imode, _, _ = size_pass(jbuf, lam, s=s, frame_w=w,
                                       frame_h=h, bd=bd, B=B)
        rcost, rmv = tme.refine_pass(jorig, refp80, memaps[s][1], lam, s=s,
                                     frame_w=w, frame_h=h, bd=bd,
                                     planes=planes)
        icost = icost.cpu().numpy().astype(np.int64)
        rcost = rcost.cpu().numpy().astype(np.int64)
        # first minimum over (intra, inter): a tie keeps intra
        data[s] = (np.minimum(icost, rcost), imode.cpu().numpy(),
                   rcost < icost, rmv.cpu().numpy())

    dec = FrameDecisions.empty(h, w)
    (cost8, imode8, inter8, mv8) = data[8]
    (cost16, imode16, inter16, mv16) = data[16]
    (cost32, imode32, inter32, mv32) = data[32]
    use16, use8 = _split_and_fill(dec, B, lam, cost8, cost16, cost32)
    mode = _pick(imode32, imode16, imode8, use16, use8)
    itf = _pick(inter32.astype(np.uint8), inter16.astype(np.uint8),
                inter8.astype(np.uint8), use16, use8).astype(bool)
    mvx = _pick(mv32[..., 0], mv16[..., 0], mv8[..., 0], use16, use8)
    mvy = _pick(mv32[..., 1], mv16[..., 1], mv8[..., 1], use16, use8)
    dec.inter8[:] = itf.astype(np.uint8)
    dec.modes8[:] = np.where(itf, 0, mode)
    dec.mrl8[:] = 0
    dec.isp8[:] = 0
    dec.mv8[..., 0] = np.where(itf, mvx, 0)   # already 1/16-pel
    dec.mv8[..., 1] = np.where(itf, mvy, 0)
    return dec


def decide_frame_b(orig_y: np.ndarray, ref0_y, ref1_y, qp: int,
                   bd: int = 8, *, device,
                   me_ext: bool = False) -> FrameDecisions:
    """B-frame decisions (twin of vvctpu.coding.decide.decide_frame_b,
    default toolset): per block size the intra cost, the refined uni cost
    of each list and the bi cost; the first minimum over [intra, L0, L1,
    BI] wins, so a tie keeps the earlier kind.  ref0_y / ref1_y are the
    REF_MARGIN edge-padded reference luma planes on the device."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(0, qp)
    jbuf = _pad_buf(orig_y, device)
    jorig = _orig_dev(orig_y, device)
    refs = (ref0_y, ref1_y)
    with record_function("me"):
        memaps = [tme.me_pass(jorig, r, lam, frame_w=w, frame_h=h,
                              ext=me_ext) for r in refs]
    planes = [tme.quarter_phase_planes(r, bd) for r in refs]

    data = {}
    for s in (8, 16, 32):
        icost, imode, _, _ = size_pass(jbuf, lam, s=s, frame_w=w,
                                       frame_h=h, bd=bd, B=B)
        ucost, umv = [], []
        for lst in range(2):
            rc, rmv = tme.refine_pass(jorig, refs[lst], memaps[lst][s][1],
                                      lam, s=s, frame_w=w, frame_h=h, bd=bd,
                                      planes=planes[lst])
            ucost.append(rc)
            umv.append(rmv)
        bcost, _ = tme.bi_cost_pass(jorig, umv[0], umv[1], lam, s=s,
                                    frame_w=w, frame_h=h, bd=bd,
                                    planes0=planes[0], planes1=planes[1])
        costs = torch.stack([icost, ucost[0], ucost[1], bcost]).cpu() \
            .numpy().astype(np.int64)
        data[s] = (costs.min(0), imode.cpu().numpy(),
                   costs.argmin(0).astype(np.int32), umv[0].cpu().numpy(),
                   umv[1].cpu().numpy())

    dec = FrameDecisions.empty(h, w)
    (c8, im8, k8, mva8, mvb8) = data[8]
    (c16, im16, k16, mva16, mvb16) = data[16]
    (c32, im32, k32, mva32, mvb32) = data[32]
    use16, use8 = _split_and_fill(dec, B, lam, c8, c16, c32)
    kind = _pick(k32, k16, k8, use16, use8)
    mode = _pick(im32, im16, im8, use16, use8)
    itf = kind > 0
    dec.inter8[:] = itf.astype(np.uint8)
    dec.modes8[:] = np.where(itf, 0, mode)
    dec.mrl8[:] = 0
    dec.isp8[:] = 0
    # kind 1 = L0, 2 = L1, 3 = BI -> dir 0 / 1 / 2
    dec.dir8[:] = np.where(itf, kind - 1, 0).astype(np.uint8)
    use0 = (kind == 1) | (kind == 3)
    use1 = (kind == 2) | (kind == 3)
    for c in range(2):
        dec.mv8[..., c] = np.where(
            use0, _pick(mva32[..., c], mva16[..., c], mva8[..., c], use16,
                        use8), 0)
        dec.mv8_l1[..., c] = np.where(
            use1, _pick(mvb32[..., c], mvb16[..., c], mvb8[..., c], use16,
                        use8), 0)
    return dec
