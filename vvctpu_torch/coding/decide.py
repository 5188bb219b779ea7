"""Batched mode and partition decision — twin of vvctpu/coding/decide.py.

Per block size one batched pass builds the in-frame references of every
block, predicts all 67 modes, takes the 8x8-tiled Hadamard SATD and the
integer cost SATD << 8 + bits * lambda, and keeps the first minimum.  The
QT partition and the P-frame intra/inter choice are then assembled on the
host exactly as in the reference; B frames choose per block among
intra, L0, L1 and the bi-predicted average.  Default toolset only.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..cabac import estimate as est
from ..core import rom
from ..kernels import intra_pred
from ..spec.codec import FrameDecisions
from ..spec.decide import _bl, lambda_satd_fp
from . import me as tme


def _satd(diff, s: int):
    """Tiled 8x8 Hadamard SATD of (..., s, s) int32 blocks, per-tile
    rounding as in spec.decide; the transform is an integer butterfly
    (the absolute sum does not depend on the Hadamard row order)."""
    t = s // 8
    lead = diff.shape[:-2]
    x = diff.reshape(*lead, t, 8, t, 8)
    for ax in (-3, -1):          # rows within a tile, then columns
        for half in (4, 2, 1):
            x = x.unflatten(ax, (8 // (2 * half), 2, half))
            a = x.select(ax - 1, 0)
            b = x.select(ax - 1, 1)
            x = torch.stack([a + b, a - b], ax - 1).flatten(ax - 2, ax)
    per_tile = (x.abs().sum((-3, -1), dtype=torch.int32) + 4) >> 3
    return per_tile.sum((-2, -1), dtype=torch.int32)


def size_pass(buf, lam: int, *, s: int, frame_w: int, frame_h: int,
              bd: int = 8, B=None):
    """Best (cost, mode) per s-block over the 67 regular modes; int32
    (nby, nbx) arrays.  buf: margin-padded original luma plane."""
    dev = buf.device
    nby, nbx = frame_h // s, frame_w // s
    if B is None:
        B = est.decision_bits(2, 32)
    nm = rom.NUM_LUMA_MODE
    ys = (torch.arange(nby, dtype=torch.int32, device=dev) * s)[:, None] \
        .expand(nby, nbx).reshape(-1)
    xs = (torch.arange(nbx, dtype=torch.int32, device=dev) * s)[None, :] \
        .expand(nby, nbx).reshape(-1)
    nblk = ys.shape[0]
    top, left = intra_pred.build_references(
        buf, xs, ys, s=s, is_luma=True, frame_w=frame_w, frame_h=frame_h,
        n_ctu_x=frame_w // 64, bd=bd, in_frame_only=True)
    ar = torch.arange(s, device=dev)
    blk = buf[(ys.long() + 1)[:, None, None] + ar[None, :, None],
              (xs.long() + 1)[:, None, None] + ar[None, None, :]]
    modes = torch.arange(nm, dtype=torch.int32, device=dev).repeat(nblk)
    pred = intra_pred.predict(top.repeat_interleave(nm, 0),
                              left.repeat_interleave(nm, 0), modes, s=s,
                              is_luma=True, bd=bd)
    satd = _satd(blk.repeat_interleave(nm, 0) - pred, s).reshape(nblk, nm)
    bits = torch.as_tensor(
        ((np.asarray(B.mode_fp[:nm], np.int64) * lam) >> 8).astype(np.int32),
        device=dev)
    costs = (satd << 8) + bits[None]
    best = torch.argmin(costs, dim=1)
    bcost = torch.gather(costs, 1, best[:, None])[:, 0]
    return bcost.reshape(nby, nbx), best.to(torch.int32).reshape(nby, nbx)


def _pad_buf(orig_y, device):
    h, w = orig_y.shape
    buf = np.zeros((h + 1 + intra_pred.MARGIN, w + 1 + intra_pred.MARGIN),
                   np.int32)
    buf[1:h + 1, 1:w + 1] = orig_y
    return torch.as_tensor(buf, device=device)


def decide_frame_device(orig_y: np.ndarray, qp: int, bd: int = 8, *,
                        device):
    """Launch the I-frame decision passes; returns a handle for
    decide_frame_assemble (results still on the device)."""
    h, w = orig_y.shape
    lam = lambda_satd_fp(qp)
    B = est.decision_bits(2, qp)
    jbuf = _pad_buf(orig_y, device)
    res = {s: size_pass(jbuf, lam, s=s, frame_w=w, frame_h=h, bd=bd, B=B)
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
    cost = {s: res[s][0].cpu().numpy().astype(np.int64) for s in res}
    mode = {s: res[s][1].cpu().numpy() for s in res}
    dec = FrameDecisions.empty(h, w)
    use16, use8 = _split_and_fill(dec, B, lam, cost[8], cost[16], cost[32])
    dec.modes8[:] = _pick(mode[32], mode[16], mode[8], use16, use8)
    dec.mrl8[:] = 0
    dec.isp8[:] = 0
    return dec


def decide_frame(orig_y: np.ndarray, qp: int, bd: int = 8, *,
                 device) -> FrameDecisions:
    """Decisions for a padded luma plane (host assembly)."""
    return decide_frame_assemble(decide_frame_device(orig_y, qp, bd,
                                                     device=device))


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
        icost, imode = size_pass(jbuf, lam, s=s, frame_w=w, frame_h=h,
                                 bd=bd, B=B)
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
        icost, imode = size_pass(jbuf, lam, s=s, frame_w=w, frame_h=h,
                                 bd=bd, B=B)
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
