"""Leaf reconstruction pieces — twin of vvctpu/pipeline/recon.py.

Host-side slot tables (copied), the shared residual/recon chain of one
component for a batch of blocks, the phase-A pass that reconstructs every
inter leaf of one size at once (uni- and bi-prediction), and the edge
padding of the decoded picture buffer.  Device planes carry a leading
frame axis (F, h, w) and every block its frame index, so one pass serves
F mutually independent frames.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import intra_pred, mc, transform
from ..spec.codec import FrameDecisions
from ..spec.inter import BCW_DEFAULT, BCW_W, REF_MARGIN
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


def _component(src, pred, f, xs, ys, w: int, h: int, qp: int, bd: int,
               encode: bool, rdoq: bool = False, lam_rd: int = 0):
    """Residual + recon of a batch of (h, w) component blocks with the
    given predictions (twin of recon._component and wave._comp_local).

    src: source planes when encoding, parsed level planes when decoding,
    (F, H, W).  Returns (rec, lev), both (B, h, w) int32."""
    if encode:
        resi = _gather(src, f, xs, ys, w, h).to(torch.int32) - pred
        coef = transform.forward_transform(resi, h, w, bd=bd)
        lev = transform.quantize(coef, h, w, qp, intra=True, bd=bd,
                                 rdoq=rdoq, lam_rd=lam_rd)
    else:
        lev = _gather(src, f, xs, ys, w, h)
    rec = transform.reconstruct(pred, lev, h, w, qp, bd=bd)
    return rec, lev


def chroma_rd(bcbk, bcrk, pred_opts, cs: int, qp: int, bd: int,
              rdoq: bool, lam_rd: int):
    """Chroma prediction choice of a batch of leaves (twin of the
    reference's chroma_rd_j): each (Cb, Cr) prediction pair of
    ``pred_opts`` (DM first, then CCLM) is coded, reconstructed and costed
    in one stacked pass; the first minimum in option order wins.

    bcbk, bcrk: (B, cs, cs) source blocks; pred_opts: [(pred_cb, pred_cr)]
    of (B, cs, cs).  Returns (lev_cb, lev_cr, rec_cb, rec_cr, use_c) with
    use_c the (B,) index of the chosen option."""
    dev = bcbk.device
    P = len(pred_opts)
    mx = (1 << bd) - 1
    res = ([bcbk - pcb for pcb, _ in pred_opts]
           + [bcrk - pcr for _, pcr in pred_opts])
    coef = transform.forward_transform(torch.stack(res, 1), cs, cs, bd=bd)
    lev = transform.quantize(coef, cs, cs, qp, intra=True, bd=bd,
                             rdoq=rdoq, lam_rd=lam_rd)
    rr = transform.inverse_transform(
        transform.dequantize(lev, cs, cs, qp, bd), cs, cs, bd=bd)
    rate_fp = transform.level_rate_fp(
        lev, transform.lvl_weights(qp, dev), dims=(-2, -1)).clamp(
        max=1 << 22)
    rate_w, rate_f = rate_fp >> 8, rate_fp & 255
    dist = ((torch.stack(res, 1) - rr).abs().clamp(max=2047) ** 2).sum(
        (-2, -1), dtype=torch.int32)
    cost = (dist[:, :P] + dist[:, P:] + lam_rd * rate_w[:, :P]
            + ((lam_rd * rate_f[:, :P]) >> 8) + lam_rd * rate_w[:, P:]
            + ((lam_rd * rate_f[:, P:]) >> 8))
    i = torch.argmin(cost, dim=1)
    b = torch.arange(i.shape[0], device=dev)
    pcb = torch.stack([p for p, _ in pred_opts], 1)[b, i]
    pcr = torch.stack([p for _, p in pred_opts], 1)[b, i]
    return (lev[b, i], lev[b, P + i], (pcb + rr[b, i]).clamp(0, mx),
            (pcr + rr[b, P + i]).clamp(0, mx), i.to(torch.int32))


def _scatter(buf, blocks, f, xs, ys, w: int, h: int, off: int):
    """buf[f, ys + off + i, xs + off + j] = blocks[:, i, j], in place.
    Every block must lie inside its frame: callers drop the reference's
    padded rows (x = y = 2^20, which JAX scatters drop) before they reach
    the device."""
    buf[_index(f, xs + off, ys + off, w, h)] = blocks


def _inter_batch_pass(carry, ib_slots, refs, s: int, qp: int, bd: int,
                      encode: bool, rdoq: bool = False, lam_rd: int = 0):
    """Phase A: every inter s-leaf of every frame at once.

    carry: dict of (F, ...) recon buffers, level planes and source planes
    (updated in place); ib_slots: (B, 14) int32 numpy rows of
    make_slots_split plus the frame index in column 13, whose padded rows
    (x = y = 2^20) are dropped here on the host; refs: the padded (l0 y,
    cb, cr, l1 y, cb, cr) reference planes, each an (F, Hp, Wp) stack.
    Column 6 picks L0, L1 or their rounded average (BCW's equal weight:
    the slice has no BCW)."""
    rows = ib_slots[ib_slots[:, 0] < (1 << 20)]
    if rows.shape[0] == 0:
        return
    any_l1 = bool((rows[:, 6] != 0).any())
    slots = torch.as_tensor(np.ascontiguousarray(rows),
                            device=carry["by"].device)
    cs = s // 2
    x, y, f = slots[:, 0], slots[:, 1], slots[:, 13]
    d = slots[:, 6, None, None]
    wv = BCW_W[BCW_DEFAULT]
    mx = (1 << bd) - 1

    def pred(ref0, ref1, px, py, sz, luma):
        fn = mc.mc_luma_block if luma else mc.mc_chroma_block
        p0 = fn(ref0, px, py, sz, slots[:, 2], slots[:, 3], bd, f=f)
        if not any_l1:
            return p0
        p1 = fn(ref1, px, py, sz, slots[:, 4], slots[:, 5], bd, f=f)
        avg = ((wv * p0 + (8 - wv) * p1 + 4) >> 3).clamp(0, mx)
        return torch.where(d == 0, p0, torch.where(d == 1, p1, avg))

    pred_y = pred(refs[0], refs[3], x, y, s, True)
    pred_cb = pred(refs[1], refs[4], x // 2, y // 2, cs, False)
    pred_cr = pred(refs[2], refs[5], x // 2, y // 2, cs, False)
    ry, lvy = _component(carry["sy"], pred_y, f, x, y, s, s, qp, bd, encode,
                         rdoq, lam_rd)
    rcb, lvcb = _component(carry["scb"], pred_cb, f, x // 2, y // 2, cs, cs,
                           qp, bd, encode, rdoq, lam_rd)
    rcr, lvcr = _component(carry["scr"], pred_cr, f, x // 2, y // 2, cs, cs,
                           qp, bd, encode, rdoq, lam_rd)
    _scatter(carry["by"], ry, f, x, y, s, s, 1)
    _scatter(carry["bcb"], rcb, f, x // 2, y // 2, cs, cs, 1)
    _scatter(carry["bcr"], rcr, f, x // 2, y // 2, cs, cs, 1)
    if encode:
        _scatter(carry["ly"], lvy, f, x, y, s, s, 0)
        _scatter(carry["lcb"], lvcb, f, x // 2, y // 2, cs, cs, 0)
        _scatter(carry["lcr"], lvcr, f, x // 2, y // 2, cs, cs, 0)


def _slab_strides(frame_h: int):
    """(luma ref, chroma ref, luma plane, chroma plane, grid8) per-frame
    row strides of stacked batch buffers (frame-batched engine)."""
    return (frame_h + 2 * REF_MARGIN, frame_h // 2 + REF_MARGIN,
            frame_h, frame_h // 2, frame_h // 8)


def make_slots(dec: FrameDecisions, frame_h: int, frame_w: int,
               ctu: int = 64) -> np.ndarray:
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
                     ctu: int = 64):
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
