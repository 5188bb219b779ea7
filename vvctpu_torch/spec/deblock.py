"""In-loop deblocking filter — spec model (vectorised numpy, integer exact).

Role of VTM:CommonLib/DeblockingFilter.cpp (xDeblockCU, xEdgeFilterLuma,
xEdgeFilterChroma).  Structure follows the standard design:

* edges on the 8x8 luma grid at leaf boundaries (all CUs are intra this
  round, so boundary strength is uniformly 2);
* ALL vertical edges are filtered first, then horizontal edges operate on the
  vertically-filtered samples;
* luma: per-4-line segments, d < beta on/off decision, strong (3+3 tap
  HEVC-style) vs weak (delta) filter selection, tc clipping;
* chroma: 2-point filter on the co-sited grid.

The beta/tc tables are generated monotone curves shaped like the standard's
(exact spec tables are drop-in replaceable — reference mount was empty,
SURVEY.md §0; encoder and decoder share these so the loop stays closed).

Edge masks derive from FrameDecisions geometry (pipeline/plan granularity),
so the JAX twin (kernels/deblock.py) uses identical inputs and must match
bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from ..core import rom

# beta: the published HEVC/VVC beta' table (H.266 deblocking): 0 below
# qp 16, +1 per qp through 28 (6..18), then +2 per qp to 88 at qp 63
# (r5: spec literal — the generated curve used +2/qp throughout and
# deviated for qp 17..28).  tc stays a generated monotone curve: the
# published VVC tc' values (10-bit scale, ending 395) are not confidently
# reconstructible offline — documented gap, drop-in replaceable.
_QPS = np.arange(64)
BETA_TABLE = np.where(
    _QPS < 16, 0,
    np.where(_QPS <= 28, _QPS - 10, np.minimum(2 * (_QPS - 28) + 18, 88)))
TC_TABLE = np.where(
    _QPS < 18, 0,
    np.maximum(1, np.round(2.0 ** ((_QPS - 18) / 6.0)).astype(np.int64)))
BETA_TABLE = BETA_TABLE.astype(np.int64)
TC_TABLE = TC_TABLE.astype(np.int64)
# spec anchors: qp16 -> 6, qp28 -> 18, qp29 -> 20, qp51 -> 64, qp63 -> 88
assert (BETA_TABLE[16], BETA_TABLE[28], BETA_TABLE[29], BETA_TABLE[51],
        BETA_TABLE[63]) == (6, 18, 20, 64, 88), tuple(BETA_TABLE[:52:5])


def edge_masks(decisions, height: int, width: int):
    """(ver_mask, hor_mask) bool arrays over the 8x8-granule grid: granule
    (gy, gx) has an active left/top edge iff its leaf starts there."""
    g_h, g_w = height // 8, width // 8
    size = np.full((g_h, g_w), 32, np.int32)
    s32 = np.kron(decisions.split32.astype(bool),
                  np.ones((4, 4), bool))[:g_h, :g_w]
    s16 = np.kron(decisions.split16.astype(bool),
                  np.ones((2, 2), bool))[:g_h, :g_w]
    size = np.where(s32, 16, size)
    size = np.where(s16 & s32, 8, size)
    gx = np.arange(g_w)[None, :] * 8
    gy = np.arange(g_h)[:, None] * 8
    ver = ((gx % size) == 0) & (gx > 0)
    hor = ((gy % size) == 0) & (gy > 0)
    if decisions.bt32 is not None:
        # internal boundaries of MTT binary splits (leaf halves)
        gxi = np.arange(g_w)[None, :]
        gyi = np.arange(g_h)[:, None]
        b32 = np.kron(decisions.bt32,
                      np.ones((4, 4), np.uint8))[:g_h, :g_w]
        b16 = np.kron(decisions.bt16,
                      np.ones((2, 2), np.uint8))[:g_h, :g_w]
        hor = hor | ((b32 == 1) & (gyi % 4 == 2))
        ver = ver | ((b32 == 2) & (gxi % 4 == 2))
        hor = hor | ((b16 == 1) & (gyi % 2 == 1))
        ver = ver | ((b16 == 2) & (gxi % 2 == 1))
        # ternary splits: stripe boundaries at 1/4 and 3/4 of the 32 node
        hor = hor | ((b32 == 3) & ((gyi % 4 == 1) | (gyi % 4 == 3)))
        ver = ver | ((b32 == 4) & ((gxi % 4 == 1) | (gxi % 4 == 3)))
    return ver, hor


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_ver(rec: np.ndarray, mask: np.ndarray, qp: int,
                     bd: int) -> np.ndarray:
    """Filter all active vertical luma edges.  mask: (H//8, W//8) granule
    left-edge activity; segments are 4 rows tall."""
    h, w = rec.shape
    beta = int(BETA_TABLE[qp]) << (bd - 8)
    tc = int(TC_TABLE[qp]) << (bd - 8)
    if tc == 0 and beta == 0:
        return rec
    out = rec.astype(np.int64)
    # per 4-row segment y0, granule row = y0 // 8 (each granule row = 2 segs)
    for gxi in range(mask.shape[1]):
        x = gxi * 8
        if x == 0:
            continue
        col_active_rows = np.nonzero(mask[:, gxi])[0]
        if len(col_active_rows) == 0:
            continue
        segs = np.concatenate([np.array([gr * 2, gr * 2 + 1])
                               for gr in col_active_rows])
        y0 = segs * 4
        # samples: p3..p0 = x-4..x-1, q0..q3 = x..x+3, rows (nseg, 4)
        rows = y0[:, None] + np.arange(4)[None, :]
        p = [out[rows, x - 1 - i] for i in range(4)]
        q = [out[rows, x + i] for i in range(4)]
        fp, fq = _luma_segment_filter(p, q, beta, tc, bd)
        for i in range(3):
            out[rows, x - 1 - i] = fp[i]
            out[rows, x + i] = fq[i]
    return out.astype(np.int32)


def _luma_segment_filter(p, q, beta, tc, bd):
    """p, q: lists of 4 arrays (nseg, 4) [idx 0 nearest edge].  Returns
    filtered (p0..p2, q0..q2)."""
    dp_line = np.abs(p[2] - 2 * p[1] + p[0])     # (nseg, 4)
    dq_line = np.abs(q[2] - 2 * q[1] + q[0])
    dp = dp_line[:, 0] + dp_line[:, 3]
    dq = dq_line[:, 0] + dq_line[:, 3]
    d = dp + dq
    active = (d < beta)[:, None]                  # broadcast over lines

    strong_l = np.ones(p[0].shape[0], bool)
    for ln in (0, 3):
        sd = 2 * (dp_line[:, ln] + dq_line[:, ln]) < (beta >> 2)
        sg = (np.abs(p[3][:, ln] - p[0][:, ln])
              + np.abs(q[0][:, ln] - q[3][:, ln])) < (beta >> 3)
        st = np.abs(p[0][:, ln] - q[0][:, ln]) < ((5 * tc + 1) >> 1)
        strong_l &= sd & sg & st
    strong = strong_l[:, None]

    # strong filter (clipped to +-2tc around input)
    def c2(v, ref):
        return _clip3(ref - 2 * tc, ref + 2 * tc, v)

    sp0 = c2((p[2] + 2 * p[1] + 2 * p[0] + 2 * q[0] + q[1] + 4) >> 3, p[0])
    sp1 = c2((p[2] + p[1] + p[0] + q[0] + 2) >> 2, p[1])
    sp2 = c2((2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3, p[2])
    sq0 = c2((q[2] + 2 * q[1] + 2 * q[0] + 2 * p[0] + p[1] + 4) >> 3, q[0])
    sq1 = c2((q[2] + q[1] + q[0] + p[0] + 2) >> 2, q[1])
    sq2 = c2((2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3, q[2])

    # weak filter
    delta = (9 * (q[0] - p[0]) - 3 * (q[1] - p[1]) + 8) >> 4
    weak_on = np.abs(delta) < (tc * 10)
    dc = _clip3(-tc, tc, delta)
    mx = (1 << bd) - 1
    wp0 = _clip3(0, mx, p[0] + dc)
    wq0 = _clip3(0, mx, q[0] - dc)
    side_p = (dp < ((beta + (beta >> 1)) >> 3))[:, None]
    side_q = (dq < ((beta + (beta >> 1)) >> 3))[:, None]
    tc2 = tc >> 1
    dp1 = _clip3(-tc2, tc2, (((p[2] + p[0] + 1) >> 1) - p[1] + dc) >> 1)
    dq1 = _clip3(-tc2, tc2, (((q[2] + q[0] + 1) >> 1) - q[1] - dc) >> 1)
    wp1 = _clip3(0, mx, p[1] + dp1)
    wq1 = _clip3(0, mx, q[1] + dq1)

    fp0 = np.where(active, np.where(strong, sp0,
                                    np.where(weak_on, wp0, p[0])), p[0])
    fq0 = np.where(active, np.where(strong, sq0,
                                    np.where(weak_on, wq0, q[0])), q[0])
    fp1 = np.where(active, np.where(strong, sp1,
                                    np.where(weak_on & side_p, wp1, p[1])),
                   p[1])
    fq1 = np.where(active, np.where(strong, sq1,
                                    np.where(weak_on & side_q, wq1, q[1])),
                   q[1])
    fp2 = np.where(active & strong, sp2, p[2])
    fq2 = np.where(active & strong, sq2, q[2])
    mxv = (1 << bd) - 1
    return ([_clip3(0, mxv, fp0), _clip3(0, mxv, fp1), _clip3(0, mxv, fp2)],
            [_clip3(0, mxv, fq0), _clip3(0, mxv, fq1), _clip3(0, mxv, fq2)])


def _filter_chroma_ver(rec: np.ndarray, mask: np.ndarray, qp: int,
                       bd: int) -> np.ndarray:
    """Chroma vertical edges: 2-point filter, co-sited 4-px grid (mask is the
    luma granule mask; chroma edge x = 4 * gxi)."""
    tc = int(TC_TABLE[qp]) << (bd - 8)
    if tc == 0:
        return rec
    out = rec.astype(np.int64)
    h, w = rec.shape
    mx = (1 << bd) - 1
    for gxi in range(mask.shape[1]):
        x = gxi * 4
        if x == 0 or x + 1 >= w or x < 2:
            continue
        rows_active = np.nonzero(mask[:, gxi])[0]
        if len(rows_active) == 0:
            continue
        ys = np.concatenate([np.arange(gr * 4, gr * 4 + 4)
                             for gr in rows_active])
        ys = ys[ys < h]
        p0 = out[ys, x - 1]
        p1 = out[ys, x - 2]
        q0 = out[ys, x]
        q1 = out[ys, x + 1]
        delta = _clip3(-tc, tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3)
        out[ys, x - 1] = _clip3(0, mx, p0 + delta)
        out[ys, x] = _clip3(0, mx, q0 - delta)
    return out.astype(np.int32)


def deblock_frame(planes, decisions, qp: int, bd: int = 8):
    """Apply deblocking to [Y, Cb, Cr] (padded planes).  Returns new list."""
    y, cb, cr = planes
    h, w = y.shape
    ver, hor = edge_masks(decisions, h, w)
    out_y = _filter_luma_ver(y, ver, qp, bd)
    out_y = _filter_luma_ver(out_y.T, hor.T, qp, bd).T
    out_cb = _filter_chroma_ver(cb, ver, qp, bd)
    out_cb = _filter_chroma_ver(out_cb.T, hor.T, qp, bd).T
    out_cr = _filter_chroma_ver(cr, ver, qp, bd)
    out_cr = _filter_chroma_ver(out_cr.T, hor.T, qp, bd).T
    return [out_y, out_cb, out_cr]
