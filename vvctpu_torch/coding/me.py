"""Integer and sub-pel motion estimation — twin of vvctpu/coding/me.py.

The dense +-ME_RANGE search runs in the ``me_sad`` kernel
(kernels/me_sad.py); for references more than one frame away the
+-ME_EXT coarse-to-fine stage widens it for the square sizes.  The
half/quarter-pel refinement and the bi-prediction cost read candidate
predictions from the 16 quarter-pel phase planes of the reference, for
square blocks and for the rectangular tilings of the multi-type tree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import me_sad as kme
from ..kernels.mc import _TAPS_L, _windows
from ..spec.inter import (BCW_DEFAULT, BCW_W, ME_EXT, MV_FRAC_BITS,
                          REF_MARGIN, REFINE_HALF, REFINE_QUARTER, ME_RANGE,
                          mv_bits_est)

I32MAX = kme.I32MAX

_ME_KEYS = kme.KEYS[:7]
_TT_KEYS = kme.KEYS[7:]
_EXT_KEYS = (8, 16, 32)   # the ext stage widens the square sizes only
_ME_BATCH = 16            # coarse offsets per step, as in the reference


def _offsets_with_bits() -> np.ndarray:
    """(n, 3) int32 [dy, dx, bits] in row-major (dy, dx) order."""
    r = ME_RANGE
    rows = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            rows.append((dy, dx, mv_bits_est(dx, dy)))
    return np.asarray(rows, np.int32)


def me_pass(orig, refp80, lam, *, frame_w: int, frame_h: int,
            tt: bool = False, ext: bool = False):
    """Integer ME for all square sizes and BT shapes (plus the TT keys when
    ``tt``): the dense +-ME_RANGE full search, widened to +-ME_EXT for the
    square sizes by the coarse-to-fine stage when ``ext``.

    orig: (H, W) int32; refp80: (H + 2*REF_MARGIN, ...) edge-padded
    reference.  Returns dict key -> (cost (nby, nbx), mv (nby, nbx, 2))."""
    c16 = REF_MARGIN - ME_RANGE
    refp = refp80[c16:c16 + frame_h + 2 * ME_RANGE,
                  c16:c16 + frame_w + 2 * ME_RANGE].contiguous()
    keys = _ME_KEYS + (_TT_KEYS if tt else ())
    maps = dict(zip(keys, kme.me_sad(orig.contiguous(), refp, int(lam),
                                     tt=tt)))
    if ext:
        orig32 = orig.to(torch.int32)
        coarse = _coarse_search(orig32, refp80, frame_w=frame_w,
                                frame_h=frame_h)
        for k in _EXT_KEYS:
            fc, fmv = _fine_search(orig32, refp80, *coarse[k], int(lam),
                                   s=k)
            dc, dmv = maps[k]
            better = fc < dc           # strictly cheaper replaces
            maps[k] = (torch.where(better, fc, dc),
                       torch.where(better[..., None], fmv, dmv))
    return maps


def _coarse_search(orig32, refp80, *, frame_w: int, frame_h: int):
    """Ext stage, coarse step: full search over +-ME_EXT/4 on the
    4x-decimated planes, raw SAD (no MV rate), one 2x2 decimated sum per
    8x8 granule.  Offsets in row-major order, _ME_BATCH per step (tail
    padded by repeating the last offset), first minimum inside a step and
    strict-less across steps.  Returns {key: (dx, dy)} in decimated pels,
    each (nby, nbx) int32."""
    h, w = frame_h, frame_w
    rc = ME_EXT // 4
    c64 = REF_MARGIN - ME_EXT
    od = orig32[::4, ::4]
    rd = refp80[c64:c64 + h + 2 * ME_EXT:4,
                c64:c64 + w + 2 * ME_EXT:4].to(torch.int32)
    hd, wd = h // 4, w // 4
    offs = np.asarray([(dy, dx) for dy in range(-rc, rc + 1)
                       for dx in range(-rc, rc + 1)], np.int32)
    pad = (-offs.shape[0]) % _ME_BATCH
    offs = np.concatenate([offs, np.tile(offs[-1:], (pad, 1))])
    offs_t = torch.as_tensor(offs, device=orig32.device)
    state = {}
    for k in _EXT_KEYS:
        ny, nx = h // k, w // k
        state[k] = [torch.full((ny, nx), I32MAX, dtype=torch.int32,
                               device=orig32.device),
                    torch.zeros((ny, nx), dtype=torch.int32,
                                device=orig32.device),
                    torch.zeros((ny, nx), dtype=torch.int32,
                                device=orig32.device)]
    for b0 in range(0, offs.shape[0], _ME_BATCH):
        ob = offs[b0:b0 + _ME_BATCH]
        win = torch.stack([rd[rc + dy:rc + dy + hd, rc + dx:rc + dx + wd]
                           for dy, dx in ob])
        sad2 = (od[None] - win).abs().reshape(
            _ME_BATCH, hd // 2, 2, wd // 2, 2).sum((2, 4), dtype=torch.int32)
        ot = offs_t[b0:b0 + _ME_BATCH]
        for k, st in state.items():
            sb = kme._aggregate(sad2, k)
            bi = torch.argmin(sb, dim=0)          # first minimum in order
            c = torch.gather(sb, 0, bi[None])[0]
            better = c < st[0]
            st[0] = torch.where(better, c, st[0])
            st[1] = torch.where(better, ot[:, 1][bi], st[1])
            st[2] = torch.where(better, ot[:, 0][bi], st[2])
    return {k: (st[1], st[2]) for k, st in state.items()}


def _fine_search(orig32, refp80, cdx, cdy, lam: int, *, s: int):
    """Ext stage, fine step for square s-blocks: the 5x5 full-resolution
    window around 4x the coarse winner, cost (sad << 8) + lam * bits.  One
    (s + 4, s + 4) reference window per block; the 25 candidates are
    slices of it in (ddy, ddx) row-major order, strict-less.  Returns
    (cost (nby, nbx), mv (nby, nbx, 2) [dx, dy]) in integer pels."""
    nby, nbx = cdx.shape
    *_, ys, xs = tiling(nbx * s, nby * s, s, device=orig32.device)
    bx = (cdx * 4).reshape(-1)
    by = (cdy * 4).reshape(-1)
    blk = blocks(orig32, ys, xs, s, s)
    win = _windows(refp80, ys + REF_MARGIN + by - 2, xs + REF_MARGIN + bx - 2,
                   s + 4, s + 4).to(torch.int32)
    cost = torch.full_like(bx, I32MAX)
    odx = torch.zeros_like(bx)
    ody = torch.zeros_like(bx)
    for ddy in range(-2, 3):
        for ddx in range(-2, 3):
            dx, dy = bx + ddx, by + ddy
            rb = win[:, 2 + ddy:2 + ddy + s, 2 + ddx:2 + ddx + s]
            sad = (blk - rb).abs().sum((1, 2), dtype=torch.int32)
            c = (sad << 8) + lam * (2 + 2 * kme._bitlen(dx)
                                    + 2 * kme._bitlen(dy))
            better = c < cost
            cost = torch.where(better, c, cost)
            odx = torch.where(better, dx, odx)
            ody = torch.where(better, dy, ody)
    return (cost.reshape(nby, nbx),
            torch.stack([odx, ody], -1).reshape(nby, nbx, 2))


def _mv_bits_q(mvx_q, mvy_q):
    return 2 + 2 * kme._bitlen(mvx_q) + 2 * kme._bitlen(mvy_q)


def quarter_phase_planes(refp_margin, bd: int = 8):
    """(16, Hp, Wp) int32 stack of the reference interpolated at every
    quarter-pel phase (fy, fx) in {0,4,8,12}^2, plane index
    (fy >> 2) * 4 + (fx >> 2); per pixel equal to mc_luma_block.  Border
    rows/cols within the filter footprint wrap, as in the reference."""
    r32 = refp_margin.to(torch.int32)
    tmps = []
    for fx in (0, 4, 8, 12):
        th = _TAPS_L[fx]
        acc = None
        for u in range(8):
            t = int(th[u]) * torch.roll(r32, 3 - u, dims=1)
            acc = t if acc is None else acc + t
        tmps.append(acc)
    planes = []
    for fy in (0, 4, 8, 12):
        tv = _TAPS_L[fy]
        for tmp in tmps:
            acc = None
            for t in range(8):
                v = int(tv[t]) * torch.roll(tmp, 3 - t, dims=0)
                acc = v if acc is None else acc + v
            planes.append(((acc + 2048) >> 12).clamp(0, (1 << bd) - 1))
    return torch.stack(planes)


def tiling(frame_w: int, frame_h: int, s: int, bh: int | None = None,
           sy: int | None = None, sx: int | None = None, oy: int = 0,
           ox: int = 0, device=None):
    """Blocks s wide and bh high (default square) tiled at stride (sy, sx)
    from offset (oy, ox) (default dense; the TT stripes take the TT_GEOM
    strides).  Returns (nby, nbx, hh, ys, xs) with the (B,) int32 corners
    in raster order."""
    hh = s if bh is None else bh
    sy = hh if sy is None else sy
    sx = s if sx is None else sx
    nby = (frame_h - oy - hh) // sy + 1
    nbx = (frame_w - ox - s) // sx + 1
    ys = (torch.arange(nby, device=device, dtype=torch.int32) * sy + oy)[
        :, None].expand(nby, nbx).reshape(-1)
    xs = (torch.arange(nbx, device=device, dtype=torch.int32) * sx + ox)[
        None, :].expand(nby, nbx).reshape(-1)
    return nby, nbx, hh, ys, xs


def blocks(plane, ys, xs, w: int, h: int, off: int = 0):
    """(B, h, w) blocks of a 2-D plane at (ys + off, xs + off)."""
    dev = plane.device
    return plane[(ys.long() + off)[:, None, None]
                 + torch.arange(h, device=dev)[None, :, None],
                 (xs.long() + off)[:, None, None]
                 + torch.arange(w, device=dev)[None, None, :]]


def refine_pass(orig, refp_margin, int_mv, lam, *, s: int, frame_w: int,
                frame_h: int, bd: int = 8, bh: int | None = None,
                sy: int | None = None, sx: int | None = None, oy: int = 0,
                ox: int = 0, planes=None):
    """Half- then quarter-pel refinement of s-wide, bh-high blocks tiled
    as ``tiling`` tiles them (twin of vvctpu.coding.me.refine_pass;
    default square and dense).

    int_mv: (nby, nbx, 2) integer MVs.  Returns (cost int32 (nby, nbx),
    mv int32 (nby, nbx, 2) in 1/16 pel)."""
    dev = orig.device
    nby, nbx, hh, ys, xs = tiling(frame_w, frame_h, s, bh, sy, sx, oy, ox,
                                  dev)
    if planes is None:
        planes = quarter_phase_planes(refp_margin, bd)
    _, hp, wp = planes.shape
    flat = planes.reshape(-1)
    ar_h = torch.arange(hh, device=dev, dtype=torch.int64)
    ar_w = torch.arange(s, device=dev, dtype=torch.int64)
    blk = blocks(orig.to(torch.int32), ys, xs, s, hh)
    best = (int_mv.reshape(-1, 2) << MV_FRAC_BITS).to(torch.int32)

    def pred(mvx, mvy, fyi, fxi):
        # the (fyi, fxi) quarter-step candidate around the integer centre
        # of (mvx, mvy): a slice of phase plane (ry, rx), shifted by the
        # whole samples (qy, qx) the phase folds into (a roll in the
        # reference, so indices wrap)
        ry, rx = (4 * fyi) & 15, (4 * fxi) & 15
        qy, qx = (4 * fyi) >> 4, (4 * fxi) >> 4
        y0 = (ys + (mvy >> MV_FRAC_BITS) + REF_MARGIN + qy).long()
        x0 = (xs + (mvx >> MV_FRAC_BITS) + REF_MARGIN + qx).long()
        pidx = ((ry >> 2) * 4 + (rx >> 2)).long()
        iy = (y0[:, None] + ar_h[None]) % hp
        ix = (x0[:, None] + ar_w[None]) % wp
        idx = (pidx[:, None, None] * hp + iy[:, :, None]) * wp \
            + ix[:, None, :]
        return flat[idx]

    def stage(deltas, mv, quarter: bool):
        mvx, mvy = mv[:, 0], mv[:, 1]
        cost = torch.full_like(mvx, I32MAX)
        bdx = torch.zeros_like(mvx)
        bdy = torch.zeros_like(mvx)
        for (ddx, ddy) in deltas:
            if quarter:
                fyi = ((mvy & 15) >> 2) + ddy // 4
                fxi = ((mvx & 15) >> 2) + ddx // 4
            else:
                fyi = torch.full_like(mvy, ddy // 4)
                fxi = torch.full_like(mvx, ddx // 4)
            sad = (blk - pred(mvx, mvy, fyi, fxi)).abs().sum(
                (1, 2), dtype=torch.int32)
            c = (sad << 8) + lam * _mv_bits_q((mvx + ddx) >> 2,
                                              (mvy + ddy) >> 2)
            better = c < cost
            cost = torch.where(better, c, cost)
            bdx = torch.where(better, torch.full_like(bdx, ddx), bdx)
            bdy = torch.where(better, torch.full_like(bdy, ddy), bdy)
        return cost, mv + torch.stack([bdx, bdy], -1)

    _, best = stage(REFINE_HALF, best, False)
    cost, best = stage(REFINE_QUARTER, best, True)
    return cost.reshape(nby, nbx), best.reshape(nby, nbx, 2)


def _phase_block(planes, xs, ys, mv, s: int, hh: int):
    """(B, hh, s) prediction of each block at its quarter-pel MV: one
    slice of the matching phase plane (per pixel equal to mc_luma_block),
    placed as the reference's dynamic_slice places it."""
    pidx = ((mv[:, 1] & 15) >> 2) * 4 + ((mv[:, 0] & 15) >> 2)
    return _windows(planes, ys + (mv[:, 1] >> MV_FRAC_BITS) + REF_MARGIN,
                    xs + (mv[:, 0] >> MV_FRAC_BITS) + REF_MARGIN, hh, s,
                    pidx)


def bi_cost_pass(orig, mv0, mv1, lam, *, s: int, frame_w: int,
                 frame_h: int, bd: int = 8, planes0, planes1,
                 bcw: bool = False, bcw_fp=None, bh: int | None = None,
                 sy: int | None = None, sx: int | None = None, oy: int = 0,
                 ox: int = 0):
    """BI cost per s-wide, bh-high block tiled as ``tiling`` tiles them
    (twin of vvctpu.coding.me.bi_cost_pass; default square and dense):
    SAD of the weighted average of the two refined uni predictions, plus
    both quarter-pel MV rates.  With ``bcw`` each of the three {3,4,5}/8
    weights is costed with its bcw_idx rate ``bcw_fp[i]`` (1/256 bits)
    and the first minimum wins.

    mv0, mv1: (nby, nbx, 2) refined MVs in 1/16 pel; planes0/1: the
    quarter_phase_planes of the two references.  Returns (cost, widx),
    both (nby, nbx) int32; without ``bcw`` widx is BCW_DEFAULT."""
    dev = orig.device
    nby, nbx, hh, ys, xs = tiling(frame_w, frame_h, s, bh, sy, sx, oy, ox,
                                  dev)
    blk = blocks(orig.to(torch.int32), ys, xs, s, hh)
    m0 = mv0.reshape(-1, 2).to(torch.int32)
    m1 = mv1.reshape(-1, 2).to(torch.int32)
    p0 = _phase_block(planes0, xs, ys, m0, s, hh)
    p1 = _phase_block(planes1, xs, ys, m1, s, hh)
    bits = (_mv_bits_q(m0[:, 0] >> 2, m0[:, 1] >> 2)
            + _mv_bits_q(m1[:, 0] >> 2, m1[:, 1] >> 2))
    lam = int(lam)
    costs = []
    for wi in ((0, 1, 2) if bcw else (BCW_DEFAULT,)):
        wv = BCW_W[wi]
        pb = ((wv * p0 + (8 - wv) * p1 + 4) >> 3).clamp(0, (1 << bd) - 1)
        sad = (blk - pb).abs().sum((1, 2), dtype=torch.int32)
        c = (sad << 8) + lam * bits
        if bcw:
            c = c + ((int(bcw_fp[wi]) * lam) >> 8)
        costs.append(c)
    if not bcw:
        return (costs[0].reshape(nby, nbx),
                torch.full((nby, nbx), BCW_DEFAULT, dtype=torch.int32,
                           device=dev))
    cv = torch.stack(costs, 1)
    wi = torch.argmin(cv, dim=1)
    cost = torch.gather(cv, 1, wi[:, None])[:, 0]
    return cost.reshape(nby, nbx), wi.to(torch.int32).reshape(nby, nbx)


# IBC: dx offsets per batch of the block-vector search (each dy row's 129
# offsets in three batches; at 1088x1920 one batch's int16 differences
# take 180 MB)
_IBC_DX = 43


def _ibc_offsets():
    """[(dy, [(dx, bits), ...]), ...]: the IBC window's offsets in
    row-major (dy, dx) order, dx in batches of _IBC_DX, with each
    offset's decision-time rate."""
    from ..spec.decide import IBC_WIN
    from ..spec.inter import mv_bits_q
    out = []
    for dy in range(-IBC_WIN, 1):
        row = [(dx, mv_bits_q(dx, dy)) for dx in range(-IBC_WIN, IBC_WIN + 1)]
        out += [(dy, row[i:i + _IBC_DX]) for i in range(0, len(row), _IBC_DX)]
    return out


def _wrap32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def ibc_pass(orig, lam: int, *, frame_w: int, frame_h: int, ibc_fp: int):
    """Full-search IBC block vectors for the square sizes 8, 16 and 32
    (twin of the reference's ibc_pass): SAD per 8x8 granule of the
    current picture's original luma against every offset of the window
    (dx in [-IBC_WIN, IBC_WIN], dy in [-IBC_WIN, 0], edge-padded), summed
    per block; cost (SAD << 8) + lam * bits + ((ibc_fp * lam) >> 8) in
    wrapping int32 where the source block is legal (inside the frame and
    above the block's CTU row, or in that row left of its CTU), I32MAX
    elsewhere; the first minimum in offset order (argmin inside a batch,
    strict-less across batches).  Each batch's references are a strided
    view of the padded plane, one int16 difference tensor per batch.

    orig: (H, W) int32 luma.  Returns {s: (cost (nby, nbx) int32,
    bv (nby, nbx, 2) int32 [dx, dy])}."""
    from ..spec.decide import IBC_WIN
    h, w = frame_h, frame_w
    dev = orig.device
    o16 = orig.to(torch.int16)
    iy = (torch.arange(h + 2 * IBC_WIN, device=dev) - IBC_WIN).clamp(0, h - 1)
    ix = (torch.arange(w + 2 * IBC_WIN, device=dev) - IBC_WIN).clamp(0, w - 1)
    refp = o16[iy[:, None], ix[None, :]].contiguous()
    wp = refp.shape[1]
    lam_t = torch.tensor(_wrap32(lam), dtype=torch.int32, device=dev)
    flag = _wrap32(_wrap32(ibc_fp * lam) >> 8)
    geo, state = {}, {}
    for s in (8, 16, 32):
        ny, nx = h // s, w // s
        ys = torch.arange(ny, device=dev, dtype=torch.int32)[:, None] * s
        xs = torch.arange(nx, device=dev, dtype=torch.int32)[None, :] * s
        geo[s] = (xs, ys, ys & ~63, xs & ~63)
        state[s] = [torch.full((ny, nx), I32MAX, dtype=torch.int32,
                               device=dev),
                    torch.zeros((ny, nx), dtype=torch.int32, device=dev),
                    torch.zeros((ny, nx), dtype=torch.int32, device=dev)]
    for dy, row in _ibc_offsets():
        n = len(row)
        dx0 = row[0][0]
        win = refp.as_strided((n, h, w), (1, wp, 1),
                              (IBC_WIN + dy) * wp + IBC_WIN + dx0)
        sad = (o16[None] - win).abs_().view(n, h // 8, 8, w // 8, 8).sum(
            (2, 4), dtype=torch.int32)
        dxs = torch.tensor([d for d, _ in row], dtype=torch.int32,
                           device=dev)[:, None, None]
        bits = torch.tensor([b for _, b in row], dtype=torch.int32,
                            device=dev)[:, None, None]
        rate = lam_t * bits + flag
        for s in (8, 16, 32):
            if s > 8:
                f = s // 8
                sad_s = sad.view(n, h // s, f, w // s, f).sum(
                    (2, 4), dtype=torch.int32)
            else:
                sad_s = sad
            xs, ys, cy0, cx0 = geo[s]
            sx, sy = xs[None] + dxs, ys + dy
            legal = ((sx >= 0) & (sy >= 0) & (sx + s <= w) & (sy + s <= h)
                     & ((sy + s <= cy0) | ((sy >= cy0) & (sy + s <= cy0 + 64)
                                           & (sx + s <= cx0))))
            cb = torch.where(legal, (sad_s << 8) + rate, I32MAX)
            bi = torch.argmin(cb, dim=0)          # first minimum in order
            c = torch.gather(cb, 0, bi[None])[0]
            st = state[s]
            better = c < st[0]
            st[0] = torch.where(better, c, st[0])
            st[1] = torch.where(better, dxs[:, 0, 0][bi], st[1])
            st[2] = torch.where(better, dy, st[2])
    return {s: (st[0], torch.stack([st[1], st[2]], -1))
            for s, st in state.items()}
