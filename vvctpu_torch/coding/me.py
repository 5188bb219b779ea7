"""Integer and sub-pel motion estimation — twin of vvctpu/coding/me.py.

The dense +-ME_RANGE search runs in the ``me_sad`` kernel
(kernels/me_sad.py); the half/quarter-pel refinement reads candidate
predictions from the 16 quarter-pel phase planes of the reference.
The +-ME_EXT coarse-to-fine stage is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import me_sad as kme
from ..kernels.mc import _TAPS_L
from ..spec.inter import (MV_FRAC_BITS, REF_MARGIN, REFINE_HALF,
                          REFINE_QUARTER, ME_RANGE, mv_bits_est)

I32MAX = kme.I32MAX

_ME_KEYS = kme.KEYS[:7]
_TT_KEYS = kme.KEYS[7:]


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
    ``tt``): the dense +-ME_RANGE full search.

    orig: (H, W) int32; refp80: (H + 2*REF_MARGIN, ...) edge-padded
    reference.  Returns dict key -> (cost (nby, nbx), mv (nby, nbx, 2))."""
    if ext:
        raise NotImplementedError(
            "the +-ME_EXT stage (references more than one frame away) is "
            "not ported yet")
    c16 = REF_MARGIN - ME_RANGE
    refp = refp80[c16:c16 + frame_h + 2 * ME_RANGE,
                  c16:c16 + frame_w + 2 * ME_RANGE].contiguous()
    keys = _ME_KEYS + (_TT_KEYS if tt else ())
    res = kme.me_sad(orig.contiguous(), refp, int(lam), tt=tt)
    return dict(zip(keys, res))


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


def refine_pass(orig, refp_margin, int_mv, lam, *, s: int, frame_w: int,
                frame_h: int, bd: int = 8, planes=None):
    """Half- then quarter-pel refinement of square s-blocks (twin of
    vvctpu.coding.me.refine_pass with the default dense tiling).

    int_mv: (nby, nbx, 2) integer MVs.  Returns (cost int32 (nby, nbx),
    mv int32 (nby, nbx, 2) in 1/16 pel)."""
    dev = orig.device
    nby, nbx = frame_h // s, frame_w // s
    if planes is None:
        planes = quarter_phase_planes(refp_margin, bd)
    _, hp, wp = planes.shape
    flat = planes.reshape(-1)
    ys = (torch.arange(nby, device=dev, dtype=torch.int32) * s)[:, None] \
        .expand(nby, nbx).reshape(-1)
    xs = (torch.arange(nbx, device=dev, dtype=torch.int32) * s)[None, :] \
        .expand(nby, nbx).reshape(-1)
    ar = torch.arange(s, device=dev, dtype=torch.int64)
    blk = orig.to(torch.int32)[(ys.long()[:, None, None] + ar[None, :, None]),
                               (xs.long()[:, None, None] + ar[None, None, :])]
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
        iy = (y0[:, None] + ar[None]) % hp
        ix = (x0[:, None] + ar[None]) % wp
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
