"""Motion compensation in PyTorch — twin of vvctpu/kernels/mc.py.

Two-stage separable FIR on batches of blocks: 8-tap luma at 1/16 pel,
4-tap chroma at 1/32 pel, the integer phase being an exact delta, with
(acc + 2048) >> 12 staging.  Windows are placed as jax.lax.dynamic_slice
places them, so results match the reference for any MV.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rom
from ..device import const
from ..spec.inter import BCW_W, MV_FRAC_BITS, REF_MARGIN

_TAPS_L = np.asarray(rom.mc_filter_luma(), np.int32)
_TAPS_C = np.asarray(rom.mc_filter_chroma(), np.int32)


def _windows(ref_pad, y0, x0, hh: int, ww: int, f=None):
    """(B, hh, ww) windows of a plane at per-block starts (y0, x0),
    placed as jax.lax.dynamic_slice places them: a negative start counts
    from the end, then the start is clamped so the window fits.

    ref_pad is one 2-D plane, or an (F, Hp, Wp) stack with ``f`` the
    (B,) plane index of each block (the clamp stays inside that plane)."""
    hp, wp = ref_pad.shape[-2:]
    y0 = torch.where(y0 < 0, y0 + hp, y0).clamp(0, hp - hh).long()
    x0 = torch.where(x0 < 0, x0 + wp, x0).clamp(0, wp - ww).long()
    iy = y0[:, None] + torch.arange(hh, device=ref_pad.device)[None]
    ix = x0[:, None] + torch.arange(ww, device=ref_pad.device)[None]
    if f is None:
        return ref_pad[iy[:, :, None], ix[:, None, :]]
    return ref_pad[f.long()[:, None, None], iy[:, :, None], ix[:, None, :]]


def _fir(ref_pad, x0, y0, s: int, hh: int, fx, fy, taps_np, bd: int,
         f=None):
    nt = taps_np.shape[1]
    win = _windows(ref_pad, y0, x0, hh + nt - 1, s + nt - 1, f)
    taps = const(taps_np, ref_pad.device)
    th = taps[fx.long()]
    tv = taps[fy.long()]
    tmp = th[:, 0, None, None] * win[:, :, 0:s]
    for t in range(1, nt):
        tmp = tmp + th[:, t, None, None] * win[:, :, t:t + s]
    acc = tv[:, 0, None, None] * tmp[:, 0:hh]
    for t in range(1, nt):
        acc = acc + tv[:, t, None, None] * tmp[:, t:t + hh]
    return ((acc + 2048) >> 12).clamp(0, (1 << bd) - 1)


def mc_luma_block(ref_pad, x, y, s: int, mvx, mvy, bd: int = 8,
                  margin: int = REF_MARGIN, h: int | None = None, f=None):
    """(B, h, s) luma predictions from a margin-padded reference plane for
    blocks at (x, y) with 1/16-pel MVs (all (B,) int32; h defaults to s).
    With ``f``, ref_pad is an (F, Hp, Wp) stack and f each block's plane."""
    hh = s if h is None else h
    x0 = x + (mvx >> MV_FRAC_BITS) + margin - 3
    y0 = y + (mvy >> MV_FRAC_BITS) + margin - 3
    return _fir(ref_pad, x0, y0, s, hh, mvx & 15, mvy & 15, _TAPS_L, bd, f)


def mc_chroma_block(ref_pad, x, y, s: int, mvx, mvy, bd: int = 8,
                    margin: int = REF_MARGIN // 2, h: int | None = None,
                    f=None):
    """(B, h, s) chroma predictions at 1/32-pel (the luma MV read in
    chroma units); ``f`` as in mc_luma_block."""
    hh = s if h is None else h
    x0 = x + (mvx >> 5) + margin - 1
    y0 = y + (mvy >> 5) + margin - 1
    return _fir(ref_pad, x0, y0, s, hh, mvx & 31, mvy & 31, _TAPS_C, bd, f)


# ---------------------------------------------------------------------------
# BI refinement (DMVR, BDOF) and 4-parameter affine with PROF, batched over
# blocks: every (B,) argument is one value per block.
# ---------------------------------------------------------------------------

_DMVR_OFFS = np.asarray([(dx, dy) for dy in range(-2, 3)
                         for dx in range(-2, 3)], np.int32)


def dmvr_offset(ref0_pad, ref1_pad, x, y, sub: int, m0x, m0y, m1x, m1y,
                margin: int = REF_MARGIN, f=None):
    """(B, 2) best mirrored integer offsets (dx, dy) of sub x sub blocks by
    25-point SAD on integer-aligned windows, the centre's SAD cut by a
    quarter; the first minimum in row-major (dy, dx) order wins (twin of
    the reference's dmvr_offset_j).  ``f`` as in mc_luma_block."""
    r = 2
    n = sub + 2 * r
    w0 = _windows(ref0_pad, y + (m0y >> MV_FRAC_BITS) + margin - r,
                  x + (m0x >> MV_FRAC_BITS) + margin - r, n, n, f)
    w1 = _windows(ref1_pad, y + (m1y >> MV_FRAC_BITS) + margin - r,
                  x + (m1x >> MV_FRAC_BITS) + margin - r, n, n, f)
    w0 = w0.to(torch.int32)
    w1 = w1.to(torch.int32)
    costs = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            a = w0[:, r + dy:r + dy + sub, r + dx:r + dx + sub]
            b = w1[:, r - dy:r - dy + sub, r - dx:r - dx + sub]
            sad = (a - b).abs().sum((1, 2), dtype=torch.int32)
            if dy == 0 and dx == 0:
                sad = sad - (sad >> 2)
            costs.append(sad)
    k = torch.argmin(torch.stack(costs, 1), dim=1)
    return const(_DMVR_OFFS, ref0_pad.device)[k]


def _floor_log2(v):
    """floor(log2 v) of positive int32 values up to 2^21 (threshold sum)."""
    out = torch.zeros_like(v)
    for k in range(1, 21):
        out = out + ((v >> k) > 0).to(v.dtype)
    return out


def bdof_blend(p0e, p1e, bd: int):
    """BDOF average of (B, s+2, s+2) ring-extended predictions: per-4x4
    optical-flow displacement from the summed gradients, int32 throughout
    (twin of the reference's bdof_blend_j)."""
    s = p0e.shape[-1] - 2
    p0e = p0e.to(torch.int32)
    p1e = p1e.to(torch.int32)
    p0 = p0e[:, 1:-1, 1:-1]
    p1 = p1e[:, 1:-1, 1:-1]
    gx0 = (p0e[:, 1:-1, 2:] - p0e[:, 1:-1, :-2]) >> 1
    gy0 = (p0e[:, 2:, 1:-1] - p0e[:, :-2, 1:-1]) >> 1
    gx1 = (p1e[:, 1:-1, 2:] - p1e[:, 1:-1, :-2]) >> 1
    gy1 = (p1e[:, 2:, 1:-1] - p1e[:, :-2, 1:-1]) >> 1
    diff = p1 - p0
    th = gx0 + gx1
    tv = gy0 + gy1
    n = s // 4

    def sum44(a):
        return a.reshape(-1, n, 4, n, 4).sum((2, 4), dtype=torch.int32)

    def vcomp(sg, sdi):
        fl = _floor_log2(sg.clamp(min=1))
        # |sdi| << 5 is non-negative, so the arithmetic shift is logical
        v = -torch.sign(sdi) * ((sdi.abs() << 5) >> fl)
        return torch.where(sg > 0, v.clamp(-31, 31), 0)   # BDOF_CLIP

    def up4(a):
        return a.repeat_interleave(4, 1).repeat_interleave(4, 2)

    vx = up4(vcomp(sum44(th.abs()), sum44(diff * torch.sign(th))))
    vy = up4(vcomp(sum44(tv.abs()), sum44(diff * torch.sign(tv))))
    b = (vx * (gx0 - gx1) + vy * (gy0 - gy1) + 32) >> 6
    return (((p0 + p1 + 1) >> 1) + b).clamp(0, (1 << bd) - 1)


_PROF_D = (2 * np.arange(4) - 3).astype(np.int32)
BCW_W_NP = np.asarray(BCW_W, np.int32)
_GPM_MASKS: dict = {}


def gpm_masks(s: int) -> np.ndarray:
    """(65, s, s) int32 GPM blend weights of L0 in eighths: index 0 unused
    (GPM off), 1..64 the partitions of rom.gpm_masks_all(s); built once
    per size."""
    if s not in _GPM_MASKS:
        _GPM_MASKS[s] = np.concatenate(
            [np.zeros((1, s, s), np.int32),
             np.asarray(rom.gpm_masks_all(s), np.int32)])
    return _GPM_MASKS[s]


def _sub_mvs(mvx0, mvy0, dmx, dmy, log2s: int, n: int, step: int):
    """(B, n*n) model MVs of the 4-parameter affine motion field at the
    centres (step*j + step/2, step*i + step/2) of an n x n sub-block grid,
    row-major; arithmetic shifts as in the reference."""
    dev = mvx0.device
    k = torch.arange(n * n, device=dev, dtype=torch.int32)
    cx = (step * (k % n) + step // 2)[None]
    cy = (step * (k // n) + step // 2)[None]
    dmx, dmy = dmx[:, None], dmy[:, None]
    return (mvx0[:, None] + ((dmx * cx - dmy * cy) >> log2s),
            mvy0[:, None] + ((dmy * cx + dmx * cy) >> log2s))


def _tile(blocks, B: int, n: int):
    """(B*n*n, 4, 4) row-major sub-blocks -> (B, 4n, 4n)."""
    return blocks.reshape(B, n, n, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        B, 4 * n, 4 * n)


def affine_granule_mvs(mvx0, mvy0, dmx, dmy, s: int):
    """(B, s/8, s/8, 2) model MVs at the 8x8-granule centres (twin of the
    reference's affine_granule_mvs_j)."""
    n = s // 8
    mvx, mvy = _sub_mvs(mvx0, mvy0, dmx, dmy, s.bit_length() - 1, n, 8)
    return torch.stack([mvx, mvy], -1).reshape(-1, n, n, 2)


def affine_pred_luma(ref_pad, x, y, s: int, mvx0, mvy0, dmx, dmy,
                     bd: int = 8, prof: bool = True,
                     margin: int = REF_MARGIN, f=None):
    """(B, s, s) affine luma predictions: each 4x4 sub-block motion-
    compensated at its model MV from CPMV0 (mvx0, mvy0) and dmv = CPMV1 -
    CPMV0 (dmx, dmy), all 1/16 pel; with ``prof`` the per-pixel gradient
    correction of a 6x6 extended sub-block (twin of the reference's
    affine_pred_luma_j).  ``f`` as in mc_luma_block."""
    B = x.shape[0]
    log2s = s.bit_length() - 1
    n = s // 4
    dev = x.device
    mvx, mvy = _sub_mvs(mvx0, mvy0, dmx, dmy, log2s, n, 4)
    k = torch.arange(n * n, device=dev, dtype=torch.int32)
    sx = (x[:, None] + 4 * (k % n)[None]).reshape(-1)
    sy = (y[:, None] + 4 * (k // n)[None]).reshape(-1)
    fr = None if f is None else f.repeat_interleave(n * n)
    mvx, mvy = mvx.reshape(-1), mvy.reshape(-1)
    if not prof:
        return _tile(mc_luma_block(ref_pad, sx, sy, 4, mvx, mvy, bd, margin,
                                   f=fr), B, n)
    p = mc_luma_block(ref_pad, sx - 1, sy - 1, 6, mvx, mvy, bd, margin,
                      f=fr)
    d = const(_PROF_D, dev)
    du, dv = d[None, None, :], d[None, :, None]
    dmx3, dmy3 = dmx[:, None, None], dmy[:, None, None]
    dx32 = ((dmx3 * du - dmy3 * dv) >> log2s).repeat_interleave(n * n, 0)
    dy32 = ((dmy3 * du + dmx3 * dv) >> log2s).repeat_interleave(n * n, 0)
    gx = (p[:, 1:5, 2:6] - p[:, 1:5, 0:4]) >> 1
    gy = (p[:, 2:6, 1:5] - p[:, 0:4, 1:5]) >> 1
    di = (gx * dx32 + gy * dy32 + 16) >> 5
    return _tile((p[:, 1:5, 1:5] + di).clamp(0, (1 << bd) - 1), B, n)


def affine_pred_chroma(ref_pad, cx0, cy0, cs: int, mvx0, mvy0, dmx, dmy,
                       s_luma: int, bd: int = 8,
                       margin: int = REF_MARGIN // 2, f=None):
    """(B, cs, cs) affine chroma predictions: 4x4 sub-blocks at the model
    MVs of the luma 8x8-granule centres (twin of the reference's
    affine_pred_chroma_j)."""
    B = cx0.shape[0]
    n = cs // 4
    mvx, mvy = _sub_mvs(mvx0, mvy0, dmx, dmy, s_luma.bit_length() - 1, n, 8)
    k = torch.arange(n * n, device=cx0.device, dtype=torch.int32)
    sx = (cx0[:, None] + 4 * (k % n)[None]).reshape(-1)
    sy = (cy0[:, None] + 4 * (k // n)[None]).reshape(-1)
    fr = None if f is None else f.repeat_interleave(n * n)
    return _tile(mc_chroma_block(ref_pad, sx, sy, 4, mvx.reshape(-1),
                                 mvy.reshape(-1), bd, margin, f=fr), B, n)
