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
from ..spec.inter import MV_FRAC_BITS, REF_MARGIN

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
