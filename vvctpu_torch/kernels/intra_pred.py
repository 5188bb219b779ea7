"""Intra prediction in PyTorch — twin of vvctpu/kernels/intra_pred.py.

Batched over blocks: reference samples are gathered from a margin-padded
recon buffer with geometric availability (a neighbour is available iff
its 8x8-granule z-order index precedes the block's), then planar, DC and
4-tap angular prediction with PDPC run for a (B,) vector of modes.  The
CTU size is an argument (``log2_ctu``), not module state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rom
from ..device import const as _c

MARGIN = 64  # right/bottom margin of the recon gather buffer

_ANGLE = np.asarray(rom.INTRA_PRED_ANGLE, np.int32)
_INV_ANGLE = np.asarray(rom.INTRA_INV_ANGLE, np.int32)
_TAPS_SHARP = np.asarray(rom.intra_filter_4tap(False), np.int32)
_TAPS_SMOOTH = np.asarray(rom.intra_filter_4tap(True), np.int32)
_SMOOTH_THRES = np.asarray([64, 64, 64, 14, 2, 0, 0], np.int32)  # by log2s

# PDPC distance weights by block size
_PDPC_W = {s: (32 >> np.minimum(31, (np.arange(s) * 2)
                                >> ((2 * (s.bit_length() - 1) - 2) >> 2)))
           .astype(np.int32) for s in (4, 8, 16, 32)}


def _ar(n: int, device, start: int = 0, step: int = 1):
    return torch.arange(start, start + n * step, step, dtype=torch.int32,
                        device=device)


def morton8(x, y, n_ctu_x: int, log2_ctu: int = 6):
    """Global z-order index of the 8x8 granule holding luma pixel (x, y):
    CTU raster order, then QT z-order inside the CTU of side 1 << log2_ctu;
    n_ctu_x is the frame width in CTUs."""
    nb = log2_ctu - 3
    ctu = (y >> log2_ctu) * n_ctu_x + (x >> log2_ctu)
    gx = (x >> 3) & ((1 << nb) - 1)
    gy = (y >> 3) & ((1 << nb) - 1)
    m = torch.zeros_like(gx)
    for b in range(nb):
        m = m | (((gx >> b) & 1) << (2 * b)) | (((gy >> b) & 1) << (2 * b + 1))
    return ctu * (1 << (2 * nb)) + m


def build_references(buf, x, y, *, s: int, is_luma: bool, frame_w: int,
                     frame_h: int, n_ctu_x: int, log2_ctu: int = 6,
                     bd: int = 8, in_frame_only: bool = False, f=None):
    """(top, left) reference samples, each (B, 2s+1) int32 (index 0 = the
    corner), for square s-blocks at (x, y) ((B,) int32).

    ``buf`` is the (frame_h + 1 + MARGIN, frame_w + 1 + MARGIN) recon
    buffer with a one-sample top/left offset, or an (F, ...) stack of them
    with ``f`` the (B,) frame index of each block: samples are read from
    the block's own frame only.  Missing samples are substituted as in the
    spec."""
    dev = buf.device
    n = 2 * s
    i = torch.arange(n + 1, device=dev)
    ys0 = y.long()
    xs0 = x.long()
    if f is None:
        top_raw = buf[ys0[:, None], xs0[:, None] + i]
        left_raw = buf[ys0[:, None] + i, xs0[:, None]]
    else:
        fl = f.long()[:, None]
        top_raw = buf[fl, ys0[:, None], xs0[:, None] + i]
        left_raw = buf[fl, ys0[:, None] + i, xs0[:, None]]
    scan_vals = torch.cat([left_raw[:, 1:].flip(1), top_raw], 1)

    B = x.shape[0]
    left_sx = (x - 1)[:, None].expand(B, n)
    left_sy = (y - 1)[:, None] + _ar(n, dev, n, -1)[None]
    top_sx = (x - 1)[:, None] + _ar(n + 1, dev)[None]
    top_sy = (y - 1)[:, None].expand(B, n + 1)
    sx = torch.cat([left_sx, top_sx], 1)
    sy = torch.cat([left_sy, top_sy], 1)
    scale = 1 if is_luma else 2
    avail = (sx >= 0) & (sy >= 0) & (sx < frame_w) & (sy < frame_h)
    if not in_frame_only:
        cur = morton8(x * scale, y * scale, n_ctu_x, log2_ctu)
        coded = morton8(sx.clamp(min=0) * scale, sy.clamp(min=0) * scale,
                        n_ctu_x, log2_ctu) < cur[:, None]
        avail = avail & coded

    idx = torch.arange(2 * n + 1, device=dev)[None].expand(B, 2 * n + 1)
    last = torch.cummax(torch.where(avail, idx, -1), dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1)
    src = torch.where(last >= 0, last, first[:, None])
    filled = torch.gather(scan_vals, 1, src)
    filled = torch.where(avail.any(1, keepdim=True), filled,
                         torch.full_like(filled, 1 << (bd - 1)))
    left = torch.cat([filled[:, n:n + 1], filled[:, :n].flip(1)], 1)
    top = filled[:, n:]
    return top, left


def _smooth(top, left):
    def f(a):
        mid = (a[:, :-2] + 2 * a[:, 1:-1] + a[:, 2:] + 2) >> 2
        lastv = (a[:, -2] + 3 * a[:, -1] + 2) >> 2
        return mid, lastv[:, None]
    corner = ((left[:, 1] + 2 * top[:, 0] + top[:, 1] + 2) >> 2)[:, None]
    tm, tl = f(top)
    lm, ll = f(left)
    return torch.cat([corner, tm, tl], 1), torch.cat([corner, lm, ll], 1)


def _ref_filter_flag(mode, s: int):
    log2s = int(s).bit_length() - 1
    dist = torch.minimum((mode - rom.HOR_IDX).abs(),
                         (mode - rom.VER_IDX).abs())
    is_special = (mode == rom.DC_IDX) | (mode == rom.HOR_IDX) | \
        (mode == rom.VER_IDX)
    planar_f = (mode == rom.PLANAR_IDX) & (s * s > 32)
    ang_f = (mode >= 2) & (dist > int(_SMOOTH_THRES[log2s]))
    return ~is_special & (planar_f | ang_f)


def _planar(top, left, s: int):
    dev = top.device
    lw = int(s).bit_length() - 1
    r = _ar(s, dev)
    t = top[:, None, 1:s + 1]
    lft = left[:, 1:s + 1, None]
    tr = top[:, s + 1, None, None]
    bl = left[:, s + 1, None, None]
    pv = (s - 1 - r)[None, :, None] * t + (r + 1)[None, :, None] * bl
    ph = (s - 1 - r)[None, None, :] * lft + (r + 1)[None, None, :] * tr
    return ((pv << lw) + (ph << lw) + s * s) >> (2 * lw + 1)


def _dc(top, left, s: int):
    lsum = top[:, 1:s + 1].sum(1, dtype=torch.int32) \
        + left[:, 1:s + 1].sum(1, dtype=torch.int32)
    v = torch.div(lsum + s, 2 * s, rounding_mode="floor")
    return v[:, None, None].expand(-1, s, s)


def _angular(top, left, mode, s: int, is_luma: bool):
    dev = top.device
    B = top.shape[0]
    angle = _c(_ANGLE, dev)[mode.long()]
    inv_angle = _c(_INV_ANGLE, dev)[mode.long()]
    vertical = (mode >= rom.DIA_IDX)[:, None]
    main = torch.where(vertical, top, left)
    side = torch.where(vertical, left, top)

    off = s
    ext_len = 4 * s + 2
    i_main = (torch.arange(ext_len, device=dev) - off).clamp(0, 2 * s)
    ext = main[:, i_main]
    k = _ar(off, dev, off, -1)
    sidx = ((k[None] * inv_angle[:, None] + 256) >> 9).clamp(0, 2 * s)
    proj = torch.gather(side, 1, sidx.long())
    ext = torch.cat([torch.where((angle < 0)[:, None], proj, ext[:, :off]),
                     ext[:, off:]], 1)

    pos = _ar(s, dev, 1)[None] * angle[:, None]
    i_idx = pos >> 5
    i_fact = pos & 31
    base = (off + 1 + _ar(s, dev)[None, None, :]
            + i_idx[:, :, None]).long()

    def tap(d):
        return torch.gather(ext, 1, (base + d).clamp(0, ext_len - 1)
                            .reshape(B, s * s)).reshape(B, s, s)

    integer_slope = ((angle % 32) == 0)[:, None, None]
    a = tap(0)
    if is_luma:
        filt = _ref_filter_flag(mode, s)[:, None, None]
        fl = i_fact.long()
        taps = torch.where(filt, _c(_TAPS_SMOOTH, dev)[fl],
                           _c(_TAPS_SHARP, dev)[fl])
        four = taps[:, :, 0, None] * tap(-1)
        for t in range(1, 4):
            four = four + taps[:, :, t, None] * tap(t - 1)
        pred = torch.where(integer_slope, a, (four + 32) >> 6)
    else:
        fct = i_fact[:, :, None]
        two_tap = ((32 - fct) * a + fct * tap(1) + 16) >> 5
        pred = torch.where(integer_slope, a, two_tap)
    return torch.where(vertical[:, :, None], pred, pred.transpose(1, 2))


def _pdpc(pred, top, left, mode, s: int, bd: int):
    dev = pred.device
    w = _c(_PDPC_W[s], dev)
    wl = w[None, None, :]
    wt = w[None, :, None]
    t = top[:, None, 1:s + 1]
    lft = left[:, 1:s + 1, None]
    corner = top[:, 0, None, None]
    mx = (1 << bd) - 1
    plain = (wl * lft + wt * t + (64 - wl - wt) * pred + 32) >> 6
    ver = (pred + ((wl * (lft - corner) + 32) >> 6)).clamp(0, mx)
    hor = (pred + ((wt * (t - corner) + 32) >> 6)).clamp(0, mx)
    m = mode[:, None, None]
    return torch.where((m == rom.PLANAR_IDX) | (m == rom.DC_IDX), plain,
                       torch.where(m == rom.VER_IDX, ver,
                                   torch.where(m == rom.HOR_IDX, hor, pred)))


def predict(top, left, mode, *, s: int, is_luma: bool, bd: int = 8):
    """(B, s, s) predictions for (B,) int32 modes from (B, 2s+1) refs."""
    mode = mode.to(torch.int32)
    if is_luma:
        angle = _c(_ANGLE, top.device)[mode.long()]
        smooth_now = (_ref_filter_flag(mode, s)
                      & ((mode == rom.PLANAR_IDX) | ((angle % 32) == 0)))
        ts, ls = _smooth(top, left)
        top = torch.where(smooth_now[:, None], ts, top)
        left = torch.where(smooth_now[:, None], ls, left)
    m = mode[:, None, None]
    pred = torch.where(
        m == 0, _planar(top, left, s),
        torch.where(m == 1, _dc(top, left, s),
                    _angular(top, left, mode.clamp(min=2), s, is_luma)))
    if is_luma:
        pred = _pdpc(pred, top, left, mode, s, bd)
    return pred.clamp(0, (1 << bd) - 1).to(torch.int32)
