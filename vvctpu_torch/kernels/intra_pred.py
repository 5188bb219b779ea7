"""Intra prediction in PyTorch — twin of vvctpu/kernels/intra_pred.py.

Batched over blocks: reference samples are gathered from a margin-padded
recon buffer with geometric availability (a neighbour is available iff
its 8x8-granule z-order index precedes the block's), then planar, DC and
4-tap angular prediction with PDPC run for a (B,) vector of modes, with
an optional (B,) reference line (MRL).  Beside the square family: the
rectangular family of ISP stripes (wide-angle modes), MIP and CCLM.  The
CTU size is an argument (``log2_ctu``), not module state.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rom
from ..device import const as _c
from ..spec.intra import CCLM_AMAX, CCLM_SHIFT, _mip_upsample_idx

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


_MORTON: dict = {}


def _morton_luts(log2_ctu: int):
    """(x part, y part) of the z-order index inside a CTU, by the luma
    coordinate modulo the CTU size: the bits of the 8x8 granule column
    spread to the even positions, of the row to the odd ones."""
    if log2_ctu not in _MORTON:
        g = np.arange(1 << log2_ctu) >> 3
        spread = np.zeros_like(g)
        for b in range(log2_ctu - 3):
            spread |= ((g >> b) & 1) << (2 * b)
        _MORTON[log2_ctu] = (spread.astype(np.int32),
                             (spread << 1).astype(np.int32))
    return _MORTON[log2_ctu]


def morton8(x, y, n_ctu_x: int, log2_ctu: int = 6):
    """Global z-order index of the 8x8 granule holding luma pixel (x, y):
    CTU raster order, then QT z-order inside the CTU of side 1 << log2_ctu;
    n_ctu_x is the frame width in CTUs."""
    lx, ly = (_c(a, x.device) for a in _morton_luts(log2_ctu))
    m = (1 << log2_ctu) - 1
    ctu = (y >> log2_ctu) * n_ctu_x + (x >> log2_ctu)
    return ((ctu << (2 * log2_ctu - 6)) + lx[(x & m).long()]
            + ly[(y & m).long()])


def _fill(scan_vals, avail, n_left: int, bd: int):
    """Substitute unavailable L-scan samples (forward fill from the first
    available one, mid-grey when none is) and split the scan into
    (top, left), index 0 the corner."""
    B, n = avail.shape
    idx = torch.arange(n, device=avail.device)[None].expand(B, n)
    last = torch.cummax(torch.where(avail, idx, -1), dim=1).values
    first = torch.argmax(avail.to(torch.int32), dim=1)
    src = torch.where(last >= 0, last, first[:, None])
    filled = torch.gather(scan_vals, 1, src)
    filled = torch.where(avail.any(1, keepdim=True), filled,
                         torch.full_like(filled, 1 << (bd - 1)))
    left = torch.cat([filled[:, n_left:n_left + 1],
                      filled[:, :n_left].flip(1)], 1)
    return filled[:, n_left:], left


def _scan_xy(x, y, n_top: int, n_left: int):
    """Plane coordinates (sx, sy) of the L-scan samples of blocks whose
    corner sample is (x, y): left column bottom-to-top, corner, top row."""
    dev = x.device
    B = x.shape[0]
    left_sx = x[:, None].expand(B, n_left)
    left_sy = y[:, None] + _ar(n_left, dev, n_left, -1)[None]
    top_sx = x[:, None] + _ar(n_top + 1, dev)[None]
    top_sy = y[:, None].expand(B, n_top + 1)
    return torch.cat([left_sx, top_sx], 1), torch.cat([left_sy, top_sy], 1)


def _coded(x, y, sx, sy, scale: int, n_ctu_x: int, log2_ctu: int):
    """Samples (sx, sy) coded before the block at (x, y) (z-order)."""
    cur = morton8(x * scale, y * scale, n_ctu_x, log2_ctu)
    return morton8(sx.clamp(min=0) * scale, sy.clamp(min=0) * scale,
                   n_ctu_x, log2_ctu) < cur[:, None]


def build_references(buf, x, y, *, s: int, is_luma: bool, frame_w: int,
                     frame_h: int, n_ctu_x: int, log2_ctu: int = 6,
                     bd: int = 8, in_frame_only: bool = False, f=None,
                     ref_line=None):
    """(top, left) reference samples, each (B, 2s+1) int32 (index 0 = the
    corner), for square s-blocks at (x, y) ((B,) int32).

    ``buf`` is the (frame_h + 1 + MARGIN, frame_w + 1 + MARGIN) recon
    buffer with a one-sample top/left offset, or an (F, ...) stack of them
    with ``f`` the (B,) frame index of each block: samples are read from
    the block's own frame only.  ``ref_line`` ((B,) int32, MRL) gathers
    the k-th further line, corner-aligned.  Missing samples are
    substituted as in the spec."""
    dev = buf.device
    n = 2 * s
    i = torch.arange(n + 1, device=dev)
    k = 0 if ref_line is None else ref_line.to(torch.int32)
    xk, yk = x - k, y - k
    # a sample left of or above the frame (only with k > 0) is clamped
    # into the buffer: it is never available, so its value is never read
    ys0 = yk.long().clamp(min=0)
    xs0 = xk.long().clamp(min=0)
    ty = ys0[:, None]
    tx = (xk.long()[:, None] + i).clamp(min=0)
    ly = (yk.long()[:, None] + i).clamp(min=0)
    lx = xs0[:, None]
    if f is None:
        top_raw = buf[ty, tx]
        left_raw = buf[ly, lx]
    else:
        fl = f.long()[:, None]
        top_raw = buf[fl, ty, tx]
        left_raw = buf[fl, ly, lx]
    scan_vals = torch.cat([left_raw[:, 1:].flip(1), top_raw], 1)

    sx, sy = _scan_xy(xk - 1, yk - 1, n, n)
    scale = 1 if is_luma else 2
    avail = (sx >= 0) & (sy >= 0) & (sx < frame_w) & (sy < frame_h)
    if not in_frame_only:
        avail = avail & _coded(x, y, sx, sy, scale, n_ctu_x, log2_ctu)
    return _fill(scan_vals, avail, n, bd)


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


def _angular(top, left, mode, s: int, is_luma: bool, ref_line=None):
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

    rl = 0 if ref_line is None else ref_line.to(torch.int32)[:, None]
    pos = (_ar(s, dev, 1)[None] + rl) * angle[:, None]
    i_idx = pos >> 5
    i_fact = pos & 31
    base = (off + 1 + _ar(s, dev)[None, None, :]
            + (i_idx + rl)[:, :, None]).long()

    def tap(d):
        return torch.gather(ext, 1, (base + d).clamp(0, ext_len - 1)
                            .reshape(B, s * s)).reshape(B, s, s)

    integer_slope = ((angle % 32) == 0)[:, None, None]
    a = tap(0)
    if is_luma:
        filt = _ref_filter_flag(mode, s)
        if ref_line is not None:
            filt = filt & (ref_line == 0)
        fl = i_fact.long()
        taps = torch.where(filt[:, None, None], _c(_TAPS_SMOOTH, dev)[fl],
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


def predict(top, left, mode, *, s: int, is_luma: bool, bd: int = 8,
            ref_line=None):
    """(B, s, s) predictions for (B,) int32 modes from (B, 2s+1) refs.
    ``ref_line`` ((B,) int32, MRL): smoothing and PDPC are off where it
    is non-zero, and the angular ray starts that many lines further."""
    mode = mode.to(torch.int32)
    if is_luma:
        angle = _c(_ANGLE, top.device)[mode.long()]
        filt = _ref_filter_flag(mode, s)
        if ref_line is not None:
            filt = filt & (ref_line == 0)
        smooth_now = filt & ((mode == rom.PLANAR_IDX) | ((angle % 32) == 0))
        ts, ls = _smooth(top, left)
        top = torch.where(smooth_now[:, None], ts, top)
        left = torch.where(smooth_now[:, None], ls, left)
    m = mode[:, None, None]
    pred = torch.where(
        m == 0, _planar(top, left, s),
        torch.where(m == 1, _dc(top, left, s),
                    _angular(top, left, mode.clamp(min=2), s, is_luma,
                             ref_line)))
    if is_luma:
        pdpc = _pdpc(pred, top, left, mode, s, bd)
        pred = pdpc if ref_line is None else torch.where(
            (ref_line == 0)[:, None, None], pdpc, pred)
    return pred.clamp(0, (1 << bd) - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# rectangular blocks (ISP stripes): wide-angle modes, reference line 0
# ---------------------------------------------------------------------------


def build_references_rect(buf, x, y, *, w: int, h: int, is_luma: bool,
                          frame_w: int, frame_h: int, n_ctu_x: int,
                          log2_ctu: int = 6, bd: int = 8,
                          in_frame_only: bool = False, leaf_x=None,
                          leaf_y=None, leaf_w: int = 0, leaf_h: int = 0,
                          f=None):
    """(top (B, 2w+1), left (B, 2h+1)) references of (w, h) blocks at
    (x, y).  leaf_x/leaf_y ((B,)) with leaf_w/leaf_h: an enclosing leaf
    in which every sample above/left of the block counts as coded (the
    ISP-stripe rule).  ``f`` as in build_references."""
    dev = buf.device
    nt, nl = 2 * w, 2 * h
    ty = y.long()[:, None]
    tx = x.long()[:, None] + torch.arange(nt + 1, device=dev)
    ly = y.long()[:, None] + torch.arange(nl + 1, device=dev)
    lx = x.long()[:, None]
    if f is None:
        top_raw, left_raw = buf[ty, tx], buf[ly, lx]
    else:
        fl = f.long()[:, None]
        top_raw, left_raw = buf[fl, ty, tx], buf[fl, ly, lx]
    scan_vals = torch.cat([left_raw[:, 1:].flip(1), top_raw], 1)
    sx, sy = _scan_xy(x - 1, y - 1, nt, nl)
    scale = 1 if is_luma else 2
    avail = (sx >= 0) & (sy >= 0) & (sx < frame_w) & (sy < frame_h)
    if not in_frame_only:
        coded = _coded(x, y, sx, sy, scale, n_ctu_x, log2_ctu)
        if leaf_x is not None:
            coded = coded | _inside(sx, sy, leaf_x, leaf_y, leaf_w, leaf_h)
        avail = avail & coded
    return _fill(scan_vals, avail, nl, bd)


def _inside(sx, sy, x0, y0, w: int, h: int):
    x0, y0 = x0[:, None], y0[:, None]
    return (sx >= x0) & (sx < x0 + w) & (sy >= y0) & (sy < y0 + h)


def build_references_rect_win(win, x0, y0, px, py, *, w: int, h: int,
                              is_luma: bool, frame_w: int, frame_h: int,
                              n_ctu_x: int, log2_ctu: int = 6, bd: int = 8,
                              leaf_w: int = 0, leaf_h: int = 0):
    """build_references_rect reading each row's own (B, n, n) window
    ``win`` (win[b, r, c] = buffer[y0 + r, x0 + c]), which the caller
    patches with the leaf's reconstruction stripe by stripe; (px, py) is
    the block, (x0, y0) the enclosing leaf of side (leaf_w, leaf_h)."""
    dev = win.device
    nt, nl = 2 * w, 2 * h
    ry, rx = (py - y0).long(), (px - x0).long()
    b = torch.arange(win.shape[0], device=dev)[:, None]
    top_raw = win[b, ry[:, None], rx[:, None] + torch.arange(nt + 1,
                                                              device=dev)]
    left_raw = win[b, ry[:, None] + torch.arange(nl + 1, device=dev),
                   rx[:, None]]
    scan_vals = torch.cat([left_raw[:, 1:].flip(1), top_raw], 1)
    sx, sy = _scan_xy(px - 1, py - 1, nt, nl)
    scale = 1 if is_luma else 2
    avail = ((sx >= 0) & (sy >= 0) & (sx < frame_w) & (sy < frame_h)
             & (_coded(px, py, sx, sy, scale, n_ctu_x, log2_ctu)
                | _inside(sx, sy, x0, y0, leaf_w, leaf_h)))
    return _fill(scan_vals, avail, nl, bd)


_SMOOTH_THRES_BY_LOG2 = {2: 64, 3: 14, 4: 2, 5: 0, 6: 0}


def _ref_filter_flag_rect(mode, w: int, h: int):
    """``mode`` may be wide-angle remapped (67..94): the distance uses the
    signed mode (negative for the wide-low range)."""
    log2s = ((int(w).bit_length() - 1) + (int(h).bit_length() - 1)) >> 1
    thres = _SMOOTH_THRES_BY_LOG2.get(log2s, 0)
    signed = torch.where(mode > 80, 80 - mode, mode)
    dist = torch.minimum((signed - rom.HOR_IDX).abs(),
                         (signed - rom.VER_IDX).abs())
    is_special = (mode == rom.DC_IDX) | (mode == rom.HOR_IDX) | \
        (mode == rom.VER_IDX)
    planar_f = (mode == rom.PLANAR_IDX) & (w * h > 32)
    ang_f = ((mode >= 2) | (mode > 80)) & (dist > thres)
    return ~is_special & (planar_f | ang_f)


def _planar_rect(top, left, w: int, h: int):
    dev = top.device
    lw, lh = int(w).bit_length() - 1, int(h).bit_length() - 1
    xs, ys = _ar(w, dev), _ar(h, dev)
    t = top[:, None, 1:w + 1]
    lft = left[:, 1:h + 1, None]
    tr = top[:, w + 1, None, None]
    bl = left[:, h + 1, None, None]
    pv = (h - 1 - ys)[None, :, None] * t + (ys + 1)[None, :, None] * bl
    ph = (w - 1 - xs)[None, None, :] * lft + (xs + 1)[None, None, :] * tr
    return ((pv << lw) + (ph << lh) + w * h) >> (lw + lh + 1)


def _dc_rect(top, left, w: int, h: int):
    if w == h:
        ssum = top[:, 1:w + 1].sum(1, dtype=torch.int32) \
            + left[:, 1:h + 1].sum(1, dtype=torch.int32)
        v = torch.div(ssum + ((w + h) >> 1), w + h, rounding_mode="floor")
    elif w > h:
        v = (top[:, 1:w + 1].sum(1, dtype=torch.int32) + (w >> 1)) \
            >> (int(w).bit_length() - 1)
    else:
        v = (left[:, 1:h + 1].sum(1, dtype=torch.int32) + (h >> 1)) \
            >> (int(h).bit_length() - 1)
    return v[:, None, None].expand(-1, h, w)


def _angular_one(main, side, angle, inv_angle, filt, n_pred: int,
                 n_orth: int, is_luma: bool):
    """(B, n_orth, n_pred) angular prediction along ``main`` (length
    2 n_pred + 1) with the side projection for negative angles."""
    dev = main.device
    B = main.shape[0]
    ext_len = 2 * (n_pred + n_orth) + 2
    off = n_orth
    i_main = (torch.arange(ext_len, device=dev) - off).clamp(0, 2 * n_pred)
    ext = main[:, i_main]
    k = _ar(off, dev, off, -1)
    sidx = ((k[None] * inv_angle[:, None] + 256) >> 9).clamp(0, 2 * n_orth)
    proj = torch.gather(side, 1, sidx.long())
    ext = torch.cat([torch.where((angle < 0)[:, None], proj, ext[:, :off]),
                     ext[:, off:]], 1)
    pos = _ar(n_orth, dev, 1)[None] * angle[:, None]
    i_idx = pos >> 5
    i_fact = pos & 31
    base = (off + 1 + _ar(n_pred, dev)[None, None, :]
            + i_idx[:, :, None]).long()

    def tap(d):
        return torch.gather(ext, 1, (base + d).clamp(0, ext_len - 1)
                            .reshape(B, -1)).reshape(B, n_orth, n_pred)

    integer_slope = ((angle % 32) == 0)[:, None, None]
    a = tap(0)
    if not is_luma:
        fct = i_fact[:, :, None]
        return torch.where(integer_slope, a,
                           ((32 - fct) * a + fct * tap(1) + 16) >> 5)
    fl = i_fact.long()
    taps = torch.where(filt[:, None, None], _c(_TAPS_SMOOTH, dev)[fl],
                       _c(_TAPS_SHARP, dev)[fl])
    four = taps[:, :, 0, None] * tap(-1)
    for t in range(1, 4):
        four = four + taps[:, :, t, None] * tap(t - 1)
    return torch.where(integer_slope, a, (four + 32) >> 6)


def _angular_rect(top, left, mode, w: int, h: int, is_luma: bool, filt):
    dev = top.device
    angle = _c(_ANGLE, dev)[mode.long()]
    inv_angle = _c(_INV_ANGLE, dev)[mode.long()]
    if w == h:
        vertical = (mode >= rom.DIA_IDX)[:, None]
        main = torch.where(vertical, top, left)
        side = torch.where(vertical, left, top)
        pred = _angular_one(main, side, angle, inv_angle, filt, w, h,
                            is_luma)
        return torch.where(vertical[:, :, None], pred, pred.transpose(1, 2))
    # wide-high indices (67..80) predict from the top, wide-low (81..94)
    # from the left
    from_top = ((mode >= rom.DIA_IDX) & (mode <= 80))[:, None, None]
    vert = _angular_one(top, left, angle, inv_angle, filt, w, h, is_luma)
    hor = _angular_one(left, top, angle, inv_angle, filt, h, w, is_luma)
    return torch.where(from_top, vert, hor.transpose(1, 2))


def _pdpc_rect(pred, top, left, mode, w: int, h: int, bd: int):
    dev = pred.device
    scale = ((int(w).bit_length() - 1) + (int(h).bit_length() - 1) - 2) >> 2
    wl = (32 >> ((_ar(w, dev) * 2) >> scale).clamp(max=31))[None, None, :]
    wt = (32 >> ((_ar(h, dev) * 2) >> scale).clamp(max=31))[None, :, None]
    t = top[:, None, 1:w + 1]
    lft = left[:, 1:h + 1, None]
    corner = top[:, 0, None, None]
    mx = (1 << bd) - 1
    plain = (wl * lft + wt * t + (64 - wl - wt) * pred + 32) >> 6
    ver = (pred + ((wl * (lft - corner) + 32) >> 6)).clamp(0, mx)
    hor = (pred + ((wt * (t - corner) + 32) >> 6)).clamp(0, mx)
    m = mode[:, None, None]
    return torch.where((m == rom.PLANAR_IDX) | (m == rom.DC_IDX), plain,
                       torch.where(m == rom.VER_IDX, ver,
                                   torch.where(m == rom.HOR_IDX, hor, pred)))


def predict_rect(top, left, mode, *, w: int, h: int, is_luma: bool,
                 bd: int = 8):
    """(B, h, w) predictions of (w, h) blocks for (B,) modes from
    (B, 2w+1) / (B, 2h+1) references, with the wide-angle remap of
    non-square blocks."""
    mode = mode.to(torch.int32)
    m2 = mode
    if w != h:
        r = abs((int(w).bit_length() - 1) - (int(h).bit_length() - 1))
        if w > h:
            thr = (8 + 2 * r) if r > 1 else 8
            m2 = torch.where((mode >= 2) & (mode < thr), mode + 65, mode)
        else:
            thr = (60 - 2 * r) if r > 1 else 60
            m2 = torch.where((mode <= 66) & (mode > thr), 147 - mode, mode)
    if is_luma:
        filt = _ref_filter_flag_rect(m2, w, h)
        angle = _c(_ANGLE, top.device)[m2.long()]
        smooth_now = filt & ((mode == rom.PLANAR_IDX) | ((angle % 32) == 0))
        ts, ls = _smooth(top, left)
        top = torch.where(smooth_now[:, None], ts, top)
        left = torch.where(smooth_now[:, None], ls, left)
    else:
        filt = torch.zeros_like(mode, dtype=torch.bool)
    m = mode[:, None, None]
    pred = torch.where(
        m == 0, _planar_rect(top, left, w, h),
        torch.where(m == 1, _dc_rect(top, left, w, h),
                    _angular_rect(top, left, m2.clamp(min=2), w, h,
                                  is_luma, filt)))
    if is_luma:
        pred = _pdpc_rect(pred, top, left, mode, w, h, bd)
    return pred.clamp(0, (1 << bd) - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# MIP (matrix intra prediction)
# ---------------------------------------------------------------------------


def _mip_w(rs: int, device):
    """(NUM_MIP_MODES, rs*rs, 8) float64 weights, read at call time."""
    return _c(rom.mip_weights(rs), device).to(torch.float64)


_MIP_UP: dict = {}


def _mip_up(s: int):
    """Upsampling gathers of an s-block (numpy, built once per size):
    (anchor present, anchor index, next anchor index, distance, boundary
    index of each reduced row)."""
    if s not in _MIP_UP:
        rs = rom.MIP_REDUCED[s]
        k0, d, _ = _mip_upsample_idx(s, rs)
        _MIP_UP[s] = (k0 >= 0, np.maximum(k0, 0).astype(np.int64),
                      np.minimum(k0 + 1, rs - 1).astype(np.int64),
                      d.astype(np.int32), (np.arange(rs) * 4) // rs)
    return _MIP_UP[s]


def mip_predict(top, left, mode16, *, s: int, bd: int = 8):
    """(B, s, s) MIP predictions for (B,) ids mode16 = 2 * matrix mode +
    transpose (clamped to 0..15) from (B, 2s+1) references: the reduced
    boundary times the weights (an exact float64 product), then the
    separable upsampling."""
    dev = top.device
    rs = rom.MIP_REDUCED[s]
    mode16 = mode16.to(torch.int32).clamp(0, 2 * rom.NUM_MIP_MODES - 1)
    m, tr = mode16 >> 1, (mode16 & 1) > 0
    B = top.shape[0]
    mx = (1 << bd) - 1
    r4 = s // 4
    lr4 = int(r4).bit_length() - 1
    t = top[:, 1:s + 1]
    lft = left[:, 1:s + 1]
    b_t = (t.reshape(B, 4, r4).sum(2, dtype=torch.int32) + (r4 >> 1)) >> lr4
    b_l = (lft.reshape(B, 4, r4).sum(2, dtype=torch.int32)
           + (r4 >> 1)) >> lr4
    b = torch.where(tr[:, None], torch.cat([b_l, b_t], 1),
                    torch.cat([b_t, b_l], 1))
    w = _mip_w(rs, dev)[m.long()]                       # (B, rs*rs, 8)
    prod = torch.matmul(w, b.to(torch.float64)[:, :, None]).round() \
        .to(torch.int32)[:, :, 0]
    red = ((prod + (1 << (rom.MIP_SHIFT - 1))) >> rom.MIP_SHIFT) \
        .clamp(0, mx).reshape(B, rs, rs)
    red = torch.where(tr[:, None, None], red.transpose(1, 2), red)
    if rs == s:
        return red
    u = s // rs
    lu = int(u).bit_length() - 1
    has, k0, k1, d, lr = (_c(a, dev) for a in _mip_up(s))
    lrow = b_l[:, lr]
    a = torch.where(has[None, None, :], red[:, :, k0], lrow[:, :, None])
    bb = red[:, :, k1]
    hor = ((u - d)[None, None, :] * a + d[None, None, :] * bb
           + (u >> 1)) >> lu                            # (B, rs, s)
    a2 = torch.where(has[None, :, None], hor[:, k0], t[:, None, :])
    b2 = hor[:, k1]
    out = ((u - d)[None, :, None] * a2 + d[None, :, None] * b2
           + (u >> 1)) >> lu
    return out.clamp(0, mx).to(torch.int32)


# ---------------------------------------------------------------------------
# CCLM (cross-component linear model)
# ---------------------------------------------------------------------------


def _sort4(lu, ch):
    """The 5-comparator sorting network on (B, 4) luma keys, carrying the
    chroma values ((B, 4, ...)) (the spec model's comparator sequence)."""
    lu = [lu[:, i] for i in range(4)]
    ch = [ch[:, i] for i in range(4)]
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        sw = lu[i] > lu[j]
        swc = sw.reshape(sw.shape + (1,) * (ch[i].dim() - 1))
        lu[i], lu[j] = (torch.where(sw, lu[j], lu[i]),
                        torch.where(sw, lu[i], lu[j]))
        ch[i], ch[j] = (torch.where(swc, ch[j], ch[i]),
                        torch.where(swc, ch[i], ch[j]))
    return torch.stack(lu, 1), torch.stack(ch, 1)


def _win(buf, f, y0, x0, n_rows: int, n_cols: int):
    """(B, n_rows, n_cols) windows of an (F, H, W) buffer stack at
    (y0, x0) ((B,)); rows and columns left of or above the buffer clamp
    to 0 (their samples are never available)."""
    dev = buf.device
    ry = (y0.long()[:, None] + torch.arange(n_rows, device=dev)).clamp(min=0)
    cx = (x0.long()[:, None] + torch.arange(n_cols, device=dev)).clamp(min=0)
    return buf[f.long()[:, None, None], ry[:, :, None], cx[:, None, :]]


_CCLM_PICKS: dict = {}


def _cclm_picks(cs: int):
    """Neighbour positions CCLM samples: two per side when both sides
    are available, four on the one side otherwise (numpy, per size)."""
    if cs not in _CCLM_PICKS:
        _CCLM_PICKS[cs] = (np.asarray([cs // 4, (3 * cs) // 4]),
                           np.asarray([((2 * k + 1) * cs) >> 3
                                       for k in range(4)]))
    return _CCLM_PICKS[cs]


def cclm_predict_local(by, bc, rec_y, cx, cy, *, cs: int, n_ctu_x: int,
                       log2_ctu: int = 6, bd: int = 8, f=None):
    """(B, cs, cs) CCLM predictions of chroma blocks at (cx, cy) from the
    (F, ...) luma and chroma recon buffers (``f`` the frame of each row):
    the collocated luma interior is the leaf's own (B, 2cs, 2cs) recon
    ``rec_y`` (not yet in the buffer); only its left column is read from
    ``by``."""
    if f is None:           # single (H, W) buffers
        by, bc, f = by[None], bc[None], torch.zeros_like(cx)
    return cclm_predict_pair(by, (bc,), rec_y, cx, cy, cs=cs,
                             n_ctu_x=n_ctu_x, log2_ctu=log2_ctu, bd=bd,
                             f=f)[0]


def cclm_predict_pair(by, bcs, rec_y, cx, cy, *, cs: int, n_ctu_x: int,
                      log2_ctu: int, bd: int, f):
    """cclm_predict_local for each chroma buffer of ``bcs`` at once: the
    luma side (downsampling, availability, the sort order of the four
    picked samples) is shared by both chroma components."""
    half = 1 << (bd - 1)
    mx = (1 << bd) - 1

    def ds_from(win):
        # win: (B, 2r, 2cs+1) luma over plane columns 2cx-1 .. 2cx+2cs-1
        c0 = torch.where((cx > 0)[:, None], win[:, :, 0], win[:, :, 1])
        win = torch.cat([c0[:, :, None], win[:, :, 1:]], 2)
        a, b = win[:, 0::2], win[:, 1::2]
        return ((2 * a[:, :, 1:2 * cs:2] + a[:, :, 0:2 * cs - 1:2]
                 + a[:, :, 2:2 * cs + 1:2]
                 + 2 * b[:, :, 1:2 * cs:2] + b[:, :, 0:2 * cs - 1:2]
                 + b[:, :, 2:2 * cs + 1:2] + 4) >> 3)

    left_col = _win(by, f, 2 * cy + 1, 2 * cx, 2 * cs, 1)
    ds = ds_from(torch.cat([left_col, rec_y], 2))           # (B, cs, cs)
    a_ds = ds_from(_win(by, f, 2 * cy - 1, 2 * cx, 2, 2 * cs + 1))[:, 0]
    lf = _win(by, f, 2 * cy + 1, 2 * cx - 2, 2 * cs, 3)
    a2, b2 = lf[:, 0::2], lf[:, 1::2]
    l_ds = ((2 * a2[:, :, 1] + a2[:, :, 0] + a2[:, :, 2]
             + 2 * b2[:, :, 1] + b2[:, :, 0] + b2[:, :, 2] + 4) >> 3)
    a_c = torch.stack([_win(bc, f, cy, cx + 1, 1, cs)[:, 0]
                       for bc in bcs], 2)                   # (B, cs, P)
    l_c = torch.stack([_win(bc, f, cy + 1, cx, cs, 1)[:, :, 0]
                       for bc in bcs], 2)

    cur = morton8(2 * cx, 2 * cy, n_ctu_x, log2_ctu)
    above = (cy > 0) & (morton8(2 * cx, (2 * cy - 2).clamp(min=0), n_ctu_x,
                                log2_ctu) < cur)
    left = (cx > 0) & (morton8((2 * cx - 2).clamp(min=0), 2 * cy, n_ctu_x,
                               log2_ctu) < cur)
    i2, i4 = (_c(a, by.device) for a in _cclm_picks(cs))

    def pick(arr_a, arr_l):
        both = torch.cat([arr_a[:, i2], arr_l[:, i2]], 1)
        sel = (slice(None),) + (None,) * (arr_a.dim() - 1)
        return torch.where((above & left)[sel], both,
                           torch.where(above[sel], arr_a[:, i4],
                                       arr_l[:, i4]))

    pl, pc = _sort4(pick(a_ds, l_ds), pick(a_c, l_c))       # pc (B, 4, P)
    lmin = ((pl[:, 0] + pl[:, 1] + 1) >> 1)[:, None]
    lmax = ((pl[:, 2] + pl[:, 3] + 1) >> 1)[:, None]
    cmin = (pc[:, 0] + pc[:, 1] + 1) >> 1
    cmax = (pc[:, 2] + pc[:, 3] + 1) >> 1
    d = lmax - lmin
    a = torch.div((cmax - cmin) << CCLM_SHIFT, d.clamp(min=1),
                  rounding_mode="floor").clamp(-CCLM_AMAX, CCLM_AMAX)
    a = torch.where(d == 0, 0, a)
    b = torch.where(d == 0, (cmin + cmax + 1) >> 1,
                    cmin - ((a * lmin) >> CCLM_SHIFT))
    pred = ((a[:, :, None, None] * ds[:, None]) >> CCLM_SHIFT) \
        + b[:, :, None, None]
    pred = torch.where((above | left)[:, None, None, None], pred, half)
    pred = pred.clamp(0, mx).to(torch.int32)
    return [pred[:, i] for i in range(len(bcs))]
