"""Spec-model intra prediction: reference construction, 67 modes, PDPC, MPM.

Role of VTM:CommonLib/IntraPrediction.cpp (initIntraPatternChType,
predIntraAng, xPredIntraPlanar, xPredIntraDc, PDPC) and the MPM derivation in
VTM:CommonLib/UnitTools.cpp (PU::getIntraMPMs).

Conventions: reference arrays ``top[0..w+h]`` with ``top[0]`` the above-left
corner sample and ``top[i] = p(x-1+i, y-1)``; ``left[j] = p(x-1, y-1+j)``
(``left[0] == top[0]``).  Unavailable samples are substituted scanning from the
bottom-most left sample upward then across the top row, as in the standard;
if nothing is available the half-range value is used.

Deviations this round (documented per SURVEY.md §0 — internally consistent,
encoder and decoder share this code): PDPC is applied for Planar/DC/HOR/VER
(not yet for the near-diagonal angular modes); the 4-tap fractional filters
are the generated sets from core.rom.
"""
from __future__ import annotations

import numpy as np

from ..core import rom

P, DC, HOR, DIA, VER = (rom.PLANAR_IDX, rom.DC_IDX, rom.HOR_IDX, rom.DIA_IDX,
                        rom.VER_IDX)


# ---------------------------------------------------------------------------
# Reference sample construction
# ---------------------------------------------------------------------------

def build_references(plane: np.ndarray, valid: np.ndarray, x: int, y: int,
                     w: int, h: int, bit_depth: int = rom.BIT_DEPTH,
                     ref_line: int = 0):
    """Return (top, left) int32 reference arrays of length 2w+1 / 2h+1.

    VVC 8.4.5.2.5: refW = 2*nTbW, refH = 2*nTbH — the extended rows wide-
    angle rays need on non-square blocks (for squares 2w == w+h, identical
    to the pre-r5 build).  ref_line k > 0 (MRL) gathers the k-th further
    line with corner alignment: top[i] = p(x-1-k+i, y-1-k),
    left[j] = p(x-1-k, y-1-k+j)."""
    fh, fw = plane.shape
    nt, nl = 2 * w, 2 * h
    half = 1 << (bit_depth - 1)
    k = ref_line

    # gather raw samples + availability, in substitution scan order:
    # left column bottom-to-top, then corner, then top row left-to-right.
    coords = []
    for j in range(nl, 0, -1):
        coords.append((x - 1 - k, y - 1 - k + j))
    coords.append((x - 1 - k, y - 1 - k))
    for i in range(1, nt + 1):
        coords.append((x - 1 - k + i, y - 1 - k))

    vals = np.empty(len(coords), np.int32)
    avail = np.zeros(len(coords), bool)
    for i, (cx, cy) in enumerate(coords):
        if 0 <= cx < fw and 0 <= cy < fh and valid[cy, cx]:
            vals[i] = plane[cy, cx]
            avail[i] = True

    if not avail.any():
        vals[:] = half
    else:
        # substitute: first entry from first available, then carry forward
        first = int(np.argmax(avail))
        vals[:first + 1][~avail[:first + 1]] = vals[first]
        for i in range(first + 1, len(coords)):
            if not avail[i]:
                vals[i] = vals[i - 1]

    left = vals[:nl + 1][::-1].copy()  # left[0]=corner, left[j]=p(x-1,y-1+j)
    top = vals[nl:].copy()             # top[0]=corner, top[i]=p(x-1+i,y-1)
    return top.astype(np.int32), left.astype(np.int32)


def _smooth_refs(top: np.ndarray, left: np.ndarray):
    """[1 2 1]/4 reference smoothing (luma, selected modes)."""
    def f(a):
        out = a.copy()
        out[1:-1] = (a[:-2] + 2 * a[1:-1] + a[2:] + 2) >> 2
        out[0] = (a[1] + 2 * a[0] + a[1] + 2) >> 2
        out[-1] = (a[-2] + 3 * a[-1] + 2) >> 2
        return out
    corner = (left[1] + 2 * top[0] + top[1] + 2) >> 2
    tf, lf = f(top), f(left)
    tf[0] = lf[0] = corner
    return tf, lf


# distance threshold per log2(size) above which smoothing applies
_SMOOTH_THRES = {2: 64, 3: 14, 4: 2, 5: 0, 6: 0}


def ref_filter_flag(mode: int, w: int, h: int) -> bool:
    """mode may be a wide-angle-remapped index (67..94): the smoothing
    distance uses the signed mode (negative for the wide-low range), so
    wide angles always measure far from HOR/VER."""
    if mode in (DC, HOR, VER):
        return False
    log2s = ((int(w).bit_length() - 1) + (int(h).bit_length() - 1)) >> 1
    if mode == P:
        return (w * h) > 32
    signed = 80 - mode if mode > 80 else mode
    dist = min(abs(signed - HOR), abs(signed - VER))
    return dist > _SMOOTH_THRES.get(log2s, 0)


# ---------------------------------------------------------------------------
# Prediction
# ---------------------------------------------------------------------------

def _planar(top, left, w, h):
    lw, lh = int(w).bit_length() - 1, int(h).bit_length() - 1
    xs = np.arange(w)
    ys = np.arange(h)
    t = top[1:w + 1].astype(np.int64)
    l = left[1:h + 1].astype(np.int64)
    tr = int(top[w + 1]) if w + 1 < len(top) else int(top[w])
    bl = int(left[h + 1]) if h + 1 < len(left) else int(left[h])
    pred_v = (h - 1 - ys)[:, None] * t[None, :] + (ys + 1)[:, None] * bl
    pred_h = (w - 1 - xs)[None, :] * l[:, None] + (xs + 1)[None, :] * tr
    return ((pred_v << lw) + (pred_h << lh) + w * h) >> (lw + lh + 1)


def _dc(top, left, w, h):
    if w == h:
        s = int(top[1:w + 1].sum() + left[1:h + 1].sum())
        return np.full((h, w), (s + ((w + h) >> 1)) // (w + h), np.int64)
    if w > h:
        s = int(top[1:w + 1].sum())
        return np.full((h, w), (s + (w >> 1)) >> (int(w).bit_length() - 1),
                       np.int64)
    s = int(left[1:h + 1].sum())
    return np.full((h, w), (s + (h >> 1)) >> (int(h).bit_length() - 1),
                   np.int64)


def _angular(top, left, mode, w, h, is_chroma, filt, ref_line=0):
    """Angular modes 2..66.  Modes >= DIA predict from the top reference;
    modes < DIA are the transpose (predict from left).  ref_line k shifts
    the ray intersection: pos = (row + k) * angle, index offset +k (exact
    extension of the corner-aligned MRL reference geometry)."""
    vertical = DIA <= mode <= 80    # 67..80 wide-high; 81..94 wide-low
    angle = int(rom.INTRA_PRED_ANGLE[mode])
    inv_angle = int(rom.INTRA_INV_ANGLE[mode])

    if vertical:
        main, side = top, left
        n_pred, n_orth = w, h
    else:
        main, side = left, top
        n_pred, n_orth = h, w

    # extended main reference indexed ext[k] = main_ref(k - n_orth)
    ext = np.zeros(2 * (n_pred + n_orth) + 2, np.int64)
    off = n_orth
    ln = min(len(main) - 1, 2 * n_pred + 1)
    ext[off:off + ln + 1] = main[:ln + 1]
    ext[off + ln + 1:] = main[ln]
    if angle < 0:
        # project side reference onto the main axis
        for k in range(1, n_orth + 1):
            sidx = (k * inv_angle + 256) >> 9
            sidx = min(sidx, len(side) - 1)
            ext[off - k] = side[sidx]

    ys = np.arange(1, n_orth + 1)
    pos = (ys + ref_line) * angle
    i_idx = (pos >> 5)
    i_fact = pos & 31

    xs = np.arange(n_pred)
    # sample index per (row y, col x): off + x + 1 + k + i_idx[y]
    base = off + 1 + ref_line + xs[None, :] + i_idx[:, None]

    if is_chroma or (angle % 32) == 0:
        if (angle % 32) == 0:
            pred = ext[base]
        else:
            a = ext[base]
            b = ext[base + 1]
            pred = ((32 - i_fact)[:, None] * a + i_fact[:, None] * b + 16) >> 5
    else:
        taps = rom.intra_filter_4tap(filt).astype(np.int64)
        f = taps[i_fact]  # (n_orth, 4)
        pred = np.zeros((n_orth, n_pred), np.int64)
        for t in range(4):
            pred += f[:, t][:, None] * ext[base + t - 1]
        pred = (pred + 32) >> 6

    if not vertical:
        pred = pred.T
    return pred


def _pdpc(pred, top, left, mode, w, h, bit_depth):
    scale = ((int(w).bit_length() - 1) + (int(h).bit_length() - 1) - 2) >> 2
    xs = np.arange(w)
    ys = np.arange(h)
    wl = np.maximum(32 >> np.minimum(31, (xs * 2) >> scale), 0)[None, :]
    wt = np.maximum(32 >> np.minimum(31, (ys * 2) >> scale), 0)[:, None]
    t = top[1:w + 1].astype(np.int64)[None, :]
    l = left[1:h + 1].astype(np.int64)[:, None]
    corner = int(top[0])
    p = pred.astype(np.int64)
    if mode in (P, DC):
        out = (wl * l + wt * t + (64 - wl - wt) * p + 32) >> 6
    elif mode == VER:
        out = np.clip(p + ((wl * (l - corner) + 32) >> 6), 0,
                      (1 << bit_depth) - 1)
    elif mode == HOR:
        out = np.clip(p + ((wt * (t - corner) + 32) >> 6), 0,
                      (1 << bit_depth) - 1)
    else:
        out = p
    return out


def predict(top: np.ndarray, left: np.ndarray, mode: int, w: int, h: int,
            is_chroma: bool = False,
            bit_depth: int = rom.BIT_DEPTH, ref_line: int = 0) -> np.ndarray:
    """Intra prediction from reference arrays.  Returns (h, w) int32.

    ref_line > 0 (MRL): reference smoothing and PDPC are disabled, as in
    the standard; arrays must be built with the same ref_line.

    Non-square blocks remap near-diagonal angular modes to wide angles
    (rom.wide_angle_mode; VVC 8.4.5.2.6) at prediction time — the
    signalled mode stays 0..66.  References are 2w/2h long (VVC refW/refH)
    so wide-angle rays read real samples; reads past 2*n_pred (4-tap tail)
    clamp to the last built sample as in the standard's extension rule."""
    m2 = rom.wide_angle_mode(mode, w, h)
    filt = (not is_chroma) and ref_line == 0 and ref_filter_flag(m2, w, h)
    if filt and (mode == P or (rom.INTRA_PRED_ANGLE[m2] % 32) == 0):
        top, left = _smooth_refs(top, left)
        smoothed_interp = False
    else:
        smoothed_interp = filt

    if mode == P:
        pred = _planar(top, left, w, h)
    elif mode == DC:
        pred = _dc(top, left, w, h)
    else:
        pred = _angular(top, left, m2, w, h, is_chroma, smoothed_interp,
                        ref_line)

    if not is_chroma and ref_line == 0 and mode in (P, DC, HOR, VER):
        pred = _pdpc(pred, top, left, mode, w, h, bit_depth)
    return np.clip(pred, 0, (1 << bit_depth) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# MIP: matrix intra prediction
# (role of VTM:CommonLib/MatrixIntraPrediction.cpp — boundary downsample ->
#  int matrix multiply -> linear upsample, with a transpose variant.  The
#  weight matrices are generated LMMSE predictors, see core/rom.mip_weights.
#  Identical integer algorithm in the JAX twin kernels/intra_pred.py.)
# ---------------------------------------------------------------------------

def _mip_upsample_idx(s: int, rs: int):
    """Static upsample gather: (k0, d) per output position 0..s-1, anchors
    at positions (k+1)*u - 1; k0 = -1 selects the boundary line."""
    u = s // rs
    xs = np.arange(s)
    k0 = (xs + 1) // u - 1
    d = xs - ((k0 + 1) * u - 1)
    return k0, d, u


def mip_predict(top: np.ndarray, left: np.ndarray, mode16: int, s: int,
                bd: int) -> np.ndarray:
    """MIP prediction for an (s, s) luma block from reference arrays.

    mode16 = 2 * matrix_mode + transpose (0..15)."""
    rs = rom.MIP_REDUCED[s]
    m, tr = mode16 >> 1, mode16 & 1
    w = rom.mip_weights(rs)[m].astype(np.int64)
    mx = (1 << bd) - 1
    r4 = s // 4
    lr4 = int(r4).bit_length() - 1
    t = top[1:s + 1].astype(np.int64)
    l = left[1:s + 1].astype(np.int64)
    b_t = (t.reshape(4, r4).sum(axis=1) + (r4 >> 1)) >> lr4
    b_l = (l.reshape(4, r4).sum(axis=1) + (r4 >> 1)) >> lr4
    b = np.concatenate([b_l, b_t] if tr else [b_t, b_l])
    red = np.clip((w @ b + (1 << (rom.MIP_SHIFT - 1))) >> rom.MIP_SHIFT,
                  0, mx).reshape(rs, rs)
    if tr:
        red = red.T
    if rs == s:
        return red.astype(np.int32)
    # upsample: horizontal (left boundary = downsampled left), then vertical
    # (top boundary = full-resolution top row) — integer linear interpolation
    k0, d, u = _mip_upsample_idx(s, rs)
    lu = int(u).bit_length() - 1
    lrow = b_l[(np.arange(rs) * 4) // rs]                    # (rs,)
    a = np.where(k0[None, :] >= 0, red[:, np.maximum(k0, 0)], lrow[:, None])
    bb = red[:, np.minimum(k0 + 1, rs - 1)]
    hor = ((u - d)[None, :] * a + d[None, :] * bb + (u >> 1)) >> lu  # (rs, s)
    a2 = np.where(k0[:, None] >= 0, hor[np.maximum(k0, 0)], t[None, :])
    b2 = hor[np.minimum(k0 + 1, rs - 1)]
    out = ((u - d)[:, None] * a2 + d[:, None] * b2 + (u >> 1)) >> lu
    return np.clip(out, 0, mx).astype(np.int32)


# ---------------------------------------------------------------------------
# CCLM: chroma-from-luma linear model
# (role of VTM:CommonLib/IntraPrediction.cpp predIntraChromaLM /
#  xGetLumaRecPixels: min/max 4-pair derivation + 6-tap 4:2:0 downsample.
#  Integer staging is this build's own — CCLM_SHIFT-bit slope, deterministic
#  5-comparator sorting network — identical in the JAX twin.)
# ---------------------------------------------------------------------------
CCLM_SHIFT = 13
CCLM_AMAX = 1 << 17


def luma_ds(recon_y: np.ndarray, cx: int, cy: int, w: int, h: int):
    """(h, w) downsampled luma for chroma block at (cx, cy) — 6-tap
    {1 2 1; 1 2 1}/8 with left-edge clamp.  Coordinates on the chroma grid."""
    ly, lx = 2 * cy, 2 * cx
    rows = recon_y[ly:ly + 2 * h]
    # columns lx-1 .. lx+2w-1 (clamp x = -1 to 0)
    x_idx = np.clip(np.arange(lx - 1, lx + 2 * w), 0, recon_y.shape[1] - 1)
    win = rows[:, x_idx].astype(np.int64)          # (2h, 2w+1)
    a, b = win[0::2], win[1::2]
    mid = slice(1, 2 * w, 2)
    lft = slice(0, 2 * w - 1, 2)
    rgt = slice(2, 2 * w + 1, 2)
    return ((2 * a[:, mid] + a[:, lft] + a[:, rgt]
             + 2 * b[:, mid] + b[:, lft] + b[:, rgt] + 4) >> 3)


def _sort4(l, c):
    """Deterministic 5-comparator sorting network on (luma, chroma) pairs;
    swaps strictly-greater luma only (same network in the JAX twin)."""
    l, c = list(l), list(c)
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        if l[i] > l[j]:
            l[i], l[j] = l[j], l[i]
            c[i], c[j] = c[j], c[i]
    return l, c


def cclm_alpha_beta(pl, pc, bd: int):
    """Integer (a, b) from 4 (luma, chroma) pairs; pred = ((a*l)>>SH) + b."""
    l, c = _sort4([int(v) for v in pl], [int(v) for v in pc])
    lmin = (l[0] + l[1] + 1) >> 1
    cmin = (c[0] + c[1] + 1) >> 1
    lmax = (l[2] + l[3] + 1) >> 1
    cmax = (c[2] + c[3] + 1) >> 1
    d = lmax - lmin
    if d == 0:
        return 0, (cmin + cmax + 1) >> 1
    a = ((cmax - cmin) << CCLM_SHIFT) // d
    a = max(-CCLM_AMAX, min(CCLM_AMAX, a))
    b = cmin - ((a * lmin) >> CCLM_SHIFT)
    return a, b


def cclm_predict(recon_y: np.ndarray, chroma_plane: np.ndarray,
                 chroma_valid: np.ndarray, cx: int, cy: int, cs: int,
                 bd: int) -> np.ndarray:
    """CCLM prediction for the (cs, cs) chroma block at (cx, cy).

    recon_y: current luma recon plane (the collocated block is already
    reconstructed — chroma follows luma in the leaf).  Returns (cs, cs)."""
    above = cy > 0 and bool(chroma_valid[cy - 1, cx])
    left = cx > 0 and bool(chroma_valid[cy, cx - 1])
    half = 1 << (bd - 1)
    ds = luma_ds(recon_y, cx, cy, cs, cs)

    if not (above or left):
        pred = np.full((cs, cs), half, np.int64)
        return np.clip(pred, 0, (1 << bd) - 1).astype(np.int32)

    pl, pc = [], []
    if above and left:
        idxs = (cs // 4, (3 * cs) // 4)
        a_ds = luma_ds(recon_y, cx, cy - 1, cs, 1)[0]
        l_ds = _left_ds(recon_y, cx, cy, cs)
        for i in idxs:
            pl.append(int(a_ds[i]))
            pc.append(int(chroma_plane[cy - 1, cx + i]))
        for j in idxs:
            pl.append(int(l_ds[j]))
            pc.append(int(chroma_plane[cy + j, cx - 1]))
    elif above:
        a_ds = luma_ds(recon_y, cx, cy - 1, cs, 1)[0]
        for k in range(4):
            i = ((2 * k + 1) * cs) >> 3
            pl.append(int(a_ds[i]))
            pc.append(int(chroma_plane[cy - 1, cx + i]))
    else:
        l_ds = _left_ds(recon_y, cx, cy, cs)
        for k in range(4):
            j = ((2 * k + 1) * cs) >> 3
            pl.append(int(l_ds[j]))
            pc.append(int(chroma_plane[cy + j, cx - 1]))

    a, b = cclm_alpha_beta(pl, pc, bd)
    pred = ((a * ds) >> CCLM_SHIFT) + b
    return np.clip(pred, 0, (1 << bd) - 1).astype(np.int32)


def _left_ds(recon_y: np.ndarray, cx: int, cy: int, h: int) -> np.ndarray:
    """(h,) downsampled luma column for the chroma column cx - 1."""
    ly, lx = 2 * cy, 2 * (cx - 1)
    rows = recon_y[ly:ly + 2 * h]
    x_idx = np.clip(np.arange(lx - 1, lx + 2), 0, recon_y.shape[1] - 1)
    win = rows[:, x_idx].astype(np.int64)          # (2h, 3)
    a, b = win[0::2], win[1::2]
    return ((2 * a[:, 1] + a[:, 0] + a[:, 2]
             + 2 * b[:, 1] + b[:, 0] + b[:, 2] + 4) >> 3)


# ---------------------------------------------------------------------------
# MPM list (6 entries, planar always first)
# ---------------------------------------------------------------------------

def _adj(m: int, d: int) -> int:
    return ((m - 2 + d) % 65) + 2


def mpm_list(left_mode: int, above_mode: int) -> list[int]:
    l, a = left_mode, above_mode
    out = [P]

    def push(m):
        if m not in out:
            out.append(m)

    if l == a and l > DC:
        for m in (l, _adj(l, -1), _adj(l, 1), DC, _adj(l, -2)):
            push(m)
    elif l > DC and a > DC:
        push(l)
        push(a)
        push(DC)
        for m in (_adj(l, -1), _adj(l, 1), _adj(a, -1), _adj(a, 1),
                  _adj(l, -2), _adj(a, -2)):
            push(m)
    elif max(l, a) > DC:
        m0 = max(l, a)
        for m in (m0, _adj(m0, -1), _adj(m0, 1), DC, _adj(m0, -2)):
            push(m)
    else:
        for m in (DC, VER, HOR, VER - 4, VER + 4):
            push(m)
    return out[:rom.NUM_MPM]
