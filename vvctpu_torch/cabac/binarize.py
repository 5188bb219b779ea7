"""Vectorized residual binarisation: TB levels -> (kind, ctx, bin) arrays.

The encoder-side insight that unlocks TPU/vector CABAC (SURVEY.md §7.3.1):
when encoding, all levels are known up front, so every bin value and every
context index of the residual syntax is a *pure array function* of the level
plane — the context templates only reference later-in-scan positions, whose
partial (pass-1) values are already final.  Only the arithmetic-coder state
update remains sequential, and that is the native packer's job
(native/cabac.c).

Bin sequence produced here is exactly the one spec/residual.code_tb emits
(enforced by tests/test_binarize.py); kinds: 0 = context bin, 1 = bypass.
"""
from __future__ import annotations

import numpy as np

from ..core import rom
from . import contexts as C
from ..spec.residual import _GROUP_IDX, _MIN_IN_GROUP, _last_ctx, _rice_param

KIND_CTX, KIND_BYP, KIND_TERM = 0, 1, 2


class BinSink:
    """Append-only (kind, ctx, bin) stream with chunked numpy storage."""

    def __init__(self) -> None:
        self._chunks: list[np.ndarray] = []

    def push(self, kinds, ctxs, bins) -> None:
        arr = np.stack([np.asarray(kinds, np.int32),
                        np.asarray(ctxs, np.int32),
                        np.asarray(bins, np.int32)], axis=1)
        self._chunks.append(arr)

    def ctx(self, ctx_id: int, b: int) -> None:
        self._chunks.append(
            np.array([[KIND_CTX, ctx_id, b]], np.int32))

    def byp(self, b: int) -> None:
        self._chunks.append(np.array([[KIND_BYP, 0, b]], np.int32))

    def byp_bits(self, v: int, n: int) -> None:
        if n <= 0:
            return
        bits = [(v >> i) & 1 for i in range(n - 1, -1, -1)]
        arr = np.zeros((n, 3), np.int32)
        arr[:, 0] = KIND_BYP
        arr[:, 2] = bits
        self._chunks.append(arr)

    def term(self, b: int) -> None:
        self._chunks.append(np.array([[KIND_TERM, 0, b]], np.int32))

    def concat(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, 3), np.int32)
        return np.concatenate(self._chunks, axis=0)


def _golomb_rice_bins(sink: BinSink, val: int, k: int) -> None:
    prefix = val >> k
    if prefix < 6:
        sink.byp_bits((((1 << prefix) - 1) << 1), prefix + 1)
        if k:
            sink.byp_bits(val & ((1 << k) - 1), k)
        return
    sink.byp_bits((1 << 6) - 1, 6)
    sym = val - (6 << k)
    count = k + 1
    ones = 0
    while sym >= (1 << count):
        ones += 1
        sym -= 1 << count
        count += 1
    sink.byp_bits(((1 << ones) - 1) << 1, ones + 1)
    if count:
        sink.byp_bits(sym, count)


_TEMPLATE = ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1))


def _conv5(p: np.ndarray) -> np.ndarray:
    """Sum over the forward template (dx, dy) offsets."""
    h, w = p.shape
    z = np.zeros((h + 2, w + 2), p.dtype)
    z[:h, :w] = p
    out = np.zeros_like(p)
    for dx, dy in _TEMPLATE:
        out += z[dy:dy + h, dx:dx + w]
    return out


def _conv5_cg(p_same: np.ndarray, p_other: np.ndarray) -> np.ndarray:
    """Template sum taking ``p_same`` for neighbours in the same 4x4 CG and
    ``p_other`` for neighbours in a different (later-scan, hence fully
    reconstructed) CG — matching the pass interleaving of code_tb."""
    h, w = p_same.shape
    zs = np.zeros((h + 2, w + 2), p_same.dtype)
    zo = np.zeros((h + 2, w + 2), p_other.dtype)
    zs[:h, :w] = p_same
    zo[:h, :w] = p_other
    ys, xs = np.mgrid[0:h, 0:w]
    out = np.zeros_like(p_same)
    for dx, dy in _TEMPLATE:
        same = ((xs // rom.CG_SIZE) == ((xs + dx) // rom.CG_SIZE)) \
            & ((ys // rom.CG_SIZE) == ((ys + dy) // rom.CG_SIZE))
        out += np.where(same, zs[dy:dy + h, dx:dx + w],
                        zo[dy:dy + h, dx:dx + w])
    return out


def tb_bins(sink: BinSink, levels: np.ndarray, log2_w: int, log2_h: int,
            is_chroma: bool = False) -> None:
    """Emit the full residual-coding bin sequence for one TB into sink."""
    w, h = 1 << log2_w, 1 << log2_h
    scan = rom.scan_order(log2_w, log2_h)
    n = len(scan)
    cg_n = min(w, rom.CG_SIZE) * min(h, rom.CG_SIZE)
    sx, sy = scan[:, 0], scan[:, 1]

    a = np.abs(levels).astype(np.int64)
    neg = (levels < 0).astype(np.int32)
    a_scan = a[sy, sx]
    nz_idx = np.flatnonzero(a_scan)
    last_scan = int(nz_idx[-1])
    lx, ly = int(sx[last_scan]), int(sy[last_scan])

    # --- last position: both TU prefixes first, then both suffixes -------
    for val, log2s, cset, maxpos in ((lx, log2_w, C.LAST_X, w - 1),
                                     (ly, log2_h, C.LAST_Y, h - 1)):
        g = _GROUP_IDX[val]
        gmax = _GROUP_IDX[maxpos]
        nb = g + (1 if g < gmax else 0)
        if nb:
            ctxs = np.array([_last_ctx(is_chroma, log2s, i, cset)
                             for i in range(nb)], np.int32)
            bins = np.ones(nb, np.int32)
            if g < gmax:
                bins[-1] = 0
            sink.push(np.zeros(nb, np.int32), ctxs, bins)
    for val in (lx, ly):
        g = _GROUP_IDX[val]
        if g > 3:
            sink.byp_bits(val - _MIN_IN_GROUP[g], (g >> 1) - 1)

    # --- per-position planes (vectorised) --------------------------------
    par_full = np.where(a >= 2, (a - 2) & 1, 0)
    p1 = np.minimum(a, 4 + par_full)               # pass-1 partial level
    t_sig = _conv5(np.minimum(p1, 2))          # min(p1,2)==min(a,2)
    t_sum = _conv5_cg(p1, a)                   # pass-1 in-CG, full cross-CG
    t_abs = _conv5(a)

    d = sx + sy
    if is_chroma:
        sig_base = C.SIG_CHROMA_BASE + np.where(d == 0, 4, 0)
        gt_base = C.GTX_CHROMA_BASE + np.where(d == 0, 4, 0)
    else:
        sig_base = np.where(d == 0, 8, np.where(d < 3, 4, 0))
        gt_base = C.GTX_LUMA_BASE + np.where(d == 0, 8,
                                             np.where(d < 3, 4, 0))
    sig_ctx = C.SIG_FLAG.offset + sig_base + np.minimum(
        (t_sig[sy, sx] + 1) >> 1, 3)
    tctx = np.minimum((t_sum[sy, sx] + 1) >> 1, 3)
    gt1_ctx = C.GT1_FLAG.offset + gt_base + tctx
    par_ctx = C.PAR_FLAG.offset + gt_base + tctx
    gt3_ctx = C.GT3_FLAG.offset + gt_base + tctx

    sig_v = (a_scan > 0).astype(np.int32)
    gt1_v = (a_scan > 1).astype(np.int32)
    par_v = par_full[sy, sx].astype(np.int32)
    gt3_v = (a_scan > 3).astype(np.int32)

    # --- CG flags + passes, reverse CG order ------------------------------
    last_cg = last_scan // cg_n
    cg_w = max(w // rom.CG_SIZE, 1)
    cg_sx = sx[::cg_n] // rom.CG_SIZE    # CG coords per cg index
    cg_sy = sy[::cg_n] // rom.CG_SIZE
    num_cg = n // cg_n
    cg_any = np.array([a_scan[c * cg_n:(c + 1) * cg_n].any()
                       for c in range(num_cg)], np.int32)
    cg_grid = np.zeros((max(h // rom.CG_SIZE, 1), cg_w), np.int32)
    cg_grid[cg_sy, cg_sx] = cg_any
    cg_off = 0 if not is_chroma else 2

    for cg in range(last_cg, -1, -1):
        first, lastc = cg * cg_n, cg * cg_n + cg_n - 1
        if cg != last_cg and cg != 0:
            gx, gy = int(cg_sx[cg]), int(cg_sy[cg])
            right = int(cg_grid[gy, gx + 1]) if gx + 1 < cg_grid.shape[1] \
                else 0
            below = int(cg_grid[gy + 1, gx]) if gy + 1 < cg_grid.shape[0] \
                else 0
            sink.ctx(C.CG_FLAG(cg_off + min(1, right + below)),
                     int(cg_any[cg]))
            if not cg_any[cg]:
                continue

        start = last_scan if cg == last_cg else lastc
        ks = np.arange(start, first - 1, -1)
        # pass 1 interleaved sig/gt1/par/gt3 per position
        has_sig = (ks != last_scan)
        sigs = sig_v[ks]
        pres = np.zeros((len(ks), 4), bool)
        pres[:, 0] = has_sig
        pres[:, 1] = sigs > 0
        pres[:, 2] = gt1_v[ks] > 0
        pres[:, 3] = gt1_v[ks] > 0
        kinds4 = np.zeros((len(ks), 4), np.int32)
        ctxs4 = np.stack([sig_ctx[ks], gt1_ctx[ks], par_ctx[ks],
                          gt3_ctx[ks]], axis=1).astype(np.int32)
        bins4 = np.stack([sigs, gt1_v[ks], par_v[ks], gt3_v[ks]],
                         axis=1).astype(np.int32)
        m = pres.ravel()
        sink.push(kinds4.ravel()[m], ctxs4.ravel()[m], bins4.ravel()[m])

        # pass 2: remainders for gt3 positions (rare; python GR)
        for k in ks[gt3_v[ks] > 0]:
            rice = _rice_param(int(t_abs[sy[k], sx[k]]))
            rem = (int(a_scan[k]) - 4 - int(par_v[k])) >> 1
            _golomb_rice_bins(sink, rem, rice)

        # pass 3: signs
        sk = ks[sigs > 0]
        if len(sk):
            kinds = np.full(len(sk), KIND_BYP, np.int32)
            sink.push(kinds, np.zeros(len(sk), np.int32),
                      neg[sy[sk], sx[sk]])
