"""Palette mode (PLT): index-map coding of screen content.

Role of VTM's palette coding (spread across CommonLib/IntraSearch palette
paths, CABACWriter/Reader palette syntax, DecCu palette reconstruction —
SURVEY.md §2.2 "Palette mode").  TPU-first redesign with documented
simplifications:

* luma-driven palette: up to 8 entries, chosen as the most frequent luma
  values of the block (count desc, value asc tie-break); every pixel maps
  to the nearest entry (first-min) — no escape pixels, no predictor
  propagation across leaves;
* each entry carries explicit (Y, Cb, Cr) — chroma values are the rounded
  means of the chroma samples whose co-sited luma cell maps to the entry;
* the index map is coded as raster runs: ceil(log2 N) bypass bins for the
  symbol + EG2 bypass for (run - 1); no residual is coded (recon ==
  palette[idx], as in VVC palette CUs);
* square I-slice leaves only (8/16/32), like IBC in this build.

The same derivation runs in the spec encoder and the JAX pipeline, so the
two engines stay byte-identical; the decoder parses entries + index map.
"""
from __future__ import annotations

import numpy as np

MAX_PLT = 8
PLT_FLAG_BITS = 1      # plt_flag rate proxy in the decision pass


def derive_palette(src_y, src_cb, src_cr, x: int, y: int, s: int, bd: int):
    """(entries (N, 3) int32, idx (s, s) int32) for the luma block at
    (x, y).  Deterministic; the index map depends only on luma (so the
    luma-only decision pass reproduces it exactly)."""
    blk = np.asarray(src_y[y:y + s, x:x + s], dtype=np.int64)
    ents_y, idx = _luma_palette(blk)
    n = len(ents_y)
    cs = s // 2
    cx, cy = x // 2, y // 2
    sub = idx[0::2, 0::2]
    half = 1 << (bd - 1)
    ents_c = np.full((n, 2), half, np.int64)
    for comp, plane in ((0, src_cb), (1, src_cr)):
        cb = np.asarray(plane[cy:cy + cs, cx:cx + cs], dtype=np.int64)
        for k in range(n):
            m = sub == k
            c = int(m.sum())
            if c:
                ents_c[k, comp] = (int(cb[m].sum()) + c // 2) // c
    entries = np.concatenate([ents_y[:, None], ents_c],
                             axis=1).astype(np.int32)
    return entries, idx.astype(np.int32)


def _luma_palette(blk: np.ndarray):
    """(entries_y (N,) int64, idx (s, s)) from a luma block: top-MAX_PLT
    values by (count desc, value asc), nearest-entry first-min mapping."""
    vals, cnts = np.unique(blk, return_counts=True)
    order = np.lexsort((vals, -cnts))
    ents_y = vals[order[:MAX_PLT]]
    idx = np.argmin(np.abs(blk[..., None] - ents_y[None, None, :]), axis=-1)
    return ents_y, idx


def map_block(entries: np.ndarray, idx: np.ndarray):
    """Reconstructed (Y, Cb, Cr) planes of a palette leaf (chroma from the
    co-sited even-position indices)."""
    sub = idx[0::2, 0::2]
    return (entries[idx, 0].astype(np.int32),
            entries[sub, 1].astype(np.int32),
            entries[sub, 2].astype(np.int32))


def runs_of(idx: np.ndarray):
    """Raster-scan (symbol, run) list of the index map."""
    flat = idx.ravel()
    cut = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(flat)]])
    return [(int(flat[a]), int(b - a)) for a, b in zip(starts, ends)]


def palette_bins(n_ent: int, idx: np.ndarray, bd: int) -> int:
    """Exact syntax bin count below the plt_flag: size + entries + runs."""
    ib = max(int(n_ent - 1).bit_length(), 0)
    bins = 3 + n_ent * 3 * bd
    for sym, run in runs_of(idx):
        bins += ib + eg_k_len(run - 1, 2)
    return bins


def eg_k_len(v: int, k: int) -> int:
    """Bin count of _eg_k(io, v, k)."""
    n = 0
    while v >= (1 << k):
        v -= 1 << k
        k += 1
        n += 1
    return n + 1 + k


def code_palette(io, s: int, bd: int, entries=None, idx=None):
    """Direction-agnostic palette syntax below the plt_flag.

    Encode: pass (entries, idx); decode: returns (entries, idx)."""
    from .codec import _eg_k
    if io.decoding:
        n = io.byp_n(n=3) + 1
        entries = np.zeros((n, 3), np.int32)
        for k in range(n):
            for c in range(3):
                entries[k, c] = io.byp_n(n=bd)
        ib = max(int(n - 1).bit_length(), 0)
        flat = np.zeros(s * s, np.int32)
        pos = 0
        while pos < s * s:
            sym = io.byp_n(n=ib) if ib else 0
            run = _eg_k(io, None, 2) + 1
            run = min(run, s * s - pos)
            flat[pos:pos + run] = sym
            pos += run
        return entries, flat.reshape(s, s)
    n = len(entries)
    io.byp_n(n - 1, 3)
    for k in range(n):
        for c in range(3):
            io.byp_n(int(entries[k, c]), bd)
    ib = max(int(n - 1).bit_length(), 0)
    for sym, run in runs_of(idx):
        if ib:
            io.byp_n(sym, ib)
        _eg_k(io, run - 1, 2)
    return entries, idx


def palette_size_pass(orig_y: np.ndarray, s: int, lam: int, bd: int):
    """Decision-pass palette cost per s-block (luma-only, exact rate):
    (cost (nby, nbx) int64) — shared by both engines (host pass; palette
    derivation is histogram work, intentionally not a device kernel).

    Fully vectorised over the frame's blocks; arithmetic is identical to
    the per-block _luma_palette/palette_bins path (count-desc/value-asc
    entry order, first-min nearest mapping, 8x8 Hadamard SATD, exact run
    bins)."""
    from .decide import _H8
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    B, L = nby * nbx, s * s
    nv = 1 << bd
    flatb = (orig_y.astype(np.int32).reshape(nby, s, nbx, s)
             .transpose(0, 2, 1, 3).reshape(B, L))
    hist = np.bincount(
        (np.repeat(np.arange(B, dtype=np.int64), L) << bd)
        | flatb.ravel().astype(np.int64), minlength=B * nv
    ).reshape(B, nv).astype(np.int32)
    # top-MAX_PLT values by (count desc, value asc): embed the value
    # tie-break in one sort key (counts <= L < nv ensures no overlap)
    key = -(hist * nv + (nv - 1 - np.arange(nv, dtype=np.int32))[None, :])
    kp = np.argpartition(key, MAX_PLT, axis=1)[:, :MAX_PLT]
    top = np.take_along_axis(
        kp, np.argsort(np.take_along_axis(key, kp, axis=1), axis=1), axis=1)
    cnts = np.take_along_axis(hist, top, axis=1)
    n_ent = (cnts > 0).sum(axis=1).astype(np.int64)      # (B,)
    ents = np.where(cnts > 0, top, 1 << 20).astype(np.int32)  # absent->far
    idx = np.argmin(np.abs(flatb[:, :, None] - ents[:, None, :]), axis=2)
    mapped = np.take_along_axis(ents, idx, axis=1)
    # 8x8 Hadamard SATD via batched float64 matmuls (exact: |t| < 2^53)
    h8f = _H8.astype(np.float64)
    diff = (flatb - mapped).reshape(nby, nbx, s // 8, 8, s // 8, 8)
    tiles = diff.transpose(0, 1, 2, 4, 3, 5).astype(np.float64)
    ht = h8f @ tiles @ h8f
    satd = ((np.abs(ht).sum(axis=(4, 5)).astype(np.int64) + 4) >> 3).sum(
        axis=(2, 3)).reshape(B)
    # run bins over the index map (block-boundary-forced run breaks)
    ib = np.where(n_ent > 1,
                  np.floor(np.log2(np.maximum(n_ent - 1, 1)
                                   .astype(np.float64))).astype(np.int64)
                  + 1, 0)
    g = idx.ravel()
    change = np.empty(B * L, bool)
    change[0] = True
    change[1:] = g[1:] != g[:-1]
    change[::L] = True
    starts = np.flatnonzero(change)
    runlen = np.diff(np.append(starts, B * L))
    blk_id = starts // L
    # eg_k_len(v, 2) == 2*m + 3 with m = max(floor(log2(v + 4)) - 2, 0)
    m = np.maximum(np.floor(np.log2(runlen + 3.0)).astype(np.int64) - 2, 0)
    runbits = np.bincount(blk_id, weights=(ib[blk_id] + 2 * m + 3),
                          minlength=B).astype(np.int64)
    bins = PLT_FLAG_BITS + 3 + n_ent * 3 * bd + runbits
    cost = (satd << 8) + bins * lam
    return cost.reshape(nby, nbx)


def plt_leaves(dec) -> list[tuple[int, int, int]]:
    """[(x, y, s)] of all palette leaves from the decision maps (square
    leaves only, by construction)."""
    out = []
    n32y, n32x = dec.split32.shape
    for by in range(n32y):
        for bx in range(n32x):
            b = int(dec.bt32[by, bx]) if dec.bt32 is not None else 0
            if not dec.split32[by, bx] and not b:
                if dec.plt8[by * 4, bx * 4]:
                    out.append((bx * 32, by * 32, 32))
                continue
            if not dec.split32[by, bx]:
                continue
            for sy in range(2):
                for sx in range(2):
                    iy, ix = by * 2 + sy, bx * 2 + sx
                    b16 = int(dec.bt16[iy, ix]) \
                        if dec.bt16 is not None else 0
                    if not dec.split16[iy, ix] and not b16:
                        if dec.plt8[iy * 2, ix * 2]:
                            out.append((ix * 16, iy * 16, 16))
                        continue
                    if not dec.split16[iy, ix]:
                        continue
                    for qy in range(2):
                        for qx in range(2):
                            gy, gx = iy * 2 + qy, ix * 2 + qx
                            if dec.plt8[gy, gx]:
                                out.append((gx * 8, gy * 8, 8))
    return out


def derive_plt_data(dec, src_y, src_cb, src_cr, bd: int) -> None:
    """Encoder-side: fill dec.plt_data for every palette leaf from the
    (coded-domain) source planes — the same derivation the spec engine
    runs inside _code_plt_leaf, precomputed for the JAX walker."""
    if dec.plt_data is None:
        dec.plt_data = {}
    for (x, y, s) in plt_leaves(dec):
        dec.plt_data[(x, y, s)] = derive_palette(src_y, src_cb, src_cr,
                                                 x, y, s, bd)


def build_planes(plt_data: dict, height: int, width: int):
    """Dense (Y, Cb, Cr) palette-recon planes (zeros elsewhere) for the
    JAX engine's frame scan, from {(x, y, s): (entries, idx)}."""
    py = np.zeros((height, width), np.int32)
    pcb = np.zeros((height // 2, width // 2), np.int32)
    pcr = np.zeros((height // 2, width // 2), np.int32)
    for (x, y, s), (entries, idx) in plt_data.items():
        ry, rcb, rcr = map_block(entries, idx)
        py[y:y + s, x:x + s] = ry
        pcb[y // 2:y // 2 + s // 2, x // 2:x // 2 + s // 2] = rcb
        pcr[y // 2:y // 2 + s // 2, x // 2:x // 2 + s // 2] = rcr
    return py, pcb, pcr
