"""LMCS — luma mapping with chroma scaling (reshaper), luma-mapping part.

Role of VTM:CommonLib/Reshape.cpp (fwd/inv piecewise-linear LUTs) and
VTM:EncoderLib/EncReshape.cpp (model estimation) — SURVEY.md §2.5.  The
16-segment codeword model is derived from the source-luma histogram
(equalisation with clamps), signalled per slice, and both engines apply the
identical integer LUTs: intra coding runs in the mapped domain, inter
predictions are forward-mapped, and the reconstruction is inverse-mapped
before the loop filters (the standard's dataflow).

Chroma residual scaling (CRS) is applied to INTER (and CIIP) chroma
residuals: the scale is the per-bin luma slope at the leaf's average
reconstructed mapped luma (build_crs_lut; no syntax — decoder re-derives).
Intra chroma codes unscaled residuals this round (documented
simplification: the mapped-domain CCLM/JCCR RD loop stays scale-free).
"""
from __future__ import annotations

import numpy as np

N_BINS = 16
SCALE_SHIFT = 11


def derive_model(src_y: np.ndarray, bd: int = 8) -> tuple[int, ...]:
    """Encoder policy: histogram-equalising codeword allocation.

    Returns the 16 per-bin codeword counts (sum == 2^bd), each clamped to
    [org/4, 2*org]; deterministic integer largest-remainder rounding."""
    rng = 1 << bd
    org = rng // N_BINS
    hist = np.bincount((src_y.reshape(-1) * N_BINS) >> bd,
                       minlength=N_BINS)[:N_BINS].astype(np.int64)
    total = int(hist.sum())
    if total == 0:
        return (org,) * N_BINS
    lo, hi = org // 4, 2 * org
    ideal = hist * rng  # / total, kept as rationals for exact rounding
    cw = np.clip(ideal // total, lo, hi).astype(np.int64)
    # largest-remainder distribution of the leftover codewords
    rem = rng - int(cw.sum())
    order = np.argsort(-(ideal % total), kind="stable")
    i = 0
    guard = 0
    while rem != 0 and guard < 8 * N_BINS:
        b = int(order[i % N_BINS])
        if rem > 0 and cw[b] < hi:
            cw[b] += 1
            rem -= 1
        elif rem < 0 and cw[b] > lo:
            cw[b] -= 1
            rem += 1
        i += 1
        guard += 1
    if rem != 0:   # clamps made the target infeasible: fall back to identity
        return (org,) * N_BINS
    return tuple(int(v) for v in cw)


def build_luts(cw, bd: int = 8):
    """(fwd, inv) int32 LUTs of length 2^bd from the codeword model."""
    rng = 1 << bd
    org = rng // N_BINS
    cw = np.asarray(cw, np.int64)
    pivots = np.concatenate([[0], np.cumsum(cw)])
    scale = (cw << SCALE_SHIFT) // org          # per-bin slope, 11-bit fp

    x = np.arange(rng, dtype=np.int64)
    b = x >> (bd - 4)                           # bin index of each input
    fwd = pivots[b] + ((scale[b] * (x - b * org)
                        + (1 << (SCALE_SHIFT - 1))) >> SCALE_SHIFT)
    fwd = np.clip(fwd, 0, rng - 1).astype(np.int32)

    y = np.arange(rng, dtype=np.int64)
    yb = np.clip(np.searchsorted(pivots, y, side="right") - 1, 0,
                 N_BINS - 1)
    sc = np.maximum(scale[yb], 1)
    inv = yb * org + (((y - pivots[yb]) << SCALE_SHIFT)
                      + (sc >> 1)) // sc
    inv = np.clip(inv, 0, rng - 1).astype(np.int32)
    return fwd, inv


CRS_MIN, CRS_MAX = 512, 8192     # slope clamp: 1/4x .. 4x (11-bit fp)


def build_crs_lut(cw, bd: int = 8) -> np.ndarray:
    """CRS scale (1.11 fixed point) per MAPPED luma value: the slope of
    the codeword bin containing the value, clamped to [1/4x, 4x].  Both
    engines index it with the leaf's average reconstructed mapped luma."""
    rng = 1 << bd
    org = rng // N_BINS
    cw = np.asarray(cw, np.int64)
    pivots = np.concatenate([[0], np.cumsum(cw)])
    scale = (cw << SCALE_SHIFT) // org
    y = np.arange(rng, dtype=np.int64)
    yb = np.clip(np.searchsorted(pivots, y, side="right") - 1, 0,
                 N_BINS - 1)
    return np.clip(scale[yb], CRS_MIN, CRS_MAX).astype(np.int32)


def crs_fwd(res: np.ndarray, sc: int) -> np.ndarray:
    """Forward residual scaling (encoder): divide by the slope (floor)."""
    return ((res.astype(np.int64) << SCALE_SHIFT) // sc).astype(np.int32)


def crs_inv(r: np.ndarray, sc: int) -> np.ndarray:
    """Inverse residual scaling (shared recon): multiply by the slope."""
    return ((r.astype(np.int64) * sc) >> SCALE_SHIFT).astype(np.int32)


def code_model(w, cw) -> None:
    """Write the model into the slice-header BitWriter (per-bin ue)."""
    for v in cw:
        w.ue(int(v))


def parse_model(r) -> tuple[int, ...]:
    return tuple(r.ue() for _ in range(N_BINS))
