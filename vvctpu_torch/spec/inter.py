"""Spec-model inter prediction: MC interpolation, MV prediction, ME.

Role of VTM:CommonLib/InterPrediction.cpp (motionCompensation, xPredInterBlk)
+ InterpolationFilter.cpp (8-tap luma / 4-tap chroma separable FIR) and the
encoder side VTM:EncoderLib/InterSearch.cpp (xMotionEstimation), redesigned
batched (SURVEY.md §2.9/§7.2 stage 4): integer full-search SAD over a dense
candidate window instead of TZSearch's sequential early-out pattern.

MV convention: 1/16-pel luma units (VVC storage precision); chroma derives
the same numeric MV interpreted on the 1/32 grid of the half-res plane.
Interpolation staging (8-bit): horizontal pass unshifted (64-weighted),
vertical pass (sum + 2048) >> 12; single-direction pass (sum + 32) >> 6.
"""
from __future__ import annotations

import numpy as np

from ..core import rom

MV_FRAC_BITS = 4                 # 1/16 pel
REF_MARGIN = 80


def pad_reference(plane: np.ndarray, margin: int = REF_MARGIN) -> np.ndarray:
    return np.pad(plane, margin, mode="edge")


def mc_luma(ref_pad: np.ndarray, x: int, y: int, w: int, h: int,
            mvx: int, mvy: int, bd: int = 8,
            margin: int = REF_MARGIN) -> np.ndarray:
    """Motion-compensated (h, w) luma block; mv in 1/16 pel."""
    taps = rom.mc_filter_luma().astype(np.int64)
    ix, fx = (mvx >> MV_FRAC_BITS), mvx & 15
    iy, fy = (mvy >> MV_FRAC_BITS), mvy & 15
    x0 = x + ix + margin
    y0 = y + iy + margin
    mx = (1 << bd) - 1
    if fx == 0 and fy == 0:
        return ref_pad[y0:y0 + h, x0:x0 + w].astype(np.int32)
    if fy == 0:
        win = ref_pad[y0:y0 + h, x0 - 3:x0 + w + 4].astype(np.int64)
        acc = np.zeros((h, w), np.int64)
        for t in range(8):
            acc += taps[fx, t] * win[:, t:t + w]
        return np.clip((acc + 32) >> 6, 0, mx).astype(np.int32)
    if fx == 0:
        win = ref_pad[y0 - 3:y0 + h + 4, x0:x0 + w].astype(np.int64)
        acc = np.zeros((h, w), np.int64)
        for t in range(8):
            acc += taps[fy, t] * win[t:t + h, :]
        return np.clip((acc + 32) >> 6, 0, mx).astype(np.int32)
    win = ref_pad[y0 - 3:y0 + h + 4, x0 - 3:x0 + w + 4].astype(np.int64)
    tmp = np.zeros((h + 7, w), np.int64)
    for t in range(8):
        tmp += taps[fx, t] * win[:, t:t + w]
    acc = np.zeros((h, w), np.int64)
    for t in range(8):
        acc += taps[fy, t] * tmp[t:t + h, :]
    return np.clip((acc + 2048) >> 12, 0, mx).astype(np.int32)


def mc_chroma(ref_pad: np.ndarray, x: int, y: int, w: int, h: int,
              mvx: int, mvy: int, bd: int = 8,
              margin: int = REF_MARGIN) -> np.ndarray:
    """Chroma MC: coords on the half-res plane, mv numerically equal to the
    luma MV -> 1/32-pel phases."""
    taps = rom.mc_filter_chroma().astype(np.int64)
    ix, fx = (mvx >> 5), mvx & 31
    iy, fy = (mvy >> 5), mvy & 31
    x0 = x + ix + margin
    y0 = y + iy + margin
    mx = (1 << bd) - 1
    if fx == 0 and fy == 0:
        return ref_pad[y0:y0 + h, x0:x0 + w].astype(np.int32)
    if fy == 0:
        win = ref_pad[y0:y0 + h, x0 - 1:x0 + w + 2].astype(np.int64)
        acc = sum(taps[fx, t] * win[:, t:t + w] for t in range(4))
        return np.clip((acc + 32) >> 6, 0, mx).astype(np.int32)
    if fx == 0:
        win = ref_pad[y0 - 1:y0 + h + 2, x0:x0 + w].astype(np.int64)
        acc = sum(taps[fy, t] * win[t:t + h, :] for t in range(4))
        return np.clip((acc + 32) >> 6, 0, mx).astype(np.int32)
    win = ref_pad[y0 - 1:y0 + h + 2, x0 - 1:x0 + w + 2].astype(np.int64)
    tmp = sum(taps[fx, t] * win[:, t:t + w] for t in range(4))
    acc = sum(taps[fy, t] * tmp[t:t + h, :] for t in range(4))
    return np.clip((acc + 2048) >> 12, 0, mx).astype(np.int32)


def clip_mv(mvx: int, mvy: int, x: int, y: int, s: int, frame_w: int,
            frame_h: int, margin: int = REF_MARGIN):
    """Keep the full 8-tap filter footprint inside the padded reference."""
    def clip1(mv, pos, n):
        lo = -((pos + margin - 8) << MV_FRAC_BITS)
        hi = (n - pos - s + margin - 8) << MV_FRAC_BITS
        return max(lo, min(hi, mv))

    return clip1(mvx, x, frame_w), clip1(mvy, y, frame_h)


# ---------------------------------------------------------------------------
# MV prediction (simple deterministic 2-candidate AMVP; doc'd subset of
# VTM:CommonLib/UnitTools.cpp PU::getInterMVPCandidates)
# ---------------------------------------------------------------------------

def mvp_candidates(mv_map: np.ndarray, inter_map: np.ndarray, x: int, y: int,
                   s: int, h: int | None = None):
    """mv_map: (H//8, W//8, 2); inter_map: (H//8, W//8) bool.
    Candidates: left neighbour, above neighbour, zero (first two distinct).
    s is the leaf width; h the height (default square)."""
    cands = []
    gh, gw = inter_map.shape
    hh = s if h is None else h

    def add(gx, gy):
        if 0 <= gx < gw and 0 <= gy < gh and inter_map[gy, gx]:
            mv = (int(mv_map[gy, gx, 0]), int(mv_map[gy, gx, 1]))
            if mv not in cands:
                cands.append(mv)

    add((x - 1) // 8, (y + hh - 1) // 8)     # left
    add((x + s - 1) // 8, (y - 1) // 8)      # above
    add((x - 1) // 8, (y - 1) // 8)          # above-left
    while len(cands) < 2:
        if (0, 0) not in cands:
            cands.append((0, 0))
        else:
            cands.append((0, 0))
            break
    return cands[:2]


# ---------------------------------------------------------------------------
# Merge candidate derivation (role of VTM:CommonLib/UnitTools.cpp
# PU::getInterMergeCandidates: spatial A1/B1/B0/A0/B2 + scaled TMVP +
# HMVP FIFO + pairwise average + zero fill).  Candidates are normalized
# (d, (mv0x, mv0y), (mv1x, mv1y)) tuples with unused-list MVs zeroed, so
# encoder-side matching is plain tuple equality.
# ---------------------------------------------------------------------------
MRG_MAX = 6          # merge candidate list size
HMVP_MAX = 5         # history FIFO depth (reset per CTU row)


def mv_scale_factor(tb: int, td: int) -> int | None:
    """VTM-style POC distance scale factor; None if td == 0 (no scaling)."""
    if td == 0:
        return None
    tdc = max(-128, min(127, td))
    tbc = max(-128, min(127, tb))
    a = abs(tdc)
    tx = (16384 + (a >> 1)) // a
    if tdc < 0:
        tx = -tx
    return max(-4096, min(4095, (tbc * tx + 32) >> 6))


def build_col_motion(col_inter8, col_dir8, col_mv8, col_mv8_l1,
                     col_poc: int, col_ref_pocs, cur_poc: int, cur_ref_pocs):
    """Per-granule scaled TMVP source from the collocated picture's stored
    motion field.  Returns None (no usable motion) or a dict:
    {"avail": (gh, gw) bool, "mv": [(gh, gw, 2) int32 per current list]}.
    """
    if col_inter8 is None or not len(col_ref_pocs):
        return None
    avail = col_inter8.astype(bool)
    if not avail.any():
        return None
    # source list per granule: L0 when the col block used it, else L1
    use_l1 = (col_dir8 == 1)
    src_mv = np.where(use_l1[..., None], col_mv8_l1, col_mv8).astype(np.int64)
    td0 = col_poc - col_ref_pocs[0]
    td1 = (col_poc - col_ref_pocs[1]) if len(col_ref_pocs) > 1 else td0
    out = []
    for ref in cur_ref_pocs:
        tb = cur_poc - ref
        dsf0 = mv_scale_factor(tb, td0)
        dsf1 = mv_scale_factor(tb, td1)
        if dsf0 is None and dsf1 is None:
            return None
        dsf = np.where(use_l1, dsf1 if dsf1 is not None else 0,
                       dsf0 if dsf0 is not None else 0).astype(np.int64)
        prod = dsf[..., None] * src_mv
        mag = (np.abs(prod) + 127) >> 8
        sc = np.where(prod >= 0, mag, -mag)
        out.append(np.clip(sc, -131072, 131071).astype(np.int32))
    return {"avail": avail, "mv": out}


def _cand_at(inter_map, mv_map, gx: int, gy: int):
    """Normalized candidate tuple from the traversal-state maps, or None."""
    gh, gw = inter_map.shape[:2]
    if not (0 <= gx < gw and 0 <= gy < gh):
        return None
    l0, l1 = bool(inter_map[gy, gx, 0]), bool(inter_map[gy, gx, 1])
    if not (l0 or l1):
        return None
    d = 2 if (l0 and l1) else (0 if l0 else 1)
    mv0 = (int(mv_map[gy, gx, 0, 0]), int(mv_map[gy, gx, 0, 1])) if l0 \
        else (0, 0)
    mv1 = (int(mv_map[gy, gx, 1, 0]), int(mv_map[gy, gx, 1, 1])) if l1 \
        else (0, 0)
    return (d, mv0, mv1)


def merge_candidates(inter_map, mv_map, x: int, y: int, s: int, is_b: bool,
                     col=None, hmvp=None, h: int | None = None):
    """Merge list for the leaf at (x, y), width s, height h (default
    square); always MRG_MAX entries.

    inter_map: (gh, gw, 2) bool; mv_map: (gh, gw, 2, 2) int32 — the
    traversal-state maps (identical in both engines' walkers).
    """
    cands: list[tuple] = []
    hh = s if h is None else h

    def push(c):
        if c is not None and c not in cands and len(cands) < MRG_MAX:
            cands.append(c)

    g = 8
    # spatial: A1 (left), B1 (above), B0 (above-right), A0 (below-left)
    push(_cand_at(inter_map, mv_map, (x - 1) // g, (y + hh - 1) // g))
    push(_cand_at(inter_map, mv_map, (x + s - 1) // g, (y - 1) // g))
    push(_cand_at(inter_map, mv_map, (x + s) // g, (y - 1) // g))
    push(_cand_at(inter_map, mv_map, (x - 1) // g, (y + hh) // g))
    if len(cands) < 4:   # B2 (above-left) only when the list is short
        push(_cand_at(inter_map, mv_map, (x - 1) // g, (y - 1) // g))

    # TMVP: C0 bottom-right, fallback C1 centre
    if col is not None:
        gh, gw = col["avail"].shape
        for cy, cx in (((y + hh) // g, (x + s) // g),
                       ((y + hh // 2) // g, (x + s // 2) // g)):
            if 0 <= cy < gh and 0 <= cx < gw and col["avail"][cy, cx]:
                mv0 = (int(col["mv"][0][cy, cx, 0]),
                       int(col["mv"][0][cy, cx, 1]))
                if is_b and len(col["mv"]) > 1:
                    mv1 = (int(col["mv"][1][cy, cx, 0]),
                           int(col["mv"][1][cy, cx, 1]))
                    push((2, mv0, mv1))
                else:
                    push((0, mv0, (0, 0)))
                break

    # HMVP: most recent first
    if hmvp:
        for c in reversed(hmvp):
            push(c)

    # pairwise average of the first two (per list where available)
    if len(cands) >= 2 and len(cands) < MRG_MAX:
        a, b = cands[0], cands[1]
        al0, al1 = a[0] in (0, 2), a[0] in (1, 2)
        bl0, bl1 = b[0] in (0, 2), b[0] in (1, 2)

        def avg(p, q):
            return ((p[0] + q[0] + 1) >> 1, (p[1] + q[1] + 1) >> 1)

        mv0 = avg(a[1], b[1]) if (al0 and bl0) else (a[1] if al0 else
                                                     (b[1] if bl0 else None))
        mv1 = avg(a[2], b[2]) if (al1 and bl1) else (a[2] if al1 else
                                                     (b[2] if bl1 else None))
        has0, has1 = mv0 is not None, mv1 is not None
        d = 2 if (has0 and has1) else (0 if has0 else 1)
        push((d, mv0 or (0, 0), mv1 or (0, 0)))

    zero = (2 if is_b else 0, (0, 0), (0, 0))
    while len(cands) < MRG_MAX:
        cands.append(zero)       # duplicates allowed in the fill tail
    return cands


# ---------------------------------------------------------------------------
# MMVD: merge with MVD (role of VTM:CommonLib/UnitTools.cpp
# PU::getInterMMVDMergeCandidates + InterPrediction MMVD expansion):
# base = one of the first 2 merge candidates, plus a signalled offset of
# 8 distances x 4 directions; for BI the L1 offset is mirrored.
# ---------------------------------------------------------------------------
MMVD_STEPS = (1, 2, 4, 8, 16, 32, 64, 128)   # quarter-pel distances
MMVD_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
MMVD_BASES = 2


def mmvd_derive(cand: tuple, dist_idx: int, dir_idx: int) -> tuple:
    """Expand a merge candidate by the MMVD offset (normalized tuple)."""
    d, mv0, mv1 = cand
    off = MMVD_STEPS[dist_idx] << 2              # quarter -> 1/16 pel
    dx, dy = MMVD_DIRS[dir_idx]
    ox, oy = dx * off, dy * off
    if d == 0:
        return (0, (mv0[0] + ox, mv0[1] + oy), (0, 0))
    if d == 1:
        return (1, (0, 0), (mv1[0] + ox, mv1[1] + oy))
    return (2, (mv0[0] + ox, mv0[1] + oy), (mv1[0] - ox, mv1[1] - oy))


def mmvd_match(cands: list, me: tuple):
    """Encoder-side exact match of the ME result against the MMVD pattern
    set; returns (base, dist_idx, dir_idx) or None (first match wins)."""
    for b in range(min(MMVD_BASES, len(cands))):
        for di in range(len(MMVD_STEPS)):
            for dd in range(len(MMVD_DIRS)):
                if mmvd_derive(cands[b], di, dd) == me:
                    return (b, di, dd)
    return None


def hmvp_push(hmvp: list, cand: tuple) -> None:
    """FIFO update after each inter leaf (VTM: updateMotionCandList)."""
    if cand in hmvp:
        hmvp.remove(cand)
    hmvp.append(cand)
    if len(hmvp) > HMVP_MAX:
        hmvp.pop(0)


# ---------------------------------------------------------------------------
# AMVR: adaptive MV resolution (role of VTM's amvr_flag/amvr_precision_idx,
# CommonLib/Mv.h roundToAmvrSignalPrec + EncoderLib/InterSearch AMVR loop).
# Per explicit-inter leaf the MVD is signalled at quarter-, integer- or
# 4-pel precision; AMVP candidates are rounded to that grid.  The default
# quarter-pel rounding also guards against non-aligned candidates (TMVP
# scaling produces arbitrary 1/16-pel values).
# ---------------------------------------------------------------------------
AMVR_SHIFTS = (2, 4, 6)    # MVD shift in 1/16-pel units per precision index
AMVR_BITS = (1, 2, 2)      # signalling cost of each precision index


def round_mv_prec(v: int, shift: int) -> int:
    """Round one MV component to the precision grid, half away from zero."""
    a = abs(int(v))
    r = ((a + (1 << (shift - 1))) >> shift) << shift
    return r if v >= 0 else -r


def mvd_est_bits(v: int) -> int:
    """Decision-time rate of one MVD component (mvd_coding shape)."""
    a = abs(int(v))
    if a == 0:
        return 1
    if a == 1:
        return 3
    return 4 + 2 * bitlen_int(a - 1)


def amvr_choose(mvs, cand_lists, enabled: bool) -> int:
    """Precision index for one explicit leaf: the cheapest precision whose
    grid holds every used MV component (identical pure-int math in both
    engines; the reconstructed MV is exact for every eligible precision,
    so this is a rate-only decision)."""
    if not enabled:
        return 0
    best = None
    for pi, sh in enumerate(AMVR_SHIFTS):
        unit = 1 << sh
        if any(c % unit for mv in mvs for c in mv):
            continue
        bits = AMVR_BITS[pi]
        for mv, cands in zip(mvs, cand_lists):
            rc = [(round_mv_prec(c[0], sh), round_mv_prec(c[1], sh))
                  for c in cands]
            costs = [abs(mv[0] - c[0]) + abs(mv[1] - c[1]) for c in rc]
            i = int(np.argmin(costs))
            bits += (mvd_est_bits((mv[0] - rc[i][0]) >> sh)
                     + mvd_est_bits((mv[1] - rc[i][1]) >> sh))
        if best is None or bits < best[0]:
            best = (bits, pi)
    return best[1]


# ---------------------------------------------------------------------------
# SMVD: symmetric MVD (role of VTM's sym_mvd_flag, CommonLib/UnitTools
# PU::... + EncoderLib/InterSearch symmetric ME).  For explicit BI leaves
# with POC-symmetric references, one MVD is signalled and mirrored onto
# L1: mv1 = mvp1 - mvd.  Encoder side: exact pattern match of the chosen
# (mv0, mv1) pair against the mirrored form.
# ---------------------------------------------------------------------------

def smvd_match(mv_map, inter_map, x: int, y: int, s: int, mv0, mv1,
               shift: int = 2):
    """L1 mvp index making (mv0, mv1) SMVD-expressible at the given AMVR
    precision, or None.  Uses the same rounded-candidate argmin as
    code_mv_list, so the coded MVs reconstruct exactly."""
    c0 = mvp_candidates(mv_map[:, :, 0], inter_map[:, :, 0], x, y, s)
    c1 = mvp_candidates(mv_map[:, :, 1], inter_map[:, :, 1], x, y, s)
    rc0 = [(round_mv_prec(c[0], shift), round_mv_prec(c[1], shift))
           for c in c0]
    rc1 = [(round_mv_prec(c[0], shift), round_mv_prec(c[1], shift))
           for c in c1]
    costs = [abs(mv0[0] - c[0]) + abs(mv0[1] - c[1]) for c in rc0]
    i0 = int(np.argmin(costs))
    mvd = (mv0[0] - rc0[i0][0], mv0[1] - rc0[i0][1])
    for i1, c in enumerate(rc1):
        if (c[0] - mvd[0], c[1] - mvd[1]) == tuple(mv1):
            return i1
    return None


# ---------------------------------------------------------------------------
# BCW: bi-prediction with CU-level weights (role of VTM:CommonLib/
# InterPrediction.cpp xWeightedAverage + the bcw_idx syntax).  This build
# uses the 3-weight RA set {3, 4, 5}/8; index 1 (equal weight) is the
# default, merge leaves always use it, and DMVR/BDOF are disabled for
# unequal weights (as in VVC).
# ---------------------------------------------------------------------------
BCW_W = (3, 4, 5)          # w/8 applied to L0; L1 gets (8 - w)/8
BCW_DEFAULT = 1            # index of the equal weight
BCW_IDX_BITS = (2, 1, 2)   # decision-time rate of each index


def bcw_average(p0: np.ndarray, p1: np.ndarray, widx: int,
                bd: int) -> np.ndarray:
    """Weighted bi average: clip((w*P0 + (8-w)*P1 + 4) >> 3); w = 4 is the
    plain rounded average bit-for-bit."""
    w = BCW_W[widx]
    return np.clip((w * p0.astype(np.int64) + (8 - w) * p1 + 4) >> 3, 0,
                   (1 << bd) - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# DMVR: decoder-side MV refinement (role of VTM:CommonLib/InterPrediction.cpp
# xProcessDMVR / xDMVRCost).  Applied to bi-predicted leaves whose two
# references are POC-symmetric around the current picture; both engines run
# the identical integer search, so no syntax is needed.  Documented
# simplifications vs VTM: the 25-point SAD runs on integer-aligned reference
# windows (fractional MV part dropped for the search; VTM uses bilinear
# taps), and the parametric sub-pel step is omitted.
# ---------------------------------------------------------------------------
DMVR_SUB = 16      # refinement granularity (VTM: 16x16 subblocks)
DMVR_RANGE = 2     # +- integer-pel search


def dmvr_offset(ref0_pad: np.ndarray, ref1_pad: np.ndarray, x: int, y: int,
                sub: int, mv0, mv1, margin: int = REF_MARGIN):
    """Best mirrored integer offset (dx, dy) for one subblock.

    Row-major (dy, dx) scan with strict-less running min; the zero offset
    gets a 25% SAD discount (VTM centre bias) so tiny gains don't move MVs.
    """
    r = DMVR_RANGE
    x00 = x + (mv0[0] >> MV_FRAC_BITS) + margin
    y00 = y + (mv0[1] >> MV_FRAC_BITS) + margin
    x10 = x + (mv1[0] >> MV_FRAC_BITS) + margin
    y10 = y + (mv1[1] >> MV_FRAC_BITS) + margin
    w0 = ref0_pad[y00 - r:y00 + sub + r, x00 - r:x00 + sub + r].astype(
        np.int64)
    w1 = ref1_pad[y10 - r:y10 + sub + r, x10 - r:x10 + sub + r].astype(
        np.int64)
    best = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            a = w0[r + dy:r + dy + sub, r + dx:r + dx + sub]
            b = w1[r - dy:r - dy + sub, r - dx:r - dx + sub]
            sad = int(np.abs(a - b).sum())
            if dy == 0 and dx == 0:
                sad -= sad >> 2
            if best is None or sad < best[0]:
                best = (sad, dx, dy)
    return best[1], best[2]


# ---------------------------------------------------------------------------
# BDOF: bi-directional optical flow (role of VTM:CommonLib/InterPrediction
# applyBiOptFlow / xCalcBIOPar).  Per-4x4 gradient-based correction of the
# bi-prediction average; no syntax, identical integer math in both engines.
# Simplifications vs VTM: sums run over the 4x4 itself (VTM: 6x6 window),
# the vy cross term is dropped, gradients come from a 1-pel MC ring, and
# the per-subblock SAD early-skip is omitted.
# ---------------------------------------------------------------------------
BDOF_CLIP = 31     # displacement clip, 1/16-pel fixed point


def _floor_log2_arr(v):
    """Elementwise floor(log2(v)) for v >= 1 via threshold sums (identical
    formula in the JAX twin)."""
    out = np.zeros_like(v)
    for k in range(1, 21):
        out += (v >> k) > 0
    return out


def bdof_blend(p0e: np.ndarray, p1e: np.ndarray, bd: int) -> np.ndarray:
    """Corrected bi average from (s+2, s+2) ring-extended predictions.

    v = argmin of the optical-flow residual per 4x4 (L1 normal-equation
    approximation, shift division as in VTM); correction
    b = (vx*(gx0-gx1) + vy*(gy0-gy1)) / 64 on top of the rounded average
    (v is 1/16-pel fixed point, and the flow model contributes /4).
    """
    p0 = p0e[1:-1, 1:-1].astype(np.int64)
    p1 = p1e[1:-1, 1:-1].astype(np.int64)
    s = p0.shape[0]
    gx0 = (p0e[1:-1, 2:].astype(np.int64) - p0e[1:-1, :-2]) >> 1
    gy0 = (p0e[2:, 1:-1].astype(np.int64) - p0e[:-2, 1:-1]) >> 1
    gx1 = (p1e[1:-1, 2:].astype(np.int64) - p1e[1:-1, :-2]) >> 1
    gy1 = (p1e[2:, 1:-1].astype(np.int64) - p1e[:-2, 1:-1]) >> 1
    diff = p1 - p0
    th = gx0 + gx1
    tv = gy0 + gy1

    def sum44(a):
        return a.reshape(s // 4, 4, s // 4, 4).sum(axis=(1, 3))

    sgx = sum44(np.abs(th))
    sgy = sum44(np.abs(tv))
    sgxdi = sum44(diff * np.sign(th))
    sgydi = sum44(diff * np.sign(tv))

    def vcomp(sg, sdi):
        fl = _floor_log2_arr(np.maximum(sg, 1))
        mag = (np.abs(sdi) << 5) >> fl
        v = -np.sign(sdi) * mag
        return np.where(sg > 0, np.clip(v, -BDOF_CLIP, BDOF_CLIP), 0)

    vx = np.kron(vcomp(sgx, sgxdi), np.ones((4, 4), np.int64))
    vy = np.kron(vcomp(sgy, sgydi), np.ones((4, 4), np.int64))
    b = (vx * (gx0 - gx1) + vy * (gy0 - gy1) + 32) >> 6
    mx = (1 << bd) - 1
    return np.clip(((p0 + p1 + 1) >> 1) + b, 0, mx).astype(np.int32)


# ---------------------------------------------------------------------------
# Integer motion estimation (encoder policy; numpy twin of coding/me.py)
# ---------------------------------------------------------------------------
ME_RANGE = 16   # +- integer-pel dense search window
ME_EXT = 64     # +- extended range via the coarse-to-fine stage (round 4);
                # must satisfy ME_EXT + 2 + 1 <= REF_MARGIN (fine window +
                # MC filter footprint inside the padded reference)


def me_block_sads(orig: np.ndarray, ref: np.ndarray, x: int, y: int,
                  s: int) -> np.ndarray:
    """(2R+1, 2R+1) int64 SAD map over integer offsets (dy, dx); candidates
    outside the frame use edge-padded reference samples."""
    r = ME_RANGE
    blk = orig[y:y + s, x:x + s].astype(np.int64)
    refp = np.pad(ref, r, mode="edge").astype(np.int64)
    sads = np.empty((2 * r + 1, 2 * r + 1), np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            win = refp[y + dy + r:y + dy + r + s, x + dx + r:x + dx + r + s]
            sads[dy + r, dx + r] = np.abs(blk - win).sum()
    return sads


def mv_bits_est(mvx_q: int, mvy_q: int) -> int:
    """Rough rate of an integer-pel MV at decision time (quarter-pel units
    would be <<2; we store 1/16)."""
    return (2 + abs(mvx_q).bit_length() * 2
            + abs(mvy_q).bit_length() * 2)


def bitlen_int(v: int) -> int:
    """Integer bit length via threshold sums — identical formula to the JAX
    engine (no .bit_length(), so both sides agree exactly)."""
    v = abs(int(v))
    return sum(1 for k in range(15) if v >= (1 << k))


def mv_bits_q(mvx_q: int, mvy_q: int) -> int:
    """Decision-time rate of a quarter-pel MV."""
    return 2 + 2 * bitlen_int(mvx_q) + 2 * bitlen_int(mvy_q)


# half-pel then quarter-pel refinement deltas in 1/16-pel units; centre
# first so strict-less running min prefers the unrefined vector on ties
REFINE_HALF = [(0, 0), (-8, 0), (8, 0), (0, -8), (0, 8),
               (-8, -8), (8, -8), (-8, 8), (8, 8)]
REFINE_QUARTER = [(0, 0), (-4, 0), (4, 0), (0, -4), (0, 4),
                  (-4, -4), (4, -4), (-4, 4), (4, 4)]


# ---------------------------------------------------------------------------
# Affine motion (4-parameter) + PROF
# (role of VTM:CommonLib/InterPrediction.cpp xPredAffineBlk — per-4x4
#  subblock MVs derived from control-point MVs — and the PROF gradient
#  correction.  This build parameterises by CPMV0 = the leaf MV and
#  dmv = CPMV1 - CPMV0 at the right edge; affine leaves are 16/32 luma,
#  uni-prediction; the JAX twin kernels/mc.py affine_* matches bit-exact.)
# ---------------------------------------------------------------------------
AFF_MIN_SIZE = 16
AFF_DELTAS = (-8, -4, 0, 4, 8)   # per-axis dmv search grid, 1/16-pel
AFF_BITS = 2                     # affine_flag decision-time rate


def affine_sub_mv(mv0, dmv, log2s: int, cx: int, cy: int):
    """Model MV at luma offset (cx, cy) from the block origin, 1/16-pel.

    4-parameter: mvx = mv0x + (a*cx - b*cy), mvy = mv0y + (b*cx + a*cy)
    with a = dmvx / s (scale) and b = dmvy / s (rotation)."""
    return (mv0[0] + ((dmv[0] * cx - dmv[1] * cy) >> log2s),
            mv0[1] + ((dmv[1] * cx + dmv[0] * cy) >> log2s))


def affine_merge_cands(inter_map, mv_map, aff_map, admv_map, x: int,
                       y: int, s: int, d: int):
    """Inherited affine merge candidates for an (s x s) leaf: continue the
    A1/B1 neighbour's affine field across the boundary — the candidate
    base is chosen so the current leaf's 4-parameter model reproduces the
    neighbour granule's stored model MV at that granule's centre (role of
    VTM:CommonLib/UnitTools.cpp inherited affine candidates, recast for
    the granule motion field).  Up to 2 unique (bx, by, dmx, dmy)."""
    log2s = int(s).bit_length() - 1
    cands = []
    for (nx, ny) in ((x - 1, y + s - 1), (x + s - 1, y - 1)):   # A1, B1
        if nx < 0 or ny < 0:
            continue
        gy, gx = ny // 8, nx // 8
        if not aff_map[gy, gx] or not inter_map[gy, gx, d]:
            continue
        dmx = int(admv_map[gy, gx, 0])
        dmy = int(admv_map[gy, gx, 1])
        cx = (gx * 8 + 4) - x
        cy = (gy * 8 + 4) - y
        offx = (dmx * cx - dmy * cy) >> log2s
        offy = (dmy * cx + dmx * cy) >> log2s
        cand = (int(mv_map[gy, gx, d, 0]) - offx,
                int(mv_map[gy, gx, d, 1]) - offy, dmx, dmy)
        if cand not in cands:
            cands.append(cand)
    return cands


def affine_granule_mvs(mv0, dmv, s: int) -> np.ndarray:
    """(s//8, s//8, 2) int32 model MVs at the 8x8-granule centres — the
    per-granule motion stored into the runtime mv field and used for the
    chroma subblock MVs (deterministic, both engines)."""
    log2s = int(s).bit_length() - 1
    n = s // 8
    out = np.zeros((n, n, 2), np.int32)
    for i in range(n):
        for j in range(n):
            out[i, j] = affine_sub_mv(mv0, dmv, log2s, 8 * j + 4, 8 * i + 4)
    return out


_PROF_D = 2 * np.arange(4) - 3        # (2u - 3) per position in a subblock


def affine_pred_luma(ref_pad: np.ndarray, x: int, y: int, s: int, mv0, dmv,
                     bd: int, prof: bool = True,
                     margin: int = REF_MARGIN) -> np.ndarray:
    """(s, s) affine luma prediction: per-4x4-subblock translational MC at
    the model MV of the subblock centre, plus the PROF per-pixel gradient
    correction (dI = (gx*dx + gy*dy + 16) >> 5, offsets in 1/32-pel)."""
    log2s = int(s).bit_length() - 1
    mx = (1 << bd) - 1
    out = np.zeros((s, s), np.int32)
    du = _PROF_D[None, :]
    dv = _PROF_D[:, None]
    dx32 = (dmv[0] * du - dmv[1] * dv) >> log2s
    dy32 = (dmv[1] * du + dmv[0] * dv) >> log2s
    for i in range(s // 4):
        for j in range(s // 4):
            mvx, mvy = affine_sub_mv(mv0, dmv, log2s, 4 * j + 2, 4 * i + 2)
            if prof:
                p = mc_luma(ref_pad, x + 4 * j - 1, y + 4 * i - 1, 6, 6,
                            mvx, mvy, bd, margin).astype(np.int32)
                gx = (p[1:5, 2:6] - p[1:5, 0:4]) >> 1
                gy = (p[2:6, 1:5] - p[0:4, 1:5]) >> 1
                di = (gx * dx32 + gy * dy32 + 16) >> 5
                blk = np.clip(p[1:5, 1:5] + di, 0, mx)
            else:
                blk = mc_luma(ref_pad, x + 4 * j, y + 4 * i, 4, 4,
                              mvx, mvy, bd, margin)
            out[4 * i:4 * i + 4, 4 * j:4 * j + 4] = blk
    return out


def affine_pred_chroma(ref_pad: np.ndarray, cx0: int, cy0: int, cs: int,
                       mv0, dmv, s_luma: int, bd: int,
                       margin: int) -> np.ndarray:
    """(cs, cs) affine chroma prediction: 4x4 chroma subblocks (one per
    8x8 luma granule) MC'd at the granule-centre model MV."""
    log2s = int(s_luma).bit_length() - 1
    out = np.zeros((cs, cs), np.int32)
    for i in range(cs // 4):
        for j in range(cs // 4):
            mvx, mvy = affine_sub_mv(mv0, dmv, log2s, 8 * j + 4, 8 * i + 4)
            out[4 * i:4 * i + 4, 4 * j:4 * j + 4] = mc_chroma(
                ref_pad, cx0 + 4 * j, cy0 + 4 * i, 4, 4, mvx, mvy, bd,
                margin)
    return out
