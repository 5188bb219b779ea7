"""Spec-model transform & quantisation (numpy, integer-exact).

Role of VTM:CommonLib/TrQuant.cpp (xT/xIT/transformNxN) and
VTM:CommonLib/Quant.cpp (quant/dequant).  All arithmetic is integer with the
standard staged shifts so coefficients stay within 16-bit dynamic range
(MAX_TR_DYNAMIC_RANGE = 15):

forward:  E = (x @ Mw^T  + r) >> st1,  st1 = log2W + BD - 9
          C = (Mh @ E    + r) >> st2,  st2 = log2H + 6
inverse:  E = (Mh^T @ C  + r) >> 7            (clamped to 16-bit)
          x = (E @ Mw    + r) >> (20 - BD)

quant:    qBits = 14 + qp//6 + transform_shift
          level = sign * ((|c| * qScale[qp%6] + f) >> qBits)
dequant:  shift = BD + ((log2W+log2H)>>1) - 9
          c = clip16((level * iqScale[qp%6] << qp//6  + round) >> shift)

The JAX engine (vvctpu/kernels/transform.py) implements the same maths as MXU
int32 matmuls and is tested bit-exact against this module.
"""
from __future__ import annotations

import numpy as np

from ..core import rom

COEFF_MIN, COEFF_MAX = -32768, 32767


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def forward_transform(resi: np.ndarray, kind_h: int = rom.DCT2,
                      kind_v: int = rom.DCT2,
                      bit_depth: int = rom.BIT_DEPTH) -> np.ndarray:
    """resi (H, W) int -> coefficients (H, W) int (16-bit range).

    kind IDT (both dims) is transform skip: residual scaled by the
    transform shift so the shared quantiser sees the standard dynamic
    range (VTM:CommonLib/TrQuant.cpp xTransformSkip)."""
    h, w = resi.shape
    if kind_h == rom.IDT:
        ts = rom.transform_shift(_log2(w), _log2(h), bit_depth)
        return np.clip(resi.astype(np.int64) << ts,
                       COEFF_MIN, COEFF_MAX).astype(np.int32)
    mh = rom.tr_matrix(kind_v, h)
    mw = rom.tr_matrix(kind_h, w)
    st1 = _log2(w) + bit_depth - 9
    st2 = _log2(h) + 6
    x = resi.astype(np.int64)
    e = (x @ mw.T + (1 << (st1 - 1))) >> st1
    c = (mh @ e + (1 << (st2 - 1))) >> st2
    return np.clip(c, COEFF_MIN, COEFF_MAX).astype(np.int32)


def inverse_transform(coef: np.ndarray, kind_h: int = rom.DCT2,
                      kind_v: int = rom.DCT2,
                      bit_depth: int = rom.BIT_DEPTH) -> np.ndarray:
    h, w = coef.shape
    if kind_h == rom.IDT:
        ts = rom.transform_shift(_log2(w), _log2(h), bit_depth)
        c = coef.astype(np.int64)
        if ts > 0:
            c = (c + (1 << (ts - 1))) >> ts
        return np.clip(c, COEFF_MIN, COEFF_MAX).astype(np.int32)
    mh = rom.tr_matrix(kind_v, h)
    mw = rom.tr_matrix(kind_h, w)
    st2 = 20 - bit_depth
    c = coef.astype(np.int64)
    e = (mh.T @ c + 64) >> 7
    e = np.clip(e, COEFF_MIN, COEFF_MAX)
    x = (e @ mw + (1 << (st2 - 1))) >> st2
    return np.clip(x, COEFF_MIN, COEFF_MAX).astype(np.int32)


def quantize(coef: np.ndarray, qp: int, intra: bool = True,
             bit_depth: int = rom.BIT_DEPTH, rdoq: bool = False,
             lam_rd: int = 0, dq: bool = False) -> np.ndarray:
    if dq:
        return quantize_dq(coef, qp, lam_rd, bit_depth)
    if rdoq:
        return quantize_rdoq(coef, qp, lam_rd, intra, bit_depth)
    h, w = coef.shape
    ts = rom.transform_shift(_log2(w), _log2(h), bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + ts
    scale = int(rom.QUANT_SCALES[qp % 6])
    f = (171 if intra else 85) << (q_bits - 9)
    c = coef.astype(np.int64)
    level = (np.abs(c) * scale + f) >> q_bits
    level = np.clip(level, 0, COEFF_MAX)
    return (np.sign(c) * level).astype(np.int32)


def quantize_rdoq(coef: np.ndarray, qp: int, lam_rd: int,
                  intra: bool = True,
                  bit_depth: int = rom.BIT_DEPTH) -> np.ndarray:
    """Rate-distortion optimized quantization (vectorized RDOQ-lite).

    Role of VTM:CommonLib/QuantRDOQ.cpp, redesigned batched (SURVEY.md
    §7.3.2): per coefficient the floor / floor+1 levels are costed as
    coefficient-domain SSE + lambda * rate-proxy and the cheaper wins
    (ties keep floor).  lambda is mapped from the pixel domain by the
    2*transform_shift energy scaling; the rate proxy matches
    level_rate_est's per-level term.  No trellis state — the decoder's
    scalar dequant is unchanged, so any choice is conformant."""
    h, w = coef.shape
    ts = rom.transform_shift(_log2(w), _log2(h), bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + ts
    scale = int(rom.QUANT_SCALES[qp % 6])
    dq_shift = bit_depth + ((_log2(w) + _log2(h)) >> 1) - 9
    dq_scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    # caps keep cost < 2^31 so the int32 device twin is bit-identical
    lam = min(int(lam_rd) << max(2 * ts, 0), 1 << 25)

    c = coef.astype(np.int64)
    a = np.abs(c)
    l_a = np.clip((a * scale) >> q_bits, 0, COEFF_MAX)
    l_b = np.clip(l_a + 1, 0, COEFF_MAX)

    def cost(lv):
        deq = np.clip((lv * dq_scale + (1 << (dq_shift - 1))) >> dq_shift,
                      COEFF_MIN, COEFF_MAX)
        err = np.minimum(np.abs(a - deq), 30000)
        bl = np.zeros_like(lv)
        for k in range(15):
            bl += (lv >= (1 << k)).astype(np.int64)
        # NOTE: the per-coefficient proxy stays the integer 2 + 2*bitlen —
        # an A/B against the fractional lvl_w weights (round 4) measured a
        # ~5% WORSE Lagrangian at qp32: the conservative charge implicitly
        # prices the context-adaptation drift that the init-state
        # estimates cannot see.  The fractional estimates are used where
        # they demonstrably help: candidate COMPARISON in choose_tx /
        # choose_sbt / the chroma joint-mode RD (level_rate_fp).
        rate = np.where(lv > 0, 2 + 2 * bl, 0)
        return err * err + lam * rate

    lev = np.where(cost(l_b) < cost(l_a), l_b, l_a)
    return (np.sign(c) * lev).astype(np.int32)


def dequantize(level: np.ndarray, qp: int,
               bit_depth: int = rom.BIT_DEPTH,
               dq: bool = False) -> np.ndarray:
    if dq:
        return dequantize_dq(level, qp, bit_depth)
    h, w = level.shape
    shift = bit_depth + ((_log2(w) + _log2(h)) >> 1) - 9
    scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    c = (level.astype(np.int64) * scale + (1 << (shift - 1))) >> shift
    return np.clip(c, COEFF_MIN, COEFF_MAX).astype(np.int32)


# ---------------------------------------------------------------------------
# Dependent quantization (role of VTM:CommonLib/DepQuant.cpp, DQIntern):
# two interleaved scalar quantizers Q0 (recon 2k*step') / Q1 (recon
# (2k-1)*step', k>0) selected by a 4-state machine driven by level parities
# along the coding (reverse-diagonal-scan) order; the encoder picks levels
# by a Viterbi trellis over the states.  Documented deviations from VTM
# (internally consistent across engines + spec): the state walk spans the
# whole scan (not just from the last-significant coefficient), sig-coeff
# contexts do not depend on the state, and the rate proxy is the shared
# RDOQ one.
# ---------------------------------------------------------------------------

# next_state = DQ_TRANS[state][level & 1]
DQ_TRANS = ((0, 2), (2, 0), (1, 3), (3, 1))
# m_p[s] = DQ_TRANS[s][p] as composable maps (shared with the JAX twin)
DQ_MAPS = ((0, 2, 1, 3), (2, 0, 3, 1))


def dq_states(level: np.ndarray) -> np.ndarray:
    """Per-coefficient quantizer state (h, w) from the level plane.

    The walk runs in coding order (reverse diagonal scan from the highest
    scan position), starting in state 0; the state at each position is the
    one *before* consuming that position's parity."""
    h, w = level.shape
    scan = rom.scan_order(_log2(w), _log2(h))
    n = len(scan)
    st = np.zeros((h, w), np.int32)
    s = 0
    for k in range(n - 1, -1, -1):
        x, y = int(scan[k][0]), int(scan[k][1])
        st[y, x] = s
        s = DQ_TRANS[s][int(abs(int(level[y, x]))) & 1]
    return st


def dequantize_dq(level: np.ndarray, qp: int,
                  bit_depth: int = rom.BIT_DEPTH) -> np.ndarray:
    """State-dependent dequant: c = ((2*lev - sgn*off)*scale + 2^shift)
    >> (shift+1), off = 1 on Q1 states (2, 3) for nonzero levels."""
    h, w = level.shape
    shift = bit_depth + ((_log2(w) + _log2(h)) >> 1) - 9
    scale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    st = dq_states(level)
    lv = level.astype(np.int64)
    off = ((st > 1) & (lv != 0)).astype(np.int64) * np.sign(lv)
    c = ((2 * lv - off) * scale + (1 << shift)) >> (shift + 1)
    return np.clip(c, COEFF_MIN, COEFF_MAX).astype(np.int32)


def _dq_rate(lv: int) -> int:
    """Rate proxy per level (matches quantize_rdoq's)."""
    return 2 + 2 * int(lv).bit_length() if lv > 0 else 0


def quantize_dq(coef: np.ndarray, qp: int, lam_rd: int,
                bit_depth: int = rom.BIT_DEPTH) -> np.ndarray:
    """Trellis (Viterbi) dependent quantization over the coding-order walk.

    Per position, per state, the active quantizer's floor level, floor+1
    and zero are costed (coefficient-domain SSE + lambda*rate) and the
    4-state DP takes the first-min over (state-major, candidate-minor)
    order; running costs are renormalised by the state minimum each step so
    the int32 device twin (kernels/transform.py quantize_dq_j) agrees
    bit-for-bit."""
    h, w = coef.shape
    ts = rom.transform_shift(_log2(w), _log2(h), bit_depth)
    q_bits = rom.QUANT_SHIFT + qp // 6 + ts
    qscale = int(rom.QUANT_SCALES[qp % 6])
    shift = bit_depth + ((_log2(w) + _log2(h)) >> 1) - 9
    iscale = int(rom.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    # int32-safety bounds (the device twin accumulates in int32): lambda
    # capped so err^2 + lam*rate < 2^31, per-step increments >>4, running
    # state costs renormalised by the min and clamped to 2^28
    lam = min(int(lam_rd) << max(2 * ts, 0), 1 << 22)
    scan = rom.scan_order(_log2(w), _log2(h))
    n = len(scan)
    big = 1 << 28

    def deq(l, q1):
        t = (2 * l - (1 if (q1 and l > 0) else 0)) * iscale
        return min(max((t + (1 << shift)) >> (shift + 1), COEFF_MIN),
                   COEFF_MAX)

    cost = [0, big, big, big]           # start in state 0
    bp = np.zeros((n, 4), np.int8)      # backpointer: previous state
    cl = np.zeros((n, 4), np.int32)     # chosen level (abs) per next state
    for j in range(n):
        k = n - 1 - j
        x, y = int(scan[k][0]), int(scan[k][1])
        a = abs(int(coef[y, x]))
        u = (a * qscale) >> (q_bits - 1)      # ~ 2a / step
        ncost = [1 << 30] * 4
        nbp = [0] * 4
        nlv = [0] * 4
        for s in range(4):
            q1 = s > 1
            lf = min(((u + 1) >> 1) if q1 else (u >> 1), COEFF_MAX - 1)
            for l in (0, lf, lf + 1):
                d = min(abs(a - deq(l, q1)), 30000)
                c = cost[s] + ((d * d + lam * _dq_rate(l)) >> 4)
                s2 = DQ_TRANS[s][l & 1]
                if c < ncost[s2]:
                    ncost[s2] = c
                    nbp[s2] = s
                    nlv[s2] = l
        m = min(ncost)
        cost = [min(c - m, big) for c in ncost]
        bp[j] = nbp
        cl[j] = nlv

    s = int(np.argmin(cost))            # first-min final state
    out = np.zeros((h, w), np.int32)
    for j in range(n - 1, -1, -1):
        k = n - 1 - j
        x, y = int(scan[k][0]), int(scan[k][1])
        lv = int(cl[j, s])
        out[y, x] = lv if coef[y, x] >= 0 else -lv
        s = int(bp[j, s])
    return out


def reconstruct(pred: np.ndarray, level: np.ndarray, qp: int,
                kind_h: int = rom.DCT2, kind_v: int = rom.DCT2,
                bit_depth: int = rom.BIT_DEPTH, lfnst: int = 0,
                mode: int = 0, dq: bool = False) -> np.ndarray:
    """Shared enc/dec reconstruction: dequant -> (inv LFNST) -> inverse
    transform -> add-clip."""
    if not level.any():
        return pred.astype(np.int32)
    coef = dequantize(level, qp, bit_depth, dq=dq)
    if lfnst:
        coef = inv_lfnst(coef, lfnst, mode)
    resi = inverse_transform(coef, kind_h, kind_v, bit_depth)
    return np.clip(pred.astype(np.int32) + resi, 0, (1 << bit_depth) - 1)


# ---------------------------------------------------------------------------
# LFNST (secondary transform on the top-left 4x4 primary coefficients;
# role of VTM:CommonLib/TrQuant.cpp xFwdLfnst/xInvLfnst)
# ---------------------------------------------------------------------------

def fwd_lfnst(coef: np.ndarray, lfnst_idx: int, mode: int) -> np.ndarray:
    """Forward secondary transform: rotate the top-left 4x4, zero the rest."""
    s, tr = rom.lfnst_set_for_mode(mode)
    m = rom.lfnst_matrix(s, lfnst_idx - 1).astype(np.int64)
    sub = coef[:4, :4].astype(np.int64)
    if tr:
        sub = sub.T
    t = (m @ sub.reshape(16) + 64) >> 7
    out = np.zeros_like(coef)
    out[:4, :4] = np.clip(t, COEFF_MIN, COEFF_MAX).reshape(4, 4)
    return out


def inv_lfnst(coef: np.ndarray, lfnst_idx: int, mode: int) -> np.ndarray:
    s, tr = rom.lfnst_set_for_mode(mode)
    m = rom.lfnst_matrix(s, lfnst_idx - 1).astype(np.int64)
    t = coef[:4, :4].astype(np.int64).reshape(16)
    v = (m.T @ t + 64) >> 7
    sub = np.clip(v, COEFF_MIN, COEFF_MAX).reshape(4, 4)
    if tr:
        sub = sub.T
    out = np.zeros_like(coef)
    out[:4, :4] = sub
    return out


# ---------------------------------------------------------------------------
# MTS (explicit multiple transform selection, intra luma)
# ---------------------------------------------------------------------------
MTS_SET = ((rom.DCT2, rom.DCT2), (rom.DST7, rom.DST7),
           (rom.DST7, rom.DCT8), (rom.DCT8, rom.DST7),
           (rom.DCT8, rom.DCT8), (rom.IDT, rom.IDT))
MTS_IDX_BITS = (1, 2, 3, 4, 5, 5)    # truncated-unary bin counts (cmax 5);
# index 5 = transform skip, folded into the unified candidate set (the
# reference signals a separate transform_skip_flag — VTM TrQuant.cpp; this
# build's single TU index is the TPU-first simplification, both engines)


def lambda_rd_int(qp: int) -> int:
    """Integer full-lambda for SSE-domain RD (shared with the JAX engine)."""
    import math
    return max(1, int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)))))


def level_rate_est(lev: np.ndarray) -> int:
    """Integer rate proxy: nnz + sum of |level| bit lengths (threshold-sum
    formula identical to the JAX twin)."""
    a = np.abs(lev.astype(np.int64))
    nnz = int((a > 0).sum())
    bl = sum(int((a >= (1 << k)).sum()) for k in range(15))
    return nnz + bl


def level_rate_fp(lev: np.ndarray, w) -> int:
    """Fractional-bit (8.8) level rate: per-context CABAC estimates of the
    sig/gt1/par/gt3/rice structure (cabac/estimate.py lvl_w weights; the
    VTM QuantRDOQ/RdCost fractional-rate analog for the TB RD loop).

    w = (w_nnz, w_ge2, w_ge4, w_dbl); with the flat weights
    (2<<8, 1<<8, 1<<8, 1<<8) this equals ``level_rate_est(lev) << 8``
    exactly (threshold-sum identity: count(a>=1) == nnz)."""
    a = np.abs(lev.astype(np.int64))
    nnz = int((a > 0).sum())
    ge2 = int((a >= 2).sum())
    ge4 = int((a >= 4).sum())
    dbl = sum(int((a >= (1 << k)).sum()) for k in range(3, 15))
    return nnz * w[0] + ge2 * w[1] + ge4 * w[2] + dbl * w[3]


def _rd_cost(dist: int, rate_fp: int, lam: int) -> int:
    """dist + lam * rate in fractional bits, int32-safe in the device
    twin: rate capped at 1<<22 (== the old 1<<14 integer-bit cap << 8),
    split into whole-bit and sub-bit parts so the product fits int32."""
    r = min(rate_fp, 1 << 22)
    return dist + lam * (r >> 8) + ((lam * (r & 255)) >> 8)


def choose_mts(resi: np.ndarray, qp: int, bd: int = rom.BIT_DEPTH):
    """RD-select the transform pair: returns (idx, levels).

    cost = SSE(recon residual) + lambda * (level rate + idx bins);
    first-min tie-breaking in MTS_SET order."""
    idx, _, lev = choose_tx(resi, qp, 0, bd, mts=True, lfnst=False)
    return idx, lev


LFNST_IDX_BITS = (1, 2, 2)           # truncated-unary, cmax 2


def tx_candidates(mts: bool, lfnst: bool, ts: bool = False):
    """(mts_idx, lfnst_idx) candidate list; (0, 0) is always first."""
    out = [(0, 0)]
    if mts:
        out += [(k, 0) for k in range(1, 5)]
    if ts:
        out += [(5, 0)]
    if lfnst:
        out += [(0, 1), (0, 2)]
    return out


# ---------------------------------------------------------------------------
# SBT (sub-block transform: transform only half of the inter luma residual,
# implicit DST7/DCT8 kernel pair by position; role of VTM:CommonLib/
# TrQuant.cpp SBT paths + EncoderLib InterSearch SBT loop).  Documented
# simplifications: half-splits only (no quarter), luma only, and the levels
# live in the full-size TB plane with the untransformed half zeroed (the
# residual coder codes the full TB; zeros are cheap).
# ---------------------------------------------------------------------------
# idx: 0 none, 1 V-left, 2 V-right, 3 H-top, 4 H-bottom
SBT_IDX_BITS = (1, 3, 3, 3, 3)   # sbt_flag + (dir, pos) bypass


def sbt_region(idx: int, s: int):
    """(x0, y0, w, h) of the transformed half within the s x s block."""
    hs = s // 2
    return ((0, 0, s, s), (0, 0, hs, s), (hs, 0, hs, s),
            (0, 0, s, hs), (0, hs, s, hs))[idx]


def sbt_kernels(idx: int):
    """Implicit (kind_h, kind_v) per SBT position (position-adaptive like
    the standard: the kernel with its high-energy end at the prediction
    boundary)."""
    return ((rom.DCT2, rom.DCT2), (rom.DCT8, rom.DST7),
            (rom.DST7, rom.DST7), (rom.DST7, rom.DCT8),
            (rom.DST7, rom.DST7))[idx]


def sbt_reconstruct(lev_full: np.ndarray, sbt_idx: int, qp: int,
                    bd: int = rom.BIT_DEPTH, dq: bool = False) -> np.ndarray:
    """Residual of an SBT TB: dequant + inverse-transform the sub-area,
    zero elsewhere.  lev_full: full-size level plane (sub-area holds the
    sub-TB levels)."""
    s = lev_full.shape[0]
    x0, y0, w, h = sbt_region(sbt_idx, s)
    kh, kv = sbt_kernels(sbt_idx)
    sub = lev_full[y0:y0 + h, x0:x0 + w]
    resi = np.zeros((s, s), np.int32)
    if sub.any():
        resi[y0:y0 + h, x0:x0 + w] = inverse_transform(
            dequantize(sub, qp, bd, dq=dq), kh, kv, bd)
    return resi


def choose_sbt(resi: np.ndarray, qp: int, bd: int = rom.BIT_DEPTH,
               rdoq: bool = False, dq: bool = False):
    """RD-select SBT for an inter luma TB: full DCT-II vs the 4 half
    transforms (dropped half costs its residual energy).  Returns
    (sbt_idx, levels_full); first-min tie-breaking in index order; an
    all-zero winner collapses to idx 0 (identical recon, fewer bins)."""
    from ..cabac import estimate as est
    s = resi.shape[0]
    lam = lambda_rd_int(qp)
    B = est.tx_bits(qp)
    r64 = resi.astype(np.int64)
    best = None
    for idx in range(5):
        x0, y0, w, h = sbt_region(idx, s)
        kh, kv = sbt_kernels(idx)
        sub = resi[y0:y0 + h, x0:x0 + w]
        coef = forward_transform(sub, kh, kv, bd)
        lev_s = quantize(coef, qp, intra=True, bit_depth=bd, rdoq=rdoq,
                         lam_rd=lam, dq=dq)
        lev = np.zeros((s, s), np.int32)
        lev[y0:y0 + h, x0:x0 + w] = lev_s
        rec = np.zeros((s, s), np.int64)
        if lev_s.any():
            rec[y0:y0 + h, x0:x0 + w] = inverse_transform(
                dequantize(lev_s, qp, bd, dq=dq), kh, kv, bd)
        dist = int(((r64 - rec) ** 2).sum())
        rate_fp = level_rate_fp(lev, B.lvl_w) + B.sbt_fp[idx]
        cost = _rd_cost(dist, rate_fp, lam)
        if best is None or cost < best[0]:
            best = (cost, idx, lev)
    idx, lev = best[1], best[2]
    if idx and not lev.any():
        idx = 0
    return idx, lev


def choose_tx(resi: np.ndarray, qp: int, mode: int, bd: int = rom.BIT_DEPTH,
              mts: bool = True, lfnst: bool = False, rdoq: bool = False,
              ts: bool = False, dq: bool = False):
    """Joint MTS/TS/LFNST RD selection for an intra luma TB.

    Returns (mts_idx, lfnst_idx, levels); first-min tie-breaking in
    tx_candidates order.  LFNST candidates ride on the primary DCT-II
    (mts_idx 0), as in the standard."""
    from ..cabac import estimate as est
    lam = lambda_rd_int(qp)
    B = est.tx_bits(qp)
    dct2_coef = None
    best = None
    for mk, lk in tx_candidates(mts, lfnst, ts):
        kh, kv = MTS_SET[mk]
        if mk == 0:
            if dct2_coef is None:
                dct2_coef = forward_transform(resi, kh, kv, bd)
            coef = dct2_coef
        else:
            coef = forward_transform(resi, kh, kv, bd)
        if lk:
            coef = fwd_lfnst(coef, lk, mode)
        lev = quantize(coef, qp, intra=True, bit_depth=bd, rdoq=rdoq,
                       lam_rd=lam, dq=dq)
        dqc = dequantize(lev, qp, bd, dq=dq)
        if lk:
            dqc = inv_lfnst(dqc, lk, mode)
        rec = inverse_transform(dqc, kh, kv, bd)
        dist = int(((resi.astype(np.int64) - rec) ** 2).sum())
        bits_fp = (B.mts_fp[mk] if (mts or ts) else 0) \
            + (B.lfnst_fp[lk] if (lfnst and mk == 0) else 0)
        cost = _rd_cost(dist, level_rate_fp(lev, B.lvl_w) + bits_fp, lam)
        if best is None or cost < best[0]:
            best = (cost, mk, lk, lev)
    return best[1], best[2], best[3]
