"""Adaptive loop filter — 25-class Wiener 7x7 diamond with geometric
transposes and CTU on/off flags.

Role of VTM:CommonLib/AdaptiveLoopFilter.cpp (deriveClassification,
filterBlk) + EncoderLib/EncAdaptiveLoopFilter.cpp (covariance accumulation,
solve, RD decisions) — SURVEY.md §2.5.  As in the standard, the 4x4-block
classification (5 direction bins x 5 activity bins) and the transpose index
are derived from the *reconstruction*, so nothing per-block is signalled;
the encoder signals up to 25 filters (per-class presence flags) and per-CTU
on/off.

Own-design details (documented; encoder and decoder share this code):
gradient ratios use the 2x-dominance rule for weak/strong bins, activity is
quantised by the standard 16->5 table, and the transpose index is
(sumV > sumH) + 2*(sumD1 > sumD0).  The filter is DC-neutral difference
form: out = p + (sum c_i * (p_{T(o_i)} + p_{-T(o_i)} - 2p) + 64) >> 7.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..cabac import contexts as C

# 7x7 diamond: 12 symmetric (dy, dx) offset pairs (mirror is implicit)
DIAMOND = [(-3, 0), (-2, -1), (-2, 0), (-2, 1), (-1, -2), (-1, -1),
           (-1, 0), (-1, 1), (-1, 2), (0, -3), (0, -2), (0, -1)]
N_COEFF = len(DIAMOND)
N_CLASSES = 25
COEFF_MAX = 1023          # 10-bit signed, scale 128 = 1.0

# activity quantisation (VVC's 16 -> 5 mapping)
_ACT_TABLE = np.array([0, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4],
                      np.int32)


def _transpose_perms() -> np.ndarray:
    """(4, N_COEFF) permutations of the diamond for the 4 geometric
    transposes (identity, xy-swap, vflip, both); features are symmetric so
    o and -o are interchangeable."""
    index = {}
    for i, o in enumerate(DIAMOND):
        index[o] = i
        index[(-o[0], -o[1])] = i
    perms = np.empty((4, N_COEFF), np.int32)
    for t in range(4):
        for i, (dy, dx) in enumerate(DIAMOND):
            o = (dx, dy) if t & 1 else (dy, dx)
            if t & 2:
                o = (-o[0], o[1])
            perms[t, i] = index[o]
    return perms


TRANS_PERMS = _transpose_perms()


# 5x5 diamond for chroma: 6 symmetric (dy, dx) offset pairs
DIAMOND_C = [(-2, 0), (-1, -1), (-1, 0), (-1, 1), (0, -2), (0, -1)]
N_COEFF_C = len(DIAMOND_C)
# CC-ALF: 8 luma taps (difference to the collocated luma sample)
CC_OFFSETS = [(-1, 0), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1),
              (2, 0), (-2, 0)]
N_COEFF_CC = len(CC_OFFSETS)
CC_MAX = 127


@dataclass
class AlfParams:
    enabled: bool = False
    coeff: np.ndarray = field(
        default_factory=lambda: np.zeros((N_CLASSES, N_COEFF), np.int32))
    present: np.ndarray = field(
        default_factory=lambda: np.zeros(N_CLASSES, np.uint8))
    ctu_on: np.ndarray = None      # (nY, nX) uint8
    # chroma ALF (5x5) + CC-ALF, per component (Cb, Cr)
    c_enabled: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.uint8))
    c_coeff: np.ndarray = field(
        default_factory=lambda: np.zeros((2, N_COEFF_C), np.int32))
    cc_present: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.uint8))
    cc_coeff: np.ndarray = field(
        default_factory=lambda: np.zeros((2, N_COEFF_CC), np.int32))
    ctu_on_c: np.ndarray = None    # (2, nY, nX) uint8

    def equal(self, o: "AlfParams") -> bool:
        return (self.enabled == o.enabled
                and np.array_equal(self.coeff, o.coeff)
                and np.array_equal(self.present, o.present)
                and (not self.enabled
                     or np.array_equal(self.ctu_on, o.ctu_on))
                and np.array_equal(self.c_enabled, o.c_enabled)
                and np.array_equal(self.c_coeff, o.c_coeff)
                and np.array_equal(self.cc_present, o.cc_present)
                and np.array_equal(self.cc_coeff, o.cc_coeff)
                and ((not self.c_enabled.any())
                     or np.array_equal(self.ctu_on_c, o.ctu_on_c)))


def _features(plane: np.ndarray) -> np.ndarray:
    """(12, H, W) int32 difference features (p_i + p_-i - 2p)."""
    p = plane.astype(np.int32)
    z = np.pad(p, 3, mode="edge")
    h, w = p.shape
    out = np.empty((N_COEFF, h, w), np.int32)
    for i, (dy, dx) in enumerate(DIAMOND):
        a = z[3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
        b = z[3 - dy:3 - dy + h, 3 - dx:3 - dx + w]
        out[i] = a + b - 2 * p
    return out


def classify(plane: np.ndarray, bd: int = 8):
    """Per-4x4-block (class, transpose) from the reconstruction.

    Returns (cls (H//4, W//4) int32 in [0, 25), tr (H//4, W//4) int32 in
    [0, 4)).  Derived from recon only — decoder recomputes identically
    (VTM AdaptiveLoopFilter::deriveClassification).
    """
    p = plane.astype(np.int64)
    z = np.pad(p, 1, mode="edge")
    h, w = p.shape
    gv = np.abs(2 * p - z[:-2, 1:-1] - z[2:, 1:-1])
    gh = np.abs(2 * p - z[1:-1, :-2] - z[1:-1, 2:])
    gd0 = np.abs(2 * p - z[:-2, :-2] - z[2:, 2:])
    gd1 = np.abs(2 * p - z[:-2, 2:] - z[2:, :-2])

    def bsum(g):
        return g.reshape(h // 4, 4, w // 4, 4).sum(axis=(1, 3))

    sv, sh_, sd0, sd1 = bsum(gv), bsum(gh), bsum(gd0), bsum(gd1)
    hv1 = np.maximum(sv, sh_)
    hv0 = np.minimum(sv, sh_)
    d1 = np.maximum(sd0, sd1)
    d0 = np.minimum(sd0, sd1)

    strong_hv = hv1 > 2 * hv0
    strong_d = d1 > 2 * d0
    diag_main = d1 * hv0 > hv1 * d0
    dir_idx = np.where(~strong_hv & ~strong_d, 0,
                       np.where(diag_main,
                                np.where(strong_d, 4, 3),
                                np.where(strong_hv, 2, 1))).astype(np.int32)

    act = sv + sh_
    # 16 activity bins over the 4x4 sum (scaled by bit depth), then 16->5
    a16 = np.clip((act * 16) >> (3 + bd), 0, 15).astype(np.int32)
    act_idx = _ACT_TABLE[a16]
    cls = dir_idx * 5 + act_idx
    tr = ((sv > sh_).astype(np.int32)
          + 2 * (sd1 > sd0).astype(np.int32))
    return cls, tr


def _coeff_planes(params: AlfParams, cls, tr, h: int, w: int) -> np.ndarray:
    """(12, H, W) per-pixel effective coefficients: the class filter with
    its block transpose permutation applied."""
    eff = params.coeff[:, TRANS_PERMS]          # (25, 4, 12)
    eff = eff * params.present[:, None, None]   # absent class -> identity
    per_block = eff[cls, tr].astype(np.int32)   # (H//4, W//4, 12)
    per_pix = np.repeat(np.repeat(per_block, 4, axis=0), 4, axis=1)
    return per_pix[:h, :w].transpose(2, 0, 1)


def apply_alf(plane: np.ndarray, params: AlfParams, ctu: int = 64,
              bd: int = 8) -> np.ndarray:
    """Filter the luma plane with per-CTU on/off (shared enc/dec)."""
    if not params.enabled:
        return plane
    h, w = plane.shape
    cls, tr = classify(plane, bd)
    f = _features(plane)
    cpl = _coeff_planes(params, cls, tr, h, w)
    delta = ((cpl * f).sum(axis=0, dtype=np.int32) + 64) >> 7
    filtered = np.clip(plane.astype(np.int32) + delta, 0, (1 << bd) - 1)
    on = np.kron(params.ctu_on.astype(bool),
                 np.ones((ctu, ctu), bool))[:h, :w]
    return np.where(on, filtered, plane).astype(np.int32)


def _features_c(plane: np.ndarray) -> np.ndarray:
    """(6, H, W) chroma difference features over the 5x5 diamond."""
    p = plane.astype(np.int32)
    z = np.pad(p, 2, mode="edge")
    h, w = p.shape
    out = np.empty((N_COEFF_C, h, w), np.int32)
    for i, (dy, dx) in enumerate(DIAMOND_C):
        a = z[2 + dy:2 + dy + h, 2 + dx:2 + dx + w]
        b = z[2 - dy:2 - dy + h, 2 - dx:2 - dx + w]
        out[i] = a + b - 2 * p
    return out


def _features_cc(luma: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """(8, cH, cW) CC-ALF features: collocated-luma differences on the
    chroma grid (luma sample (2y, 2x) is the collocated centre)."""
    p = luma.astype(np.int32)
    z = np.pad(p, 2, mode="edge")
    ctr = z[2:2 + 2 * ch:2, 2:2 + 2 * cw:2]
    out = np.empty((N_COEFF_CC, ch, cw), np.int32)
    for i, (dy, dx) in enumerate(CC_OFFSETS):
        out[i] = z[2 + dy:2 + dy + 2 * ch:2,
                   2 + dx:2 + dx + 2 * cw:2] - ctr
    return out


def apply_alf_frame(planes, params: AlfParams, ctu: int = 64,
                    bd: int = 8):
    """Filter [Y, Cb, Cr]: 25-class luma ALF, 5x5 chroma ALF + CC-ALF
    (CC-ALF taps the pre-ALF luma, as in the standard's SAO-output tap)."""
    luma_in = planes[0]
    out = [apply_alf(planes[0], params, ctu, bd)]
    cctu = ctu // 2
    mx = (1 << bd) - 1
    for c in (0, 1):
        base = planes[c + 1]
        if not params.c_enabled[c]:
            out.append(base)
            continue
        ch, cw = base.shape
        delta = np.zeros((ch, cw), np.int32)
        if params.c_coeff[c].any():
            fc = _features_c(base)
            delta += (np.tensordot(params.c_coeff[c].astype(np.int32), fc,
                                   axes=(0, 0)) + 64) >> 7
        if params.cc_present[c]:
            fcc = _features_cc(luma_in, ch, cw)
            delta += (np.tensordot(params.cc_coeff[c].astype(np.int32), fcc,
                                   axes=(0, 0)) + 64) >> 7
        filt = np.clip(base.astype(np.int32) + delta, 0, mx)
        on = np.kron(params.ctu_on_c[c].astype(bool),
                     np.ones((cctu, cctu), bool))[:ch, :cw]
        out.append(np.where(on, filt, base).astype(np.int32))
    return out


def derive_alf_frame(orig_planes, rec_planes, qp: int, ctu: int = 64,
                     bd: int = 8) -> AlfParams:
    """Full-frame derivation: luma 25-class + chroma 5x5 + CC-ALF."""
    params = derive_alf(orig_planes[0], rec_planes[0], qp, ctu, bd)
    lam = max(1, int(round(0.57 * 2.0 ** ((qp - 12) / 3.0))))
    n_y, n_x = rec_planes[0].shape[0] // ctu, rec_planes[0].shape[1] // ctu
    params.ctu_on_c = np.zeros((2, n_y, n_x), np.uint8)
    cctu = ctu // 2
    mx = (1 << bd) - 1
    for c in (0, 1):
        base = rec_planes[c + 1]
        o = orig_planes[c + 1].astype(np.int64)
        ch, cw = base.shape
        err = (o - base).reshape(-1).astype(np.float64)
        fc = _features_c(base)
        fm = fc.reshape(N_COEFF_C, -1).astype(np.float64)
        gram = fm @ fm.T
        gram += np.eye(N_COEFF_C) * (1.0 + gram.trace() * 1e-9)
        sol = np.linalg.solve(gram, fm @ err)
        ccoef = np.clip(np.round(sol * 128.0), -COEFF_MAX,
                        COEFF_MAX).astype(np.int32)
        delta = (np.tensordot(ccoef.astype(np.int64), fc,
                              axes=(0, 0)) + 64) >> 7
        # CC-ALF Wiener on the residual left after chroma ALF
        fcc = _features_cc(rec_planes[0], ch, cw)
        fmc = fcc.reshape(N_COEFF_CC, -1).astype(np.float64)
        err2 = err - delta.reshape(-1).astype(np.float64)
        gram2 = fmc @ fmc.T
        gram2 += np.eye(N_COEFF_CC) * (1.0 + gram2.trace() * 1e-9)
        sol2 = np.linalg.solve(gram2, fmc @ err2)
        cccoef = np.clip(np.round(sol2 * 128.0), -CC_MAX,
                         CC_MAX).astype(np.int32)
        if not ccoef.any() and not cccoef.any():
            continue
        delta2 = delta + ((np.tensordot(cccoef.astype(np.int64), fcc,
                                        axes=(0, 0)) + 64) >> 7)
        filt = np.clip(base.astype(np.int64) + delta2, 0, mx)
        e_off = (o - base) ** 2
        e_on = (o - filt) ** 2
        gain = ((e_off - e_on).reshape(n_y, cctu, n_x, cctu)
                .sum(axis=(1, 3)))
        on_map = (gain > lam).astype(np.uint8)
        total_gain = int(gain[gain > lam].sum())
        coeff_bits = 8 + (N_COEFF_C + N_COEFF_CC) * 7
        if on_map.any() and total_gain > lam * coeff_bits:
            params.c_enabled[c] = 1
            params.c_coeff[c] = ccoef
            params.cc_present[c] = 1 if cccoef.any() else 0
            params.cc_coeff[c] = cccoef if cccoef.any() else 0
            params.ctu_on_c[c] = on_map
    return params


def derive_alf(orig: np.ndarray, rec: np.ndarray, qp: int, ctu: int = 64,
               bd: int = 8) -> AlfParams:
    """Per-class Wiener solve + integer quantisation + RD decisions."""
    h, w = rec.shape
    n_y, n_x = h // ctu, w // ctu
    params = AlfParams(ctu_on=np.zeros((n_y, n_x), np.uint8))
    cls, tr = classify(rec, bd)
    f = _features(rec)
    # per-pixel transposed feature vectors: fT[i] = f[perm_tr(block)[i]]
    perm_pix = TRANS_PERMS[tr]                       # (H//4, W//4, 12)
    perm_pix = np.repeat(np.repeat(perm_pix, 4, axis=0), 4, axis=1)[:h, :w]
    fT = np.take_along_axis(
        f.transpose(1, 2, 0), perm_pix, axis=2)      # (H, W, 12)
    err = (orig.astype(np.int64) - rec)
    cls_pix = np.repeat(np.repeat(cls, 4, axis=0), 4, axis=1)[:h, :w]

    lam = max(1, int(round(0.57 * 2.0 ** ((qp - 12) / 3.0))))
    flat_f = fT.reshape(-1, N_COEFF).astype(np.float64)
    flat_e = err.reshape(-1).astype(np.float64)
    flat_c = cls_pix.reshape(-1)
    # per-class Gram/rhs on contiguous class-sorted slices (stable sort
    # keeps raster order within a class, so sums match the masked-gather
    # formulation bit-for-bit in float64)
    order = np.argsort(flat_c, kind="stable")
    counts = np.bincount(flat_c, minlength=N_CLASSES)
    offs = np.concatenate([[0], np.cumsum(counts)])
    fs = flat_f[order]
    es = flat_e[order]
    for k in range(N_CLASSES):
        npix = int(counts[k])
        if npix < 64:
            continue
        fm = fs[offs[k]:offs[k + 1]]
        gram = fm.T @ fm
        rhs = fm.T @ es[offs[k]:offs[k + 1]]
        gram += np.eye(N_COEFF) * (1.0 + gram.trace() * 1e-9)
        sol = np.linalg.solve(gram, rhs)
        coeff = np.clip(np.round(sol * 128.0), -COEFF_MAX,
                        COEFF_MAX).astype(np.int32)
        if coeff.any():
            params.coeff[k] = coeff
            params.present[k] = 1
    if not params.present.any():
        return params
    params.enabled = True

    # per-CTU decision by SSE gain (+ lambda * flag bit)
    cpl = _coeff_planes(params, cls, tr, h, w)
    delta = ((cpl * f).sum(axis=0) + 64) >> 7
    filt = np.clip(rec.astype(np.int64) + delta, 0, (1 << bd) - 1)
    e_off = err * err
    e_on = (orig.astype(np.int64) - filt) ** 2
    gain = ((e_off - e_on).reshape(n_y, ctu, n_x, ctu)
            .sum(axis=(1, 3)))
    params.ctu_on[:] = (gain > lam).astype(np.uint8)
    total_gain = int(gain[gain > lam].sum())
    # frame-level decision must also pay for the filter-coefficient bits
    coeff_bits = 26 + int(params.present.sum()) * N_COEFF * 7
    if not params.ctu_on.any() or total_gain <= lam * coeff_bits:
        params.enabled = False
        params.ctu_on[:] = 0
        params.present[:] = 0
        params.coeff[:] = 0
    return params


# ---------------------------------------------------------------------------
# syntax (slice-tail section after SAO), direction-agnostic io
# ---------------------------------------------------------------------------

def _eg3(io, v):
    """Signed EG(3) bypass code for coefficients."""
    if io.decoding:
        sym = 0
        k = 3
        while io.byp():
            sym += 1 << k
            k += 1
        sym += io.byp_n(n=k) if k else 0
        if sym == 0:
            return 0
        sign = io.byp()
        return -sym if sign else sym
    a = abs(int(v))
    sym = a
    k = 3
    while sym >= (1 << k):
        io.byp(1)
        sym -= 1 << k
        k += 1
    io.byp(0)
    if k:
        io.byp_n(sym, k)
    if a:
        io.byp(int(v < 0))
    return v


def code_alf_params(io, params: AlfParams | None, n_y: int,
                    n_x: int) -> AlfParams:
    out = params if params is not None else AlfParams(
        ctu_on=np.zeros((n_y, n_x), np.uint8),
        ctu_on_c=np.zeros((2, n_y, n_x), np.uint8))
    if out.ctu_on_c is None:
        out.ctu_on_c = np.zeros((2, n_y, n_x), np.uint8)
    dec = io.decoding
    on = io.bin(C.ALF_CTB_FLAG(0), None if dec else int(out.enabled))
    if dec:
        out.enabled = bool(on)
    if on:
        for k in range(N_CLASSES):
            pr = io.bin(C.ALF_CTB_FLAG(2),
                        None if dec else int(out.present[k]))
            if dec:
                out.present[k] = pr
            if not pr:
                continue
            for i in range(N_COEFF):
                v = _eg3(io, None if dec else int(out.coeff[k, i]))
                if dec:
                    out.coeff[k, i] = v
        for cy in range(n_y):
            for cx in range(n_x):
                b = io.bin(C.ALF_CTB_FLAG(1),
                           None if dec else int(out.ctu_on[cy, cx]))
                if dec:
                    out.ctu_on[cy, cx] = b
    # chroma ALF (5x5) + CC-ALF per component
    for c in (0, 1):
        con = io.bin(C.ALF_CTB_FLAG(3 + c),
                     None if dec else int(out.c_enabled[c]))
        if dec:
            out.c_enabled[c] = con
        if not con:
            continue
        for i in range(N_COEFF_C):
            v = _eg3(io, None if dec else int(out.c_coeff[c, i]))
            if dec:
                out.c_coeff[c, i] = v
        ccp = io.bin(C.ALF_CTB_FLAG(5 + c),
                     None if dec else int(out.cc_present[c]))
        if dec:
            out.cc_present[c] = ccp
        if ccp:
            for i in range(N_COEFF_CC):
                v = _eg3(io, None if dec else int(out.cc_coeff[c, i]))
                if dec:
                    out.cc_coeff[c, i] = v
        for cy in range(n_y):
            for cx in range(n_x):
                b = io.bin(C.ALF_CTB_FLAG(7),
                           None if dec else int(out.ctu_on_c[c, cy, cx]))
                if dec:
                    out.ctu_on_c[c, cy, cx] = b
    return out
