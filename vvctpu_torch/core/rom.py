"""ROM: constant tables for the TPU-native VVC engine.

Mirrors the role of the reference's constant-table unit (VTM:CommonLib/Rom.cpp
``initROM`` — scan orders, transform matrices, QP/lambda tables).  See SURVEY.md
§2.1.  Unlike the reference, every table here is *generated* from the closed-form
definitions rather than embedded as literal dumps:

* Transform matrices (DCT-II / DST-VII / DCT-VIII) are produced by rounding the
  orthonormal basis scaled to the standard 64-DC convention
  (``round(64*sqrt(N) * basis)``).  The VVC spec tables contain a handful of
  hand-tweaked ±1 entries inherited from HEVC; generated tables are therefore
  within ±1 of the published ones.  The engine is *internally* bit-exact
  (encoder and decoder share these tables); swap in literal spec tables via
  ``TR_MATRIX_OVERRIDE`` once an external conformance oracle is available
  (the reference mount was empty this round — SURVEY.md §0).
* Diagonal coefficient scan orders (4x4 coefficient groups, diagonal CG scan)
  as in VTM:CommonLib/Rom.cpp ``initROM`` scan-order initialisation.
* Quant scale tables per (QP % 6) as in VTM:CommonLib/Quant.cpp
  (``g_quantScales`` / ``g_invQuantScales``).
* Intra prediction angle / inverse-angle tables as in
  VTM:CommonLib/IntraPrediction.cpp (spec Table 8-8 layout).

All tables are plain numpy int arrays; the JAX engine loads them as device
constants at init (SURVEY.md §3.3).
"""
from __future__ import annotations

import functools
import math

import numpy as np

# ---------------------------------------------------------------------------
# Geometry / limits
# ---------------------------------------------------------------------------
CTU_SIZE = 64
MIN_CU_SIZE = 8          # min luma CU this build signals (4x4 chroma TBs exist)
MIN_TB_SIZE = 4
MAX_TB_SIZE = 32         # 64-CUs carry an implicit 4-way TU split
MAX_QP = 63
BIT_DEPTH = 8            # primary path; 10-bit is a config knob (see io.cfg)

MAX_TR_DYNAMIC_RANGE = 15
QUANT_SHIFT = 14

# per (QP % 6): forward and inverse quantisation scales (the classic
# HEVC/VVC pair with product ~2^20); VTM:CommonLib/Quant.cpp g_quantScales.
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int64)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], np.int64)


def transform_shift(log2_w: int, log2_h: int, bit_depth: int = BIT_DEPTH) -> int:
    """Coefficient dynamic-range alignment shift (VTM TrQuant getTransformShift)."""
    return MAX_TR_DYNAMIC_RANGE - bit_depth - ((log2_w + log2_h) >> 1)


# ---------------------------------------------------------------------------
# Transform matrices
# ---------------------------------------------------------------------------
DCT2, DST7, DCT8, IDT = 0, 1, 2, 3   # IDT = transform skip (identity)
TR_SIZES = (4, 8, 16, 32, 64)
MTS_SIZES = (4, 8, 16, 32)   # DST7/DCT8 defined for 4..32 only

TR_MATRIX_OVERRIDE: dict[tuple[int, int], np.ndarray] = {}


def _dct2(n: int) -> np.ndarray:
    # VVC derives N-point DCT-II from the 64-point matrix by taking every
    # (64/N)-th row (first N columns); reproduce that construction so e.g. the
    # 4-point matrix matches the 64-point subsampling exactly.
    n64 = 64
    k = np.arange(n64)[:, None]
    j = np.arange(n64)[None, :]
    eps = np.where(k == 0, 1.0 / math.sqrt(2.0), 1.0)
    base = math.sqrt(2.0 / n64) * eps * np.cos(math.pi * k * (2 * j + 1) / (2 * n64))
    m64 = np.round(64.0 * math.sqrt(n64) * base).astype(np.int64)
    step = n64 // n
    return m64[::step, :n]


def _dst7(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    base = math.sqrt(4.0 / (2 * n + 1)) * np.sin(
        math.pi * (2 * k + 1) * (j + 1) / (2 * n + 1))
    return np.round(64.0 * math.sqrt(n) * base).astype(np.int64)


def _dct8(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    base = math.sqrt(4.0 / (2 * n + 1)) * np.cos(
        math.pi * (2 * k + 1) * (2 * j + 1) / (2 * (2 * n + 1)))
    return np.round(64.0 * math.sqrt(n) * base).astype(np.int64)


@functools.lru_cache(maxsize=None)
def tr_matrix(kind: int, n: int) -> np.ndarray:
    """N-point transform matrix, rows = basis functions (forward: C = M x)."""
    if (kind, n) in TR_MATRIX_OVERRIDE:
        return TR_MATRIX_OVERRIDE[(kind, n)]
    if kind == DCT2:
        return _dct2(n)
    if kind == DST7:
        return _dst7(n)
    if kind == DCT8:
        return _dct8(n)
    raise ValueError(f"unknown transform kind {kind}")


# ---------------------------------------------------------------------------
# LFNST: low-frequency non-separable secondary transform
# (role of VTM:CommonLib/Rom.cpp g_lfnst8x8/4x4 tables + TrQuant xFwdLfnst).
# Kernels here are *generated*: the 16x16 non-separable matrix is the exact
# rotation that maps the top-left 4x4 DCT-II coefficient subspace onto a
# directional (DST-VII / DCT-VIII) basis pair — kron(A C4^T, B C4^T) with
# orthonormal float bases, scaled by 128.  Near-orthogonal by construction,
# so fwd/inv round-trip is tight; swap literal spec tables via
# LFNST_MATRIX_OVERRIDE once a conformance oracle is available.
# ---------------------------------------------------------------------------
LFNST_SETS = 4
LFNST_MATRIX_OVERRIDE: dict[tuple[int, int], np.ndarray] = {}

_LFNST_SET_BASES = (
    ((DST7, DST7), (DCT8, DCT8)),   # set 0: planar / DC
    ((DST7, DCT8), (DST7, DST7)),   # set 1: near-horizontal
    ((DCT8, DST7), (DCT8, DCT8)),   # set 2: diagonal-ish
    ((DCT8, DST7), (DST7, DCT8)),   # set 3: near-vertical (pre-transpose)
)


def _float_basis(kind: int, n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    if kind == DCT2:
        eps = np.where(k == 0, 1.0 / math.sqrt(2.0), 1.0)
        return math.sqrt(2.0 / n) * eps * np.cos(
            math.pi * k * (2 * j + 1) / (2 * n))
    if kind == DST7:
        return math.sqrt(4.0 / (2 * n + 1)) * np.sin(
            math.pi * (2 * k + 1) * (j + 1) / (2 * n + 1))
    if kind == DCT8:
        return math.sqrt(4.0 / (2 * n + 1)) * np.cos(
            math.pi * (2 * k + 1) * (2 * j + 1) / (2 * (2 * n + 1)))
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def lfnst_matrix(set_idx: int, kernel_idx: int) -> np.ndarray:
    """(16, 16) int32 forward kernel (inverse = transpose), scale 128."""
    if (set_idx, kernel_idx) in LFNST_MATRIX_OVERRIDE:
        return LFNST_MATRIX_OVERRIDE[(set_idx, kernel_idx)]
    ka, kb = _LFNST_SET_BASES[set_idx][kernel_idx]
    c4 = _float_basis(DCT2, 4)
    a = _float_basis(ka, 4) @ c4.T
    b = _float_basis(kb, 4) @ c4.T
    m = np.kron(a, b)          # row-major vec convention: v = vec(rows)
    return np.round(128.0 * m).astype(np.int32)


def lfnst_set_for_mode(mode: int) -> tuple[int, bool]:
    """(set index, transpose) from the intra luma mode (own mapping in the
    shape of VTM's g_lfnstLut: fold >DIA modes onto <=DIA with transpose)."""
    if mode <= DC_IDX:
        return 0, False
    tr = mode > DIA_IDX
    m = mode if mode <= DIA_IDX else 68 - mode
    if m <= 12:
        return 1, tr
    if m <= 23:
        return 2, tr
    return 3, tr


# ---------------------------------------------------------------------------
# Coefficient scan orders (diagonal, 4x4 coefficient groups)
# ---------------------------------------------------------------------------
CG_SIZE = 4


def _diag_scan(w: int, h: int) -> np.ndarray:
    """Up-right diagonal scan positions, shape (w*h, 2) of (x, y).

    Matches the VVC coefficient scan: diagonals walked from bottom-left to
    top-right (within each anti-diagonal y decreases), diagonal index
    increasing.  VTM:CommonLib/Rom.cpp initROM / g_scanOrder.
    """
    out = []
    for d in range(w + h - 1):
        y0 = min(d, h - 1)
        for y in range(y0, -1, -1):
            x = d - y
            if x < w:
                out.append((x, y))
    return np.array(out, np.int32)


@functools.lru_cache(maxsize=None)
def scan_order(log2_w: int, log2_h: int) -> np.ndarray:
    """Full-TB scan: diagonal over CGs, diagonal within each CG.

    Returns (num_coeff, 2) array of (x, y) in scan order (first entry = DC).
    """
    w, h = 1 << log2_w, 1 << log2_h
    cg_w, cg_h = max(w // CG_SIZE, 1), max(h // CG_SIZE, 1)
    sw, sh = min(w, CG_SIZE), min(h, CG_SIZE)
    cg_scan = _diag_scan(cg_w, cg_h)
    in_scan = _diag_scan(sw, sh)
    pos = []
    for cgx, cgy in cg_scan:
        for x, y in in_scan:
            pos.append((cgx * sw + x, cgy * sh + y))
    return np.array(pos, np.int32)


# ---------------------------------------------------------------------------
# Intra prediction tables
# ---------------------------------------------------------------------------
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 18
DIA_IDX = 34
VER_IDX = 50
NUM_LUMA_MODE = 67
NUM_MPM = 6

# intraPredAngle for modes 2..66 (spec Table 8-8 layout): antisymmetric around
# the diagonal mode 34; 1/32-sample units.
_HALF_ANGLES = [32, 29, 26, 23, 20, 18, 16, 14, 12, 10, 8, 6, 4, 3, 2, 1, 0,
                -1, -2, -3, -4, -6, -8, -10, -12, -14, -16, -18, -20, -23,
                -26, -29, -32]
INTRA_PRED_ANGLE = np.zeros(NUM_LUMA_MODE, np.int32)
for _m in range(2, 35):
    INTRA_PRED_ANGLE[_m] = _HALF_ANGLES[_m - 2]
for _m in range(35, 67):
    INTRA_PRED_ANGLE[_m] = _HALF_ANGLES[66 - _m]

# Wide-angle extension (round 4; VVC 8.4.5.2.6 / Table 8-8 beyond the
# +-32 slopes): for non-square blocks the near-diagonal modes are remapped
# to angles steeper than 45 degrees.  Encoded indices here:
#   67..80  = wide-high (W > H, original modes 2..15 remapped +65)
#   81..94  = wide-low  (H > W, original modes 66..53 remapped; signed
#             mode -k is stored as index 80 + k)
# Both share the same angle magnitudes (transpose symmetry).
WIDE_ANGLES = [35, 39, 45, 51, 57, 64, 73, 86, 102, 128, 171, 256, 341,
               512]
NUM_ANGLE_IDS = 67 + 2 * len(WIDE_ANGLES)
_EXT = np.zeros(NUM_ANGLE_IDS, np.int32)
_EXT[:NUM_LUMA_MODE] = INTRA_PRED_ANGLE
for _k, _a in enumerate(WIDE_ANGLES):
    _EXT[67 + _k] = _a
    _EXT[81 + _k] = _a
INTRA_PRED_ANGLE = _EXT


def wide_angle_mode(mode: int, w: int, h: int) -> int:
    """Remapped prediction-mode index for a (w, h) block (identity for
    squares / non-angular modes).  Returns the encoded index described
    above; the SIGNALLED mode is always the 0..66 input (remap is a
    prediction-time operation, as in the standard)."""
    if w == h or mode < 2 or mode > 66:
        return mode
    r = abs((int(w).bit_length() - 1) - (int(h).bit_length() - 1))
    if w > h:
        thr = (8 + 2 * r) if r > 1 else 8
        if mode < thr:
            return mode + 65
    else:
        thr = (60 - 2 * r) if r > 1 else 60
        if mode > thr:
            return 80 + (67 - mode)
    return mode


# inverse angle (for negative-angle modes projecting the side reference);
# scaled by 512*32 as in VVC; stored positive, used with |angle|.  Wide
# angles are all positive so their entries stay 0 (unused).
INTRA_INV_ANGLE = np.zeros(NUM_ANGLE_IDS, np.int32)
for _m in range(2, 67):
    a = abs(int(INTRA_PRED_ANGLE[_m]))
    if a != 0:
        INTRA_INV_ANGLE[_m] = int(round(512 * 32 / a))


@functools.lru_cache(maxsize=None)
def intra_filter_4tap(smoothed: bool) -> np.ndarray:
    """(32, 4) int32 4-tap fractional-position interpolation filters.

    VVC uses two 4-tap sets for angular intra: a DCT-IF (cubic-like) set and a
    smoothed (Gaussian) set, selected per block (VTM:CommonLib/Rom.cpp
    g_intraGaussFilter / the fC tables).  Generated here from the standard
    closed forms (sum 64, phase p/32).
    """
    taps = np.zeros((32, 4), np.int64)
    for p in range(32):
        f = p / 32.0
        if smoothed:
            # cubic B-spline weights (smoothed/Gaussian-like set)
            w0 = ((1 - f) ** 3) / 6
            w1 = (4 - 6 * f * f + 3 * f ** 3) / 6
            w2 = (1 + 3 * f + 3 * f * f - 3 * f ** 3) / 6
            w3 = (f ** 3) / 6
            w = np.array([w0, w1, w2, w3])
        else:
            # Catmull-Rom cubic (DCT-IF-like sharp interpolator)
            w0 = -0.5 * f + f * f - 0.5 * f ** 3
            w1 = 1 - 2.5 * f * f + 1.5 * f ** 3
            w2 = 0.5 * f + 2 * f * f - 1.5 * f ** 3
            w3 = -0.5 * f * f + 0.5 * f ** 3
            w = np.array([w0, w1, w2, w3])
        q = np.round(w * 64).astype(np.int64)
        # force sum to 64 by adjusting the largest tap
        q[np.argmax(q)] += 64 - q.sum()
        taps[p] = q
    return taps.astype(np.int32)


# ---------------------------------------------------------------------------
# Inter MC interpolation filters (8-tap luma / 4-tap chroma), 1/16 pel
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def mc_filter_luma() -> np.ndarray:
    """(16, 8) int32 luma MC filters, sum 64 (VTM InterpolationFilter.cpp

    m_lumaFilter).  Generated as windowed-sinc (Lanczos-3 style) rounded to
    6-bit, the construction the standard filters approximate.
    """
    taps = np.zeros((16, 8), np.int64)
    for p in range(16):
        f = p / 16.0
        x = np.arange(-3, 5) - f
        w = np.sinc(x) * np.sinc(x / 4.0)
        w /= w.sum()
        q = np.round(w * 64).astype(np.int64)
        q[np.argmax(np.abs(q))] += 64 - q.sum()
        taps[p] = q
    return taps.astype(np.int32)


@functools.lru_cache(maxsize=None)
def mc_filter_chroma() -> np.ndarray:
    """(32, 4) int32 chroma MC filters, sum 64, 1/32 pel."""
    taps = np.zeros((32, 4), np.int64)
    for p in range(32):
        f = p / 32.0
        x = np.arange(-1, 3) - f
        w = np.sinc(x) * np.sinc(x / 2.0)
        w /= w.sum()
        q = np.round(w * 64).astype(np.int64)
        q[np.argmax(np.abs(q))] += 64 - q.sum()
        taps[p] = q
    return taps.astype(np.int32)


# ---------------------------------------------------------------------------
# MIP: matrix intra prediction weights
# (role of VTM:CommonLib/MipData.h — trained int weight matrices.  Here the
# matrices are *generated*: each mode is the LMMSE (Wiener) predictor of the
# reduced block from the 8 downsampled boundary samples under an anisotropic
# first-order Markov image model stretched along one of 8 orientations —
# the statistical model the trained VVC weights approximate.  Rows are
# renormalised to sum 64 so a flat boundary reproduces exactly.  Swap literal
# spec tables via MIP_WEIGHT_OVERRIDE once a conformance oracle is available.)
# ---------------------------------------------------------------------------
NUM_MIP_MODES = 8                 # per size class; x2 for the transpose flag
MIP_SHIFT = 6                     # weight scale 64
MIP_REDUCED = {8: 4, 16: 8, 32: 8}   # block size -> reduced prediction size
MIP_WEIGHT_OVERRIDE: dict[int, np.ndarray] = {}

# (anisotropy along direction?, angle degrees) per mode: planar-like
# isotropic short range, DC-like isotropic long range, then 6 orientations.
_MIP_MODELS = ((False, 0.0), (False, 90.0), (True, 0.0), (True, 30.0),
               (True, 45.0), (True, 60.0), (True, 90.0), (True, 135.0))


@functools.lru_cache(maxsize=None)
def mip_weights(rs: int) -> np.ndarray:
    """(NUM_MIP_MODES, rs*rs, 8) int32 weights, scale 2^MIP_SHIFT.

    Input layout: [top0..top3, left0..left3] downsampled boundary."""
    if rs in MIP_WEIGHT_OVERRIDE:
        return MIP_WEIGHT_OVERRIDE[rs]
    u4 = rs // 4
    # boundary sample positions (x, y): 4 top at y=-1, 4 left at x=-1
    bpos = [((k * u4) + (u4 - 1) / 2.0, -1.0) for k in range(4)] + \
           [(-1.0, (k * u4) + (u4 - 1) / 2.0) for k in range(4)]
    ppos = [(float(x), float(y)) for y in range(rs) for x in range(rs)]

    def corr(p, q, aniso, theta):
        dx, dy = p[0] - q[0], p[1] - q[1]
        if aniso:
            th = math.radians(theta)
            a = dx * math.cos(th) + dy * math.sin(th)
            b = -dx * math.sin(th) + dy * math.cos(th)
            d = math.sqrt((a / 4.0) ** 2 + b * b)
        else:
            d = math.sqrt(dx * dx + dy * dy) / (3.0 if theta > 0 else 1.0)
        return 0.9 ** d

    out = np.zeros((NUM_MIP_MODES, rs * rs, 8), np.int32)
    for m, (aniso, theta) in enumerate(_MIP_MODELS):
        cbb = np.array([[corr(p, q, aniso, theta) for q in bpos]
                        for p in bpos])
        cpb = np.array([[corr(p, q, aniso, theta) for q in bpos]
                        for p in ppos])
        w = cpb @ np.linalg.inv(cbb + 1e-3 * np.eye(8))
        q = np.round(w * (1 << MIP_SHIFT)).astype(np.int64)
        # renormalise rows to sum 64: spread the residue, largest tap last
        for r in range(rs * rs):
            res = (1 << MIP_SHIFT) - int(q[r].sum())
            step = 1 if res > 0 else -1
            order = np.argsort(-np.abs(q[r]))
            for i in range(abs(res)):
                q[r, order[i % 8]] += step
        out[m] = q
    return out


# ---------------------------------------------------------------------------
# GPM: geometric partitioning blend masks
# (role of VTM:CommonLib/Rom.cpp g_geoParams / g_globalGeoWeights +
#  InterPrediction::weightedGeoBlk.  64 partitions = 8 angles x 4 offsets x
#  2 inversions, generated from the closed-form signed-distance ramp the
#  standard tables encode; weights 0..8, ramp ~±2 px around the edge.)
# ---------------------------------------------------------------------------
GPM_PARTITIONS = 64
_GPM_ANGLES = ((8, 0), (7, 3), (6, 6), (3, 7),
               (0, 8), (-3, 7), (-6, 6), (-7, 3))


@functools.lru_cache(maxsize=None)
def gpm_mask(s: int, idx: int) -> np.ndarray:
    """(s, s) int32 luma weight mask (0..8) for partition ``idx`` (0..63).

    idx = (angle << 3) | (offset << 1) | inversion.  The prediction is
    (w * P0 + (8 - w) * P1 + 4) >> 3."""
    a = (idx >> 3) & 7
    dist = (idx >> 1) & 3
    inv = idx & 1
    nx, ny = _GPM_ANGLES[a]
    u = 2 * np.arange(s) - s + 1              # odd-grid coords (x2 pixels)
    d = (nx * u[None, :] + ny * u[:, None]
         - (2 * dist - 3) * s * 2)
    w = np.clip(((d + 4) >> 3) + 4, 0, 8)
    if inv:
        w = 8 - w
    return w.astype(np.int32)


@functools.lru_cache(maxsize=None)
def gpm_masks_all(s: int) -> np.ndarray:
    """(64, s, s) stacked luma masks (device constant for the JAX engine)."""
    return np.stack([gpm_mask(s, i) for i in range(GPM_PARTITIONS)])


def qp_to_lambda(qp: int, intra: bool = True) -> float:
    """RD lambda from QP (the classic 0.57*2^((qp-12)/3) family,

    VTM:EncoderLib/EncSlice.cpp setUpLambda)."""
    alpha = 0.57 if intra else 0.68
    return alpha * (2.0 ** ((qp - 12) / 3.0))


# Spec-literal DCT2 tables are the DEFAULT since round 5 (VERDICT r4 ask
# #3): tables_spec.install() routes them through TR_MATRIX_OVERRIDE at
# import.  VVCTPU_SPEC_TABLES=0 restores the generated tables (A/B for
# the ladder).  Note the round-4 "opt-in" gate imported tables_spec
# without calling install() — the env var was a no-op; fixed here.
import os as _os

if _os.environ.get("VVCTPU_SPEC_TABLES", "1") != "0":
    from . import tables_spec as _tables_spec

    _tables_spec.install()
