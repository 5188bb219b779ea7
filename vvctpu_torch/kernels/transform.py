"""Transforms and quantisation in PyTorch — twin of vvctpu/kernels/transform.py.

The separable DCT-II / DST-VII / DCT-VIII products and the 16x16 LFNST
products run in float64: every partial sum is an integer below 2^53, so
the product is exact, and it is rounded back to int32 before the
rounding shifts (CUDA has no int32 matmul).  The matrices are read from
``rom.tr_matrix`` / ``rom.lfnst_matrix`` at call time, cached on the
table's identity, so a runtime table swap (core/tables_spec
install/uninstall) takes effect at once.

Functions operate on (..., h, w) int32 batches with static (h, w) and a
host-side integer qp; the MTS/LFNST RD choice (``choose_tx``), the SBT
choice (``choose_sbt``) and the per-row inverse kernels take a leading
block axis.  Dependent quantization's trellis is the hand kernel of
``kernels/dq.py``; its state walk and dequantizer are here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cabac import estimate as est
from ..core import rom
from ..device import const
from ..spec.transform import (DQ_MAPS, MTS_SET, sbt_kernels, sbt_region,
                              tx_candidates)

COEFF_MIN, COEFF_MAX = -32768, 32767

# (kind, n, device) -> (source array, float64 tensor); the source array is
# kept so a swapped table (a new array) misses the cache
_MAT_CACHE: dict = {}


def _log2(n: int) -> int:
    return int(n).bit_length() - 1


def _mat(kind: int, n: int, device):
    src = rom.tr_matrix(kind, n)
    key = (kind, n, str(device))
    hit = _MAT_CACHE.get(key)
    if hit is None or hit[0] is not src:
        t = torch.as_tensor(np.asarray(src, np.float64), device=device)
        hit = (src, t)
        _MAT_CACHE[key] = hit
    return hit[1]


def _mm(a, b):
    """Exact integer product of float64 operands, back to int32."""
    return torch.matmul(a, b).round().to(torch.int32)


def _ts_fwd(resi, h: int, w: int, bd: int):
    """Transform skip: the residual shifted up by transform_shift."""
    ts = rom.transform_shift(_log2(w), _log2(h), bd)
    return (resi.to(torch.int32) << ts).clamp(COEFF_MIN, COEFF_MAX)


def _ts_inv(coef, h: int, w: int, bd: int):
    """Transform skip's inverse: a rounding shift down by transform_shift."""
    ts = rom.transform_shift(_log2(w), _log2(h), bd)
    c = coef.to(torch.int32)
    if ts > 0:
        c = (c + (1 << (ts - 1))) >> ts
    return c.clamp(COEFF_MIN, COEFF_MAX)


def forward_transform(resi, h: int, w: int, kind_h: int = rom.DCT2,
                      kind_v: int = rom.DCT2, bd: int = 8):
    if kind_h == rom.IDT:
        return _ts_fwd(resi, h, w, bd)
    dev = resi.device
    mh = _mat(kind_v, h, dev)
    mw = _mat(kind_h, w, dev)
    st1 = _log2(w) + bd - 9
    st2 = _log2(h) + 6
    x = resi.to(torch.float64)
    e = (_mm(x, mw.T) + (1 << (st1 - 1))) >> st1
    c = (_mm(mh, e.to(torch.float64)) + (1 << (st2 - 1))) >> st2
    return c.clamp(COEFF_MIN, COEFF_MAX)


def inverse_transform(coef, h: int, w: int, kind_h: int = rom.DCT2,
                      kind_v: int = rom.DCT2, bd: int = 8):
    if kind_h == rom.IDT:
        return _ts_inv(coef, h, w, bd)
    dev = coef.device
    mh = _mat(kind_v, h, dev)
    mw = _mat(kind_h, w, dev)
    st2 = 20 - bd
    c = coef.to(torch.float64)
    e = ((_mm(mh.T, c) + 64) >> 7).clamp(COEFF_MIN, COEFF_MAX)
    x = (_mm(e.to(torch.float64), mw) + (1 << (st2 - 1))) >> st2
    return x.clamp(COEFF_MIN, COEFF_MAX)


_Q_SCALES = np.asarray(rom.QUANT_SCALES, np.int32)
_IQ_SCALES = np.asarray(rom.INV_QUANT_SCALES, np.int32)


def _bitlen15(a):
    """Bit length of 0 <= a < 2^15 (levels are COEFF_MAX-clipped)."""
    return torch.frexp(a.to(torch.float32)).exponent.to(torch.int32)


def quantize(coef, h: int, w: int, qp: int, intra: bool = True, bd: int = 8,
             rdoq: bool = False, lam_rd: int = 0, dq: bool = False):
    if dq:
        return quantize_dq(coef, h, w, qp, lam_rd, bd)
    if rdoq:
        return quantize_rdoq_j(coef, h, w, qp, lam_rd, bd)
    ts = rom.transform_shift(_log2(w), _log2(h), bd)
    q_bits = rom.QUANT_SHIFT + qp // 6 + ts
    scale = int(_Q_SCALES[qp % 6])
    f = (171 if intra else 85) << (q_bits - 9)
    c = coef.to(torch.int32)
    level = ((c.abs() * scale + f) >> q_bits).clamp(0, COEFF_MAX)
    return torch.sign(c) * level


def quantize_rdoq_j(coef, h: int, w: int, qp: int, lam_rd: int, bd: int = 8):
    """RDOQ: floor or floor + 1 per coefficient by the integer RD cost
    (twin of the reference's int32 arithmetic)."""
    ts = rom.transform_shift(_log2(w), _log2(h), bd)
    q_bits = rom.QUANT_SHIFT + qp // 6 + ts
    scale = int(_Q_SCALES[qp % 6])
    dq_shift = bd + ((_log2(w) + _log2(h)) >> 1) - 9
    dq_scale = int(_IQ_SCALES[qp % 6]) << (qp // 6)
    lam = min(int(lam_rd) << max(2 * ts, 0), 1 << 25)

    c = coef.to(torch.int32)
    a = c.abs()
    l_a = ((a * scale) >> q_bits).clamp(0, COEFF_MAX)
    l_b = (l_a + 1).clamp(0, COEFF_MAX)

    def cost(lv):
        deq = ((lv * dq_scale + (1 << (dq_shift - 1))) >> dq_shift).clamp(
            COEFF_MIN, COEFF_MAX)
        err = (a - deq).abs().clamp(max=30000)
        rate = torch.where(lv > 0, 2 + 2 * _bitlen15(lv),
                           torch.zeros_like(lv))
        return err * err + lam * rate

    lev = torch.where(cost(l_b) < cost(l_a), l_b, l_a)
    return torch.sign(c) * lev


def _net_shift(t, net: int):
    """Exact (t << net) for net >= 0 (with saturation pre-clip) or rounded
    (t + 2^(|net|-1)) >> |net| for net < 0."""
    if net >= 0:
        lim = 1 << (30 - net)
        return t.clamp(-lim, lim) << net
    rnd = 1 << (-net - 1)
    return (t + rnd) >> -net


def dequantize(level, h: int, w: int, qp: int, bd: int = 8,
               dq: bool = False):
    if dq:
        return dequantize_dq(level, h, w, qp, bd)
    shift = bd + ((_log2(w) + _log2(h)) >> 1) - 9
    iq = int(_IQ_SCALES[qp % 6])
    t = level.to(torch.int32) * iq
    return _net_shift(t, qp // 6 - shift).clamp(COEFF_MIN, COEFF_MAX)


def reconstruct(pred, level, h: int, w: int, qp: int,
                kind_h: int = rom.DCT2, kind_v: int = rom.DCT2, bd: int = 8,
                dq: bool = False):
    """Shared enc/dec reconstruction (zero levels reduce to pred exactly)."""
    resi = inverse_transform(dequantize(level, h, w, qp, bd, dq=dq), h, w,
                             kind_h, kind_v, bd)
    return (pred.to(torch.int32) + resi).clamp(0, (1 << bd) - 1)


# ---------------------------------------------------------------------------
# Dependent quantization (twins of the reference's dq_states_j /
# dequantize_dq_j / quantize_dq_j): the decoder's state walk is a
# log-depth composition of the 4-state transition maps, the encoder's
# trellis the hand kernel of kernels/dq.py.  Both take any leading batch
# axes over (h, w) blocks.
# ---------------------------------------------------------------------------

_SCAN_XY: dict = {}


def _scan_xy(log2w: int, log2h: int):
    """Walk-ordered (reverse diagonal scan) x/y index arrays (numpy)."""
    key = (log2w, log2h)
    if key not in _SCAN_XY:
        scan = rom.scan_order(log2w, log2h)
        xs = np.asarray([p[0] for p in scan], np.int32)[::-1].copy()
        ys = np.asarray([p[1] for p in scan], np.int32)[::-1].copy()
        _SCAN_XY[key] = (xs, ys)
    return _SCAN_XY[key]


_WALK: dict = {}


def _walk(h: int, w: int):
    """(walk-order raster index, its inverse) as int64 numpy arrays: the
    raster position of walk step j, and the walk step of each raster
    position."""
    key = (h, w)
    if key not in _WALK:
        xs, ys = _scan_xy(_log2(w), _log2(h))
        fwd = (ys.astype(np.int64) * w + xs)
        inv = np.empty_like(fwd)
        inv[fwd] = np.arange(fwd.size)
        _WALK[key] = (fwd, inv)
    return _WALK[key]


_DQ_MAPS = np.asarray(DQ_MAPS, np.int64)


def dq_states(level, h: int, w: int):
    """(..., h, w) int32 quantizer-state planes (twin of dq_states_j): the
    state before each position of the walk, from state 0.  The prefix
    compositions of the per-position maps come from log2(h * w) doubling
    steps."""
    fwd, inv = _walk(h, w)
    dev = level.device
    lead = level.shape[:-2]
    lv = level.reshape(-1, h * w)
    par = (lv.abs()[:, const(fwd, dev)] & 1).long()       # (B, n) walk
    cum = const(_DQ_MAPS, dev)[par]                       # (B, n, 4)
    n = h * w
    d = 1
    while d < n:
        # cum[j] <- cum[j] after cum[j - d]
        cum = torch.cat([cum[:, :d], torch.gather(cum[:, d:], 2,
                                                  cum[:, :-d])], 1)
        d *= 2
    st = torch.cat([torch.zeros_like(cum[:, :1, 0]), cum[:, :-1, 0]], 1)
    return st[:, const(inv, dev)].to(torch.int32).reshape(*lead, h, w)


def dequantize_dq(level, h: int, w: int, qp: int, bd: int = 8):
    """State-dependent dequantization (twin of dequantize_dq_j)."""
    shift = bd + ((_log2(w) + _log2(h)) >> 1) - 9
    iq = int(_IQ_SCALES[qp % 6])
    st = dq_states(level, h, w)
    lv = level.to(torch.int32)
    off = ((st > 1) & (lv != 0)).to(torch.int32) * torch.sign(lv)
    t = (2 * lv - off) * iq
    return _net_shift(t, qp // 6 - (shift + 1)).clamp(COEFF_MIN, COEFF_MAX)


def dq_params(h: int, w: int, qp: int, lam_rd: int, bd: int = 8):
    """dq_trellis's scalars for (h, w) blocks: (forward scale, forward
    shift, inverse scale, the dequantizer's net shift, lambda scaled by
    the transform shift and clamped to 2^22)."""
    ts = rom.transform_shift(_log2(w), _log2(h), bd)
    shift = bd + ((_log2(w) + _log2(h)) >> 1) - 9
    return (int(_Q_SCALES[qp % 6]), rom.QUANT_SHIFT + qp // 6 + ts,
            int(_IQ_SCALES[qp % 6]), qp // 6 - (shift + 1),
            min(int(lam_rd) << max(2 * ts, 0), 1 << 22))


_WALK32: dict = {}


def walk32(h: int, w: int):
    """The walk table of (h, w) blocks as int32 numpy, the trellis
    kernel's index input: the raster position of each walk step."""
    key = (h, w)
    if key not in _WALK32:
        _WALK32[key] = _walk(h, w)[0].astype(np.int32)
    return _WALK32[key]


def quantize_dq(coef, h: int, w: int, qp: int, lam_rd: int, bd: int = 8):
    """Trellis dependent quantization of (..., h, w) coefficients (twin of
    quantize_dq_j): one dq_trellis over every block, which gathers into
    walk order, quantizes, signs and scatters back."""
    from .dq import dq_trellis      # dq builds on this module's helpers
    c = coef.reshape(-1, h, w).to(torch.int32)
    lev = dq_trellis(c, const(walk32(h, w), coef.device),
                     *dq_params(h, w, qp, lam_rd, bd))
    return lev.reshape(coef.shape)


# ---------------------------------------------------------------------------
# MTS / LFNST RD selection (twin of the reference's choose_tx_j family)
# ---------------------------------------------------------------------------


def level_rate_est(lev, dims=None):
    """Integer rate proxy (nonzero count + bit lengths), int32; ``dims``
    are the reduced axes (default all)."""
    a = lev.abs()
    dims = tuple(range(a.dim())) if dims is None else dims
    return ((a > 0).sum(dims, dtype=torch.int32)
            + _bitlen15(a).sum(dims, dtype=torch.int32))


def level_rate_fp(lev, w, dims=None):
    """Fractional-bit (8.8) level rate; ``w`` the (4,) int32 level weights
    (w_nnz, w_ge2, w_ge4, w_dbl) of ``lvl_weights``."""
    a = lev.abs()
    dims = tuple(range(a.dim())) if dims is None else dims
    nnz = (a > 0).sum(dims, dtype=torch.int32)
    ge2 = (a >= 2).sum(dims, dtype=torch.int32)
    ge4 = (a >= 4).sum(dims, dtype=torch.int32)
    dbl = (_bitlen15(a) - 3).clamp(min=0).sum(dims, dtype=torch.int32)
    return nnz * w[0] + ge2 * w[1] + ge4 * w[2] + dbl * w[3]


def _rd_cost(dist, rate_fp, lam: int):
    """dist + lam * rate_fp / 256 in wrapping int32, split so that
    lam * rate stays in range (twin of the reference's _rd_cost_j)."""
    r = rate_fp.clamp(max=1 << 22)
    return dist + lam * (r >> 8) + ((lam * (r & 255)) >> 8)


_LFNST_CACHE: dict = {}


def _lfnst_mats(device):
    """(4, 2, 16, 16) float64 forward LFNST kernels (set, kernel), read
    from rom.lfnst_matrix at call time."""
    srcs = tuple(rom.lfnst_matrix(si, ki) for si in range(rom.LFNST_SETS)
                 for ki in range(2))
    key = str(device)
    hit = _LFNST_CACHE.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], srcs)):
        t = torch.as_tensor(np.stack(srcs).astype(np.float64),
                            device=device).reshape(rom.LFNST_SETS, 2, 16, 16)
        hit = _LFNST_CACHE[key] = (srcs, t)
    return hit[1]


def _lfnst_set(mode):
    """(set index int32, transpose bool) per row of (B,) luma modes."""
    tr = mode > rom.DIA_IDX
    m = torch.where(tr, 68 - mode, mode)
    s = torch.where(mode <= rom.DC_IDX, 0,
                    torch.where(m <= 12, 1, torch.where(m <= 23, 2, 3)))
    return s.to(torch.int32), tr & (mode > rom.DC_IDX)


def _lfnst_fwd4(sub, kmat, tr):
    """Forward LFNST of (..., 4, 4) corners with (..., 16, 16) kernels;
    ``tr`` (broadcast to the corners) transposes the input."""
    sub = torch.where(tr[..., None, None], sub.transpose(-1, -2), sub)
    t = _mm(kmat, sub.reshape(*sub.shape[:-2], 16, 1).to(torch.float64))
    return ((t.reshape(sub.shape) + 64) >> 7).clamp(COEFF_MIN, COEFF_MAX)


def _lfnst_inv4(sub, kmat, tr):
    """Inverse LFNST of (..., 4, 4) corners (kernel transposed)."""
    v = _mm(kmat.transpose(-1, -2),
            sub.reshape(*sub.shape[:-2], 16, 1).to(torch.float64))
    out = ((v.reshape(sub.shape) + 64) >> 7).clamp(COEFF_MIN, COEFF_MAX)
    return torch.where(tr[..., None, None], out.transpose(-1, -2), out)


def _corner(sub, like):
    """``like``-shaped zeros with ``sub`` in the top-left 4x4 corner."""
    out = torch.zeros_like(like)
    out[..., :4, :4] = sub
    return out


def fwd_lfnst(coef, kernel: int, mode):
    """Forward secondary transform of (B, h, w) primary coefficients with
    kernel ``kernel`` (lfnst_idx - 1) of each row's mode set; only the
    4x4 corner survives."""
    s_idx, tr = _lfnst_set(mode.to(torch.int32))
    kmat = _lfnst_mats(coef.device)[s_idx.long(), kernel]
    return _corner(_lfnst_fwd4(coef[..., :4, :4], kmat, tr), coef)


def inv_lfnst(coef, kernel: int, mode):
    """Inverse secondary transform (inverse = transposed kernel)."""
    s_idx, tr = _lfnst_set(mode.to(torch.int32))
    kmat = _lfnst_mats(coef.device)[s_idx.long(), kernel]
    return _corner(_lfnst_inv4(coef[..., :4, :4], kmat, tr), coef)


def inv_lfnst_switch(coef, lfnst_idx, mode):
    """Per-row inverse LFNST by a (B,) index (0 = identity, clamped to
    0..2): one gather of each row's kernel, one batched product."""
    idx = lfnst_idx.to(torch.int32).clamp(0, 2)
    s_idx, tr = _lfnst_set(mode.to(torch.int32))
    kmat = _lfnst_mats(coef.device)[s_idx.long(),
                                    (idx - 1).clamp(min=0).long()]
    inv = _corner(_lfnst_inv4(coef[..., :4, :4], kmat, tr), coef)
    return torch.where((idx > 0)[:, None, None], inv, coef)


_TX_CONST: dict = {}


def _tx_const(cands: tuple, s: int, device):
    """(C, s, s) float64 stacks of each candidate's vertical and
    horizontal primary kernels (LFNST candidates ride the DCT-II pair, and
    so does transform skip, index 5, whose results are overwritten), read
    from rom.tr_matrix at call time."""
    pairs = [MTS_SET[0 if mk == 5 else mk] for mk, _ in cands]
    srcs = tuple(rom.tr_matrix(k, s) for kh, kv in pairs for k in (kv, kh))
    key = (cands, s, str(device))
    hit = _TX_CONST.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], srcs)):
        mh = torch.stack([_mat(kv, s, device) for kh, kv in pairs])
        mw = torch.stack([_mat(kh, s, device) for kh, kv in pairs])
        hit = _TX_CONST[key] = (srcs, mh, mw)
    return hit[1], hit[2]


_MTS_ROWS = tuple((k, 0) for k in range(5))


def inverse_transform_rows(coef, s: int, midx, bd: int = 8):
    """inverse_transform of (B, s, s) coefficients with each row's MTS
    pair MTS_SET[midx] ((B,) index): a gather of the kernels and one
    batched product pair; rows of index 5 (transform skip) take its
    rounding shift instead."""
    mh, mw = _tx_const(_MTS_ROWS, s, coef.device)
    i = midx.long().clamp(0, 4)
    gh, gw = mh[i], mw[i]
    st2 = 20 - bd
    e = ((_mm(gh.transpose(-1, -2), coef.to(torch.float64)) + 64) >> 7) \
        .clamp(COEFF_MIN, COEFF_MAX)
    x = ((_mm(e.to(torch.float64), gw) + (1 << (st2 - 1))) >> st2).clamp(
        COEFF_MIN, COEFF_MAX)
    return torch.where((midx == 5)[:, None, None], _ts_inv(coef, s, s, bd),
                       x)


def tx_bits(qp: int):
    """``estimate.tx_bits(qp)``: the host tables of the MTS / LFNST / SBT
    index bits and the level-rate weights (8.8); the flat tables under
    VVCTPU_FLAT_BITS, read at call time since ``decision_bits``' cache
    is not keyed on that switch."""
    return est._flat_tables() if est.flat_bits() else est.tx_bits(qp)


_LVL_W: dict = {}


def lvl_weights(qp: int, device):
    """``tx_bits(qp).lvl_w`` as a (4,) int32 tensor on ``device``, built
    once per (qp, device, flat-bits switch)."""
    key = (int(qp), str(device), est.flat_bits())
    hit = _LVL_W.get(key)
    if hit is None:
        hit = _LVL_W[key] = torch.as_tensor(
            np.asarray(tx_bits(qp).lvl_w, np.int32), device=device)
    return hit


_CAND_CONST: dict = {}


def _cand_const(cands: tuple, mts: bool, lfnst: bool, ts: bool, qp: int,
                device):
    """Per-candidate device constants of choose_tx, built once per
    (candidates, qp, device) so that no call uploads from the host: the
    index bits (8.8; the transform index is coded with MTS or transform
    skip, the LFNST index after DCT-II only), the non-DCT-II mask and the
    (mts, lfnst) index of each candidate."""
    key = (cands, mts, lfnst, ts, int(qp), str(device), est.flat_bits())
    hit = _CAND_CONST.get(key)
    if hit is None:
        tb = tx_bits(qp)
        mts_fp, lfnst_fp = tb.mts_fp, tb.lfnst_fp
        bits = np.asarray([(int(mts_fp[mk]) if mts or ts else 0)
                           + (int(lfnst_fp[lk]) if lfnst and mk == 0 else 0)
                           for mk, lk in cands], np.int32)
        pen = np.asarray([(mk, lk) != (0, 0) for mk, lk in cands])
        idx = np.asarray(cands, np.int32)
        hit = _CAND_CONST[key] = tuple(
            torch.as_tensor(a, device=device) for a in (bits, pen, idx))
    return hit


def choose_tx(resi, s: int, qp: int, lam_rd: int, mode, bd: int = 8,
              mts: bool = True, lfnst: bool = False, rdoq: bool = False,
              allow=None, dq: bool = False, ts: bool = False):
    """Joint MTS/TS/LFNST RD choice for (B, s, s) luma residuals with (B,)
    modes: every candidate of ``tx_candidates(mts, lfnst, ts)`` is
    transformed, quantised, reconstructed and costed in one stacked pass,
    and the first minimum in candidate order wins.  Transform skip (index
    5, after the MTS pairs) is the residual shifted by transform_shift.
    ``allow`` ((B,) bool, optional): where False every candidate but
    DCT-II alone costs 2^29 more (MIP leaves).  Returns (mts_idx (B,),
    lfnst_idx (B,), levels (B, s, s), reconstructed residual (B, s, s)),
    int32."""
    dev = resi.device
    cands = tuple(tx_candidates(mts, lfnst, ts))
    # transform skip's slot sits between the MTS and LFNST candidates
    ti = cands.index((5, 0)) if ts else None
    # the two LFNST candidates come last and ride the DCT-II primaries
    ls = slice(len(cands) - 2, len(cands)) if lfnst else None
    B = resi.shape[0]
    mh, mw = _tx_const(cands, s, dev)
    bits, pen, idx_c = _cand_const(cands, mts, lfnst, ts, qp, dev)

    st1 = _log2(s) + bd - 9
    st2 = _log2(s) + 6
    x = resi.to(torch.int32)
    e = (_mm(x.to(torch.float64)[:, None], mw.transpose(1, 2))
         + (1 << (st1 - 1))) >> st1
    coef = ((_mm(mh, e.to(torch.float64)) + (1 << (st2 - 1))) >> st2) \
        .clamp(COEFF_MIN, COEFF_MAX)                      # (B, C, s, s)
    if lfnst:
        s_idx, tr = _lfnst_set(mode.to(torch.int32))
        kmat = _lfnst_mats(dev)[s_idx.long()]             # (B, 2, 16, 16)
        tr2 = tr[:, None].expand(B, 2)
        coef[:, ls] = _corner(_lfnst_fwd4(coef[:, :1, :4, :4].expand(
            B, 2, 4, 4), kmat, tr2), coef[:, ls])
    if ts:
        coef[:, ti] = _ts_fwd(x, s, s, bd)

    lev = quantize(coef, s, s, qp, intra=True, bd=bd, rdoq=rdoq,
                   lam_rd=lam_rd, dq=dq)
    dqc = dequantize(lev, s, s, qp, bd, dq=dq)
    if lfnst:
        dqc[:, ls] = _corner(_lfnst_inv4(dqc[:, ls, :4, :4], kmat, tr2),
                             dqc[:, ls])

    st2i = 20 - bd
    ei = ((_mm(mh.transpose(1, 2), dqc.to(torch.float64)) + 64) >> 7) \
        .clamp(COEFF_MIN, COEFF_MAX)
    rec = ((_mm(ei.to(torch.float64), mw) + (1 << (st2i - 1))) >> st2i) \
        .clamp(COEFF_MIN, COEFF_MAX)
    if ts:
        rec[:, ti] = _ts_inv(dqc[:, ti], s, s, bd)

    dist = ((x[:, None] - rec) ** 2).sum((-2, -1), dtype=torch.int32)
    rate_fp = level_rate_fp(lev, lvl_weights(qp, dev), dims=(-2, -1)) + bits
    costs = _rd_cost(dist, rate_fp, lam_rd)
    if allow is not None:
        costs = costs + ((pen[None] & ~allow[:, None]).to(torch.int32)
                         << 29)
    idx = torch.argmin(costs, dim=1)
    rows = torch.arange(B, device=dev)
    return (idx_c[idx, 0], idx_c[idx, 1], lev[rows, idx], rec[rows, idx])


def choose_mts(resi, s: int, qp: int, lam_rd: int, bd: int = 8):
    """(mts_idx, levels, reconstructed residual): the MTS-only RD choice
    (choose_tx without LFNST)."""
    midx, _, lev, rec = choose_tx(
        resi, s, qp, lam_rd,
        torch.zeros(resi.shape[0], dtype=torch.int32, device=resi.device),
        bd, mts=True, lfnst=False)
    return midx, lev, rec


# ---------------------------------------------------------------------------
# SBT (twins of the reference's choose_sbt_j / sbt_resi_j), batched over
# leaves
# ---------------------------------------------------------------------------


def _sbt_rec(lev_s, idx: int, s: int, qp: int, bd: int, dq: bool):
    """Dequantised and inverse-transformed (B, h, w) levels of SBT
    region ``idx``, zero-padded into (B, s, s)."""
    x0, y0, w, h = sbt_region(idx, s)
    kh, kv = sbt_kernels(idx)
    r = inverse_transform(dequantize(lev_s, h, w, qp, bd, dq=dq), h, w,
                          kh, kv, bd)
    return _pad_region(r, x0, y0, s)


def _pad_region(sub, x0: int, y0: int, s: int):
    out = sub.new_zeros((sub.shape[0], s, s))
    out[:, y0:y0 + sub.shape[1], x0:x0 + sub.shape[2]] = sub
    return out


def choose_sbt(resi, s: int, qp: int, lam_rd: int, bd: int = 8,
               rdoq: bool = False, dq: bool = False):
    """SBT RD choice for (B, s, s) inter luma residuals: the full DCT-II
    and the four half transforms, each quantised and reconstructed, the
    first minimum of the RD cost in index order, an all-zero winner
    collapsed to 0.  Returns (sbt_idx (B,), levels (B, s, s),
    reconstructed residual (B, s, s)), int32."""
    dev = resi.device
    x = resi.to(torch.int32)
    sbt_fp = tx_bits(qp).sbt_fp
    lw = lvl_weights(qp, dev)
    costs, levs, recs = [], [], []
    for idx in range(5):
        x0, y0, w, h = sbt_region(idx, s)
        kh, kv = sbt_kernels(idx)
        coef = forward_transform(x[:, y0:y0 + h, x0:x0 + w], h, w, kh, kv,
                                 bd)
        lev_s = quantize(coef, h, w, qp, intra=True, bd=bd, rdoq=rdoq,
                         lam_rd=lam_rd, dq=dq)
        rec = _sbt_rec(lev_s, idx, s, qp, bd, dq)
        dist = ((x - rec) ** 2).sum((-2, -1), dtype=torch.int32)
        rate_fp = level_rate_fp(lev_s, lw, dims=(-2, -1)) + int(sbt_fp[idx])
        costs.append(_rd_cost(dist, rate_fp, lam_rd))
        levs.append(_pad_region(lev_s, x0, y0, s))
        recs.append(rec)
    i = torch.argmin(torch.stack(costs, 1), dim=1)
    rows = torch.arange(x.shape[0], device=dev)
    lev = torch.stack(levs, 1)[rows, i]
    rec = torch.stack(recs, 1)[rows, i]
    i = torch.where(lev.flatten(1).any(1), i, torch.zeros_like(i))
    return i.to(torch.int32), lev, rec


def sbt_resi(lev_full, sbt_idx, s: int, qp: int, bd: int = 8,
             dq: bool = False):
    """Residual of (B, s, s) SBT level blocks: each leaf's region (index
    0 the full DCT-II) dequantised and inverse-transformed, zero
    elsewhere.  sbt_idx: the (B,) indices as a host array (the decoder's
    parsed slot column), by which the leaves are grouped."""
    idx_np = np.clip(np.asarray(sbt_idx), 0, 4)
    out = lev_full.new_zeros(lev_full.shape)
    for idx in np.unique(idx_np):
        ri = torch.as_tensor(np.nonzero(idx_np == idx)[0],
                             device=lev_full.device)
        x0, y0, w, h = sbt_region(int(idx), s)
        out[ri] = _sbt_rec(lev_full[ri, y0:y0 + h, x0:x0 + w], int(idx), s,
                           qp, bd, dq)
    return out
