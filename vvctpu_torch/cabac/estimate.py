"""Fractional-bit CABAC rate estimates for the encoder decision passes.

Role of VTM's BinEncoder "estimate mode" + RdCost fractional-bit tables
(VTM:EncoderLib/BinEncoder.h BinEst / CABACWriter estimate calls): mode,
split and transform-index decisions are charged the *fractional* number of
bits the arithmetic coder would actually spend, derived from the
two-hypothesis context states, instead of the flat integer guesses used in
rounds 1-3 (spec/decide.py MODE_BITS et al.).

Design constraints honoured here (SURVEY.md §7.3.2 batched decisions):

* The decision pass is a pure batched function of the original frame, so
  per-block context adaptation is unavailable; estimates are computed from
  the CONTEXT-INIT states at the slice's (slice_type, qp) — VTM's estimate
  state at slice start.  Because init states depend on qp, the tables
  refresh with every frame's QP (temporal-layer offsets) while remaining a
  pure function both engines compute identically.
* All values are 8.8 fixed-point "fractional bits"; decision costs use
  ``(bits_fp * lam) >> 8`` so the spec (int64 numpy) and device (int32
  jnp) twins stay bit-identical.
* ``VVCTPU_FLAT_BITS=1`` reproduces the round-3 flat tables exactly (A/B
  harness for tools/ladder.py).

Init-state closed form (engine.py CtxState): p0 = pre << 3, p1 = pre << 7
=> state = (p0 << 4) + p1 = pre << 8, with
pre = clip(1, 127, ((m * (clip(0,63,qp) - 32)) >> 4) + n + 64).
"""
from __future__ import annotations

import functools
import math
import os

import numpy as np

from . import contexts as C

FP = 256          # 8.8 fixed point
_MAX_FP = 2304    # cap: 9 bits (p = 1/512)

# FRAC_TBL[i]: bits (8.8) to code a bin whose probability is
# ((i << 7) + 64) / 32768 = (2i + 1) / 512  — indexed by state >> 7.
FRAC_TBL = np.array(
    [min(_MAX_FP, round(-math.log2((2 * i + 1) / 512.0) * FP))
     for i in range(256)], np.int32)


def flat_bits() -> bool:
    return bool(os.environ.get("VVCTPU_FLAT_BITS"))


def init_state(init_value: int, qp: int) -> int:
    """15-bit init probability state (closed form of CtxState.__init__)."""
    slope_idx, offset_idx = init_value >> 4, init_value & 15
    m = slope_idx * 5 - 45
    n = (offset_idx << 3) - 16
    q = 0 if qp < 0 else 63 if qp > 63 else qp
    pre = ((m * (q - 32)) >> 4) + n
    pre = 1 if pre < 1 else 127 if pre > 127 else pre
    return pre << 8


def fb(state: int, binval: int) -> int:
    """Fractional bits (8.8) of coding ``binval`` in a ctx at ``state``."""
    idx = (state if binval else (32767 - state)) >> 7
    return int(FRAC_TBL[idx])


@functools.lru_cache(maxsize=256)
def _ctx_fb(slice_type: int, qp: int):
    """(n_ctx, 2) int32: fractional bits of bin 0/1 per context at init."""
    iv, _ = C.R.tables(slice_type)
    out = np.zeros((len(iv), 2), np.int32)
    for i, v in enumerate(iv):
        s = init_state(int(v), qp)
        out[i, 0] = fb(s, 0)
        out[i, 1] = fb(s, 1)
    return out


class DecisionBits:
    """Per-(slice_type, qp) fractional-bit tables for the decision pass.

    All fields are 8.8 fixed point; scalars are plain ints, arrays int64
    (spec) — the device twins convert to int32 (values < 2^15 so both
    ``(bits_fp * lam) >> 8`` paths agree exactly)."""

    __slots__ = ("mode_fp", "split_fp", "leaf_fp", "bt_fp", "tt_fp",
                 "bt32_fp", "mrl1_fp", "mrl2_fp", "mrl0_fp", "isp0_fp",
                 "ispd_fp", "mip0_fp", "ibc_fp", "aff_fp", "gpm_fp",
                 "amvr_fp", "bcw_fp", "mts_fp", "lfnst_fp", "sbt_fp",
                 "lvl_w")


def _flat_tables() -> DecisionBits:
    """Round-3 flat integer tables expressed in 8.8 (byte-identical A/B)."""
    from ..spec import decide as sdec
    from ..spec import inter as sinter
    from ..spec import transform as stf
    B = DecisionBits()
    B.mode_fp = sdec.MODE_BITS.astype(np.int64) * FP
    B.split_fp = 4 * sdec.SPLIT_BITS * FP     # charged once per QT split
    B.leaf_fp = sdec.BT_LEAF_BITS * FP
    B.bt_fp = sdec.BT_BITS * FP
    B.tt_fp = sdec.TT_BITS * FP
    B.bt32_fp = sdec.TT_BITS * FP             # bt at 32 when TT on (+tt=0)
    B.mrl0_fp = 1 * FP           # the old "+int(mrl)" extra on base cands
    B.mrl1_fp = 2 * FP
    B.mrl2_fp = 2 * FP
    B.isp0_fp = 1 * FP           # the old "+int(isp)" extra on base cands
    B.ispd_fp = 2 * FP
    B.mip0_fp = 0
    from ..spec.codec import IBC_BITS
    B.ibc_fp = IBC_BITS * FP
    B.aff_fp = sinter.AFF_BITS * FP
    B.gpm_fp = sdec.GPM_BITS * FP
    B.amvr_fp = tuple(b * FP for b in sinter.AMVR_BITS)
    B.bcw_fp = tuple(b * FP for b in sinter.BCW_IDX_BITS)
    B.mts_fp = tuple(b * FP for b in stf.MTS_IDX_BITS)
    B.lfnst_fp = tuple(b * FP for b in stf.LFNST_IDX_BITS)
    B.sbt_fp = tuple(b * FP for b in stf.SBT_IDX_BITS)
    B.lvl_w = (2 * FP, FP, FP, FP)   # == level_rate_est << 8 exactly
    return B


@functools.lru_cache(maxsize=256)
def decision_bits(slice_type: int, qp: int) -> DecisionBits:
    """Fractional-bit decision tables from the context-init states."""
    if flat_bits():
        return _flat_tables()
    t = _ctx_fb(slice_type, qp)

    def b(cs, inc, v):
        return int(t[cs(inc), v])

    from ..core import rom
    B = DecisionBits()

    # --- intra mode syntax (spec/codec.py code_mode) --------------------
    # mpm hit: mpm_flag=1 + planar_flag (+ TU index bins, bypass).  The
    # batched pass can't know the neighbour-built MPM list; structural
    # priors: planar is always mpm[0]; DC/H/V/2/66/DIA are frequent list
    # members (expected index ~2 -> 2 bypass bins); generic angular modes
    # pay the miss path (mpm_flag=0 + ~6-bin truncated-binary remainder:
    # 3 syms at 5, 58 at 6 -> 1523 fp).
    mpm1 = b(C.INTRA_MPM_FLAG, 0, 1)
    mpm0 = b(C.INTRA_MPM_FLAG, 0, 0)
    pl1 = b(C.INTRA_PLANAR_FLAG, 0, 1)
    pl0 = b(C.INTRA_PLANAR_FLAG, 0, 0)
    n_modes = rom.NUM_LUMA_MODE
    mode_fp = np.full(n_modes + 2 * rom.NUM_MIP_MODES,
                      mpm0 + 1523, np.int64)
    mode_fp[rom.PLANAR_IDX] = mpm1 + pl1
    mode_fp[rom.DC_IDX] = mpm1 + pl0 + 1 * FP       # expected idx ~1
    for m in (rom.HOR_IDX, rom.VER_IDX, rom.DIA_IDX, 2, 66):
        mode_fp[m] = mpm1 + pl0 + 3 * FP            # expected idx ~3
    # MIP: mip_flag (4 neighbour ctxs; use inc 1) + transpose + 3-bit id;
    # regular modes pay the mip_flag=0 bin via B.mip0_fp (base cands only)
    mode_fp[n_modes:] = b(C.MIP_FLAG, 1, 1) + 4 * FP
    B.mode_fp = mode_fp

    # --- partition flags ------------------------------------------------
    # QT split at s: split=1 for the parent + split=0 for each child that
    # stays a leaf (lumped as in the round-3 tables: one charge per split
    # decision).  Ctx inc unknown at batch time -> middle ctx (inc 1).
    sp1 = b(C.SPLIT_QT_FLAG, 1, 1)
    sp0 = b(C.SPLIT_QT_FLAG, 1, 0)
    B.split_fp = sp1 + 4 * sp0
    B.leaf_fp = b(C.BT_FLAG, 1, 0)                  # bt_flag=0 on a leaf
    bt1 = b(C.BT_FLAG, 1, 1)
    # direction ~ equiprobable at batch time: integer mean of the 0/1 costs
    btd = (b(C.BT_DIR, 0, 0) + b(C.BT_DIR, 0, 1)) >> 1
    B.bt_fp = bt1 + btd
    tt1 = b(C.TT_FLAG, 0, 1)
    tt0 = b(C.TT_FLAG, 0, 0)
    B.tt_fp = bt1 + btd + tt1
    # when TT is on, a BT at 32 additionally codes tt=0; the caller picks
    # bt32_fp (TT on) vs bt_fp (TT off) at the 32 level
    B.bt32_fp = bt1 + btd + tt0

    # --- intra tool flags ----------------------------------------------
    B.mrl0_fp = b(C.MRL_IDX, 0, 0)
    B.mrl1_fp = b(C.MRL_IDX, 0, 1) + b(C.MRL_IDX, 1, 0)
    B.mrl2_fp = b(C.MRL_IDX, 0, 1) + b(C.MRL_IDX, 1, 1)
    B.isp0_fp = b(C.ISP_MODE, 0, 0)
    B.ispd_fp = (b(C.ISP_MODE, 0, 1)
                 + ((b(C.ISP_MODE, 1, 0) + b(C.ISP_MODE, 1, 1)) >> 1))
    B.mip0_fp = b(C.MIP_FLAG, 1, 0)
    B.ibc_fp = b(C.IBC_FLAG, 1, 1)

    # --- inter tool flags ----------------------------------------------
    B.aff_fp = b(C.AFF_FLAG, 0, 1)
    B.gpm_fp = b(C.GPM_FLAG, 0, 1) + 6 * FP + FP // 2   # flag + 6-bin idx
    am0 = b(C.AMVR_FLAG, 0, 0)
    am1 = b(C.AMVR_FLAG, 0, 1)
    B.amvr_fp = (am0, am1 + b(C.AMVR_PREC, 0, 0),
                 am1 + b(C.AMVR_PREC, 0, 1))
    B.bcw_fp = (b(C.BCW_IDX, 0, 1) + FP, b(C.BCW_IDX, 0, 0),
                b(C.BCW_IDX, 0, 1) + FP)   # idx0/idx2 pay the sign bin

    # --- transform indices ---------------------------------------------
    # truncated unary over ctx bins 0..4 (spec/codec.py _code_mts_idx)
    acc = 0
    mts_fp = []
    for k in range(6):
        if k < 5:
            mts_fp.append(acc + b(C.MTS_IDX, k, 0))
            acc += b(C.MTS_IDX, k, 1)
        else:
            mts_fp.append(acc)
    B.mts_fp = tuple(mts_fp)
    B.lfnst_fp = (b(C.LFNST_IDX, 0, 0),
                  b(C.LFNST_IDX, 0, 1) + b(C.LFNST_IDX, 1, 0),
                  b(C.LFNST_IDX, 0, 1) + b(C.LFNST_IDX, 1, 1))
    sb1 = b(C.SBT_FLAG, 0, 1) + 2 * FP      # flag + bypass dir/pos
    B.sbt_fp = (b(C.SBT_FLAG, 0, 0), sb1, sb1, sb1, sb1)

    # --- residual level-rate weights (level_rate_est) -------------------
    # cost(|l|=1)  = sig1 + gt1_0
    # cost(|l|=2)  = sig1 + gt1_1 + par + gt3_0
    # cost(|l|>=4) += gt3_1 - gt3_0 + rice bins (bypass, ~2/doubling)
    # Representative ctx: middle of each luma set (inc 6); exact integer
    # arithmetic so the device twin (tx_tables_j) reproduces it.
    sig1 = b(C.SIG_FLAG, C.SIG_LUMA_BASE + 6, 1)
    g1_0 = b(C.GT1_FLAG, C.GTX_LUMA_BASE + 6, 0)
    g1_1 = b(C.GT1_FLAG, C.GTX_LUMA_BASE + 6, 1)
    par_b = ((b(C.PAR_FLAG, C.GTX_LUMA_BASE + 6, 0)
              + b(C.PAR_FLAG, C.GTX_LUMA_BASE + 6, 1)) >> 1)
    g3_0 = b(C.GT3_FLAG, C.GTX_LUMA_BASE + 6, 0)
    g3_1 = b(C.GT3_FLAG, C.GTX_LUMA_BASE + 6, 1)
    w_nnz = sig1 + g1_0                          # every nonzero level
    w_ge2 = (g1_1 - g1_0) + par_b + g3_0         # extra for |l| >= 2
    w_ge4 = (g3_1 - g3_0) + 2 * FP               # extra for |l| >= 4
    w_dbl = 2 * FP                               # rice per doubling beyond
    B.lvl_w = (max(w_nnz, 1), max(w_ge2, 1), max(w_ge4, 1), w_dbl)
    return B


def tx_bits(qp: int) -> DecisionBits:
    """TB-level tables (mts/lfnst/sbt/level weights) — slice-type-free
    (those contexts share inits across slice types); used inside
    choose_tx where only qp is in scope."""
    return decision_bits(2, qp)
