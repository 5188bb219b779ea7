"""Context-model registry: named context sets with per-slice-type init values.

Plays the role of VTM:CommonLib/Contexts.cpp (ContextSetCfg) — one declarative
table from which both the writer and reader build identical context state, so
they cannot diverge (SURVEY.md §7.1 design principle).

Init-value *contents* are this project's own tuning (see engine.py docstring);
the slope/offset encoding matches the reference's scheme so a verified table
can be dropped in later without code changes.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# neutral init: slope 9 -> m = 0;  offset 10 -> n = 64  => pState ~ 0.5
NEUTRAL = (9 << 4) | 10
# biased inits (probability of "1" below/above half at init)
LOW = (9 << 4) | 6      # n = 32  -> p ~ 0.25
HIGH = (9 << 4) | 14    # n = 96  -> p ~ 0.75
DEFAULT_RATE = 4        # shift0 = 3, shift1 = 7


@dataclass(frozen=True)
class CtxSet:
    name: str
    offset: int
    size: int

    def __call__(self, inc: int = 0) -> int:
        assert 0 <= inc < self.size, (self.name, inc, self.size)
        return self.offset + inc


class _Registry:
    def __init__(self) -> None:
        self._sets: list[tuple[CtxSet, tuple[int, int, int], int]] = []
        self.total = 0

    def add(self, name: str, size: int, init=(NEUTRAL,) * 3,
            rate: int = DEFAULT_RATE) -> CtxSet:
        cs = CtxSet(name, self.total, size)
        self._sets.append((cs, tuple(init), rate))
        self.total += size
        return cs

    def tables(self, slice_type: int) -> tuple[np.ndarray, np.ndarray]:
        """(init_values, rates) arrays for the given slice type (0=B,1=P,2=I)."""
        iv = np.zeros(self.total, np.int32)
        rt = np.zeros(self.total, np.int32)
        for cs, init, rate in self._sets:
            iv[cs.offset:cs.offset + cs.size] = init[slice_type]
            rt[cs.offset:cs.offset + cs.size] = rate
        return iv, rt


R = _Registry()

_NAMES = None


def name_of(idx: int) -> str:
    """Syntax-class name owning a flat context index (bit statistics)."""
    global _NAMES
    if _NAMES is None or len(_NAMES) < R.total:
        _NAMES = [""] * R.total
        for cs, _, _ in R._sets:
            for i in range(cs.size):
                _NAMES[cs.offset + i] = cs.name
    return _NAMES[idx]

# --- coding tree ---------------------------------------------------------
SPLIT_QT_FLAG = R.add("split_qt_flag", 3, init=(NEUTRAL, NEUTRAL, HIGH))
SPLIT_CU_FLAG = R.add("split_cu_flag", 3)          # MTT split (reserved)
BT_FLAG = R.add("bt_split_flag", 2)                # binary split (16 / 32)
BT_DIR = R.add("bt_split_dir", 1)                  # 0 = horizontal halves
IBC_FLAG = R.add("ibc_flag", 2)                    # ctx by neighbour IBCness
PRED_MODE = R.add("pred_mode", 2)                  # intra/inter (reserved)

# --- inter ---------------------------------------------------------------
MVD_FLAG = R.add("mvd_flags", 2)                   # gt0, gt1 (shared x/y)
INTER_DIR = R.add("inter_dir", 1)                  # bi-prediction flag
MERGE_FLAG = R.add("merge_flag", 1)
MERGE_IDX = R.add("merge_idx", 1)
SKIP_FLAG = R.add("cu_skip_flag", 1)               # merge + zero residual
MMVD_FLAG = R.add("mmvd_merge_flag", 1)
MMVD_BASE = R.add("mmvd_cand_flag", 1)
MMVD_DIST = R.add("mmvd_distance_idx", 1)
BCW_IDX = R.add("bcw_idx", 1)                      # CU-level bi-pred weight
AMVR_FLAG = R.add("amvr_flag", 1)                  # MVD precision != 1/4 pel
AMVR_PREC = R.add("amvr_precision_idx", 1)         # integer vs 4-pel
SMVD_FLAG = R.add("sym_mvd_flag", 1)               # mirrored single MVD
CIIP_FLAG = R.add("ciip_flag", 1)                  # inter + planar blend
SBT_FLAG = R.add("sbt_flag", 1)                    # sub-block transform

# --- intra mode ----------------------------------------------------------
INTRA_MPM_FLAG = R.add("intra_luma_mpm_flag", 1, init=(HIGH,) * 3)
INTRA_PLANAR_FLAG = R.add("intra_luma_planar_flag", 1, init=(HIGH,) * 3)
INTRA_CHROMA_DM = R.add("intra_chroma_dm_flag", 1, init=(HIGH,) * 3)
MIP_FLAG = R.add("intra_mip_flag", 4)
ISP_MODE = R.add("intra_isp_mode", 2)
MRL_IDX = R.add("intra_mrl_idx", 2)

# --- residual ------------------------------------------------------------
CBF_LUMA = R.add("cbf_luma", 2, init=(HIGH,) * 3)
CBF_CB = R.add("cbf_cb", 1)
CBF_CR = R.add("cbf_cr", 2)
LAST_X = R.add("last_sig_x_prefix", 20, init=(LOW,) * 3)
LAST_Y = R.add("last_sig_y_prefix", 20, init=(LOW,) * 3)
CG_FLAG = R.add("coded_sub_block_flag", 4)        # 2 luma + 2 chroma
SIG_FLAG = R.add("sig_coeff_flag", 20)            # 12 luma + 8 chroma
GT1_FLAG = R.add("abs_level_gt1_flag", 20, init=(LOW,) * 3)
PAR_FLAG = R.add("par_level_flag", 20)
GT3_FLAG = R.add("abs_level_gt3_flag", 20, init=(LOW,) * 3)
TS_SIG = R.add("ts_sig_coeff_flag", 3)            # transform-skip (reserved)

# --- transforms / tools --------------------------------------------------
MTS_IDX = R.add("mts_idx", 5)   # TU cmax 5; index 5 = transform skip
JCCR_FLAG = R.add("tu_joint_cbcr_flag", 3)
LFNST_IDX = R.add("lfnst_idx", 3)

# --- loop filters (CTU-level flags; reserved until SAO/ALF land) ---------
SAO_MERGE = R.add("sao_merge_flag", 1)
SAO_TYPE = R.add("sao_type_idx", 1)
ALF_CTB_FLAG = R.add("alf_ctb_flag", 9)
GPM_FLAG = R.add("gpm_flag", 1)          # geometric partitioning (B leaves)
AFF_FLAG = R.add("affine_flag", 1)       # 4-parameter affine (uni leaves)
TT_FLAG = R.add("tt_split_flag", 1)      # ternary (vs binary) MTT split
PLT_FLAG = R.add("plt_flag", 2)          # palette mode (ctx by neighbours)
AFFM_FLAG = R.add("affine_merge_flag", 1)  # inherited affine merge

NUM_CTX = R.total

SIG_LUMA_BASE = 0     # offsets inside SIG_FLAG: luma [0,12), chroma [12,20)
SIG_CHROMA_BASE = 12
GTX_LUMA_BASE = 0
GTX_CHROMA_BASE = 12


def make_ctx_state(slice_type: int, qp: int):
    from .engine import CtxState
    iv, rt = R.tables(slice_type)
    return CtxState(iv, rt, qp)
