"""Transform-coefficient (residual) coding — single traversal for write+read.

Role of VTM:EncoderLib/CABACWriter.cpp residual_coding() and its mirror
VTM:DecoderLib/CABACReader.cpp, with the context-index derivation of
VTM:CommonLib/ContextModelling.cpp (CoeffCodingContext).  One traversal
function drives both directions through a direction-agnostic ``io`` adapter,
so writer and reader cannot diverge (SURVEY.md §7.1 design principle).

Structure per transform block (VVC pass layout, which is what makes the
vectorized device CABAC lanes possible later):
  1. last significant coefficient position (TR prefix ctx-coded + suffix)
  2. reverse-diagonal CG scan: coded_sub_block_flag
  3. per CG, pass 1 (reverse scan): sig / gt1 / par / gt3 flags (ctx-coded)
  4. per CG, pass 2: Golomb-Rice remainders (bypass)
  5. per CG, pass 3: sign bits (bypass)

Deviations this round (internally consistent): no dependent-quantisation state
in the sig context (scalar quant path), no regular-bin budget clamp.
"""
from __future__ import annotations

import numpy as np

from ..cabac import contexts as C

# last-position group tables (classic HEVC/VVC binarisation)
_MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24]
_GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
              8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9]


class EncIO:
    """Adapter: encoder direction.  Values flow in, get coded, flow out."""
    decoding = False

    def __init__(self, cabac):
        self.c = cabac

    def bin(self, ctx, v):
        return self.c.bin(ctx, v)

    def byp(self, v):
        return self.c.bypass(v)

    def byp_n(self, v, n):
        return self.c.bypass_bits(v, n)


class DecIO:
    """Adapter: decoder direction.  Supplied values are ignored."""
    decoding = True

    def __init__(self, cabac):
        self.c = cabac

    def bin(self, ctx, v=None):
        return self.c.bin(ctx)

    def byp(self, v=None):
        return self.c.bypass()

    def byp_n(self, v=None, n=0):
        return self.c.bypass_bits(n)


# ---------------------------------------------------------------------------
# shared binarisations
# ---------------------------------------------------------------------------

def _tu_enc_dec(io, val, cmax, ctx_fn):
    """Truncated unary: '1' means continue, '0' terminates (VVC prefix style)."""
    if io.decoding:
        v = 0
        while v < cmax and io.bin(ctx_fn(v)):
            v += 1
        return v
    for i in range(min(val, cmax)):
        io.bin(ctx_fn(i), 1)
    if val < cmax:
        io.bin(ctx_fn(val), 0)
    return val


def _golomb_rice(io, val, k):
    """GR with escape to exp-golomb after 6 prefix ones (HEVC/VVC remainder)."""
    if io.decoding:
        prefix = 0
        while prefix < 6 and io.byp():
            prefix += 1
        if prefix < 6:
            return (prefix << k) + (io.byp_n(n=k) if k else 0)
        # escape: exp-golomb order k+1... incremental
        count = k + 1
        sym = 6 << k
        while io.byp():
            sym += 1 << count
            count += 1
        return sym + (io.byp_n(n=count) if count else 0)
    # encode
    prefix = val >> k
    if prefix < 6:
        for _ in range(prefix):
            io.byp(1)
        io.byp(0)
        if k:
            io.byp_n(val & ((1 << k) - 1), k)
        return val
    for _ in range(6):
        io.byp(1)
    sym = val - (6 << k)
    count = k + 1
    while sym >= (1 << count):
        io.byp(1)
        sym -= 1 << count
        count += 1
    io.byp(0)
    if count:
        io.byp_n(sym, count)
    return val


def _rice_param(local_sum: int) -> int:
    return min(3, max(0, int(local_sum).bit_length() - 2))


# ---------------------------------------------------------------------------
# last position
# ---------------------------------------------------------------------------

def _last_ctx(is_chroma: bool, log2_size: int, bin_idx: int, cset) -> int:
    if is_chroma:
        offset, shift = 15, max(log2_size - 2, 0)
    else:
        offset = 3 * (log2_size - 2) + ((log2_size - 1) >> 2)
        shift = (log2_size + 1) >> 2
    return cset(min(offset + (bin_idx >> shift), cset.size - 1))


def _code_last(io, last_x, last_y, log2_w, log2_h, is_chroma):
    gx = None if io.decoding else _GROUP_IDX[last_x]
    gy = None if io.decoding else _GROUP_IDX[last_y]
    max_gx = _GROUP_IDX[(1 << log2_w) - 1]
    max_gy = _GROUP_IDX[(1 << log2_h) - 1]
    gx = _tu_enc_dec(io, gx, max_gx,
                     lambda i: _last_ctx(is_chroma, log2_w, i, C.LAST_X))
    gy = _tu_enc_dec(io, gy, max_gy,
                     lambda i: _last_ctx(is_chroma, log2_h, i, C.LAST_Y))
    if gx > 3:
        nbits = (gx >> 1) - 1
        sfx = io.byp_n(None if io.decoding else last_x - _MIN_IN_GROUP[gx],
                       nbits)
        last_x = _MIN_IN_GROUP[gx] + sfx
    else:
        last_x = gx
    if gy > 3:
        nbits = (gy >> 1) - 1
        sfx = io.byp_n(None if io.decoding else last_y - _MIN_IN_GROUP[gy],
                       nbits)
        last_y = _MIN_IN_GROUP[gy] + sfx
    else:
        last_y = gy
    return last_x, last_y


# ---------------------------------------------------------------------------
# significance / level context derivation
# ---------------------------------------------------------------------------

def _sig_ctx(abs_buf, x, y, w, h, is_chroma):
    tmpl = 0
    for dx, dy in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1)):
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            tmpl += min(int(abs_buf[ny, nx]), 2)
    d = x + y
    if is_chroma:
        base = C.SIG_CHROMA_BASE + (4 if d == 0 else 0)
    else:
        base = 8 if d == 0 else 4 if d < 3 else 0
    return base + min((tmpl + 1) >> 1, 3)


def _local_sum(abs_buf, x, y, w, h):
    s = 0
    for dx, dy in ((1, 0), (2, 0), (0, 1), (0, 2), (1, 1)):
        nx, ny = x + dx, y + dy
        if nx < w and ny < h:
            s += int(abs_buf[ny, nx])
    return s


# ---------------------------------------------------------------------------
# the traversal
# ---------------------------------------------------------------------------

def code_tb(io, levels, log2_w: int, log2_h: int,
            is_chroma: bool = False) -> np.ndarray:
    """Code one transform block.  Encoder: ``levels`` is (h, w) int32 with at
    least one nonzero (cbf is coded by the caller).  Decoder: ``levels`` is
    None; returns the parsed (h, w) block."""
    from ..core import rom
    w, h = 1 << log2_w, 1 << log2_h
    scan = rom.scan_order(log2_w, log2_h)
    n = len(scan)
    cg_n = min(w, rom.CG_SIZE) * min(h, rom.CG_SIZE)
    num_cg = n // cg_n

    if io.decoding:
        out = np.zeros((h, w), np.int32)
    else:
        out = levels.astype(np.int32)
        nz = [k for k in range(n) if out[scan[k][1], scan[k][0]]]
        last_scan = nz[-1]

    # --- last position ----------------------------------------------------
    if io.decoding:
        lx, ly = _code_last(io, None, None, log2_w, log2_h, is_chroma)
        last_scan = next(k for k in range(n)
                         if scan[k][0] == lx and scan[k][1] == ly)
    else:
        lx, ly = int(scan[last_scan][0]), int(scan[last_scan][1])
        _code_last(io, lx, ly, log2_w, log2_h, is_chroma)

    abs_buf = np.zeros((h, w), np.int32)
    sign_buf = np.zeros((h, w), np.int32)
    last_cg = last_scan // cg_n
    cg_flags = np.zeros(num_cg, np.int32)

    gtx_base = C.GTX_LUMA_BASE if not is_chroma else C.GTX_CHROMA_BASE
    cg_ctx_off = 0 if not is_chroma else 2

    cg_w = max(w // rom.CG_SIZE, 1)

    for cg in range(last_cg, -1, -1):
        first, lastc = cg * cg_n, cg * cg_n + cg_n - 1
        # coded_sub_block_flag (implicit for the last CG and CG 0)
        if cg == last_cg or cg == 0:
            coded = 1
        else:
            cgx, cgy = int(scan[first][0]) // rom.CG_SIZE, \
                int(scan[first][1]) // rom.CG_SIZE
            right = cg_flags_2d(cg_flags, scan, cg_n, cgx + 1, cgy, cg_w,
                                num_cg)
            below = cg_flags_2d(cg_flags, scan, cg_n, cgx, cgy + 1, cg_w,
                                num_cg)
            inc = C.CG_FLAG(cg_ctx_off + min(1, right + below))
            have = None if io.decoding else int(
                any(out[scan[k][1], scan[k][0]] for k in range(first,
                                                               lastc + 1)))
            coded = io.bin(inc, have)
        cg_flags[cg] = coded
        if not coded:
            continue

        # pass 1: sig / gt1 / par / gt3 (reverse scan within CG)
        start = last_scan if cg == last_cg else lastc
        gt3_list = []   # scan positions needing remainder
        sig_list = []   # nonzero scan positions (for signs)
        for k in range(start, first - 1, -1):
            x, y = int(scan[k][0]), int(scan[k][1])
            if k == last_scan:
                sig = 1
            else:
                sig = io.bin(C.SIG_FLAG(_sig_ctx(abs_buf, x, y, w, h,
                                                 is_chroma)),
                             None if io.decoding else int(out[y, x] != 0))
            if not sig:
                continue
            sig_list.append(k)
            a = None if io.decoding else abs(int(out[y, x]))
            tctx = min((_local_sum(abs_buf, x, y, w, h) + 1) >> 1, 3)
            d = x + y
            tbase = gtx_base + (8 if d == 0 else 4 if d < 3 else 0) \
                if not is_chroma else gtx_base + (4 if d == 0 else 0)
            gt1 = io.bin(C.GT1_FLAG(tbase + tctx),
                         None if io.decoding else int(a > 1))
            lvl = 1
            if gt1:
                par = io.bin(C.PAR_FLAG(tbase + tctx),
                             None if io.decoding else (a - 2) & 1)
                gt3 = io.bin(C.GT3_FLAG(tbase + tctx),
                             None if io.decoding else int(a > 3))
                lvl = 2 + par
                if gt3:
                    lvl += 2
                    gt3_list.append((k, par))
            abs_buf[y, x] = lvl
            if not io.decoding:
                sign_buf[y, x] = int(out[y, x] < 0)

        # pass 2: remainders
        for k, par in gt3_list:
            x, y = int(scan[k][0]), int(scan[k][1])
            rice = _rice_param(_local_sum(abs_buf, x, y, w, h))
            a = None if io.decoding else abs(int(out[y, x]))
            rem = _golomb_rice(io,
                               None if io.decoding else (a - 4 - par) >> 1,
                               rice)
            abs_buf[y, x] = 4 + par + 2 * rem

        # pass 3: signs (in coding order = reverse scan)
        for k in sig_list:
            x, y = int(scan[k][0]), int(scan[k][1])
            s = io.byp(None if io.decoding else int(sign_buf[y, x]))
            sign_buf[y, x] = s

    if io.decoding:
        out = np.where(sign_buf != 0, -abs_buf, abs_buf).astype(np.int32)
    return out


def cg_flags_2d(cg_flags, scan, cg_n, cgx, cgy, cg_w, num_cg) -> int:
    """Lookup a CG flag by CG coordinates (0 outside)."""
    from ..core import rom
    if cgx >= cg_w:
        return 0
    for cg in range(num_cg):
        sx = int(scan[cg * cg_n][0]) // rom.CG_SIZE
        sy = int(scan[cg * cg_n][1]) // rom.CG_SIZE
        if sx == cgx and sy == cgy:
            return int(cg_flags[cg])
    return 0
