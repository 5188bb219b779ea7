"""In-loop filters in PyTorch — twin of vvctpu/kernels/loopfilter.py.

Deblocking: the vertical-edge windows on the 8x8 luma grid are disjoint
8-column tiles, so a whole plane filters as one reshaped elementwise
pass; horizontal edges run on the transposed plane.  SAO: per-CTU
statistics by scatter-add, the integer RD choice, then the elementwise
offset stencil.  ALF and CC-ALF: the 4x4 classification and the
diamond filters as shifted-plane sums.  Bit-identical to spec/deblock.py,
spec/sao.py and spec/alf.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import const
from ..spec.alf import _ACT_TABLE, CC_OFFSETS, DIAMOND, DIAMOND_C, TRANS_PERMS
from ..spec.deblock import BETA_TABLE, TC_TABLE, edge_masks
from ..spec.sao import (MAX_OFFSET, N_BANDS, SAO_BAND, SAO_EO0, SAO_EO45,
                        SAO_EO90, SAO_EO135, SAO_OFF, _EO_NEIGH, _EO_SIGN)


def _luma_segment_filter_j(p, q, beta: int, tc: int, bd: int):
    """Twin of spec _luma_segment_filter on (..., 4)-line segments."""
    dp_line = (p[2] - 2 * p[1] + p[0]).abs()
    dq_line = (q[2] - 2 * q[1] + q[0]).abs()
    dp = dp_line[..., 0] + dp_line[..., 3]
    dq = dq_line[..., 0] + dq_line[..., 3]
    active = ((dp + dq) < beta)[..., None]

    strong_l = torch.ones(p[0].shape[:-1], dtype=torch.bool,
                          device=p[0].device)
    for ln in (0, 3):
        sd = 2 * (dp_line[..., ln] + dq_line[..., ln]) < (beta >> 2)
        sg = ((p[3][..., ln] - p[0][..., ln]).abs()
              + (q[0][..., ln] - q[3][..., ln]).abs()) < (beta >> 3)
        st = (p[0][..., ln] - q[0][..., ln]).abs() < ((5 * tc + 1) >> 1)
        strong_l = strong_l & sd & sg & st
    strong = strong_l[..., None]

    def c2(v, ref):
        return torch.minimum(torch.maximum(v, ref - 2 * tc), ref + 2 * tc)

    sp0 = c2((p[2] + 2 * p[1] + 2 * p[0] + 2 * q[0] + q[1] + 4) >> 3, p[0])
    sp1 = c2((p[2] + p[1] + p[0] + q[0] + 2) >> 2, p[1])
    sp2 = c2((2 * p[3] + 3 * p[2] + p[1] + p[0] + q[0] + 4) >> 3, p[2])
    sq0 = c2((q[2] + 2 * q[1] + 2 * q[0] + 2 * p[0] + p[1] + 4) >> 3, q[0])
    sq1 = c2((q[2] + q[1] + q[0] + p[0] + 2) >> 2, q[1])
    sq2 = c2((2 * q[3] + 3 * q[2] + q[1] + q[0] + p[0] + 4) >> 3, q[2])

    delta = (9 * (q[0] - p[0]) - 3 * (q[1] - p[1]) + 8) >> 4
    weak_on = delta.abs() < (tc * 10)
    dc = delta.clamp(-tc, tc)
    mx = (1 << bd) - 1
    wp0 = (p[0] + dc).clamp(0, mx)
    wq0 = (q[0] - dc).clamp(0, mx)
    side_p = (dp < ((beta + (beta >> 1)) >> 3))[..., None]
    side_q = (dq < ((beta + (beta >> 1)) >> 3))[..., None]
    tc2 = tc >> 1
    dp1 = ((((p[2] + p[0] + 1) >> 1) - p[1] + dc) >> 1).clamp(-tc2, tc2)
    dq1 = ((((q[2] + q[0] + 1) >> 1) - q[1] - dc) >> 1).clamp(-tc2, tc2)
    wp1 = (p[1] + dp1).clamp(0, mx)
    wq1 = (q[1] + dq1).clamp(0, mx)

    w = torch.where
    fp0 = w(active, w(strong, sp0, w(weak_on, wp0, p[0])), p[0])
    fq0 = w(active, w(strong, sq0, w(weak_on, wq0, q[0])), q[0])
    fp1 = w(active, w(strong, sp1, w(weak_on & side_p, wp1, p[1])), p[1])
    fq1 = w(active, w(strong, sq1, w(weak_on & side_q, wq1, q[1])), q[1])
    fp2 = w(active & strong, sp2, p[2])
    fq2 = w(active & strong, sq2, q[2])
    return ([fp0.clamp(0, mx), fp1.clamp(0, mx), fp2.clamp(0, mx)],
            [fq0.clamp(0, mx), fq1.clamp(0, mx), fq2.clamp(0, mx)])


def _filter_luma_ver_j(rec, mask, qp: int, bd: int):
    """All vertical luma edges in one dense pass.

    rec: (H, W) int32; mask: (H//8, W//8) bool granule left-edge activity.
    Edge windows [8k+4, 8k+12) are disjoint, so the frame reshapes into
    (H//4, nW, 4, 8) tiles filtered elementwise."""
    h, w = rec.shape
    beta = int(BETA_TABLE[qp]) << (bd - 8)
    tc = int(TC_TABLE[qp]) << (bd - 8)
    x32 = rec.to(torch.int32)
    n_w = (w - 8) // 8
    tiles = x32[:, 4:w - 4].reshape(h // 4, 4, n_w, 8).permute(0, 2, 1, 3)
    seg_mask = mask[:, 1:].repeat_interleave(2, 0)[..., None]   # (H//4, nW)
    p = [tiles[..., 3 - i] for i in range(4)]            # p0 at col 3
    q = [tiles[..., 4 + i] for i in range(4)]
    fp, fq = _luma_segment_filter_j(p, q, beta, tc, bd)
    cols = [tiles[..., c] for c in range(8)]
    for i in range(3):
        cols[3 - i] = torch.where(seg_mask, fp[i], cols[3 - i])
        cols[4 + i] = torch.where(seg_mask, fq[i], cols[4 + i])
    core = torch.stack(cols, -1).permute(0, 2, 1, 3).reshape(h, w - 8)
    return torch.cat([x32[:, :4], core, x32[:, w - 4:]], 1)


def _filter_chroma_ver_j(rec, mask, qp: int, bd: int):
    """Chroma vertical edges (2-point filter), dense tiles of width 4
    (windows [4k+2, 4k+6); the spec skips only the edge at x = 0)."""
    h, w = rec.shape
    tc = int(TC_TABLE[qp]) << (bd - 8)
    x32 = rec.to(torch.int32)
    n_w = (w - 4) // 4
    tiles = x32[:, 2:w - 2].reshape(h // 4, 4, n_w, 4).permute(0, 2, 1, 3)
    m = mask[:, 1:][..., None]      # luma granule rows == chroma 4-row groups
    p1, p0, q0, q1 = (tiles[..., i] for i in range(4))
    mx = (1 << bd) - 1
    delta = ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3).clamp(-tc, tc)
    fp0 = torch.where(m, (p0 + delta).clamp(0, mx), p0)
    fq0 = torch.where(m, (q0 - delta).clamp(0, mx), q0)
    core = torch.stack([p1, fp0, fq0, q1], -1).permute(0, 2, 1, 3) \
        .reshape(h, w - 4)
    return torch.cat([x32[:, :2], core, x32[:, w - 2:]], 1)


def _deblock(y, cb, cr, ver, hor, qp: int, bd: int):
    oy = _filter_luma_ver_j(y, ver, qp, bd)
    oy = _filter_luma_ver_j(oy.T, hor.T, qp, bd).T
    ocb = _filter_chroma_ver_j(cb, ver, qp, bd)
    ocb = _filter_chroma_ver_j(ocb.T, hor.T, qp, bd).T
    ocr = _filter_chroma_ver_j(cr, ver, qp, bd)
    ocr = _filter_chroma_ver_j(ocr.T, hor.T, qp, bd).T
    return oy, ocb, ocr


def _masks(decisions, h: int, w: int, device):
    ver, hor = edge_masks(decisions, h, w)
    return (torch.as_tensor(np.asarray(ver, bool), device=device),
            torch.as_tensor(np.asarray(hor, bool), device=device))


def deblock_frame_j(planes, decisions, qp: int, bd: int = 8):
    """Deblock three device planes (twin of spec deblock.deblock_frame)."""
    y, cb, cr = planes
    h, w = y.shape
    ver, hor = _masks(decisions, h, w, y.device)
    return list(_deblock(y, cb, cr, ver, hor, qp, bd))


# ---------------------------------------------------------------------------
# SAO
# ---------------------------------------------------------------------------

_EO_SIGN4 = np.asarray(_EO_SIGN, np.int32)[[0, 1, 3, 4]]
_SAO_ORDER = np.asarray([SAO_OFF, SAO_EO0, SAO_EO90, SAO_EO135, SAO_EO45,
                         SAO_BAND], np.int32)


def _edge_categories_j(p, t: int):
    (dy1, dx1), (dy2, dx2) = _EO_NEIGH[t]
    h, w = p.shape
    dev = p.device
    iy = (torch.arange(h + 2, device=dev) - 1).clamp(0, h - 1)
    ix = (torch.arange(w + 2, device=dev) - 1).clamp(0, w - 1)
    zp = p[iy[:, None], ix[None, :]]            # edge pad by 1
    n1 = zp[1 + dy1:1 + dy1 + h, 1 + dx1:1 + dx1 + w]
    n2 = zp[1 + dy2:1 + dy2 + h, 1 + dx2:1 + dx2 + w]
    cat = 2 + torch.sign(p - n1) + torch.sign(p - n2)
    if dy1 != 0 or dy2 != 0:
        cat[0, :] = 2
        cat[-1, :] = 2
    if dx1 != 0 or dx2 != 0:
        cat[:, 0] = 2
        cat[:, -1] = 2
    return cat


def _sao_component_j(rec, tp, offs_px, bp, bd: int):
    """rec (h, w) int32; tp / bp (h, w) per-pixel type / band position;
    offs_px (h, w, 4) int32."""
    mx = (1 << bd) - 1
    add = torch.zeros_like(rec)
    for t in range(SAO_EO0, SAO_EO45 + 1):
        cat = _edge_categories_j(rec, t)
        m_t = tp == t
        for oi, ci in enumerate((0, 1, 3, 4)):
            m = m_t & (cat == ci)
            add = add + torch.where(m, offs_px[..., oi] * int(_EO_SIGN[ci]),
                                    0)
    rel = torch.remainder((rec >> (bd - 5)) - bp, N_BANDS)
    sel = torch.gather(offs_px, -1, rel.clamp(max=3).long()[..., None])[..., 0]
    add = add + torch.where((tp == SAO_BAND) & (rel < 4), sel, 0)
    return (rec + add).clamp(0, mx)


def _up(a, n_y: int, n_x: int, cs: int):
    return a.reshape(n_y, n_x).repeat_interleave(cs, 0) \
        .repeat_interleave(cs, 1)


def _sao_apply_comp_j(rec, tp_c, offs_c, bp_c, cs: int, bd: int):
    """Apply per-CTU params (CTU-grid arrays) to one component plane."""
    h, w = rec.shape
    n_y, n_x = h // cs, w // cs
    offs_px = torch.stack([_up(offs_c[:, i], n_y, n_x, cs)
                           for i in range(4)], -1)
    return _sao_component_j(rec, _up(tp_c, n_y, n_x, cs), offs_px,
                            _up(bp_c, n_y, n_x, cs), bd)


def apply_sao_j(planes, params, ctu: int = 64, bd: int = 8):
    """Apply parsed SAO params to three device planes (twin of spec
    sao.apply_sao)."""
    out = []
    for comp in range(3):
        rec = planes[comp].to(torch.int32)
        cs = ctu // (1 if comp == 0 else 2)
        dev = rec.device

        def grid(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=dev).reshape(-1, *a.shape[2:])

        out.append(_sao_apply_comp_j(
            rec, grid(params.type[:, :, comp]),
            grid(params.offsets[:, :, comp]),
            grid(params.band_pos[:, :, comp]), cs, bd))
    return out


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _count(idx, vals, n: int):
    out = torch.zeros(n, dtype=torch.int32, device=vals.device)
    return out.scatter_add_(0, idx, vals)


def _sao_decide_comp_j(org, rec, lam: int, n_y: int, n_x: int, cs: int,
                       bd: int):
    """(type (nY*nX,), offs (nY*nX, 4), band_pos (nY*nX,)) int32 — the
    integer RD choice of spec sao.decide_sao for one component."""
    h, w = rec.shape
    dev = rec.device
    n_ctu = n_y * n_x
    diff = (org - rec).reshape(-1)
    ctu_id = ((torch.arange(h, device=dev) // cs)[:, None] * n_x
              + (torch.arange(w, device=dev) // cs)[None, :])
    ones = torch.ones(h * w, dtype=torch.int32, device=dev)

    def lam_bits(b):
        return (b * lam + 128) >> 8

    def refine(n, e):
        o = torch.where(n > 0, _fdiv(2 * e + n, (2 * n).clamp(min=1)), 0)
        o = o.clamp(0, MAX_OFFSET)
        for _ in range(MAX_OFFSET):
            cur = n * o * o - 2 * o * e
            dn = n * (o - 1) * (o - 1) - 2 * (o - 1) * e
            o = torch.where((o > 0) & (cur > dn), o - 1, o)
        return o

    costs = [None] * 6
    offs = [None] * 6
    costs[SAO_OFF] = torch.full((n_ctu,), lam_bits(2), dtype=torch.int32,
                                device=dev)
    offs[SAO_OFF] = torch.zeros((n_ctu, 4), dtype=torch.int32, device=dev)
    sign4 = const(_EO_SIGN4, dev)
    for t in range(SAO_EO0, SAO_EO45 + 1):
        idx = (ctu_id * 5 + _edge_categories_j(rec, t)).reshape(-1)
        n_cnt = _count(idx, ones, n_ctu * 5).reshape(n_ctu, 5)
        e_sum = _count(idx, diff, n_ctu * 5).reshape(n_ctu, 5)
        n4 = n_cnt[:, [0, 1, 3, 4]]
        e4 = e_sum[:, [0, 1, 3, 4]] * sign4[None, :]
        o4 = refine(n4, e4)
        dd = (n4 * o4 * o4 - 2 * o4 * e4).sum(1, dtype=torch.int32)
        costs[t] = dd + lam_bits(20)
        offs[t] = o4

    idx = (ctu_id * N_BANDS + (rec >> (bd - 5))).reshape(-1)
    n_b = _count(idx, ones, n_ctu * N_BANDS).reshape(n_ctu, N_BANDS)
    e_b = _count(idx, diff, n_ctu * N_BANDS).reshape(n_ctu, N_BANDS)
    o_b = torch.sign(e_b) * _fdiv(2 * e_b.abs() + n_b, (2 * n_b).clamp(min=1))
    o_b = torch.where(n_b > 0, o_b, 0).clamp(-MAX_OFFSET, MAX_OFFSET)
    dd_b = n_b * o_b * o_b - 2 * o_b * e_b
    ddc = torch.cat([dd_b, dd_b[:, :3]], 1)
    win = torch.stack([ddc[:, s:s + 4].sum(1, dtype=torch.int32)
                       for s in range(N_BANDS)], 1)
    s_best = torch.argmin(win, 1)
    costs[SAO_BAND] = torch.gather(win, 1, s_best[:, None])[:, 0] \
        + lam_bits(28)
    rel = (torch.arange(4, device=dev)[None, :] + s_best[:, None]) % N_BANDS
    offs[SAO_BAND] = torch.gather(o_b, 1, rel)

    order = [int(t) for t in _SAO_ORDER]
    pick = torch.argmin(torch.stack([costs[t] for t in order]), 0)
    chosen_t = const(_SAO_ORDER, dev)[pick]
    offs_sel = torch.stack([offs[t] for t in order])[
        pick, torch.arange(n_ctu, device=dev)]
    bp = torch.where(chosen_t == SAO_BAND, s_best.to(torch.int32), 0)
    return chosen_t, offs_sel, bp


def inverse_map(y, inv_lut):
    """LMCS inverse mapping of a luma plane through its frame's LUT."""
    return torch.as_tensor(inv_lut, device=y.device)[y.long()]


def finish_frame_j(planes, decisions, qp: int, lam: int, orig_planes,
                   inv_lut=None, ctu: int = 64, bd: int = 8,
                   deblock_on: bool = True, sao_on: bool = True):
    """Post-reconstruction chain on the device: with LMCS the inverse
    mapping of the luma through ``inv_lut`` (2^bd entries), then deblock,
    then SAO decide (against the unmapped ``orig_planes``) and apply.
    Returns (rec_y, rec_cb, rec_cr, sao_type (nY, nX, 3), sao_offs (nY,
    nX, 3, 4), sao_bp (nY, nX, 3)) as device tensors."""
    y, cb, cr = (p.to(torch.int32) for p in planes)
    h, w = y.shape
    dev = y.device
    if inv_lut is not None:
        y = inverse_map(y, inv_lut)
    if deblock_on:
        ver, hor = _masks(decisions, h, w, dev)
        y, cb, cr = _deblock(y, cb, cr, ver, hor, qp, bd)
    n_y, n_x = h // ctu, w // ctu
    if not sao_on:
        z3 = torch.zeros((n_y, n_x, 3), dtype=torch.int32, device=dev)
        return (y, cb, cr, z3, torch.zeros((n_y, n_x, 3, 4),
                                           dtype=torch.int32, device=dev),
                z3.clone())
    types, offs, bps, outs = [], [], [], []
    for comp, (o, r) in enumerate(zip(orig_planes, (y, cb, cr))):
        cs = ctu if comp == 0 else ctu // 2
        o = torch.as_tensor(np.ascontiguousarray(o, np.int32), device=dev) \
            if isinstance(o, np.ndarray) else o.to(torch.int32)
        tc, oc, bc = _sao_decide_comp_j(o, r, lam, n_y, n_x, cs, bd)
        types.append(tc)
        offs.append(oc)
        bps.append(bc)
        outs.append(_sao_apply_comp_j(r, tc, oc, bc, cs, bd))
    return (outs[0], outs[1], outs[2],
            torch.stack(types, -1).reshape(n_y, n_x, 3),
            torch.stack(offs, -2).reshape(n_y, n_x, 3, 4),
            torch.stack(bps, -1).reshape(n_y, n_x, 3))


# ---------------------------------------------------------------------------
# ALF + CC-ALF (twins of the reference's classify_j, _alf_luma_jit,
# _alf_chroma_jit, apply_alf_frame_j): the 4x4 classification, the luma
# 7x7 diamond, the chroma 5x5 diamond and the cross-component taps, on
# device planes.  The parameters are derived on the host
# (spec/alf.derive_alf_frame).
# ---------------------------------------------------------------------------


def _pad_edge(p, m: int):
    """np.pad(p, m, mode="edge") of a 2-D tensor."""
    h, w = p.shape
    dev = p.device
    iy = (torch.arange(h + 2 * m, device=dev) - m).clamp(0, h - 1)
    ix = (torch.arange(w + 2 * m, device=dev) - m).clamp(0, w - 1)
    return p[iy[:, None], ix[None, :]]


def classify_j(plane, bd: int):
    """(cls, tr) int32 per 4x4 block of a 2-D plane (twin of classify_j:
    the direction from the 2x-dominance rule, the activity by the 16->5
    table, the transpose index (sumV > sumH) + 2 (sumD1 > sumD0))."""
    p = plane.to(torch.int32)
    z = _pad_edge(p, 1)
    h, w = p.shape
    gv = (2 * p - z[:-2, 1:-1] - z[2:, 1:-1]).abs()
    gh = (2 * p - z[1:-1, :-2] - z[1:-1, 2:]).abs()
    gd0 = (2 * p - z[:-2, :-2] - z[2:, 2:]).abs()
    gd1 = (2 * p - z[:-2, 2:] - z[2:, :-2]).abs()

    def bsum(g):
        return g.reshape(h // 4, 4, w // 4, 4).sum((1, 3), dtype=torch.int32)

    sv, sh_, sd0, sd1 = bsum(gv), bsum(gh), bsum(gd0), bsum(gd1)
    hv1 = torch.maximum(sv, sh_)
    hv0 = torch.minimum(sv, sh_)
    d1 = torch.maximum(sd0, sd1)
    d0 = torch.minimum(sd0, sd1)
    strong_hv = hv1 > 2 * hv0
    strong_d = d1 > 2 * d0
    # the products need 34 bits
    diag_main = d1.long() * hv0 > hv1.long() * d0
    dir_idx = torch.where(~strong_hv & ~strong_d, 0,
                          torch.where(diag_main,
                                      torch.where(strong_d, 4, 3),
                                      torch.where(strong_hv, 2, 1)))
    a16 = (((sv + sh_) * 16) >> (3 + bd)).clamp(0, 15)
    cls = (dir_idx * 5 + const(_ACT_TABLE, plane.device)[a16.long()]) \
        .to(torch.int32)
    tr = (sv > sh_).to(torch.int32) + 2 * (sd1 > sd0).to(torch.int32)
    return cls, tr


def _stencil(z, pad: int, offsets, p):
    """Difference features p(+o) + p(-o) - 2 p of a plane ``p`` padded by
    ``pad`` into ``z``, one per offset."""
    h, w = p.shape
    return [z[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
            + z[pad - dy:pad - dy + h, pad - dx:pad - dx + w] - 2 * p
            for dy, dx in offsets]


def _ctu_mask(on, ctu: int, h: int, w: int):
    return on.repeat_interleave(ctu, 0).repeat_interleave(ctu, 1)[:h, :w]


def _alf_luma(p, coeff_eff, present, ctu_on, ctu: int, bd: int):
    h, w = p.shape
    cls, tr = classify_j(p, bd)
    per_block = coeff_eff[cls.long(), tr.long()] \
        * present[cls.long()][..., None]                 # (h/4, w/4, 12)
    per_pix = per_block.repeat_interleave(4, 0).repeat_interleave(4, 1)
    delta = torch.zeros_like(p)
    for i, f in enumerate(_stencil(_pad_edge(p, 3), 3, DIAMOND, p)):
        delta += per_pix[..., i] * f
    filt = (p + ((delta + 64) >> 7)).clamp(0, (1 << bd) - 1)
    return torch.where(_ctu_mask(ctu_on, ctu, h, w), filt, p)


def _alf_chroma(p, luma_in, c_coeff, cc_coeff, ctu_on_c, cctu: int,
                bd: int):
    """One chroma plane: the 5x5 diamond with the host coefficient list
    ``c_coeff`` (None: off) and the CC-ALF taps ``cc_coeff`` on the
    pre-ALF luma (None: off)."""
    ch, cw = p.shape
    delta = torch.zeros_like(p)
    if c_coeff is not None:
        acc = torch.zeros_like(p)
        for c, f in zip(c_coeff, _stencil(_pad_edge(p, 2), 2, DIAMOND_C, p)):
            acc += int(c) * f
        delta += (acc + 64) >> 7
    if cc_coeff is not None:
        lz = _pad_edge(luma_in, 2)
        ctr = lz[2:2 + 2 * ch:2, 2:2 + 2 * cw:2]
        acc = torch.zeros_like(p)
        for c, (dy, dx) in zip(cc_coeff, CC_OFFSETS):
            acc += int(c) * (lz[2 + dy:2 + dy + 2 * ch:2,
                                2 + dx:2 + dx + 2 * cw:2] - ctr)
        delta += (acc + 64) >> 7
    filt = (p + delta).clamp(0, (1 << bd) - 1)
    return torch.where(_ctu_mask(ctu_on_c, cctu, ch, cw), filt, p)


def apply_alf_frame(planes, params, ctu: int = 64, bd: int = 8):
    """ALF of three device planes with host AlfParams (twin of
    apply_alf_frame_j, without the fetch): luma, then each chroma plane
    with CC-ALF from the pre-ALF luma.  Returns device planes."""
    luma_in = planes[0].to(torch.int32)
    dev = luma_in.device

    def up(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    out = [luma_in]
    if params.enabled:
        out[0] = _alf_luma(luma_in, up(params.coeff[:, TRANS_PERMS]),
                           up(params.present), up(params.ctu_on, torch.bool),
                           ctu, bd)
    for c in (0, 1):
        base = planes[c + 1].to(torch.int32)
        if not params.c_enabled[c]:
            out.append(base)
            continue
        out.append(_alf_chroma(
            base, luma_in,
            params.c_coeff[c] if params.c_coeff[c].any() else None,
            params.cc_coeff[c] if params.cc_present[c] else None,
            up(params.ctu_on_c[c], torch.bool), ctu // 2, bd))
    return out
