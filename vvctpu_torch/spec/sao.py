"""Sample Adaptive Offset — stats, per-CTU RD decision, filter, syntax.

Role of VTM:CommonLib/SampleAdaptiveOffset.cpp (offsetCTU/SAOProcess) and
VTM:EncoderLib/EncSampleAdaptiveOffset.cpp (statistics gathering +
deriveParametersCTU RD estimation).  Types: band offset (4 consecutive of 32
bands) and 4-direction edge offset with the classic 2+sign(p-n1)+sign(p-n2)
categoriser; offsets clipped to +-7 (8-bit).

Placement note (internal-format choice, documented): SAO parameters are coded
in a slice-tail section after the CTU tree data, because this encoder derives
them after the frame is reconstructed and deblocked — the same two-pass
ordering VTM uses internally (compressSlice then encodeSlice, SURVEY.md
§3.1); only the bitstream position differs from the standard's per-CTU
interleave.

Everything here is vectorised numpy shared verbatim by the spec and JAX
pipelines, so enc/dec recon match is by construction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..cabac import contexts as C

SAO_OFF, SAO_BAND, SAO_EO0, SAO_EO90, SAO_EO135, SAO_EO45 = range(6)
N_BANDS = 32
MAX_OFFSET = 7

_EO_NEIGH = {
    SAO_EO0: ((0, -1), (0, 1)),      # (dy, dx) pairs: horizontal
    SAO_EO90: ((-1, 0), (1, 0)),
    SAO_EO135: ((-1, -1), (1, 1)),
    SAO_EO45: ((-1, 1), (1, -1)),
}
# edge categories: edgeIdx = 2 + sign(p-n1) + sign(p-n2); offsets apply to
# edgeIdx 0,1,3,4 with implicit signs +,+,-,-
_EO_SIGN = np.array([1, 1, 0, -1, -1], np.int64)


@dataclass
class SaoParams:
    """Per-CTU, per-component params (padded-frame CTU grid)."""
    type: np.ndarray        # (nY, nX, 3) int32
    offsets: np.ndarray     # (nY, nX, 3, 4) int32 (unsigned magnitudes)
    band_pos: np.ndarray    # (nY, nX, 3) int32

    @classmethod
    def empty(cls, n_y: int, n_x: int) -> "SaoParams":
        return cls(np.zeros((n_y, n_x, 3), np.int32),
                   np.zeros((n_y, n_x, 3, 4), np.int32),
                   np.zeros((n_y, n_x, 3), np.int32))

    def equal(self, o: "SaoParams") -> bool:
        return (np.array_equal(self.type, o.type)
                and np.array_equal(self.offsets, o.offsets)
                and np.array_equal(self.band_pos, o.band_pos))


def _edge_categories(p: np.ndarray, t: int) -> np.ndarray:
    """edgeIdx plane (borders category 2 = neutral)."""
    (dy1, dx1), (dy2, dx2) = _EO_NEIGH[t]
    h, w = p.shape
    z = np.pad(p, 1, mode="edge").astype(np.int64)
    n1 = z[1 + dy1:1 + dy1 + h, 1 + dx1:1 + dx1 + w]
    n2 = z[1 + dy2:1 + dy2 + h, 1 + dx2:1 + dx2 + w]
    cat = 2 + np.sign(p - n1) + np.sign(p - n2)
    # neutralise frame borders that lack a true neighbour
    if dy1 != 0 or dy2 != 0:
        cat[0, :] = 2
        cat[-1, :] = 2
    if dx1 != 0 or dx2 != 0:
        cat[:, 0] = 2
        cat[:, -1] = 2
    return cat.astype(np.int64)


def _apply_component(rec: np.ndarray, orig_unused, params: SaoParams,
                     comp: int, ctu: int, bd: int) -> np.ndarray:
    """Vectorised per-pixel offset application (categories and band indices
    derive from the pre-SAO plane, as in the standard)."""
    h, w = rec.shape
    scale = 1 if comp == 0 else 2
    cs = ctu // scale
    out = rec.astype(np.int64)
    mx = (1 << bd) - 1

    def up(a):
        return np.kron(a, np.ones((cs, cs), a.dtype))[:h, :w]

    tp = up(params.type[:, :, comp].astype(np.int64))
    offs_px = np.stack([up(params.offsets[:, :, comp, i].astype(np.int64))
                        for i in range(4)], axis=-1)
    add = np.zeros((h, w), np.int64)
    for t in range(SAO_EO0, SAO_EO45 + 1):
        m_t = tp == t
        if not m_t.any():
            continue
        cat = _edge_categories(out, t)
        for oi, ci in enumerate((0, 1, 3, 4)):
            m = m_t & (cat == ci)
            add[m] += offs_px[..., oi][m] * int(_EO_SIGN[ci])
    m_b = tp == SAO_BAND
    if m_b.any():
        bp = up(params.band_pos[:, :, comp].astype(np.int64))
        rel = ((out >> (bd - 5)) - bp) % N_BANDS
        sel = np.take_along_axis(offs_px, np.minimum(rel, 3)[..., None],
                                 axis=-1)[..., 0]
        add += np.where(m_b & (rel < 4), sel, 0)
    return np.clip(out + add, 0, mx).astype(np.int32)


def apply_sao(planes, params: SaoParams, ctu: int = 64, bd: int = 8):
    return [_apply_component(planes[c], None, params, c, ctu, bd)
            for c in range(3)]


# ---------------------------------------------------------------------------
# encoder: statistics + decision
# ---------------------------------------------------------------------------

def _ctu_view(plane: np.ndarray, cy: int, cx: int, cs: int) -> np.ndarray:
    return plane[cy * cs:(cy + 1) * cs, cx * cs:(cx + 1) * cs]


def decide_sao(orig_planes, rec_planes, qp: int, ctu: int = 64,
               bd: int = 8) -> SaoParams:
    """Pick per-CTU params minimising D + lambda*R (fully vectorised:
    per-(CTU, category) statistics via bincount over combined indices)."""
    h, w = rec_planes[0].shape
    n_y, n_x = h // ctu, w // ctu
    n_ctu = n_y * n_x
    params = SaoParams.empty(n_y, n_x)
    lam = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    bits_est = {"off": 2, "edge": 20, "band": 28}
    # all arithmetic below is integer and int32-range-safe (dd <= ~2^24,
    # lambda term pre-shifted) so the device twin
    # (kernels/loopfilter.py sao_decide_j) matches bit-for-bit without
    # int64 (TPU runs with 32-bit ints)

    def lam_bits(b):
        return (b * lam + 128) >> 8

    def refine_offsets(n, e):
        """Integer offsets >= 0 minimising n*o^2 - 2*o*e, elementwise
        (round-half-up start, integer descent)."""
        o = np.where(n > 0, (2 * e + n) // np.maximum(2 * n, 1), 0)
        o = np.clip(o, 0, MAX_OFFSET).astype(np.int64)
        for _ in range(MAX_OFFSET):
            cur = n * o * o - 2 * o * e
            dn = n * (o - 1) * (o - 1) - 2 * (o - 1) * e
            step = (o > 0) & (cur > dn)
            o = np.where(step, o - 1, o)
        return o

    for comp in range(3):
        rec = rec_planes[comp].astype(np.int64)
        org = orig_planes[comp].astype(np.int64)
        diff = (org - rec).ravel()
        scale = 1 if comp == 0 else 2
        cs = ctu // scale
        hh, ww = rec.shape
        yy, xx = np.mgrid[0:hh, 0:ww]
        ctu_id = ((yy // cs) * n_x + (xx // cs)).ravel()

        costs = np.full((6, n_ctu), lam_bits(bits_est["off"]), np.int64)
        all_offs = np.zeros((6, n_ctu, 4), np.int64)
        band_pos = np.zeros(n_ctu, np.int64)

        for t in range(SAO_EO0, SAO_EO45 + 1):
            cat = _edge_categories(rec, t).ravel()
            idx = ctu_id * 5 + cat
            n_cnt = np.bincount(idx, minlength=n_ctu * 5).reshape(n_ctu, 5)
            e_sum = np.bincount(idx, weights=diff,
                                minlength=n_ctu * 5).reshape(
                n_ctu, 5).astype(np.int64)
            cis = np.array([0, 1, 3, 4])
            n4 = n_cnt[:, cis]
            e4 = e_sum[:, cis] * _EO_SIGN[cis][None, :]
            o4 = refine_offsets(n4, e4)
            dd = (n4 * o4 * o4 - 2 * o4 * e4).sum(axis=1)
            costs[t] = dd + lam_bits(bits_est["edge"])
            all_offs[t] = o4

        band = (rec.ravel() >> (bd - 5))
        idx = ctu_id * N_BANDS + band
        n_b = np.bincount(idx, minlength=n_ctu * N_BANDS).reshape(
            n_ctu, N_BANDS)
        e_b = np.bincount(idx, weights=diff,
                          minlength=n_ctu * N_BANDS).reshape(
            n_ctu, N_BANDS).astype(np.int64)
        o_b = np.sign(e_b) * ((2 * np.abs(e_b) + n_b)
                              // np.maximum(2 * n_b, 1))
        o_b = np.clip(np.where(n_b > 0, o_b, 0),
                      -MAX_OFFSET, MAX_OFFSET).astype(np.int64)
        dd_b = n_b * o_b * o_b - 2 * o_b * e_b
        ddc = np.concatenate([dd_b, dd_b[:, :3]], axis=1)
        win = np.stack([ddc[:, s:s + 4].sum(axis=1)
                        for s in range(N_BANDS)], axis=1)
        s_best = np.argmin(win, axis=1)
        costs[SAO_BAND] = (win[np.arange(n_ctu), s_best]
                           + lam_bits(bits_est["band"]))
        band_pos[:] = s_best
        rel = (np.arange(4)[None, :] + s_best[:, None]) % N_BANDS
        all_offs[SAO_BAND] = np.take_along_axis(o_b, rel, axis=1)

        # selection order matches the sequential reference: OFF beats ties,
        # edge types in index order, band last (argmin keeps the first min)
        order = [SAO_OFF, SAO_EO0, SAO_EO90, SAO_EO135, SAO_EO45, SAO_BAND]
        stacked = costs[order]
        pick = np.argmin(stacked, axis=0)
        chosen_t = np.array(order)[pick]
        params.type[:, :, comp] = chosen_t.reshape(n_y, n_x)
        offs = all_offs[chosen_t, np.arange(n_ctu)]
        params.offsets[:, :, comp, :] = offs.reshape(n_y, n_x, 4)
        params.band_pos[:, :, comp] = np.where(
            chosen_t == SAO_BAND, band_pos, 0).reshape(n_y, n_x)
    return params


# ---------------------------------------------------------------------------
# syntax (slice-tail section), direction-agnostic io
# ---------------------------------------------------------------------------

def code_sao_params(io, params: SaoParams | None, n_y: int,
                    n_x: int) -> SaoParams:
    out = params if params is not None else SaoParams.empty(n_y, n_x)
    dec = io.decoding
    for cy in range(n_y):
        for cx in range(n_x):
            for comp in range(3):
                t = None if dec else int(out.type[cy, cx, comp])
                on = io.bin(C.SAO_TYPE(0), None if dec else int(t != 0))
                if not on:
                    if dec:
                        out.type[cy, cx, comp] = SAO_OFF
                    continue
                is_band = io.byp(None if dec else int(t == SAO_BAND))
                if is_band:
                    bp = io.byp_n(None if dec else
                                  int(out.band_pos[cy, cx, comp]), 5)
                    if dec:
                        out.type[cy, cx, comp] = SAO_BAND
                        out.band_pos[cy, cx, comp] = bp
                    for i in range(4):
                        mag = _tu_byp(io, None if dec else
                                      abs(int(out.offsets[cy, cx, comp, i])))
                        if mag:
                            sign = io.byp(None if dec else
                                          int(out.offsets[cy, cx, comp, i]
                                              < 0))
                        else:
                            sign = 0
                        if dec:
                            out.offsets[cy, cx, comp, i] = -mag if sign \
                                else mag
                else:
                    et = io.byp_n(None if dec else t - SAO_EO0, 2)
                    if dec:
                        out.type[cy, cx, comp] = SAO_EO0 + et
                    for i in range(4):
                        mag = _tu_byp(io, None if dec else
                                      int(out.offsets[cy, cx, comp, i]))
                        if dec:
                            out.offsets[cy, cx, comp, i] = mag
    return out


def _tu_byp(io, val, cmax: int = MAX_OFFSET):
    """Truncated-unary bypass magnitude."""
    if io.decoding:
        v = 0
        while v < cmax and io.byp():
            v += 1
        return v
    v = int(val)
    for _ in range(v):
        io.byp(1)
    if v < cmax:
        io.byp(0)
    return v
