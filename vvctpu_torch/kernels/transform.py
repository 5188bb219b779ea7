"""Transforms and quantisation in PyTorch — twin of vvctpu/kernels/transform.py.

The separable DCT-II products run in float64: every partial sum is an
integer below 2^53, so the product is exact, and it is rounded back to
int32 before the rounding shifts (CUDA has no int32 matmul).  The DCT
matrices are read from ``rom.tr_matrix`` at call time, so a runtime table
swap (core/tables_spec install/uninstall) takes effect at once.

Functions operate on (..., h, w) int32 batches with static (h, w) and a
host-side integer qp.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rom

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


def forward_transform(resi, h: int, w: int, kind_h: int = rom.DCT2,
                      kind_v: int = rom.DCT2, bd: int = 8):
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
             rdoq: bool = False, lam_rd: int = 0):
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


def dequantize(level, h: int, w: int, qp: int, bd: int = 8):
    shift = bd + ((_log2(w) + _log2(h)) >> 1) - 9
    iq = int(_IQ_SCALES[qp % 6])
    t = level.to(torch.int32) * iq
    return _net_shift(t, qp // 6 - shift).clamp(COEFF_MIN, COEFF_MAX)


def reconstruct(pred, level, h: int, w: int, qp: int,
                kind_h: int = rom.DCT2, kind_v: int = rom.DCT2, bd: int = 8):
    """Shared enc/dec reconstruction (zero levels reduce to pred exactly)."""
    resi = inverse_transform(dequantize(level, h, w, qp, bd), h, w,
                             kind_h, kind_v, bd)
    return (pred.to(torch.int32) + resi).clamp(0, (1 << bd) - 1)
